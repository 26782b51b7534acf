"""The sparse step against the dense oracle over seeds, and the oracle's own
conditioning under config 3's vorticity confinement.

The case is chip_smoke's phase 20 at the JAX parity test's parameters
(``SolverParams(dt=0.2, iterations=6, halo_lag=1)``) with config 3's
confinement (``fire.default_params().combustion``'s scale and
``factor_scale``): ``tests/test_parity.py``'s band-limited fields on an n^3
box from ``numpy.random.default_rng(seed)``, the velocity scaled to a max
CFL of 2.0 (traces cross tile seams, the trace clamp never engages).

For each box and seed, against ``step_dense`` on float64 tensors:
  - the sparse ``solver.step`` through the kernels, and through their plain
    versions (every wrapper replaced; no kernel may launch): max abs error
    of the velocity and of the widest scalar;
  - ``step_dense`` in float32;
  - ``step_dense`` in float64 with the advected velocity rounded once to
    float32 before the confinement ("one rounding"): what a single float32
    rounding of that intermediate moves the answer by, a floor under what
    any float32 step can be held to;
  - at the voxel where the kernels' velocity error peaks and where the one
    rounding moves the answer most: |grad|omega|| of the float64 oracle's
    advected velocity (the confinement divides by it + 1e-5), |omega|, and
    the count of box voxels with |grad|omega|| < 1e-4.
One line of JSON a case follows its text line.

Run: python -m hnanosolver_tpu_torch.tools.dense_spread [--boxes 128 256]
     [--seeds 0 1 2 3 4] [--device cuda|cpu]
"""

from __future__ import annotations

import contextlib
import json
from unittest import mock

import numpy as np
import torch

from hnanosolver_tpu_torch import solver
from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
from hnanosolver_tpu_torch.core.convert import dense_to_tiles, tiles_to_dense
from hnanosolver_tpu_torch.core.layout import (scalar_from_blocks, scalar_to_blocks,
                                               vec_from_blocks, vec_to_blocks)
from hnanosolver_tpu_torch.core.topology import build_topology_dense, resolve_device
from hnanosolver_tpu_torch.dense import ops as D
from hnanosolver_tpu_torch.dense.solver import step_dense
from hnanosolver_tpu_torch.fields import FieldState
from hnanosolver_tpu_torch.models import fire
from hnanosolver_tpu_torch.ops import (cuda_bfecc, cuda_pressure, cuda_sample, cuda_stencil,
                                       cuda_tail)
from hnanosolver_tpu_torch.tools import parser

CFL = 2.0  # the fastest trace's voxels a step: past a tile seam, below the clamp's 3.5
# every wrapper the parity step can reach, with its launch counter
WRAPPERS = ((cuda_bfecc, "bfecc_sample", cuda_bfecc.launches),
            (cuda_tail, "bfecc_tail", cuda_tail.launches),
            (cuda_pressure, "rbsor_color", cuda_pressure.launches_color),
            (cuda_pressure, "rbsor_lagged", cuda_pressure.launches_lagged),
            (cuda_pressure, "rbsor_fused", cuda_pressure.launches_fused),
            (cuda_stencil, "divergence", cuda_stencil.launches_div),
            (cuda_stencil, "subtract_gradient", cuda_stencil.launches_subgrad),
            (cuda_sample, "sample_at", cuda_sample.launches))


def smooth_box(n: int, seed: int):
    """tests/test_parity.py's band-limited fields on an n^3 box (numpy,
    computed in float64 and stored as float32, as that test does): velocity
    [n,n,n,3] and a Gaussian density."""
    rng = np.random.default_rng(seed)

    def smooth(a):
        for ax in range(3):
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
        return a

    x, y, z = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    vel = np.stack([
        np.sin(2 * np.pi * y / n) + 0.3 * smooth(rng.standard_normal((n,) * 3)),
        np.cos(2 * np.pi * z / n) + 0.3 * smooth(rng.standard_normal((n,) * 3)),
        np.sin(2 * np.pi * x / n) * 0.5,
    ], axis=-1).astype(np.float32)
    rho = np.exp(-((x - n / 2) ** 2 + (y - n / 2) ** 2 + (z - n / 2) ** 2)
                 / (n / 4) ** 2).astype(np.float32)
    return vel, rho


def dense_scalars(rho: torch.Tensor) -> dict:
    """test_parity.py's combustion scalars from a density."""
    return {"density": rho, "temperature": 30.0 * rho, "fuel": rho * 0.3,
            "waste": torch.zeros_like(rho), "flame": torch.zeros_like(rho)}


def scaled(vel: torch.Tensor, params: SolverParams, cfl: float = CFL) -> torch.Tensor:
    """``vel`` scaled so that its fastest trace crosses ``cfl`` voxels."""
    return vel * (cfl / (float(vel.abs().max()) * params.dt * params.inv_voxel_size))


def to_tiles(topo, vel: torch.Tensor, scal: dict) -> FieldState:
    """A dense box's fields on the topology that covers it."""
    return FieldState(velocity=vec_from_blocks(dense_to_tiles(topo, vel)).contiguous(),
                      scalars={k: scalar_from_blocks(dense_to_tiles(topo, v))
                               for k, v in scal.items()})


def to_dense(topo, state: FieldState, shape) -> tuple:
    """A sparse state's (velocity, scalars) on the dense box."""
    return (tiles_to_dense(topo, vec_to_blocks(state.velocity), shape),
            {k: tiles_to_dense(topo, scalar_to_blocks(v), shape)
             for k, v in state.scalars.items()})


def abs_err(got: tuple, ref: tuple) -> dict:
    """Max abs error of each field of ``got`` against ``ref``, both
    (velocity, scalars) on the dense box."""
    pairs = [("velocity", got[0], ref[0])] + [(k, got[1][k], ref[1][k]) for k in sorted(ref[1])]
    return {k: float((g.to(w.dtype) - w).abs().max()) for k, g, w in pairs}


def plain_versions():
    """Every kernel wrapper of the parity step replaced by its plain
    version (module-global patches)."""
    stack = contextlib.ExitStack()
    for mod, attr, _ in WRAPPERS:
        stack.enter_context(mock.patch.object(mod, attr, getattr(mod, attr + "_plain")))
    return stack


def launched() -> int:
    return sum(c.n for _, _, c in WRAPPERS)


def confinement_grad(vel: torch.Tensor, inv_dx: float, s: int) -> tuple:
    """(|grad|omega||, |omega|) of ``dense/ops.vorticity_confinement`` on
    ``vel``, each [Nx,Ny,Nz]: the gradient its normalisation divides by."""
    factor = 0.5 * inv_dx
    pos = D.positions(vel.shape[:3], vel.device)

    def curl_at(off):
        def v(o):
            d = torch.tensor([off[i] + o[i] for i in range(3)], dtype=torch.int32,
                             device=vel.device)
            return D.sample_nearest(vel, pos + d)

        upx, umx = v((1, 0, 0)), v((-1, 0, 0))
        upy, umy = v((0, 1, 0)), v((0, -1, 0))
        upz, umz = v((0, 0, 1)), v((0, 0, -1))
        return torch.stack([((upy[..., 2] - umy[..., 2]) - (upz[..., 1] - umz[..., 1])) * factor,
                            ((upz[..., 0] - umz[..., 0]) - (upx[..., 2] - umx[..., 2])) * factor,
                            ((upx[..., 1] - umx[..., 1]) - (upy[..., 0] - umy[..., 0])) * factor],
                           dim=-1)

    def mag(off):
        return curl_at(off).square().sum(-1).sqrt()

    grad = torch.stack([mag((s, 0, 0)) - mag((-s, 0, 0)), mag((0, s, 0)) - mag((0, -s, 0)),
                        mag((0, 0, s)) - mag((0, 0, -s))], dim=-1) * factor
    return grad.square().sum(-1).sqrt(), mag((0, 0, 0))


def one_rounding(vel64: torch.Tensor, scal64: dict, params: SolverParams) -> tuple:
    """``step_dense`` in float64 with the velocity entering the confinement
    rounded once to float32."""
    real = D.vorticity_confinement

    def rounded(u, *a, **kw):
        return real(u.float().double(), *a, **kw)

    with mock.patch.object(D, "vorticity_confinement", rounded):
        return step_dense(vel64, scal64, params)


def params_with_vorticity() -> SolverParams:
    c3 = fire.default_params().combustion
    return SolverParams(dt=0.2, iterations=6, halo_lag=1,
                        combustion=CombustionParams(vorticity_scale=c3.vorticity_scale,
                                                    factor_scale=c3.factor_scale))


def case(n: int, seed: int, dev: torch.device) -> dict:
    """One box and seed: the errors and the conditioning (module doc)."""
    p = params_with_vorticity()
    shape = (n, n, n)
    topo = build_topology_dense(shape, device=dev)
    vel_np, rho_np = smooth_box(n, seed)
    vel = scaled(torch.from_numpy(vel_np).to(dev), p)
    scal = dense_scalars(torch.from_numpy(rho_np).to(dev))
    del vel_np, rho_np
    state = to_tiles(topo, vel, scal)
    out_k = to_dense(topo, solver.step(topo, state, p), shape)
    before = launched()
    with plain_versions():
        out_p = to_dense(topo, solver.step(topo, state, p), shape)
    if launched() != before:
        raise AssertionError("the plain step launched a kernel")
    vel64, scal64 = vel.double(), {k: v.double() for k, v in scal.items()}
    ref = step_dense(vel64, scal64, p)
    err_k, err_p = abs_err(out_k, ref), abs_err(out_p, ref)
    err_32 = abs_err(step_dense(vel, scal, p), ref)
    rnd = one_rounding(vel64, scal64, p)
    err_r = abs_err(rnd, ref)
    g, w = confinement_grad(D.advect_bfecc(vel64, vel64, p.dt, p.inv_voxel_size),
                            p.inv_voxel_size, int(p.combustion.factor_scale))

    def at(dv: torch.Tensor) -> dict:
        i = np.unravel_index(int(dv.argmax()), dv.shape)
        return {"voxel": [int(x) for x in i], "grad": float(g[i]), "omega": float(w[i]),
                "rounding_moves": float((rnd[0] - ref[0]).abs().amax(-1)[i])}

    dv_k = (out_k[0].double() - ref[0]).abs().amax(-1)
    dv_r = (rnd[0] - ref[0]).abs().amax(-1)
    return {"n": n, "seed": seed, "kernels": err_k, "plain": err_p, "oracle_f32": err_32,
            "one_rounding": err_r, "kernels_worst": at(dv_k), "rounding_worst": at(dv_r),
            "flat_voxels": int((g < 1e-4).sum()),
            "bitwise_plain": bool(all(torch.equal(a, b) for a, b in zip(
                [out_k[0]] + [out_k[1][k] for k in sorted(out_k[1])],
                [out_p[0]] + [out_p[1][k] for k in sorted(out_p[1])])))}


def main(argv=None) -> int:
    p = parser(__doc__, timed=False)
    p.add_argument("--boxes", type=int, nargs="+", default=[128, 256])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"dense_spread on {where}: vorticity at the parity test's parameters, "
          f"{args.boxes} boxes, seeds {args.seeds}", flush=True)
    for n in args.boxes:
        for seed in args.seeds:
            r = case(n, seed, dev)
            sc = {k: max(v for f, v in r[k].items() if f != "velocity")
                  for k in ("kernels", "plain", "oracle_f32", "one_rounding")}
            kw, rw = r["kernels_worst"], r["rounding_worst"]
            print(f"{n}^3 seed {seed}: velocity max abs err vs float64 - kernels "
                  f"{r['kernels']['velocity']:.3e}, plain {r['plain']['velocity']:.3e} "
                  f"(bitwise {r['bitwise_plain']}), float32 oracle "
                  f"{r['oracle_f32']['velocity']:.3e}, one rounding "
                  f"{r['one_rounding']['velocity']:.3e}; scalars kernels {sc['kernels']:.3e}, "
                  f"one rounding {sc['one_rounding']:.3e}; kernels' worst voxel "
                  f"{kw['voxel']} |grad|w|| {kw['grad']:.3e} |w| {kw['omega']:.3e} (one "
                  f"rounding moves it {kw['rounding_moves']:.3e}); rounding's worst "
                  f"{rw['voxel']} |grad|w|| {rw['grad']:.3e} |w| {rw['omega']:.3e}; voxels "
                  f"with |grad|w|| < 1e-4: {r['flat_voxels']}", flush=True)
            print(json.dumps(r), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
