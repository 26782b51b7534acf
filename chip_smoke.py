#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hnanosolver_tpu_torch) on one NVIDIA GPU and
check it end to end. Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (nvcc); it builds the
hand-written kernels from ``hnanosolver_tpu_torch/csrc`` on first use. It
runs in phases, one line each, and any failing phase raises (non-zero exit):

  1. device: nvidia-smi's card name and power limit, torch and CUDA versions
  2. build the kernels, print the seconds it took
  3. each kernel against its plain PyTorch version on the card, at the bench
     shapes (4196-tile plume at capacity 4608), inputs from a seed:
     B1 in velocity and scalar mode with displacements past the clamp,
     B2 for F = 3 and F = 5 (bitwise), B3 as 10 launches of 5 pairs
  4. the main path: plume_step for STEPS steps on the bench domain with the
     bench SolverParams / PlumeConfig, launch counters reset just before and
     read just after (exactly 2 B1, 2 B2, 10 B3 launches per step), every
     field finite, null and padding rows exactly 0
  5. one more step from the developed state through the kernels and through
     the plain versions on the card, max relative error per field
  6. timing with CUDA events: ms/step (median of single steps), active
     voxel-updates/s, each kernel's time per step beside its plain
     version's (per-call medians over runs of 10 back-to-back calls)

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

STEPS = 20  # main-path steps from rest (develops the plume)
SEED = 0
# bench settings (bench.py): 50 pressure iterations, 1/24 s, dx 0.5
BENCH_PARAMS = dict(dt=1.0 / 24.0, iterations=50, voxel_size=0.5)
BENCH_CFG = dict(center=(128.0, 24.0, 128.0), radius=20.0)
# Tolerances, kernel vs its plain version on the card. The kernels use
# round-to-nearest intrinsics in the plain version's op order, so bitwise
# agreement is the expected outcome; the allowances below cover ulp-level
# drift (e.g. a different floor/convert path) and its amplification:
# B1's forward sample sits at a re-traced position whose ulp error is
# multiplied by the field's gradient.
TOL_B1 = 1e-5  # max abs err / max |ref|
TOL_B3 = 1e-5  # max abs err / max |ref|, 10 launches of 5 pairs
TOL_STEP = 1e-4  # per field, one full step from the developed state


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, batch: int = 1) -> list[float]:
    """``reps`` samples of the per-call time (ms) of ``fn``, each sample a
    run of ``batch`` back-to-back calls between two CUDA events."""
    import torch

    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / batch)
    return out


def paired_ms(kernel, plain, reps: int = 5, batch: int = 10) -> tuple[float, float]:
    """Median per-call ms of kernel and plain over runs of ``batch`` calls,
    measured in turns (plain, kernel, kernel, plain) after a warm-up."""
    kernel(), plain()
    p = cuda_ms(plain, reps, batch)
    k = cuda_ms(kernel, reps, batch) + cuda_ms(kernel, reps, batch)
    p += cuda_ms(plain, reps, batch)
    return statistics.median(k), statistics.median(p)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs err, max abs err / max |want|)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / scale if scale else err


def main() -> int:
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(f"[1] device: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from hnanosolver_tpu_torch.config import SolverParams
    from hnanosolver_tpu_torch.core.topology import active_mask, build_topology
    from hnanosolver_tpu_torch.fields import zeros_state
    from hnanosolver_tpu_torch.kernels import build
    from hnanosolver_tpu_torch.models import plume
    from hnanosolver_tpu_torch.ops import cuda_bfecc, cuda_pressure, cuda_tail

    # -- 2. build ------------------------------------------------------------
    info = build.build()
    build.library()
    regs = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    print(f"[2] build: {info.seconds:.1f} s -> {info.path.name}"
          f" ({len(regs)} ptxas register reports)", flush=True)
    for ln in regs:
        print(f"    ptxas: {ln}")

    dev = torch.device("cuda")
    tiles = plume.build_plume_envelope(64, 256)
    n = len(np.unique(tiles, axis=0))
    cap = ((n + 1 + 511) // 512) * 512  # bench.py's tight capacity
    topo = build_topology(tiles, capacity=cap, device=dev)
    T = topo.capacity
    params = SolverParams(**BENCH_PARAMS)
    cfg = plume.PlumeConfig(**BENCH_CFG)
    sdt = params.dt * params.inv_voxel_size
    lag = params.effective_halo_lag
    launches_per_step = {"B1": 2, "B2": 2, "B3": params.iterations // lag}
    kernels = {
        "B1": dict(name="bfecc_sample", route="cuda",
                   source="hnanosolver_tpu_torch/csrc/bfecc_sample.cu",
                   replaces="hnanosolver_tpu/ops/pallas_bfecc.py:303",
                   counter=cuda_bfecc.launches, max_abs_err=0.0),
        "B2": dict(name="bfecc_tail", route="cuda",
                   source="hnanosolver_tpu_torch/csrc/bfecc_tail.cu",
                   replaces="hnanosolver_tpu/ops/pallas_tail.py:85",
                   counter=cuda_tail.launches, max_abs_err=0.0),
        "B3": dict(name="rbsor_lagged", route="cuda",
                   source="hnanosolver_tpu_torch/csrc/rbsor_lagged.cu",
                   replaces="hnanosolver_tpu/ops/pallas_pressure.py:199",
                   counter=cuda_pressure.launches, max_abs_err=0.0),
    }

    # -- 3. kernels vs plain versions at the bench shapes ------------------------
    rng = np.random.default_rng(SEED)
    m = active_mask(topo)[:, None]

    def field(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev) * scale * m

    vel = field(3, T, 512, scale=40.0)  # |u|*sdt reaches the 7-voxel clamp
    scal = field(5, T, 512)
    clamped = float(((vel * sdt).abs() > cuda_bfecc.DISP_LIMIT).float().mean())
    if clamped <= 0:
        raise AssertionError("phase 3: no displacement reaches the clamp")
    for mode, fields, f_lo in (("velocity", vel, 0),
                               ("scalars", torch.cat([vel, scal]).contiguous(), 3)):
        got = cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, f_lo)
        want = cuda_bfecc.bfecc_sample_plain(topo.nbr, fields, sdt, f_lo)
        torch.cuda.synchronize()
        for part, g, w in zip(("phiF", "phiB"), got, want):
            err, rel = rel_err(g, w)
            kernels["B1"]["max_abs_err"] = max(kernels["B1"]["max_abs_err"], err)
            print(f"[3] B1 {mode:8s} {part}: max abs err {err:.3e}, rel {rel:.3e}"
                  f" (tol {TOL_B1:g}; {clamped:.1%} of traces clamped)", flush=True)
            if not rel <= TOL_B1:
                raise AssertionError(f"phase 3: B1 {mode} {part} rel err {rel} > {TOL_B1}")
    for F in (3, 5):
        phi0, pf, pb = field(F, T, 512), field(F, T, 512), field(F, T, 512)
        got = cuda_tail.bfecc_tail(topo.nbr, phi0, pf, pb)
        want = cuda_tail.bfecc_tail_plain(topo.nbr, phi0, pf, pb)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        bitwise = bool(torch.equal(got, want))
        kernels["B2"]["max_abs_err"] = max(kernels["B2"]["max_abs_err"], err)
        print(f"[3] B2 F={F}: bitwise {bitwise}, max abs err {err:.3e}", flush=True)
        if not bitwise:
            raise AssertionError(f"phase 3: B2 F={F} not bitwise equal to its plain version")
    div = field(T, 512)
    p_k = p_p = torch.zeros_like(div)
    for _ in range(params.iterations // lag):
        p_k = cuda_pressure.rbsor_lagged(topo.nbr, p_k, div, lag, params.omega,
                                         params.voxel_size ** 2)
        p_p = cuda_pressure.rbsor_lagged_plain(topo.nbr, p_p, div, lag, params.omega,
                                               params.voxel_size ** 2)
    torch.cuda.synchronize()
    err, rel = rel_err(p_k, p_p)
    kernels["B3"]["max_abs_err"] = err
    print(f"[3] B3 {params.iterations // lag} launches x {lag} pairs: max abs err "
          f"{err:.3e}, rel {rel:.3e} (tol {TOL_B3:g}), bitwise {bool(torch.equal(p_k, p_p))}",
          flush=True)
    if not rel <= TOL_B3:
        raise AssertionError(f"phase 3: B3 rel err {rel} > {TOL_B3}")

    # -- 4. the main path ------------------------------------------------------
    state = zeros_state(topo)
    for k in kernels.values():
        k["counter"].n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    topo, state = plume.run_plume(STEPS, params, cfg, topo=topo, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {key: k["counter"].n for key, k in kernels.items()}
    for key, k in kernels.items():
        k["launches"] = counts[key]
    want_counts = {key: per * STEPS for key, per in launches_per_step.items()}
    fields = {"velocity": state.velocity, **state.scalars}
    bad = [name for name, f in fields.items()
           if not bool(torch.isfinite(f).all())
           or bool(f[..., 0, :].any()) or bool(f[..., topo.n_active + 1:, :].any())]
    print(f"[4] main path: {STEPS} plume steps on {topo.n_active} tiles "
          f"({topo.num_voxels} active voxels, capacity {T}), {params.iterations} "
          f"iterations at halo_lag {lag}: {wall:.2f} s wall; launches {counts} "
          f"(expected {want_counts}); max density "
          f"{float(state.scalars['density'].max()):.4f}, max |u| "
          f"{float(state.velocity.abs().max()):.3f}", flush=True)
    if counts != want_counts:
        raise AssertionError(f"phase 4: launch counts {counts} != {want_counts}")
    if bad:
        raise AssertionError(f"phase 4: non-finite or non-zero background in {bad}")
    if not float(state.scalars["density"].max()) > 0:
        raise AssertionError("phase 4: the emitter sourced no density")

    # -- 5. one step through the kernels vs through the plain versions ----------
    out_k = plume.plume_step(topo, state, params, cfg)
    before = {key: k["counter"].n for key, k in kernels.items()}
    with mock.patch.object(cuda_bfecc, "bfecc_sample", cuda_bfecc.bfecc_sample_plain), \
            mock.patch.object(cuda_tail, "bfecc_tail", cuda_tail.bfecc_tail_plain), \
            mock.patch.object(cuda_pressure, "rbsor_lagged", cuda_pressure.rbsor_lagged_plain):
        out_p = plume.plume_step(topo, state, params, cfg)
    torch.cuda.synchronize()
    if {key: k["counter"].n for key, k in kernels.items()} != before:
        raise AssertionError("phase 5: the plain step launched a kernel")
    worst = 0.0
    parts = []
    for name in ["velocity"] + sorted(out_k.scalars):
        g = out_k.velocity if name == "velocity" else out_k.scalars[name]
        w = out_p.velocity if name == "velocity" else out_p.scalars[name]
        _, rel = rel_err(g, w)
        worst = max(worst, rel)
        parts.append(f"{name} {rel:.2e}")
    print(f"[5] one step, kernels vs plain on the card, max rel err per field: "
          f"{', '.join(parts)} (tol {TOL_STEP:g})", flush=True)
    if not worst <= TOL_STEP:
        raise AssertionError(f"phase 5: step rel err {worst} > {TOL_STEP}")

    # -- 6. timing ---------------------------------------------------------------
    s = state

    def one_step():
        plume.plume_step(topo, s, params, cfg)

    one_step()
    step_ms = statistics.median(cuda_ms(one_step, 15))
    vups = topo.num_voxels / (step_ms * 1e-3)
    em = plume.emit(topo, s, cfg, params.dt)
    vel_in = em.velocity.contiguous()
    sc_in = torch.cat([vel_in, torch.stack([em.scalars[k] for k in sorted(em.scalars)])])
    pf3, pb3 = cuda_bfecc.bfecc_sample(topo.nbr, vel_in, sdt, 0)
    pf5, pb5 = cuda_bfecc.bfecc_sample(topo.nbr, sc_in, sdt, 3)
    phi5 = sc_in[3:].contiguous()
    p0 = torch.zeros_like(div)
    omega, dx2 = params.omega, params.voxel_size ** 2
    shapes = {
        "B1": [(lambda: cuda_bfecc.bfecc_sample(topo.nbr, vel_in, sdt, 0),
                lambda: cuda_bfecc.bfecc_sample_plain(topo.nbr, vel_in, sdt, 0), 1),
               (lambda: cuda_bfecc.bfecc_sample(topo.nbr, sc_in, sdt, 3),
                lambda: cuda_bfecc.bfecc_sample_plain(topo.nbr, sc_in, sdt, 3), 1)],
        "B2": [(lambda: cuda_tail.bfecc_tail(topo.nbr, vel_in, pf3, pb3),
                lambda: cuda_tail.bfecc_tail_plain(topo.nbr, vel_in, pf3, pb3), 1),
               (lambda: cuda_tail.bfecc_tail(topo.nbr, phi5, pf5, pb5),
                lambda: cuda_tail.bfecc_tail_plain(topo.nbr, phi5, pf5, pb5), 1)],
        "B3": [(lambda: cuda_pressure.rbsor_lagged(topo.nbr, p0, div, lag, omega, dx2),
                lambda: cuda_pressure.rbsor_lagged_plain(topo.nbr, p0, div, lag, omega, dx2),
                params.iterations // lag)],
    }
    for key, runs in shapes.items():
        k_ms = p_ms = 0.0
        detail = []
        for kern, plain_fn, per_step in runs:
            a, b = paired_ms(kern, plain_fn)
            k_ms += a * per_step
            p_ms += b * per_step
            detail.append(f"{a:.4f}/{b:.4f} ms x{per_step}")
        kernels[key]["ms"] = k_ms
        kernels[key]["plain_ms"] = p_ms
        print(f"[6] {key} {kernels[key]['name']}: {k_ms:.4f} ms/step kernel vs "
              f"{p_ms:.4f} ms/step plain (per launch kernel/plain: {'; '.join(detail)})"
              f" | {card}", flush=True)
    print(f"[6] step: {step_ms:.3f} ms/step (median of 15, CUDA events), "
          f"{vups:.4e} active voxel-updates/s, {topo.num_voxels} voxels, "
          f"{params.iterations} iterations | {card}", flush=True)

    print(json.dumps({"kernels": [
        {key2: k[key2] for key2 in ("name", "route", "source", "replaces", "launches",
                                    "max_abs_err", "ms", "plain_ms")}
        for k in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
