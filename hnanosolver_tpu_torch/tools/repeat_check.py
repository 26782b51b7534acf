"""Whether the sparse step's stages give the same answer twice in one
process: each stage is a pure function, so two runs on identical inputs
must agree bitwise.

The inputs are ``tools/dense_spread``'s case (the parity test's fields on
an n^3 box, config 3's confinement at the parity test's parameters). The
stages run twice, in order: the velocity advection, the curl, the six
offset curl magnitudes of the confinement's gradient, the confinement, the
divergence and the pressure solve. Every stage whose two outputs differ is
printed with the count of differing values, the largest difference and
where it lies; the last line is one JSON object ``{"n", "threads",
"differing": {stage: count}}``.

Run: python -m hnanosolver_tpu_torch.tools.repeat_check [--n 128] [--seed 0]
     [--device cpu|cuda]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from hnanosolver_tpu_torch.core.topology import build_topology_dense, resolve_device
from hnanosolver_tpu_torch.ops import advection, stencil
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.tools import dense_spread as spread
from hnanosolver_tpu_torch.tools import parser


def stages(topo, state, p) -> dict:
    """Every stage's output, each from the one before (module doc)."""
    c, f = p.combustion, 0.5 * p.inv_voxel_size
    out = {"advect": advection.advect_velocity(topo, state.velocity, p.dt, p.inv_voxel_size)}
    u = out["advect"]
    out["curl"] = stencil.curl(topo, u, f)
    for ax in range(3):
        for sign in (1, -1):
            off = [0, 0, 0]
            off[ax] = sign
            out[f"curl magnitude at {tuple(off)}"] = stencil._curl_mag_at_offset(topo, u, off, f)
    out["confinement"] = stencil.vorticity_confinement(topo, u, p.dt, p.inv_voxel_size,
                                                       c.vorticity_scale, c.factor_scale)
    out["divergence"] = stencil.divergence(topo, out["confinement"], p.inv_voxel_size)
    out["pressure"] = prs.solve_pressure(topo, out["divergence"], p.iterations, p.voxel_size,
                                         p.omega, halo_lag=1)
    return out


def main(argv=None) -> int:
    ap = parser(__doc__, timed=False)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    p = spread.params_with_vorticity()
    topo = build_topology_dense((args.n,) * 3, device=dev)
    vel_np, rho_np = spread.smooth_box(args.n, args.seed)
    state = spread.to_tiles(topo, spread.scaled(torch.from_numpy(vel_np).to(dev), p),
                            spread.dense_scalars(torch.from_numpy(rho_np).to(dev)))
    first, second = stages(topo, state, p), stages(topo, state, p)
    differing = {}
    for name, a in first.items():
        d = (a - second[name]).abs()
        if bool((d > 0).any()):
            differing[name] = int((d > 0).sum())
            print(f"{name}: {differing[name]} values differ, max {float(d.max()):.3e} at "
                  f"{tuple(int(i) for i in np.unravel_index(int(d.argmax()), d.shape))}",
                  flush=True)
    print(json.dumps({"n": args.n, "threads": torch.get_num_threads(), "differing": differing}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
