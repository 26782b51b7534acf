"""MacCormack/BFECC advection of scalar and vector fields, flat layout.

Scheme per voxel at position x (index space, sdt = dt / dx):
  1. d       = clamp(-u(x) * sdt)                 (semi-Lagrangian backtrace)
  2. phiF    = phi(x + d)                          (trilinear)
  3. d2      = clamp(d + u(x + d) * sdt)           (forward re-trace)
  4. phiB    = phi(x + d2)
  5. phiCorr = phiF + 0.5 * (phi(x) - phiB)        (BFECC correction)
  6. clamp phiCorr to [min, max] over {phi(x), 6 face neighbours, phiF}
Steps 1-4 are kernel B1 (``ops/cuda_bfecc.py``), steps 5-6 kernel B2
(``ops/cuda_tail.py``). Displacements are clamped to ``DISP_LIMIT`` voxels
per axis (``cuda_bfecc.DISP_LIMIT``) so every trilinear corner lies in the
tile's 3x3x3 neighbourhood.

Ported: trace order 1 without a collision SDF (the main path). RK2-4
backtraces and SDF rejection raise until their ROADMAP items land.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hnanosolver_tpu_torch.ops import cuda_bfecc, cuda_tail


def _require_main_path(sdf, trace_order):
    if sdf is not None:
        raise NotImplementedError(
            "advection with a collision SDF is not ported yet (ROADMAP: "
            "modules still to port, collision)")
    if trace_order != 1:
        raise NotImplementedError(
            f"trace_order {trace_order} is not ported yet (ROADMAP: modules "
            "still to port, RK2-4 backtraces)")


def _bfecc_limit(topo, phi0s, pf, pb):
    """clip(pf + 0.5 (phi0 - pb), bounds over {phi0, 6 faces, pf})."""
    return cuda_tail.bfecc_tail(topo.nbr, phi0s, pf, pb)


def advect_scalars_fused(
    topo,
    vel: torch.Tensor,
    scalars: Dict[str, torch.Tensor],
    dt: float,
    inv_dx: float,
    sdf: Optional[torch.Tensor] = None,
    trace_order: int = 1,
) -> Dict[str, torch.Tensor]:
    """BFECC-advect every scalar field by ``vel [3,T,512]``, sharing trace
    corners across fields (fields taken in sorted-name order)."""
    _require_main_path(sdf, trace_order)
    if not scalars:
        return {}
    names = sorted(scalars)
    phi0s = torch.stack([scalars[n] for n in names])
    pf, pb = cuda_bfecc.bfecc_sample(topo.nbr, torch.cat([vel, phi0s]), dt * inv_dx, 3)
    out = _bfecc_limit(topo, phi0s, pf, pb)
    return {n: out[i] for i, n in enumerate(names)}


def advect_velocity(
    topo,
    vel: torch.Tensor,
    dt: float,
    inv_dx: float,
    sdf: Optional[torch.Tensor] = None,
    trace_order: int = 1,
) -> torch.Tensor:
    """BFECC self-advection of velocity with per-component clamping."""
    _require_main_path(sdf, trace_order)
    vel = vel.contiguous()
    pf, pb = cuda_bfecc.bfecc_sample(topo.nbr, vel, dt * inv_dx, 0)
    return _bfecc_limit(topo, vel, pf, pb)
