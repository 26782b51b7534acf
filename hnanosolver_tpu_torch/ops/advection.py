"""MacCormack/BFECC advection of scalar and vector fields, flat layout.

Scheme per voxel at position x (index space, sdt = dt / dx):
  1. d       = clamp(-u(x) * sdt)                 (semi-Lagrangian backtrace;
                                                   RK2-4 with trace_order 2-4)
  2. phiF    = phi(x + d)                          (trilinear)
  3. d2      = clamp(d + u(x + d) * sdt)           (forward re-trace)
  4. phiB    = phi(x + d2)
  5. phiCorr = phiF + 0.5 * (phi(x) - phiB)        (BFECC correction)
  6. clamp phiCorr to [min, max] over {phi(x), 6 face neighbours, phiF}
With a collision SDF, a trace whose end point probes sdf < 0 is rejected:
the back trace to d = 0, the re-trace to d2 = d; the velocity pass ends in
the no-slip tail ``enforce_collision(margin=0.1, blend_denom=1.5)``.

At trace order 1, steps 1-4 are kernel B1 (``ops/cuda_bfecc.py``). At
orders 2-4 the RK stage arithmetic is plain torch in the JAX package's op
order, and every sampling pass (each RK stage's velocity, each SDF probe,
the back and forward passes) is one call of kernel B8/B9
(``ops/cuda_sample.py``). Steps 5-6 are kernel B2 (``ops/cuda_tail.py``).
Displacements are clamped to ``cuda_bfecc.DISP_LIMIT`` voxels per axis so
every trilinear corner lies in the tile's 3x3x3 neighbourhood.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hnanosolver_tpu_torch.ops import collision, cuda_bfecc, cuda_sample, cuda_tail


def _clamp(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(d, -cuda_bfecc.DISP_LIMIT, cuda_bfecc.DISP_LIMIT)


def _backtrace(topo, vel: torch.Tensor, sdt: float, trace_order: int) -> torch.Tensor:
    """The back-trace displacement [3,T,512] of an RK2 (midpoint), RK3
    (Ralston) or RK4 (classic, any order >= 4) integration, each stage's
    velocity sampled by B8/B9."""
    def vel_at(d):
        return cuda_sample.sample_at(topo.nbr, vel, d)

    k1 = vel
    if trace_order == 2:
        m = vel_at(_clamp(-0.5 * k1 * sdt))
        return _clamp(-m * sdt)
    if trace_order == 3:
        k2 = vel_at(_clamp(-0.5 * k1 * sdt))
        k3 = vel_at(_clamp(-0.75 * k2 * sdt))
        return _clamp(-(2 * k1 + 3 * k2 + 4 * k3) / 9.0 * sdt)
    k2 = vel_at(_clamp(-0.5 * k1 * sdt))
    k3 = vel_at(_clamp(-0.5 * k2 * sdt))
    k4 = vel_at(_clamp(-k3 * sdt))
    return _clamp(-(k1 + 2 * k2 + 2 * k3 + k4) / 6.0 * sdt)


def _reject(topo, sdf: Optional[torch.Tensor], d: torch.Tensor, home) -> torch.Tensor:
    """``d``, with ``home`` where the SDF probed at x + d is < 0."""
    if sdf is None:
        return d
    inside = cuda_sample.sample_at(topo.nbr, sdf[None], d)[0] < 0.0
    return torch.where(inside, home, d)


def _bfecc_samples(topo, fields: torch.Tensor, sdt: float, f_lo: int,
                   sdf: Optional[torch.Tensor], trace_order: int):
    """(phiF, phiB) over ``fields[f_lo:]``; ``fields[0:3]`` is the velocity
    that traces. Orders below 2 trace first-order, as the JAX package does."""
    if trace_order < 2:
        return cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, f_lo, sdf)
    d = _reject(topo, sdf, _backtrace(topo, fields[:3], sdt, trace_order), 0.0)
    back = cuda_sample.sample_at(topo.nbr, fields, d)
    d2 = _reject(topo, sdf, _clamp(d + back[:3] * sdt), d)
    return back[f_lo:], cuda_sample.sample_at(topo.nbr, fields[f_lo:], d2)


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
    corners across fields (fields taken in sorted-name order). The scalars
    go in batches of at most ``cuda_bfecc.MAX_SCALARS`` (B1's limit); each
    batch samples the velocity again, which gives the same samples."""
    if not scalars:
        return {}
    names = sorted(scalars)
    phi0s = torch.stack([scalars[n] for n in names])
    vel = vel.contiguous()
    outs = []
    for i in range(0, len(names), cuda_bfecc.MAX_SCALARS):
        sub = phi0s[i:i + cuda_bfecc.MAX_SCALARS]
        pf, pb = _bfecc_samples(topo, torch.cat([vel, sub]), dt * inv_dx, 3, sdf,
                                trace_order)
        outs.append(_bfecc_limit(topo, sub, pf, pb))
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return {n: out[i] for i, n in enumerate(names)}


def advect_scalar(topo, vel: torch.Tensor, field: torch.Tensor, dt: float, inv_dx: float,
                  sdf: Optional[torch.Tensor] = None, trace_order: int = 1) -> torch.Tensor:
    """Single-field BFECC advection (the standalone HNanoAdvect node path)."""
    return advect_scalars_fused(topo, vel, {"f": field}, dt, inv_dx, sdf, trace_order)["f"]


def advect_velocity(
    topo,
    vel: torch.Tensor,
    dt: float,
    inv_dx: float,
    sdf: Optional[torch.Tensor] = None,
    trace_order: int = 1,
) -> torch.Tensor:
    """BFECC self-advection of velocity with per-component clamping and,
    with an SDF, the near-boundary no-slip tail (gated at 0.1, blended with
    1 - sdf/1.5: a reference quirk kept)."""
    vel = vel.contiguous()
    pf, pb = _bfecc_samples(topo, vel, dt * inv_dx, 0, sdf, trace_order)
    out = _bfecc_limit(topo, vel, pf, pb)
    if sdf is not None:
        out = collision.enforce_collision(topo, out, sdf, inv_dx, margin=0.1, blend_denom=1.5)
    return out
