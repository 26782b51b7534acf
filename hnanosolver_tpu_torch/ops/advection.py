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

The table sampler (``INTERP = "vmem"``, trace order 1, on a topology that
carries chunk plans: ``core/topology.ensure_chunk_plans``) is the JAX
package's ``_advect_vmem``. It switches on the step's CFL number
max|clamp(-u*sdt)|, read on the host (one sync per pass):
  - narrow (CFL < 1.9): B1 on the dual table, mode "both" (with the SDF);
  - mixed (1.9 <= CFL < 3.9, no SDF): B1 "back" on the dual table, the
    re-trace d2 = clamp(d + u(back)*sdt) in torch, then B1 "fwd" on the same
    table if max|d2| < 3.9, else B8/B9 at d2 through ``nbr``;
  - wide (CFL >= 3.9, or >= 1.9 with an SDF): the nbr-form B1, valid for
    every clamped displacement (the JAX package's 24-window kernel).
The dual table is ``tables.build_table_dual``, or kernel B11 from
``tables.build_table`` when ``cuda_tables.COMBINE_TBL`` is on. Tables
whose JAX byte model exceeds ``TABLE_BYTES_BUDGET`` (which the JAX package
samples in chunk slices) raise. ``BANDS`` counts the passes each branch
took.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import torch

from hnanosolver_tpu_torch.ops import collision, cuda_bfecc, cuda_sample, cuda_tables, cuda_tail
from hnanosolver_tpu_torch.ops import tables

# Sampling backend at trace order 1: None = B1 through nbr (the default);
# "vmem" = the table sampler where the topology carries chunk plans.
INTERP: Optional[str] = None
# Table bytes (the JAX package's byte model) above which the JAX package
# samples in chunk slices; not ported (ROADMAP queue 1, the sliced table path)
TABLE_BYTES_BUDGET = 2 * 1024 ** 3

BANDS = collections.Counter()  # passes per branch of the table sampler


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


def _amax(d: torch.Tensor) -> float:
    return float(d.abs().amax())


def _dual_table(topo, fields: torch.Tensor) -> torch.Tensor:
    """The chunk dual table of ``fields [nf,T,512]``: B11 from the 27-table
    when COMBINE_TBL is on, else the direct gather. Raises above
    TABLE_BYTES_BUDGET."""
    nf = fields.shape[0]
    nc, Ud = topo.chunk_dsrc.shape[:2]
    comb = bool(cuda_tables.COMBINE_TBL)
    need = tables.table_bytes(nc, Ud, nf)
    if comb:
        need = max(need, tables.table_bytes(nc, topo.chunk_uniq.shape[1], nf))
    if need > TABLE_BYTES_BUDGET:
        raise NotImplementedError(
            f"table sampler: {need} table bytes exceed TABLE_BYTES_BUDGET; the sliced "
            "table path is not ported (ROADMAP queue 1, the sliced table path)")
    if comb:
        return cuda_tables.build_table_dual_combine(
            tables.build_table(topo, fields), topo.chunk_dloc, nf)
    return tables.build_table_dual(topo, fields)


def _table_samples(topo, fields: torch.Tensor, sdt: float, f_lo: int,
                   sdf: Optional[torch.Tensor]):
    """(phiF, phiB) by the table sampler (see the module doc)."""
    nb = fields.shape[0]
    vel = fields[:3]
    d = _clamp(-vel * sdt)
    cfl = _amax(d)
    if cfl < cuda_bfecc.CFL_LIMIT:
        BANDS["narrow"] += 1
        base = fields if sdf is None else torch.cat([fields, sdf[None]])
        return cuda_bfecc.bfecc_sample_dual(_dual_table(topo, base), topo.chunk_ldual, vel,
                                            sdt, nb, f_lo, "both", sdf is not None)
    if sdf is not None or cfl >= cuda_bfecc.CFL_MID:
        BANDS["wide"] += 1
        return cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, f_lo, sdf)
    BANDS["mixed"] += 1
    tdual = _dual_table(topo, fields)
    backs = cuda_bfecc.bfecc_sample_dual(tdual, topo.chunk_ldual, vel, sdt, nb, 0, "back")
    d2 = _clamp(d + backs[:3] * sdt)
    if _amax(d2) < cuda_bfecc.CFL_MID:
        BANDS["mixed fwd narrow"] += 1
        phib = cuda_bfecc.bfecc_sample_dual(tdual, topo.chunk_ldual, d2, sdt, nb, f_lo, "fwd")
    else:
        BANDS["mixed fwd wide"] += 1
        phib = cuda_sample.sample_at(topo.nbr, fields[f_lo:].contiguous(), d2)
    return backs[f_lo:], phib


def _bfecc_samples(topo, fields: torch.Tensor, sdt: float, f_lo: int,
                   sdf: Optional[torch.Tensor], trace_order: int):
    """(phiF, phiB) over ``fields[f_lo:]``; ``fields[0:3]`` is the velocity
    that traces. Orders below 2 trace first-order, as the JAX package does."""
    if trace_order < 2:
        if INTERP == "vmem" and topo.chunk_dsrc is not None:
            return _table_samples(topo, fields, sdt, f_lo, sdf)
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
