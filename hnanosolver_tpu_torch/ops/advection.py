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
Displacements are clamped to ``DISP_LIMIT`` voxels per axis so
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
``tables.build_table`` when ``cuda_tables.COMBINE_TBL`` is on. Where the
table's byte model exceeds ``TABLE_BYTES_BUDGET`` (``tables.pick_slices``
gives k > 1 slices), B1d runs the chunk axis in contiguous slices of
ceil(nc / k) chunks, each on its own slice's table built by the direct
gather, and the outputs are concatenated: bitwise the unsliced samples. The
dispatch is the JAX package's (``advection.py:233-255``,
``pallas_bfecc.py:955-1087``): a sliced pass builds no table with B11, and
where either of the mixed band's plans (the dual table of every field, the
27-table of the forward pass's fields) slices, the band shares no table:
its "back" pass builds its own (sliced, or whole and by B11 when
COMBINE_TBL is on) and its forward pass is always the wide one (B8/B9).
``BANDS`` counts the passes each branch took.

``INTERP`` takes the JAX package's four names with their meaning for the
samples (the same trilinear samples under every name):
  - None (the default), "gather", "pallas" and "mxu": the nbr-form B1 at
    trace order 1, B8/B9 at orders 2-4. On Hopper the JAX package's
    8-corner gather, its per-tile 27-table kernel and its one-hot
    contraction (``ops/interp.trilinear_mxu``, ported as a public module)
    are the same samples, so they share the one kernel path;
  - "vmem": the table sampler above, where the topology carries chunk
    plans, else the nbr-form B1 (JAX: "pallas" without a plan).
Any other value raises ``ValueError``.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import torch

from hnanosolver_tpu_torch.core.topology import active_mask
from hnanosolver_tpu_torch.ops import collision, cuda_bfecc, cuda_sample, cuda_tables, cuda_tail
from hnanosolver_tpu_torch.ops import tables

# Sampling backend (the module doc): None, "gather", "pallas", "vmem", "mxu"
INTERP: Optional[str] = None
INTERP_NAMES = (None, "gather", "pallas", "vmem", "mxu")
DISP_LIMIT = cuda_bfecc.DISP_LIMIT  # max |displacement| per axis per trace (voxels)
# Table bytes (the JAX package's byte model, tables.table_bytes) above
# which the table sampler runs in chunk slices (the JAX package's budget)
TABLE_BYTES_BUDGET = 2 * 1024 ** 3

BANDS = collections.Counter()  # passes per branch of the table sampler
# The JAX package's default map chunk (tiles), the ``chunk`` parameter the
# entry points accept and ignore
DEFAULT_CHUNK = 1024


def cfl_clamped_count(topo, vel: torch.Tensor, dt: float, inv_dx: float) -> torch.Tensor:
    """Active voxels where a trace clamp can engage, diverging from the
    reference's unbounded trace, as a 0-d int32 tensor on vel's device (the
    caller's ``int()`` is one host sync). The back trace clamps at
    |u|*dt/dx > DISP_LIMIT and the re-trace d2 = d + u(back)*sdt at most at
    twice that, so the count is of active voxels with 2*|u|*dt/dx >
    DISP_LIMIT in any component: an upper bound, zero below |u|*dt/dx = 3.5."""
    d = vel.abs() * (dt * inv_dx)
    hit = (2.0 * d > DISP_LIMIT).any(dim=0) & (active_mask(topo) > 0)[:, None]
    return hit.sum().to(torch.int32)


def _clamp(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(d, -DISP_LIMIT, DISP_LIMIT)


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


def _dual_table(topo, tab: torch.Tensor, comb: bool) -> torch.Tensor:
    """The chunk dual table of ``tab [nf,T,512]``: B11 from the 27-table
    when ``comb``, else the direct gather."""
    if comb:
        return cuda_tables.build_table_dual_combine(
            tables.build_table(topo, tab), topo.chunk_dloc, tab.shape[0])
    return tables.build_table_dual(topo, tab)


def _slices(topo, U: int, nf: int) -> int:
    return tables.pick_slices(topo.chunk_dsrc.shape[0], U, nf, TABLE_BYTES_BUDGET)


def _sample_dual(topo, tab: torch.Tensor, vd: torch.Tensor, sdt: float, nb: int, f_lo: int,
                 mode: str, comb: bool):
    """B1d in ``mode`` on the dual table of ``tab [nf,T,512]`` (the nb base
    fields, then the SDF if nf > nb): one launch on the whole table, or
    where it slices one launch a slice of chunks on that slice's table and
    rows, the outputs concatenated along the rows."""
    nc, Ud = topo.chunk_dsrc.shape[:2]
    has_sdf = tab.shape[0] > nb
    k = _slices(topo, Ud, tab.shape[0])
    if k <= 1:
        return cuda_bfecc.bfecc_sample_dual(_dual_table(topo, tab, comb), topo.chunk_ldual, vd,
                                            sdt, nb, f_lo, mode, has_sdf)
    ncs = -(-nc // k)  # chunks a slice, the last one short: JAX's split
    C = topo.capacity // nc
    outs = []
    for c0 in range(0, nc, ncs):
        rows = slice(c0 * C, min(c0 + ncs, nc) * C)
        tbl = tables.build_table_dual(topo, tab, topo.chunk_dsrc[c0:c0 + ncs])
        outs.append(cuda_bfecc.bfecc_sample_dual(tbl, topo.chunk_ldual[rows],
                                                 vd[:, rows].contiguous(), sdt, nb, f_lo, mode,
                                                 has_sdf))
    if mode == "both":
        return tuple(torch.cat([o[i] for o in outs], dim=1) for i in range(2))
    return torch.cat(outs, dim=1)


def _table_samples(topo, fields: torch.Tensor, sdt: float, f_lo: int,
                   sdf: Optional[torch.Tensor]):
    """(phiF, phiB) by the table sampler (see the module doc)."""
    nb = fields.shape[0]
    vel = fields[:3]
    comb = bool(cuda_tables.COMBINE_TBL)
    d = _clamp(-vel * sdt)
    cfl = _amax(d)
    if cfl < cuda_bfecc.CFL_LIMIT:
        BANDS["narrow"] += 1
        tab = fields if sdf is None else torch.cat([fields, sdf[None]])
        return _sample_dual(topo, tab, vel, sdt, nb, f_lo, "both", comb)
    if sdf is not None or cfl >= cuda_bfecc.CFL_MID:
        BANDS["wide"] += 1
        return cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, f_lo, sdf)
    BANDS["mixed"] += 1
    Ud, U27 = topo.chunk_dsrc.shape[1], topo.chunk_uniq.shape[1]
    nf_wide = nb if f_lo == 0 else nb - 3  # the fields of JAX's wide forward pass
    if _slices(topo, Ud, nb) > 1 or _slices(topo, U27, max(nf_wide, 1)) > 1:
        backs = _sample_dual(topo, fields, vel, sdt, nb, 0, "back", comb)
        BANDS["mixed fwd wide"] += 1
        d2 = _clamp(d + backs[:3] * sdt)
        return backs[f_lo:], cuda_sample.sample_at(topo.nbr, fields[f_lo:].contiguous(), d2)
    tdual = _dual_table(topo, fields, comb)
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
    if INTERP not in INTERP_NAMES:
        raise ValueError(f"INTERP must be one of {INTERP_NAMES}, got {INTERP!r}")
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
    chunk: int = DEFAULT_CHUNK,
    trace_order: int = 1,
    fast="strict",
) -> Dict[str, torch.Tensor]:
    """BFECC-advect every scalar field by ``vel [3,T,512]``, sharing trace
    corners across fields (fields taken in sorted-name order). The scalars
    go in batches of at most ``cuda_bfecc.MAX_SCALARS`` (B1's limit); each
    batch samples the velocity again, which gives the same samples.
    ``chunk`` and ``fast`` are the JAX package's TPU knobs (its map chunk
    and its dot-precision tier), accepted and ignored: the port samples in
    f32 over every row at once."""
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
                  sdf: Optional[torch.Tensor] = None, chunk: int = DEFAULT_CHUNK,
                  trace_order: int = 1) -> torch.Tensor:
    """Single-field BFECC advection (the standalone HNanoAdvect node path);
    ``chunk`` is ignored, as in :func:`advect_scalars_fused`."""
    return advect_scalars_fused(topo, vel, {"f": field}, dt, inv_dx, sdf,
                                trace_order=trace_order)["f"]


def advect_velocity(
    topo,
    vel: torch.Tensor,
    dt: float,
    inv_dx: float,
    sdf: Optional[torch.Tensor] = None,
    chunk: int = DEFAULT_CHUNK,
    trace_order: int = 1,
    fast="strict",
) -> torch.Tensor:
    """BFECC self-advection of velocity with per-component clamping and,
    with an SDF, the near-boundary no-slip tail (gated at 0.1, blended with
    1 - sdf/1.5: a reference quirk kept). ``chunk`` and ``fast`` are
    ignored, as in :func:`advect_scalars_fused`."""
    vel = vel.contiguous()
    pf, pb = _bfecc_samples(topo, vel, dt * inv_dx, 0, sdf, trace_order)
    out = _bfecc_limit(topo, vel, pf, pb)
    if sdf is not None:
        out = collision.enforce_collision(topo, out, sdf, inv_dx, margin=0.1, blend_denom=1.5)
    return out
