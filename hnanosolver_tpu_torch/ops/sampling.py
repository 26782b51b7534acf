"""Sparse field samplers, the JAX package's ``ops/sampling.py``: nearest
and trilinear reads at arbitrary positions, and the halo-block samplers.

The reference's device samplers (``reference/src/Utils/Stencils.hpp:20-173``):

- ``IndexSampler<T,0>`` (nearest)           -> :func:`sample_nearest`
- ``IndexSampler<T,1>``/``TrilinearSampler`` -> :func:`sample_trilinear`

Inactive voxels read as exact background 0 through the null tile (the
reference's manual paths read voxel 0 there instead; the JAX package and
this port keep the background everywhere). Positions are in index space,
voxel centres at integer positions. Fields use the JAX package's block
layout ``[T, 8, 8, 8, *ch]``; the global samplers find their corners with
``core/topology.lookup_voxels``, the local ones in an r-voxel halo block
(``ops/halo.py``), with the displacement clamped to the halo (the JAX
package's deviation from the reference, kept).
"""

from __future__ import annotations

from typing import Optional

import torch

from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.topology import lookup_voxels
from hnanosolver_tpu_torch.ops.halo import gather_halo, shift

# the trilinear corners in the JAX package's order
_CORNERS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def _flat(field: torch.Tensor) -> torch.Tensor:
    """[T,8,8,8,*ch] -> [T*512, *ch]."""
    return field.reshape((field.shape[0] * C.TILE_VOXELS,) + tuple(field.shape[4:]))


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + flat.shape[1:])


def sample_nearest(topo, field: torch.Tensor, voxel_coords) -> torch.Tensor:
    """Integer-coordinate read ``[..., 3]``; background 0 outside the active
    set."""
    return _take(_flat(field), lookup_voxels(topo, voxel_coords))


def sample_trilinear(topo, field: torch.Tensor, pos) -> torch.Tensor:
    """Trilinear interpolation at float positions ``[..., 3]``: 8 corner
    reads with the JAX package's weight products and summation order, zero
    background at inactive corners."""
    pos = torch.as_tensor(pos, dtype=torch.float32, device=field.device)
    base = torch.floor(pos)
    frac = pos - base
    base = base.to(torch.int32)
    tx, ty, tz = frac[..., 0], frac[..., 1], frac[..., 2]
    itx, ity, itz = 1.0 - tx, 1.0 - ty, 1.0 - tz
    w00, w10 = itx * ity, tx * ity
    w01, w11 = itx * ty, tx * ty
    weights = (w00 * itz, w10 * itz, w01 * itz, w11 * itz,
               w00 * tz, w10 * tz, w01 * tz, w11 * tz)
    flat = _flat(field)
    vector = field.dim() == 5
    offs = torch.tensor(_CORNERS, dtype=torch.int32, device=field.device)
    acc = None
    for off, w in zip(offs, weights):
        v = _take(flat, lookup_voxels(topo, base + off))
        v = v * (w[..., None] if vector else w)
        acc = v if acc is None else acc + v
    return acc


def displacement_limit(radius: int) -> float:
    """Max displacement magnitude per axis for a halo radius (one voxel is
    reserved for the +1 interpolation corner)."""
    return float(radius) - 1.0 - 1e-3


def _corner_flat_idx(base: torch.Tensor, E: int) -> torch.Tensor:
    """In-block int coords [T,8,8,8,3] -> [T, 512] block indices."""
    idx = (base[..., 0] * E + base[..., 1]) * E + base[..., 2]
    return idx.reshape(base.shape[0], 512).long()


def _block_gather(block_flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """block_flat [T, E^3(,ch)], idx [T,512] -> [T,8,8,8(,ch)]."""
    T = block_flat.shape[0]
    if block_flat.dim() == 2:
        return torch.gather(block_flat, 1, idx).reshape(T, 8, 8, 8)
    ch = block_flat.shape[2]
    return torch.gather(block_flat, 1, idx[..., None].expand(T, 512, ch)).reshape(T, 8, 8, 8, ch)


def sample_trilinear_local(topo, field: torch.Tensor, disp: torch.Tensor, radius: int = 4,
                           block: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trilinear sample at (voxel position + disp) for every voxel. ``disp
    [T,8,8,8,3]`` is clamped to ``displacement_limit(radius)``. Pass
    ``block`` (= ``gather_halo(topo, field, radius)``) to share a halo
    across calls."""
    E = 8 + 2 * radius
    if block is None:
        block = gather_halo(topo, field, radius)
    T = field.shape[0]
    vector = field.dim() == 5
    block_flat = block.reshape((T, E * E * E) + ((field.shape[-1],) if vector else ()))

    lim = displacement_limit(radius)
    disp = torch.clamp(torch.as_tensor(disp, dtype=torch.float32, device=field.device),
                       -lim, lim)
    ax = torch.arange(8, dtype=torch.float32, device=field.device)
    local = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)[None]
    local = local + float(radius) + disp
    base = torch.floor(local)
    frac = local - base
    base = torch.clamp(base.to(torch.int32), 0, E - 2)

    tx, ty, tz = frac[..., 0], frac[..., 1], frac[..., 2]
    itx, ity, itz = 1.0 - tx, 1.0 - ty, 1.0 - tz
    weights = (itx * ity * itz, tx * ity * itz, itx * ty * itz, tx * ty * itz,
               itx * ity * tz, tx * ity * tz, itx * ty * tz, tx * ty * tz)
    offs = torch.tensor(_CORNERS, dtype=torch.int32, device=field.device)
    acc = None
    for off, wt in zip(offs, weights):
        idx = _corner_flat_idx(base + off, E)
        v = _block_gather(block_flat, idx)
        v = v * (wt[..., None] if vector else wt)
        acc = v if acc is None else acc + v
    return acc


def sample_offset_local(topo, field: torch.Tensor, offset, radius: Optional[int] = None,
                        block: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer-offset neighbour read for every voxel (nearest semantics):
    ``out[t,i,j,k] = field[(t,i,j,k) + offset]``, background 0; a view of a
    radius-|offset| halo block."""
    off = tuple(int(o) for o in offset)
    r = radius if radius is not None else max(1, max(abs(o) for o in off))
    if block is None:
        block = gather_halo(topo, field, r)
    return shift(block, *off)
