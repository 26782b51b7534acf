"""Per-frame topology activation: grow or shrink the active tile set as the
simulation evolves, remapping the field state between topologies by key.

Counterpart of ``hnanosolver_tpu/core/activation.py``:
- ``occupied_tile_mask`` / ``occupied_voxel_bboxes`` (device): which active
  tiles (voxels) still hold matter;
- ``topology_from_mask`` / ``topology_from_bboxes`` (host numpy): the new
  tile set, occupied tiles dilated by a tile radius or occupied voxels by a
  voxel padding, plus always-kept tiles (emitters, collider shells);
- ``remap_rows`` / ``remap_state`` (device): every field gathered from the
  old rows to the new ones by key.

Capacity never shrinks and grows by ``topology._round_capacity``. A
topology grown from one that carries chunk plans carries them too, so the
table sampler finds its plans on every new topology. ``n_active`` stays a host int: one
activation pass waits for the device once, on the occupancy mask.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.topology import (
    Topology, _round_capacity, active_mask, build_topology)
from hnanosolver_tpu_torch.fields import COLLISION_FIELD, FieldState
from hnanosolver_tpu_torch.utils.profiling import Count, span

passes = Count("grow.passes")  # activation passes (expand_for_state calls)
discarded = Count("grow.discarded")  # passes whose rebuilt topology equalled the old one


def _matter(state: FieldState) -> list:
    """The fields whose values drive activation (collision_sdf does not)."""
    return [f for name, f in state.scalars.items() if name != COLLISION_FIELD]


def occupied_tile_mask(topo: Topology, state: FieldState,
                       threshold: float = 1e-4) -> torch.Tensor:
    """[T] bool on the topology's device: an active tile holding any value
    above ``threshold`` (velocity by its max |component|)."""
    occ = state.velocity.abs().amax(dim=(0, 2))
    for f in _matter(state):
        occ = torch.maximum(occ, f.abs().amax(dim=1))
    return (active_mask(topo) > 0) & (occ > threshold)


def occupied_voxel_bboxes(topo: Topology, state: FieldState, threshold: float = 1e-4):
    """(occ [T] bool, lo [T,3] int32, hi [T,3] int32): per active tile, the
    local bounding box (voxel coords in [0, 8)) of its voxels above
    ``threshold``; occ is False where there are none."""
    v = state.velocity.abs().amax(dim=0)
    for f in _matter(state):
        v = torch.maximum(v, f.abs())
    hot = (v > threshold) & (active_mask(topo) > 0)[:, None]
    hot = hot.reshape(topo.capacity, 8, 8, 8)
    occ = hot.any(dim=3).any(dim=2).any(dim=1)
    lo, hi = [], []
    for other in ((2, 3), (1, 3), (1, 2)):
        proj = hot.any(dim=other[1]).any(dim=other[0]).to(torch.uint8)  # [T, 8]
        lo.append(torch.argmax(proj, dim=1))
        hi.append(7 - torch.argmax(proj.flip(1), dim=1))
    return occ, torch.stack(lo, -1).to(torch.int32), torch.stack(hi, -1).to(torch.int32)


def tiles_covering_boxes(wmin: np.ndarray, wmax: np.ndarray, padding: int) -> np.ndarray:
    """Tile coords covering every world-voxel box [wmin, wmax] dilated by
    Chebyshev-``padding`` voxels ([B,3] in, [*,3] int32 out, duplicates
    allowed)."""
    if not len(wmin):
        return np.zeros((0, 3), np.int32)
    lo_t = np.floor_divide(np.asarray(wmin) - padding, 8)
    hi_t = np.floor_divide(np.asarray(wmax) + padding, 8)
    R = int((hi_t - lo_t).max()) + 1
    offs = np.stack(np.meshgrid(*([np.arange(R)] * 3), indexing="ij"), -1).reshape(-1, 3)
    cand = np.minimum(lo_t[:, None, :] + offs[None], hi_t[:, None, :])
    return cand.reshape(-1, 3).astype(np.int32)


def _rebuild(topo: Topology, parts: list, min_capacity: Optional[int]) -> Topology:
    """build_topology over the union of ``parts`` on topo's device, at a
    capacity that never shrinks, with topo's plans."""
    parts = [np.asarray(p, np.int32).reshape(-1, 3) for p in parts if p is not None and len(p)]
    tiles = np.concatenate(parts, axis=0) if parts else np.zeros((0, 3), np.int32)
    cap = max(topo.capacity, min_capacity or 0)
    n_unique = len(np.unique(C.pack_keys_np(tiles))) if len(tiles) else 0
    if cap < n_unique + 1:
        cap = max(cap, _round_capacity(n_unique))
    return build_topology(tiles, capacity=cap, device=topo.device,
                          plans=topo.chunk_dsrc is not None)


def topology_from_bboxes(topo: Topology, occ: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                         padding: int, keep_tiles: Optional[np.ndarray] = None,
                         min_capacity: Optional[int] = None) -> Topology:
    """Voxel-granularity activation (host): the new tile set covers every
    occupied voxel's Chebyshev-``padding`` neighbourhood, plus
    ``keep_tiles``."""
    origins = topo.origins.cpu().numpy()
    occ = np.asarray(occ)
    wmin = origins[occ] * 8 + np.asarray(lo)[occ]
    wmax = origins[occ] * 8 + np.asarray(hi)[occ]
    return _rebuild(topo, [tiles_covering_boxes(wmin, wmax, padding), keep_tiles],
                    min_capacity)


def topology_from_mask(topo: Topology, occ_mask: np.ndarray, radius: int = 1,
                       keep_tiles: Optional[np.ndarray] = None,
                       min_capacity: Optional[int] = None) -> Topology:
    """Tile-granularity activation (host): occupied tiles and ``keep_tiles``,
    dilated by Chebyshev ``radius`` tiles."""
    hot = topo.origins.cpu().numpy()[np.asarray(occ_mask)]
    parts = [p for p in (hot, keep_tiles) if p is not None and len(p)]
    tiles = (np.concatenate([np.asarray(p, np.int32) for p in parts], axis=0) if parts
             else np.zeros((0, 3), np.int32))
    if radius > 0 and len(tiles):
        r = np.arange(-radius, radius + 1)
        offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
        tiles = (tiles[:, None, :] + offs[None].astype(np.int32)).reshape(-1, 3)
    return _rebuild(topo, [tiles], min_capacity)


def remap_rows(old: Topology, new: Topology) -> torch.Tensor:
    """[T_new] int64: for each new row, the old row holding the same key (0,
    the null row, for a newly activated tile and for every padding row)."""
    pos = torch.searchsorted(old.keys, new.keys)
    pos = torch.clamp(pos, max=old.capacity - 1)
    rows = torch.where(old.keys[pos] == new.keys, pos, 0)
    return torch.where(active_mask(new) > 0, rows, 0)


def remap_state(old: Topology, new: Topology, state: FieldState) -> FieldState:
    """Every field gathered from the old layout into the new one."""
    rows = remap_rows(old, new)
    return FieldState(
        velocity=state.velocity.index_select(1, rows),
        scalars={k: v.index_select(0, rows) for k, v in state.scalars.items()})


def expand_for_state(topo: Topology, state: FieldState, threshold: float = 1e-4,
                     radius: int = 1, keep_tiles: Optional[np.ndarray] = None,
                     padding: Optional[int] = None):
    """One activation pass: (topo, state), the same objects when the tile
    set and the capacity are unchanged. ``padding``: dilation in voxels (the
    reference SOP's parameter); when set it replaces the tile ``radius``.
    Counted in :data:`passes`, and in :data:`discarded` when the rebuilt
    topology equals the old one; traced (``utils/profiling``), its parts are
    the spans ``grow.occupancy`` (device reduction and host read-back),
    ``grow.rebuild`` (host tile set, tables and upload) and ``grow.remap``
    (device)."""
    passes.add()
    with span("grow.occupancy", device=True):
        if padding is not None:
            occ, lo, hi = occupied_voxel_bboxes(topo, state, threshold)
            packed = torch.cat([occ[:, None].to(torch.int32), lo, hi], dim=1).cpu().numpy()
        else:
            occ = occupied_tile_mask(topo, state, threshold).cpu().numpy()
    with span("grow.rebuild"):
        if padding is not None:
            new = topology_from_bboxes(topo, packed[:, 0].astype(bool), packed[:, 1:4],
                                       packed[:, 4:7], padding, keep_tiles=keep_tiles)
        else:
            new = topology_from_mask(topo, occ, radius=radius, keep_tiles=keep_tiles)
        same = new.capacity == topo.capacity and torch.equal(new.keys, topo.keys)
    if same:
        discarded.add()
        return topo, state
    with span("grow.remap", device=True):
        return new, remap_state(topo, new, state)
