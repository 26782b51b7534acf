"""Box (2-D/3-D) domain decomposition, the JAX package's
``parallel/boxes.py``: the generalisation of the x-slab partition
(``parallel/slab.py``) to a ``(Dx, Dy, Dz)`` device grid.

Tiles are partitioned by GLOBAL layer cuts per axis (tensor-product boxes):
the cuts along each partitioned axis are shared by every device row and
column, so each device has exactly one exchange partner per face direction.

Corner and edge ghosts (the 27-point stencils read diagonal tiles) arrive
by the staged exchange: phases run x, then y, then z, and each later phase
sends rows that INCLUDE the ghost rows received by the earlier ones, so
corner values propagate in at most 3 exchanges per refresh:

- phase x sends its boundary x-layer restricted to its own y/z box,
- phase y sends its boundary y-layer over the x-EXTENDED range,
- phase z sends its boundary z-layer over the x- and y-extended range.

Each device's local table is the key-sorted set of active tiles inside its
box extended by one ghost layer along every partitioned axis (corners
included), so the one-device step runs unchanged on it. ``sharded_step``
(``parallel/slab.py``) takes a BoxTopology wherever it takes a
SlabTopology; scatter/gather and the replicated-coarse multigrid hierarchy
are shared unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.topology import Topology
from hnanosolver_tpu_torch.parallel.mesh import AxisComm
from hnanosolver_tpu_torch.parallel.slab import _local_tables, _tiles
# re-exported: everything downstream of the decomposition is shared with the
# slab path (the same leaf contract: keys, ..., local_mask, exchange maps)
from hnanosolver_tpu_torch.parallel.slab import (  # noqa: F401
    build_slab_hierarchy,
    gather_state,
    scatter_state,
    sharded_step,
)


@dataclasses.dataclass(frozen=True)
class BoxTopology:
    """Stacked per-device local tables plus per-phase exchange maps (host
    tensors).

    Leaf order matches SlabTopology's contract with ``sharded_step``: the
    first five leaves are (keys, origins, nbr, n_rows, local_mask); the rest
    are the exchange maps, read by ``make_refresh_local``. ``perms`` holds
    per phase the forward/backward (source, target) pairs over the
    FLATTENED device grid (d = ix*Dy*Dz + iy*Dz + iz)."""

    keys: torch.Tensor  # [D, Tl]
    origins: torch.Tensor  # [D, Tl, 3]
    nbr: torch.Tensor  # [D, Tl, 27]
    n_rows: torch.Tensor  # [D]
    local_mask: torch.Tensor  # [D, Tl] 1.0 on OWNED rows
    exchange: Tuple[torch.Tensor, ...]  # per phase: send_lo, send_hi, recv_lo,
    # recv_hi, each [D, G_phase] (send pads -> row 0; recv pads -> trash row)
    perms: tuple
    grid: Tuple[int, int, int]  # (Dx, Dy, Dz)

    @property
    def n_devices(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def tree_flatten(self):
        return ((self.keys, self.origins, self.nbr, self.n_rows, self.local_mask)
                + tuple(self.exchange)), (self.perms, self.grid)

    def make_refresh_local(self, axis: AxisComm, ex: Sequence[torch.Tensor]):
        """Refresh closure for use inside ``shard_map`` (``ex``: this
        device's exchange maps, 4 per phase, in leaf order). Phases APPLY IN
        ORDER: later sends read rows the earlier phases just refreshed,
        which is what carries edge and corner ghosts. Returns a new
        tensor."""
        phases = [
            (tuple(torch.as_tensor(a, device=axis.device).long() for a in ex[4 * p:4 * p + 4]),
             fwd, bwd)
            for p, (fwd, bwd) in enumerate(self.perms)]

        def refresh(field: torch.Tensor) -> torch.Tensor:
            ax = 1 if field.dim() == 3 else 0  # velocity is channel-major
            for (slo, shi, rlo, rhi), fwd, bwd in phases:
                up, dn = axis.ppermute(
                    (field.index_select(ax, shi), field.index_select(ax, slo)), (fwd, bwd))
                if up is not None:
                    field = field.index_copy(ax, rlo, up)
                if dn is not None:
                    field = field.index_copy(ax, rhi, dn)
            return field

        return refresh


def _axis_cuts(vals: np.ndarray, n: int) -> List[Tuple[int, int]]:
    """Global balanced layer cuts along one axis: [(lo, hi_inclusive)] layer
    values per grid index, from the marginal tile counts (the rule of
    slab._snap_partition)."""
    layers, counts = np.unique(vals, return_counts=True)
    if len(layers) < n:
        raise ValueError(
            f"need >= {n} tile-layers along a partitioned axis, have {len(layers)}")
    total = counts.sum()
    cum = np.cumsum(counts)
    cuts = [0]
    for d in range(1, n):
        ideal = d * total / n
        lo = cuts[-1] + 1
        hi = len(layers) - (n - d)
        cand = np.arange(lo, hi + 1)
        best = cand[np.argmin(np.abs(cum[cand - 1] - ideal))]
        cuts.append(int(best))
    cuts.append(len(layers))
    return [(int(layers[cuts[d]]), int(layers[cuts[d + 1] - 1])) for d in range(n)]


def build_boxes(
    topo: Topology,
    grid: Tuple[int, int, int],
    capacity: Optional[int] = None,
) -> BoxTopology:
    """Partition an existing Topology over a ``(Dx, Dy, Dz)`` device grid.

    ``build_boxes(topo, (D, 1, 1))`` is the x-slab special case. Tensor cuts
    trade some balance for single-partner exchanges; ``local_mask`` row
    sums report the realised balance."""
    Dx, Dy, Dz = grid
    D = Dx * Dy * Dz
    tiles = _tiles(topo)

    bounds = [
        _axis_cuts(tiles[:, a], da) if da > 1 else
        [(int(tiles[:, a].min()), int(tiles[:, a].max()))]
        for a, da in enumerate(grid)
    ]

    def ext_sel(a: int, i: int) -> np.ndarray:
        """Mask over ``tiles`` for grid index i's EXTENDED range on axis a:
        its own layer interval plus the adjacent boxes' boundary layer
        values (occupied layers, so gapped domains stay consistent on both
        sides of every exchange)."""
        lo, hi = bounds[a][i]
        v = tiles[:, a]
        sel = (v >= lo) & (v <= hi)
        if i > 0:
            sel |= v == bounds[a][i - 1][1]
        if i < len(bounds[a]) - 1:
            sel |= v == bounds[a][i + 1][0]
        return sel

    def own_sel(a: int, i: int) -> np.ndarray:
        lo, hi = bounds[a][i]
        return (tiles[:, a] >= lo) & (tiles[:, a] <= hi)

    def dev(ix: int, iy: int, iz: int) -> int:
        return (ix * Dy + iy) * Dz + iz

    # per-device local tile tables: the extended box (corners included)
    tables: List[np.ndarray] = [None] * D
    owned: List[np.ndarray] = [None] * D
    for ix in range(Dx):
        sx, ox = ext_sel(0, ix), own_sel(0, ix)
        for iy in range(Dy):
            sy, oy = ext_sel(1, iy), own_sel(1, iy)
            for iz in range(Dz):
                sz, oz = ext_sel(2, iz), own_sel(2, iz)
                t = tiles[sx & sy & sz]
                order = np.argsort(C.pack_keys_np(t))
                tables[dev(ix, iy, iz)] = t[order]
                owned[dev(ix, iy, iz)] = (ox & oy & oz)[sx & sy & sz][order]

    n_rows_needed = max(len(t) for t in tables) + 1
    cap = capacity or 16
    while cap < n_rows_needed + 1:  # +1 trash row
        cap *= 2
    trash = cap - 1

    keys, origins, nbr, n_rows, row_of = _local_tables(tables, cap)
    local_mask = np.zeros((D, cap), np.float32)
    for d in range(D):
        local_mask[d, 1:len(tables[d]) + 1] = owned[d].astype(np.float32)

    # staged exchange maps: a phase per partitioned axis, in x, y, z order.
    # The send SET for device i -> i+1 on axis a is its boundary layer
    # (bounds[a][i][1]) over the earlier axes' EXTENDED ranges and the later
    # axes' OWN ranges; the receiver's ghost rows are the identical tile set
    # (the same global cut), so pairing by sorted key is consistent.
    def phase_tiles(a: int, gi: Tuple[int, int, int], layer: int) -> np.ndarray:
        sel = tiles[:, a] == layer
        for b in range(3):
            if b == a or grid[b] == 1:
                continue
            sel &= ext_sel(b, gi[b]) if b < a else own_sel(b, gi[b])
        t = tiles[sel]
        return t[np.argsort(C.pack_keys_np(t))]

    exchange: List[torch.Tensor] = []
    perms: List[Tuple[tuple, tuple]] = []
    stride = {0: Dy * Dz, 1: Dz, 2: 1}
    for a in range(3):
        if grid[a] == 1:
            continue
        fwd, bwd = [], []
        sends_hi, sends_lo, recvs_lo, recvs_hi = [], [], [], []
        for ix in range(Dx):
            for iy in range(Dy):
                for iz in range(Dz):
                    gi = (ix, iy, iz)
                    d = dev(*gi)
                    i = gi[a]
                    if i < grid[a] - 1:
                        fwd.append((d, d + stride[a]))
                        sends_hi.append((d, phase_tiles(a, gi, bounds[a][i][1])))
                    if i > 0:
                        bwd.append((d, d - stride[a]))
                        sends_lo.append((d, phase_tiles(a, gi, bounds[a][i][0])))
                        recvs_lo.append((d, phase_tiles(a, gi, bounds[a][i - 1][1])))
                    if i < grid[a] - 1:
                        recvs_hi.append((d, phase_tiles(a, gi, bounds[a][i + 1][0])))
        G = max([len(t) for _, t in sends_hi + sends_lo] + [1])
        send_lo = np.zeros((D, G), np.int32)
        send_hi = np.zeros((D, G), np.int32)
        recv_lo = np.full((D, G), trash, np.int32)
        recv_hi = np.full((D, G), trash, np.int32)
        for arr, entries in ((send_hi, sends_hi), (send_lo, sends_lo),
                             (recv_lo, recvs_lo), (recv_hi, recvs_hi)):
            for d, t in entries:
                for j, kk in enumerate(C.pack_keys_np(t)):
                    arr[d, j] = row_of[d][int(kk)]
        exchange += [torch.from_numpy(x) for x in (send_lo, send_hi, recv_lo, recv_hi)]
        perms.append((tuple(fwd), tuple(bwd)))

    return BoxTopology(
        keys=torch.from_numpy(keys),
        origins=torch.from_numpy(origins),
        nbr=torch.from_numpy(nbr),
        n_rows=torch.from_numpy(n_rows),
        local_mask=torch.from_numpy(local_mask),
        exchange=tuple(exchange),
        perms=tuple(perms),
        grid=tuple(grid),
    )
