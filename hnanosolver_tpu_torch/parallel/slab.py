"""Explicit slab decomposition, the JAX package's ``parallel/slab.py``:
``shard_map`` over a device mesh with a ghost-tile exchange.

- Active tiles are partitioned into D contiguous **x-slabs** (packed keys
  sort x-major, so a slab is a contiguous key range) balanced by tile
  count, with slab boundaries snapped to x-layers so that every cross-slab
  neighbour lives on an adjacent device.
- Each device's local tile table is ``[null, ghosts_lo, local, ghosts_hi,
  pad..., trash]``, still key-sorted, so the one-device step runs
  unchanged on it.
- **Ghost refresh**: one exchange per refresh (``AxisComm.ppermute`` of
  ``parallel/mesh.py``) in which owners push their boundary-layer tiles
  into the neighbours' ghost rows, before every op that reads cross-tile
  neighbours and every pressure colour sweep.
- Compute runs redundantly on ghost rows and is masked out of the outputs.
- Multigrid shards the fine level only: each device restricts its owned
  fine tiles into the global level-1 table, one ``psum`` combines them, and
  the coarse levels run replicated on every device.

The tables are built in host numpy, bitwise the JAX package's, and kept as
stacked ``[D, Tl, ...]`` CPU tensors (capacities padded to a common power
of two); :func:`sharded_step` puts block d on ``mesh.devices[d]``. A sharded
state is a list of D per-device :class:`FieldState` blocks
(:func:`scatter_state`, :func:`gather_state`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.topology import Topology
from hnanosolver_tpu_torch.fields import FieldState
from hnanosolver_tpu_torch.parallel.mesh import AxisComm, Mesh, shard_map

_OFFS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    np.int32,
)


@dataclasses.dataclass(frozen=True)
class SlabTopology:
    """Stacked per-device local tables (host tensors, block d for device d)."""

    keys: torch.Tensor  # [D, Tl] int32
    origins: torch.Tensor  # [D, Tl, 3] int32
    nbr: torch.Tensor  # [D, Tl, 27] int32
    n_rows: torch.Tensor  # [D] rows in use (null + ghosts + local)
    local_mask: torch.Tensor  # [D, Tl] 1.0 on OWNED rows only
    send_lo: torch.Tensor  # [D, G] local rows whose values go to device d-1
    send_hi: torch.Tensor  # [D, G] local rows whose values go to device d+1
    recv_lo: torch.Tensor  # [D, G] ghost rows receiving from d-1 (trash-padded)
    recv_hi: torch.Tensor  # [D, G] ghost rows receiving from d+1

    @property
    def n_devices(self) -> int:
        return self.keys.shape[0]

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    def tree_flatten(self):
        """(leaves, aux): the 5 core arrays, then the exchange maps, the
        contract ``sharded_step`` reads (``BoxTopology`` keeps it too)."""
        return (self.keys, self.origins, self.nbr, self.n_rows, self.local_mask,
                self.send_lo, self.send_hi, self.recv_lo, self.recv_hi), ()

    def make_refresh_local(self, axis: AxisComm, ex):
        """Refresh closure from this device's exchange leaves (the leaves
        after the 5 core arrays); ``axis`` is the device's end of the mesh
        axis."""
        send_lo, send_hi, recv_lo, recv_hi = ex
        return make_refresh(axis, send_lo, send_hi, recv_lo, recv_hi, self.n_devices)


def _snap_partition(xs: np.ndarray, n_dev: int) -> List[Tuple[int, int]]:
    """Split sorted x-layer values into n_dev contiguous layer ranges with
    balanced tile counts. Returns [(x_min, x_max_inclusive)] per device."""
    layers, counts = np.unique(xs, return_counts=True)
    if len(layers) < n_dev:
        raise ValueError(
            f"need >= {n_dev} x tile-layers to shard over {n_dev} devices, "
            f"have {len(layers)}"
        )
    total = counts.sum()
    cum = np.cumsum(counts)
    # cut after the layer whose cumulative count is closest to d*total/D,
    # keeping at least one layer per device on both sides of every cut
    cuts = [0]
    for d in range(1, n_dev):
        ideal = d * total / n_dev
        lo = cuts[-1] + 1
        hi = len(layers) - (n_dev - d)
        cand = np.arange(lo, hi + 1)
        best = cand[np.argmin(np.abs(cum[cand - 1] - ideal))]
        cuts.append(int(best))
    cuts.append(len(layers))
    return [(int(layers[cuts[d]]), int(layers[cuts[d + 1] - 1])) for d in range(n_dev)]


def _tiles(topo: Topology) -> np.ndarray:
    """The active tile coords of ``topo`` in key order, on the host."""
    return topo.origins[1:topo.n_active + 1].cpu().numpy()


def _local_tables(tables: List[np.ndarray], cap: int):
    """keys, origins, nbr, n_rows and each table's row of a key, for the
    key-sorted tile tables of D devices at capacity ``cap``."""
    D = len(tables)
    keys = np.full((D, cap), C.PAD_KEY, np.int32)
    origins = np.full((D, cap, 3), 1 << 20, np.int32)
    nbr = np.zeros((D, cap, 27), np.int32)
    n_rows = np.zeros((D,), np.int32)
    row_of: List[dict] = []
    for d, table in enumerate(tables):
        k = C.pack_keys_np(table)
        m = len(table)
        keys[d, 0] = C.NULL_KEY
        keys[d, 1:m + 1] = k
        origins[d, 1:m + 1] = table
        n_rows[d] = m + 1
        nk = C.pack_keys_np(table[:, None, :] + _OFFS[None, :, :])
        pos = np.searchsorted(k, nk)
        posc = np.minimum(pos, m - 1)
        nbr[d, 1:m + 1] = np.where(k[posc] == nk, posc + 1, 0)
        row_of.append({int(kk): i + 1 for i, kk in enumerate(k)})
    return keys, origins, nbr, n_rows, row_of


def build_slabs(topo: Topology, n_devices: int, capacity: Optional[int] = None) -> SlabTopology:
    """Host side: partition an existing Topology into per-device local
    tables with ghost layers and exchange index maps."""
    tiles = _tiles(topo)  # sorted by key (x-major)
    bounds = _snap_partition(tiles[:, 0], n_devices)

    locals_: List[np.ndarray] = []
    ghosts_lo: List[np.ndarray] = []
    ghosts_hi: List[np.ndarray] = []
    for d, (x0, x1) in enumerate(bounds):
        locals_.append(tiles[(tiles[:, 0] >= x0) & (tiles[:, 0] <= x1)])
        if d > 0:
            ghosts_lo.append(tiles[tiles[:, 0] == bounds[d - 1][1]])  # prev top layer
        else:
            ghosts_lo.append(np.zeros((0, 3), np.int32))
        if d < n_devices - 1:
            ghosts_hi.append(tiles[tiles[:, 0] == bounds[d + 1][0]])
        else:
            ghosts_hi.append(np.zeros((0, 3), np.int32))

    n_rows_needed = max(1 + len(g0) + len(lc) + len(g1)
                        for g0, lc, g1 in zip(ghosts_lo, locals_, ghosts_hi))
    cap = capacity or 16
    while cap < n_rows_needed + 1:  # +1 for the trash row at the end
        cap *= 2
    G = max(max(len(g) for g in ghosts_lo), max(len(g) for g in ghosts_hi), 1)
    trash = cap - 1

    D = n_devices
    tables = []
    for d in range(D):
        table = np.concatenate([ghosts_lo[d], locals_[d], ghosts_hi[d]], axis=0)
        tables.append(table[np.argsort(C.pack_keys_np(table))])
    keys, origins, nbr, n_rows, row_of = _local_tables(tables, cap)
    local_mask = np.zeros((D, cap), np.float32)
    for d, (x0, x1) in enumerate(bounds):
        t = tables[d]
        local_mask[d, 1:len(t) + 1] = ((t[:, 0] >= x0) & (t[:, 0] <= x1)).astype(np.float32)

    send_lo = np.zeros((D, G), np.int32)
    send_hi = np.zeros((D, G), np.int32)
    recv_lo = np.full((D, G), trash, np.int32)
    recv_hi = np.full((D, G), trash, np.int32)
    for d in range(D):
        if d > 0:  # ghosts_lo[d] is owned by d-1 (its top layer)
            for i, kk in enumerate(C.pack_keys_np(ghosts_lo[d])):
                recv_lo[d, i] = row_of[d][int(kk)]
                send_hi[d - 1, i] = row_of[d - 1][int(kk)]
        if d < D - 1:
            for i, kk in enumerate(C.pack_keys_np(ghosts_hi[d])):
                recv_hi[d, i] = row_of[d][int(kk)]
                send_lo[d + 1, i] = row_of[d + 1][int(kk)]

    return SlabTopology(*(torch.from_numpy(a) for a in (
        keys, origins, nbr, n_rows, local_mask, send_lo, send_hi, recv_lo, recv_hi)))


def _state_to(state: FieldState, device) -> FieldState:
    return FieldState(velocity=state.velocity.to(device),
                      scalars={k: v.to(device) for k, v in state.scalars.items()})


def scatter_state(topo: Topology, slab: SlabTopology, state: FieldState,
                  mesh: Optional[Mesh] = None) -> List[FieldState]:
    """Re-layout a global FieldState into per-device local tables by key
    match, ghosts filled too: a list of D blocks, block d on
    ``mesh.devices[d]`` (default: the state's device)."""
    D, Tl = slab.keys.shape
    gk = topo.keys.cpu().numpy()
    sk = slab.keys.numpy().reshape(-1)
    pos = np.minimum(np.searchsorted(gk, sk), topo.capacity - 1)
    rows = torch.from_numpy(np.where(gk[pos] == sk, pos, 0).astype(np.int64))
    rows = rows.to(state.velocity.device)
    out = []
    for d in range(D):
        r = rows[d * Tl:(d + 1) * Tl]
        block = FieldState(velocity=state.velocity.index_select(1, r),
                           scalars={k: v.index_select(0, r) for k, v in state.scalars.items()})
        out.append(block if mesh is None else _state_to(block, mesh.devices[d]))
    return out


def gather_state(topo: Topology, slab: SlabTopology, state) -> FieldState:
    """Inverse of :func:`scatter_state`: merge each block's owned rows back
    into the global table on ``topo``'s device (other rows 0)."""
    dev = topo.device
    gk = topo.keys.cpu().numpy()
    owned = slab.local_mask.numpy() > 0
    sk = slab.keys.numpy()
    first = state[0]
    vel = torch.zeros((3, topo.capacity) + first.velocity.shape[2:],
                      dtype=first.velocity.dtype, device=dev)
    scalars = {k: torch.zeros((topo.capacity,) + v.shape[1:], dtype=v.dtype, device=dev)
               for k, v in first.scalars.items()}
    for d, block in enumerate(state):
        own = np.flatnonzero(owned[d])
        src = torch.from_numpy(own.astype(np.int64))
        dst = torch.from_numpy(np.searchsorted(gk, sk[d][own]).astype(np.int64)).to(dev)
        vel[:, dst] = block.velocity.index_select(1, src.to(block.velocity.device)).to(dev)
        for k, v in block.scalars.items():
            scalars[k][dst] = v.index_select(0, src.to(v.device)).to(dev)
    return FieldState(velocity=vel, scalars=scalars)


# ---------------------------------------------------------------------------
# Sharded multigrid: fine level sharded, coarse levels replicated
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SlabHierarchy:
    """Multigrid hierarchy for a slab decomposition.

    The fine level stays sharded; every coarse level is REPLICATED on all
    devices: each device restricts only its OWNED fine tiles into the
    global coarse table (children map -> 0 elsewhere), one ``psum``
    combines the partial restrictions, and the coarse V-cycle then runs
    identically everywhere. Prolongation gathers from the replicated
    correction by each local tile's global parent row."""

    children_local: torch.Tensor  # [D, Tc, 8] local fine row per octant (0 = not owned)
    parent_global: torch.Tensor  # [D, Tl] global coarse row of each local tile
    octant_local: torch.Tensor  # [D, Tl]
    coarse_level: object  # MGLevel of the global level 1 (maps unused)
    rest: tuple  # plain MGLevels below level 1


def build_slab_hierarchy(topo: Topology, slab: SlabTopology, levels: int) -> SlabHierarchy:
    """Host side: per-device restriction/prolongation maps into the global
    coarse hierarchy of ``topo`` (built on ``topo``'s device)."""
    from hnanosolver_tpu_torch.ops.multigrid import build_hierarchy

    hier = build_hierarchy(topo, levels)
    lvl1 = hier[0]
    D, Tl = slab.keys.shape
    Tc = lvl1.topo.capacity
    gkeys = topo.keys.cpu().numpy()
    children_g = lvl1.children.cpu().numpy()
    parent_g = lvl1.parent.cpu().numpy()
    octant_g = lvl1.octant.cpu().numpy()
    owned = slab.local_mask.numpy() > 0
    skeys = slab.keys.numpy()

    children_local = np.zeros((D, Tc, 8), np.int32)
    parent_local = np.zeros((D, Tl), np.int32)
    octant_local = np.zeros((D, Tl), np.int32)
    for d in range(D):
        pos = np.minimum(np.searchsorted(gkeys, skeys[d]), len(gkeys) - 1)
        valid = (gkeys[pos] == skeys[d]) & (skeys[d] != C.PAD_KEY) & (skeys[d] != C.NULL_KEY)
        g = np.where(valid, pos, 0)
        parent_local[d] = np.where(valid, parent_g[g], 0)
        octant_local[d] = np.where(valid, octant_g[g], 0)
        g2l = np.zeros(topo.capacity, np.int32)
        own_rows = np.flatnonzero(owned[d])
        g2l[g[own_rows]] = own_rows
        children_local[d] = g2l[children_g]

    return SlabHierarchy(
        children_local=torch.from_numpy(children_local),
        parent_global=torch.from_numpy(parent_local),
        octant_local=torch.from_numpy(octant_local),
        coarse_level=lvl1,
        rest=tuple(hier[1:]),
    )


# ---------------------------------------------------------------------------
# Device-local step under shard_map
# ---------------------------------------------------------------------------


def _local_topo(slab_slice) -> Topology:
    keys, origins, nbr, n_rows = slab_slice
    return Topology(keys=keys, origins=origins, nbr=nbr, n_active=int(n_rows) - 1)


def make_refresh(axis: AxisComm, send_lo, send_hi, recv_lo, recv_hi, n_devices: int):
    """Ghost refresh closure for use inside ``shard_map``: one exchange
    pushes boundary-layer tile values into the neighbours' ghost rows.
    Handles both [T,512] scalars and [3,T,512] velocity (row axis differs).
    Returns a new tensor, as JAX's ``.at[].set`` does."""
    fwd = tuple((i, i + 1) for i in range(n_devices - 1))
    bwd = tuple((i + 1, i) for i in range(n_devices - 1))
    send_lo, send_hi, recv_lo, recv_hi = (
        torch.as_tensor(a, device=axis.device).long() for a in (send_lo, send_hi, recv_lo, recv_hi))

    def refresh(field: torch.Tensor) -> torch.Tensor:
        ax = 1 if field.dim() == 3 else 0  # velocity is channel-major
        up, dn = axis.ppermute(
            (field.index_select(ax, send_hi), field.index_select(ax, send_lo)), (fwd, bwd))
        # trash-row padding absorbs unused slots; row 0 (null) is never a
        # recv target, so the background invariant holds
        if up is not None:
            field = field.index_copy(ax, recv_lo, up)
        if dn is not None:
            field = field.index_copy(ax, recv_hi, dn)
        return field

    return refresh


def _level_on(level, device):
    """An MGLevel with every tensor (its topology's too) on ``device``."""
    if level.mask.device == device:
        return level
    moved = {f.name: getattr(level, f.name) for f in dataclasses.fields(level)}
    moved = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in moved.items()}
    t = level.topo
    moved["topo"] = dataclasses.replace(t, **{
        f.name: getattr(t, f.name).to(device) for f in dataclasses.fields(t)
        if isinstance(getattr(t, f.name), torch.Tensor)})
    return dataclasses.replace(level, **moved)


def _device_leaves(slab, mesh: Mesh) -> list:
    """Block d of every leaf of ``slab`` on ``mesh.devices[d]``, but
    ``n_rows`` as a host int (reading it from a card would wait for it)."""
    leaves = slab.tree_flatten()[0]
    return [tuple(int(a[d]) if i == 3 else a[d].to(dev) for i, a in enumerate(leaves))
            for d, dev in enumerate(mesh.devices)]


def sharded_step(
    mesh: Mesh,
    slab: SlabTopology,
    params: SolverParams,
    emit_fn=None,
    axis: str = "x",
    hierarchy: Optional[SlabHierarchy] = None,
):
    """A full step over the blocks of a sharded state, running the ONE
    pipeline implementation (``solver.step_impl``) on every device under
    ``shard_map`` with the ghost refresh as its halo hook. Returns
    ``fn(slab, state) -> state``, ``state`` a list of D FieldState blocks;
    each output block is zero off its owned rows.

    ``emit_fn(topo, state) -> state``: optional per-frame sourcing applied
    before the step (e.g. ``plume.emit`` with its config and dt).
    ``hierarchy``: from ``build_slab_hierarchy`` when params selects the
    multigrid pressure solver. ``slab`` may also be a ``BoxTopology``."""
    from hnanosolver_tpu_torch.ops.multigrid import MGLevel
    from hnanosolver_tpu_torch.solver import step_impl

    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's axis {mesh.axis!r}")
    if slab.n_devices != mesh.size:
        raise ValueError(f"{slab.n_devices} slabs on a mesh of {mesh.size} devices")
    use_mg = params.pressure_solver == "mg"
    if use_mg and hierarchy is None:
        raise ValueError("pressure_solver='mg' needs a build_slab_hierarchy()")

    leaves0 = _device_leaves(slab, mesh)
    if use_mg:
        maps = (hierarchy.children_local, hierarchy.parent_global, hierarchy.octant_local)
        hier_maps = [tuple(a[d].to(dev) for a in maps)
                     for d, dev in enumerate(mesh.devices)]
        coarse = [(_level_on(hierarchy.coarse_level, dev),
                   tuple(_level_on(lv, dev) for lv in hierarchy.rest))
                  for dev in mesh.devices]
    else:
        hier_maps = coarse = [()] * mesh.size

    def local_step(dec, ax: AxisComm, slab_arrs, hier_d, coarse_d, state: FieldState):
        # leaf contract (SlabTopology AND BoxTopology): 5 core arrays, then
        # the decomposition-specific exchange maps
        keys, origins, nbr, n_rows, local_mask = slab_arrs[:5]
        topo = _local_topo((keys, origins, nbr, n_rows))
        refresh = dec.make_refresh_local(ax, slab_arrs[5:])
        m = local_mask[:, None]

        hier, coarse_reduce, tol_reduce = (), None, None
        if use_mg:
            children, parent, octant = hier_d
            g, rest = coarse_d
            hier = (MGLevel(topo=g.topo, children=children, parent=parent, octant=octant,
                            mask=g.mask),) + rest
            coarse_reduce = ax.psum
            # mesh-wide residual max for mg_tol: ghost rows carry WRONG
            # residuals (their outer neighbours are off-table and read as
            # background 0), so mask to owned rows before the local max, then
            # pmax so that every device stops on the same cycle
            def tol_reduce(r):
                return ax.pmax((r.abs() * m).max())

        def refresh_state(s: FieldState) -> FieldState:
            return FieldState(velocity=refresh(s.velocity),
                              scalars={k: refresh(v) for k, v in s.scalars.items()})

        state = refresh_state(_state_to(state, ax.device))
        if emit_fn is not None:
            state = refresh_state(emit_fn(topo, state))
        out = step_impl(topo, state, params, hierarchy=hier, refresh=refresh,
                        coarse_reduce=coarse_reduce, tol_reduce=tol_reduce)
        return FieldState(velocity=out.velocity * m[None],
                          scalars={k: v * m for k, v in out.scalars.items()})

    def step_fn(slab_in, state: List[FieldState]) -> List[FieldState]:
        leaves = leaves0 if slab_in is slab else _device_leaves(slab_in, mesh)
        return shard_map(functools.partial(local_step, slab_in), mesh, leaves, hier_maps,
                         coarse, state)

    return step_fn


def sharded_plume_step(
    mesh: Mesh,
    slab: SlabTopology,
    params: SolverParams,
    cfg=None,
    axis: str = "x",
    hierarchy: Optional[SlabHierarchy] = None,
):
    """Plume-model convenience wrapper over ``sharded_step``."""
    emit_fn = None
    if cfg is not None:
        from hnanosolver_tpu_torch.models.plume import emit

        def emit_fn(topo, state):
            return emit(topo, state, cfg, params.dt)
    return sharded_step(mesh, slab, params, emit_fn=emit_fn, axis=axis, hierarchy=hierarchy)
