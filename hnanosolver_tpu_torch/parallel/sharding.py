"""Multi-device step over a mesh, the JAX package's ``parallel/sharding.py``.

The JAX package shards fields ``[T, ...]`` on the tile axis over the
``"x"`` mesh axis and lets XLA's GSPMD partition the one-device step and
insert the collectives for the halo row gathers; it names a shard_map +
``ppermute`` explicit-ghost path as the planned optimisation
(``hnanosolver_tpu/parallel/sharding.py:13-15``). torch has no GSPMD, so
here :func:`make_sharded_step` IS that explicit-ghost form: it builds x-slabs
over the mesh, scatters the state, runs ``parallel/slab.sharded_step`` and
gathers the result, returning the state as the one-device step does.

The shardings are descriptors (:class:`NamedSharding`): ``spec[i]`` is the
mesh axis that dimension i is split over (contiguous equal blocks), None
or a missing entry replicated. :func:`device_put` lays an array out by one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core.topology import Topology
from hnanosolver_tpu_torch.fields import FieldState
from hnanosolver_tpu_torch.models.plume import PlumeConfig
from hnanosolver_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401 (API)
from hnanosolver_tpu_torch.parallel.slab import (
    build_slabs, gather_state, scatter_state, sharded_plume_step)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """An array's layout over ``mesh``: dimension i split into contiguous
    equal blocks over the mesh axis ``spec[i]`` (None: replicated)."""

    mesh: Mesh
    spec: tuple = ()


def field_sharding(mesh: Mesh, axis: str = "x") -> NamedSharding:
    """Tile-axis (slab) sharding for a [T, ...] field array."""
    return NamedSharding(mesh, (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def vel_sharding(mesh: Mesh, axis: str = "x") -> NamedSharding:
    """Velocity is channel-major [3,T,512]: shard the tile axis (dim 1)."""
    return NamedSharding(mesh, (None, axis))


def device_put(x: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """``x`` laid out by ``sharding``: block d on ``mesh.devices[d]``."""
    mesh = sharding.mesh
    dims = [i for i, a in enumerate(sharding.spec) if a is not None]
    if not dims:
        return [x.to(dev) for dev in mesh.devices]
    if len(dims) > 1 or sharding.spec[dims[0]] != mesh.axis:
        raise ValueError(f"spec {sharding.spec} does not split one dimension over the "
                         f"mesh axis {mesh.axis!r}")
    dim = dims[0]
    if x.shape[dim] % mesh.size:
        raise ValueError(f"dimension {dim} of {x.shape[dim]} rows does not divide over "
                         f"{mesh.size} devices")
    return [b.to(dev) for b, dev in zip(x.chunk(mesh.size, dim), mesh.devices)]


def shard_topology(mesh: Mesh, topo: Topology) -> List[Topology]:
    """The topology replicated: one copy a device."""
    r = replicated(mesh)
    keys, origins, nbr = (device_put(a, r) for a in (topo.keys, topo.origins, topo.nbr))
    return [Topology(keys=k, origins=o, nbr=n, n_active=topo.n_active)
            for k, o, n in zip(keys, origins, nbr)]


def shard_state(mesh: Mesh, state: FieldState, axis: str = "x") -> List[FieldState]:
    """The state split on its tile axis: block d holds rows d*T/D to
    (d+1)*T/D of every field, on ``mesh.devices[d]``."""
    fs = field_sharding(mesh, axis)
    vel = device_put(state.velocity, vel_sharding(mesh, axis))
    scalars = {k: device_put(v, fs) for k, v in state.scalars.items()}
    return [FieldState(velocity=vel[d], scalars={k: v[d] for k, v in scalars.items()})
            for d in range(mesh.size)]


def _unshard(state, device) -> FieldState:
    """A FieldState on ``device`` from a whole one or from shard_state's blocks."""
    if isinstance(state, FieldState):
        return state
    return FieldState(
        velocity=torch.cat([b.velocity.to(device) for b in state], 1),
        scalars={k: torch.cat([b.scalars[k].to(device) for b in state], 0)
                 for k in state[0].scalars})


def make_sharded_step(mesh: Mesh, params: SolverParams, cfg: Optional[PlumeConfig] = None,
                      axis: str = "x"):
    """``run(topo, state) -> state``: a full step over ``mesh`` (with ``cfg``
    the emitter runs first), through x-slabs: slabs built once a topology,
    the state scattered, ``sharded_plume_step`` run and the owned rows
    gathered back onto ``topo``'s device. ``state`` is a FieldState or
    :func:`shard_state`'s blocks. As the JAX package's form (which calls the
    one-device step with no hierarchy), ``pressure_solver="mg"`` runs the
    RBGS solve."""
    if params.pressure_solver == "mg":
        params = params.replace(pressure_solver="rbgs")
    built = {}

    def run(topo: Topology, state) -> FieldState:
        if built.get("topo") is not topo:
            slab = build_slabs(topo, mesh.size)
            built.update(topo=topo, slab=slab,
                         step=sharded_plume_step(mesh, slab, params, cfg, axis))
        slab = built["slab"]
        blocks = scatter_state(topo, slab, _unshard(state, topo.device), mesh)
        return gather_state(topo, slab, built["step"](slab, blocks))

    return run
