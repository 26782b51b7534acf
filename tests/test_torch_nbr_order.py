"""The z order of the port's neighbour table, which kernels B3 and B6 rely
on (``csrc/tile_ring.cuh``, shared by ``rbsor_lagged.cu`` and
``residual.cu``): the packed key's low bits are the tile's z coordinate and
the keys are sorted, so for every row t ``nbr[t, +z]`` is ``t + 1`` or 0
(absent) and ``nbr[t, -z]`` is ``t - 1`` or 0. B3 and B6 take a tile's +-z
faces from its block neighbour's shared-memory plane where the table points
at it, and from device memory elsewhere; the invariant decides how many
faces stay on chip, never which value is read.

Checked on every kind of topology the solver steps: the bench plume and
config 4's fixed topologies (``cells.py``, shrunk envelopes), one grown by
``core/activation``, a topology at a capacity that is not a multiple of B3's
block of 8 tiles, and the multigrid coarse levels. The null row and the
padding rows have all-zero entries.
"""

import numpy as np
import pytest
import torch

from hnanosolver_tpu_torch.cells import CELLS
from hnanosolver_tpu_torch.core import activation as tact
from hnanosolver_tpu_torch.core.topology import build_topology
from hnanosolver_tpu_torch.models.plume import build_plume_envelope
from hnanosolver_tpu_torch.ops import multigrid
from hnanosolver_tpu_torch.ops.shifts import d_of

D_PZ, D_MZ = d_of((0, 0, 1)), d_of((0, 0, -1))
B3_TILES_A_BLOCK = 4  # csrc/tile_ring.cuh: G (B3 and B6)


def _bench():
    return build_topology(build_plume_envelope(24, 96), device="cpu")


def _config4():
    cell = CELLS["c4"]
    small = type(cell)(envelope=(24, 96), plume=cell.plume, params=cell.params,
                       develop=cell.develop, collider=cell.collider)
    return small.topology("cpu")


def _grown():
    topo = _bench()
    rng = np.random.default_rng(3)
    occ = rng.random(topo.capacity) < 0.3
    occ[0] = False
    occ[topo.n_active + 1:] = False
    return tact.topology_from_mask(topo, occ, radius=1)


def _odd_capacity():
    tiles = build_plume_envelope(24, 96)
    n = len(np.unique(tiles, axis=0))
    return build_topology(tiles, capacity=n + 1 + 3, device="cpu")


def _coarse(level):
    def make():
        return multigrid.build_hierarchy(_bench(), 2)[level - 1].topo
    return make


TOPOLOGIES = {"bench": _bench, "config4": _config4, "grown": _grown,
              "odd_capacity": _odd_capacity, "mg_level1": _coarse(1), "mg_level2": _coarse(2)}


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_z_neighbours_are_adjacent_rows(name):
    topo = TOPOLOGIES[name]()
    nbr = topo.nbr.numpy()
    t = np.arange(nbr.shape[0])
    pz, mz = nbr[:, D_PZ], nbr[:, D_MZ]
    assert np.all((pz == 0) | (pz == t + 1))
    assert np.all((mz == 0) | (mz == t - 1))
    # the two directions agree: t's +z neighbour has t as its -z neighbour
    has = pz > 0
    assert np.array_equal(mz[pz[has]], t[has])
    # null and padding rows point nowhere
    assert not nbr[0].any() and not nbr[topo.n_active + 1:].any()
    assert has.sum() > 0  # the check is not vacuous


def test_most_z_faces_stay_in_a_b3_block():
    """On a bench-shaped envelope most +-z faces join two tiles of one B3
    block, the design's premise (the bench domain of cells.py: 75% at the
    kernel's G = 4, 88% at G = 8)."""
    nbr = _bench().nbr.numpy()
    t = np.arange(nbr.shape[0])
    g = B3_TILES_A_BLOCK
    faces = inside = 0
    for col, other in ((D_PZ, t + 1), (D_MZ, t - 1)):
        linked = nbr[:, col] > 0
        faces += int(linked.sum())
        inside += int((linked & (t // g == other // g)).sum())
    assert inside / faces > 0.7
