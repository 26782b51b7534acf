"""The port's samplers (``ops/sampling.py``) and halo assembly
(``ops/halo.py``) against the JAX package's, on the CPU.

Two topologies, each built by both packages from the same tiles: a sparse
one of 3 tiles in an L (so most of each halo and many trilinear corners lie
on inactive tiles) and a dense 2x2x2 box. Fields in the block layout
``[T,8,8,8(,3)]`` made from a seed with numpy, zero on the null and padding
rows.

- Gathers and views are exact: ``sample_nearest``, ``gather_halo`` (r = 1,
  4, 8, and faces only) and ``sample_offset_local`` equal the JAX package's
  bitwise.
- The trilinear samplers (``sample_trilinear``, scalar and vector, and
  ``sample_trilinear_local``, with its clamp of the displacement to
  ``radius - 1 - 1e-3``) do the same f32 products and sums in the same
  order; XLA may contract a multiply-add into an FMA, so they are held to
  1e-6 * max|field|.
- Background: reads at inactive voxels and trilinear samples whose eight
  corners are all inactive are exactly 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import halo as jhalo
from hnanosolver_tpu.ops import sampling as jsam
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.ops import halo as thalo
from hnanosolver_tpu_torch.ops import sampling as tsam

torch.set_num_threads(1)

TOL = 1e-6  # times max|field|: the trilinear samplers
TOPOS = {
    "sparse3": np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0)]),
    "dense2": np.array([(x, y, z) for x in range(2) for y in range(2) for z in range(2)]),
}


@pytest.fixture(scope="module", params=sorted(TOPOS))
def topo(request):
    """(name, JAX topology, port topology, scalar [T,8,8,8], vector
    [T,8,8,8,3])."""
    jt = jtopo.build_topology(TOPOS[request.param])
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    rng = np.random.default_rng(11)
    m = np.asarray(jtopo.active_mask(jt))[:, None, None, None]
    s = (rng.standard_normal((jt.capacity, 8, 8, 8)) * m).astype(np.float32)
    v = (rng.standard_normal((jt.capacity, 8, 8, 8, 3)) * m[..., None]).astype(np.float32)
    return request.param, jt, tt, s, v


def _fields(topo, vector):
    _, jt, tt, s, v = topo
    f = v if vector else s
    return jt, tt, f


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_sample_nearest_equals_jax(topo, vector):
    jt, tt, f = _fields(topo, vector)
    coords = np.random.default_rng(2).integers(-12, 28, (9, 7, 3)).astype(np.int32)
    got = tsam.sample_nearest(tt, torch.from_numpy(f), coords)
    want = jsam.sample_nearest(jt, jnp.asarray(f), jnp.asarray(coords))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_sample_trilinear_equals_jax(topo, vector):
    jt, tt, f = _fields(topo, vector)
    pos = np.random.default_rng(3).uniform(-6.0, 22.0, (11, 13, 3)).astype(np.float32)
    got = tsam.sample_trilinear(tt, torch.from_numpy(f), pos)
    want = jsam.sample_trilinear(jt, jnp.asarray(f), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL * np.abs(f).max())


@pytest.mark.parametrize("faces_only", [False, True], ids=["all", "faces"])
@pytest.mark.parametrize("radius", [1, 4, 8])
def test_gather_halo_equals_jax(topo, radius, faces_only):
    for vector in (False, True):
        jt, tt, f = _fields(topo, vector)
        got = thalo.gather_halo(tt, torch.from_numpy(f), radius, faces_only)
        want = jhalo.gather_halo(jt, jnp.asarray(f), radius, faces_only)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_halo_rejects_radius_outside_1_to_8(topo):
    _, _, tt, s, _ = topo
    for r in (0, 9):
        with pytest.raises(ValueError, match="radius"):
            thalo.gather_halo(tt, torch.from_numpy(s), r)


@pytest.mark.parametrize("radius", [4, 8])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_sample_trilinear_local_equals_jax(topo, vector, radius):
    """Displacements up to 1.5x the halo, so the clamp engages; once with a
    shared halo block (``block=``)."""
    jt, tt, f = _fields(topo, vector)
    lim = tsam.displacement_limit(radius)
    assert lim == jsam.displacement_limit(radius) == radius - 1 - 1e-3
    disp = np.random.default_rng(4).uniform(-1.5 * radius, 1.5 * radius,
                                            f.shape[:4] + (3,)).astype(np.float32)
    want = np.asarray(jsam.sample_trilinear_local(jt, jnp.asarray(f), jnp.asarray(disp), radius))
    tf = torch.from_numpy(f)
    for block in (None, thalo.gather_halo(tt, tf, radius)):
        got = tsam.sample_trilinear_local(tt, tf, torch.from_numpy(disp), radius, block=block)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(f).max())


@pytest.mark.parametrize("offset", [(1, 0, 0), (0, -1, 0), (-2, 1, 4), (0, 0, -8)])
def test_sample_offset_local_equals_jax(topo, offset):
    for vector in (False, True):
        jt, tt, f = _fields(topo, vector)
        got = tsam.sample_offset_local(tt, torch.from_numpy(f), offset)
        want = jsam.sample_offset_local(jt, jnp.asarray(f), offset)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # shift over a wider shared halo reads the same values
        wide = thalo.gather_halo(tt, torch.from_numpy(f), 8)
        assert torch.equal(tsam.sample_offset_local(tt, torch.from_numpy(f), offset, 8, wide),
                           got)


def test_zero_background_at_inactive_corners(topo):
    """Nearest reads of inactive voxels and trilinear samples whose corners
    are all inactive are exactly 0, while the field is nowhere 0 on the
    active tiles."""
    name, jt, tt, s, v = topo
    org = tt.origins[1:tt.n_active + 1].numpy()
    f = torch.from_numpy(np.where(s != 0, s, 1.0).astype(np.float32)
                         * np.asarray(jtopo.active_mask(jt))[:, None, None, None])
    far = np.array([[100, 100, 100], [-9, -9, -9], [4, 20, 3]], np.int32)
    if name == "sparse3":  # the empty tile (0, 1, 0) of the L
        far = np.concatenate([far, [[3, 11, 2]]])
    assert not any((tuple(c // 8) in {tuple(o) for o in org}) for c in far)
    assert not tsam.sample_nearest(tt, f, far).any()
    pos = far.astype(np.float32) + 0.25
    assert not tsam.sample_trilinear(tt, f, pos).any()
    assert not tsam.sample_trilinear(tt, torch.from_numpy(v), pos).any()
    # and a sample between an active and an inactive voxel takes only the active share
    edge = np.array([[15.5, 3.0, 3.0]], np.float32)  # x = 15 active, 16 outside
    got = tsam.sample_trilinear(tt, f, edge)
    assert torch.equal(got, 0.5 * tsam.sample_nearest(tt, f, np.array([[15, 3, 3]], np.int32)))
