"""The port's topology growth (``core/activation.py``) and the growing frame
loops against the JAX package on the CPU.

- Each activation function on the same numpy inputs: the occupancy mask,
  the per-tile voxel boxes, the tile cover of boxes, the new topologies of
  the tile-mask form and of the ``padding`` (voxel-box) form, and a remap
  that both grows and shrinks: equal (integer results and copies, no
  arithmetic), the remapped state bitwise.
- ``run_plume`` with the JAX defaults (growth every frame) for 3 frames
  from its emitter topology: the same tile keys every frame and the fields
  within 1e-5 * max|ref| (the tolerance of tests/test_torch_step.py: XLA
  on the CPU contracts some multiply-adds into FMAs). The JAX side runs op
  by op under ``jax.disable_jit()``: compiling the growing loop's step at
  every new capacity costs XLA far more than running its ops.
  ``halo_lag=1``: on the CPU the JAX pressure solve ignores the lag.
- ``run_collider`` with its defaults' growth for 2 frames against the JAX
  package's, op by op: the same tile keys every frame, keeping the emitter
  and the collider's shell at frame f + 1, and the fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import activation as jact
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.models import collider as jcol
from hnanosolver_tpu.models import plume as jplume
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.core import activation as tact
from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.fields import COLLISION_FIELD
from hnanosolver_tpu_torch.models import collider as tcol
from hnanosolver_tpu_torch.models import plume as tplume

torch.set_num_threads(1)

NAMES = ("density", "temperature", "fuel", "waste", "flame")
REL = 1e-5
PLANS = ("chunk_uniq", "chunk_lnbr", "chunk_dsrc", "chunk_ldual", "chunk_dloc")


def _port_topo(jt):
    return convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                       np.asarray(jt.nbr), int(jt.n_active), device="cpu")


def _assert_same_topology(tt, jt):
    assert tt.capacity == jt.capacity and tt.n_active == int(jt.n_active)
    for f in ("keys", "origins", "nbr"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))


@pytest.fixture(scope="module")
def sparse():
    """A 6^3-tile box with about half the tiles active; matter in some of
    them (a few voxels each, so the voxel boxes are partial), none in the
    rest; the SDF everywhere (it must not count)."""
    rng = np.random.default_rng(61)
    box = np.array([(x, y, z) for x in range(6) for y in range(6) for z in range(6)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.5])
    T, n = jt.capacity, int(jt.n_active)
    full = rng.random((T, 512)) < 0.02  # a few hot voxels per tile
    rows = np.zeros((T, 1), bool)
    rows[1:n + 1] = rng.random((n, 1)) < 0.4
    hot = full & rows
    vel = np.zeros((3, T, 512), np.float32)
    vel[1][hot] = 0.5
    sc = {k: np.zeros((T, 512), np.float32) for k in NAMES}
    sc["density"][np.roll(hot, 3, axis=1)] = 2e-3
    sc["collision_sdf"] = rng.uniform(-5, 5, (T, 512)).astype(np.float32)
    js = JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})
    ts = convert.state_from_numpy(vel, sc, device="cpu")
    return jt, _port_topo(jt), js, ts


@pytest.mark.parametrize("threshold", [1e-4, 1e-2])
def test_occupancy_matches(sparse, threshold):
    jt, tt, js, ts = sparse
    want = np.asarray(jact.occupied_tile_mask(jt, js, threshold))
    got = tact.occupied_tile_mask(tt, ts, threshold).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < tt.n_active
    jocc, jlo, jhi = jact.occupied_voxel_bboxes(jt, js, threshold)
    occ, lo, hi = tact.occupied_voxel_bboxes(tt, ts, threshold)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    np.testing.assert_array_equal(lo.numpy()[occ.numpy()], np.asarray(jlo)[np.asarray(jocc)])
    np.testing.assert_array_equal(hi.numpy()[occ.numpy()], np.asarray(jhi)[np.asarray(jocc)])


def test_tiles_covering_boxes_match():
    rng = np.random.default_rng(3)
    wmin = rng.integers(-40, 40, (7, 3))
    wmax = wmin + rng.integers(0, 12, (7, 3))
    for padding in (0, 1, 5, 9):
        np.testing.assert_array_equal(tact.tiles_covering_boxes(wmin, wmax, padding),
                                      jact.tiles_covering_boxes(wmin, wmax, padding))


KEEP = np.array([(9, 9, 9), (10, 9, 9), (-2, 0, 1)], np.int32)


@pytest.mark.parametrize("form", ["mask r0", "mask r1", "mask r1 keep", "bboxes p1",
                                  "bboxes p3 keep"])
def test_new_topology_matches(sparse, form):
    jt, tt, js, ts = sparse
    keep = KEEP if "keep" in form else None
    if form.startswith("mask"):
        r = int(form.split()[1][1])
        occ = np.asarray(jact.occupied_tile_mask(jt, js, 1e-4))
        want = jact.topology_from_mask(jt, occ, radius=r, keep_tiles=keep)
        got = tact.topology_from_mask(tt, occ, radius=r, keep_tiles=keep)
    else:
        p = int(form.split()[1][1])
        occ, lo, hi = (np.asarray(a) for a in jact.occupied_voxel_bboxes(jt, js, 1e-4))
        want = jact.topology_from_bboxes(jt, occ, lo, hi, p, keep_tiles=keep)
        got = tact.topology_from_bboxes(tt, occ, lo, hi, p, keep_tiles=keep)
    _assert_same_topology(got, want)


@pytest.mark.parametrize("padding", [None, 2])
def test_expand_for_state_matches(sparse, padding):
    """A pass that drops empty tiles and adds the dilation (grows and
    shrinks), the remapped state bitwise, and a second pass that finds the
    set exact and returns the same objects."""
    jt, tt, js, ts = sparse
    jn, jsn = jact.expand_for_state(jt, js, 1e-4, 1, KEEP, padding)
    tn, tsn = tact.expand_for_state(tt, ts, 1e-4, 1, KEEP, padding)
    _assert_same_topology(tn, jn)
    old, new = set(tt.keys.tolist()), set(tn.keys.tolist())
    assert old - new and new - old  # both shrinks and grows
    np.testing.assert_array_equal(tact.remap_rows(tt, tn).numpy(),
                                  np.asarray(jact.remap_rows(jt, jn)))
    np.testing.assert_array_equal(tsn.velocity.numpy(), np.asarray(jsn.velocity))
    for k, v in tsn.scalars.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsn.scalars[k]))
    # padding rows read 0 after the remap
    assert not tsn.velocity[:, tn.n_active + 1:].any()
    again = tact.expand_for_state(tn, tsn, 1e-4, 1, KEEP, padding)
    jagain = jact.expand_for_state(jn, jsn, 1e-4, 1, KEEP, padding)
    if jagain[0] is jn:
        assert again[0] is tn and again[1] is tsn
    else:
        _assert_same_topology(again[0], jagain[0])


def test_capacity_grows_by_round_capacity_and_never_shrinks(sparse):
    jt, tt, js, ts = sparse
    occ = np.zeros(tt.capacity, bool)
    small = tact.topology_from_mask(tt, occ, radius=0, keep_tiles=KEEP[:1])
    assert small.capacity == tt.capacity and small.n_active == 1
    big_keep = np.array([(x, y, z) for x in range(12) for y in range(12) for z in range(12)])
    big = tact.topology_from_mask(tt, occ, radius=0, keep_tiles=big_keep)
    assert big.capacity == ttopo._round_capacity(len(big_keep)) == jtopo._round_capacity(1728)
    assert big.capacity > tt.capacity


def test_growth_carries_the_plans(sparse):
    jt, tt, js, ts = sparse
    planned = ttopo.ensure_chunk_plans(tt)
    tn, _ = tact.expand_for_state(planned, ts, 1e-4, 1, KEEP)
    want = ttopo.build_topology(C.unpack_keys_np(tn.keys[1:tn.n_active + 1].numpy()),
                                capacity=tn.capacity, device="cpu", plans=True)
    for f in PLANS:
        assert torch.equal(getattr(tn, f), getattr(want, f)), f
    plain, _ = tact.expand_for_state(tt, ts, 1e-4, 1, KEEP)
    assert all(getattr(plain, f) is None for f in PLANS)


PLUME_KW = dict(dt=1.0 / 24.0, iterations=10, voxel_size=0.5, halo_lag=1)
CFG_KW = dict(center=(24.0, 12.0, 24.0), radius=8.0)


def test_run_plume_grows_like_jax():
    """3 frames from the emitter topology with the defaults' growth."""
    frames = []

    def keep_jax(f, topo, st):
        frames.append((np.asarray(topo.keys).copy(), np.asarray(st.velocity).copy(),
                       {k: np.asarray(v).copy() for k, v in st.scalars.items()}))

    with jax.disable_jit():
        jplume.run_plume(3, jcfg.SolverParams(**PLUME_KW), jplume.PlumeConfig(**CFG_KW),
                         on_frame=keep_jax)
    got = []
    tplume.run_plume(3, tcfg.SolverParams(**PLUME_KW), tplume.PlumeConfig(**CFG_KW),
                     device="cpu", on_frame=lambda f, t, s: got.append((t, s)))
    assert len(got) == 3
    sizes = []
    for (tt, ts), (keys, vel, sc) in zip(got, frames):
        np.testing.assert_array_equal(tt.keys.numpy(), keys)
        assert tt.capacity <= 2048
        sizes.append(tt.n_active)
        np.testing.assert_allclose(ts.velocity.numpy(), vel, rtol=0,
                                   atol=REL * np.abs(vel).max())
        for k, v in ts.scalars.items():
            np.testing.assert_allclose(v.numpy(), sc[k], rtol=0, atol=REL * np.abs(sc[k]).max())
    emitter = len(np.unique(C.pack_keys_np(tplume.emitter_tiles(tplume.PlumeConfig(**CFG_KW)))))
    assert sizes[-1] > emitter  # the topology grew past the emitter


def test_run_collider_keeps_emitter_and_next_shell():
    """Two growing frames from run_collider's default topology against the
    JAX package's run_collider, op by op: the same tile keys after every
    frame, holding the emitter's tiles and the collider's shell at frame
    f + 1 (the JAX package's keep-tiles), and the fields within REL (the
    SDF, recomputed from positions, within 1e-5 voxels)."""
    col_kw = dict(center0=(20.0, 30.0, 24.0), velocity=(48.0, 0.0, 0.0), radius=5.0)
    frames = []  # numpy copies: run_collider donates each state to the next step

    def keep_jax(f, topo, st):
        frames.append((np.asarray(topo.keys).copy(), np.asarray(st.velocity).copy(),
                       {k: np.asarray(v).copy() for k, v in st.scalars.items()}))

    with jax.disable_jit():
        jcol.run_collider(2, jcfg.SolverParams(**PLUME_KW), jplume.PlumeConfig(**CFG_KW),
                          jcol.ColliderConfig(**col_kw), on_frame=keep_jax)
    params = tcfg.SolverParams(**PLUME_KW)
    cfg = tplume.PlumeConfig(**CFG_KW)
    col = tcol.ColliderConfig(**col_kw)
    seen = []
    tcol.run_collider(2, params, cfg, col, device="cpu",
                      on_frame=lambda f, t, s: seen.append((f, t, s)))
    assert len(seen) == len(frames) == 2
    emitter = set(C.pack_keys_np(tplume.emitter_tiles(cfg, pad=1)).tolist())
    for (f, tt, ts), (keys, vel, sc) in zip(seen, frames):
        np.testing.assert_array_equal(tt.keys.numpy(), keys)
        active = set(tt.keys[1:tt.n_active + 1].tolist())
        shell = set(C.pack_keys_np(tcol.collider_tiles(col, f + 1, params.dt)).tolist())
        assert emitter <= active and shell <= active
        assert tt.capacity <= 2048
        np.testing.assert_allclose(ts.velocity.numpy(), vel, rtol=0,
                                   atol=REL * np.abs(vel).max())
        assert sorted(ts.scalars) == sorted(sc)
        for k, v in ts.scalars.items():
            atol = 1e-5 if k == COLLISION_FIELD else REL * np.abs(sc[k]).max()
            np.testing.assert_allclose(v.numpy(), sc[k], rtol=0, atol=atol, err_msg=k)
    start = emitter | set(C.pack_keys_np(tcol.collider_tiles(col, 0, params.dt)).tolist())
    assert set(seen[-1][1].keys[1:seen[-1][1].n_active + 1].tolist()) - start  # it grew
