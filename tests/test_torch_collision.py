"""Collision (BASELINE config 4) in the port against the JAX package on the
CPU: ``ops/collision.py``, the collision branches of the step, and
``models/collider.py``.

Tolerances: ``enforce_collision`` and the SDF normal are held to rtol 1e-6
plus 1e-6 of the field's scale (XLA on the CPU may contract the blend's
multiply-adds into FMAs; the division sdf / blend_denom may round another
way). Whole steps and frames are held to 1e-5 of each field's max, as in
tests/test_torch_step.py. The collider's SDF is held to rtol 1e-6 plus
1e-5 voxels: XLA may contract ``sphere_sdf``'s sum of squares into FMAs,
which moves the distance by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.models import collider as jcol
from hnanosolver_tpu.models import plume as jplume
from hnanosolver_tpu.ops import collision as jcoll
from hnanosolver_tpu.solver import step as jstep
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.fields import COLLISION_FIELD
from hnanosolver_tpu_torch.models import collider as tcol
from hnanosolver_tpu_torch.models import plume as tplume
from hnanosolver_tpu_torch.ops import collision as tcoll
from hnanosolver_tpu_torch.solver import step as tstep

torch.set_num_threads(1)

REL = 1e-5
NAMES = ("density", "temperature", "fuel", "waste", "flame")


def _port_topo(jt):
    return convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                       np.asarray(jt.nbr), int(jt.n_active), device="cpu")


def _positions(jt):
    org = np.asarray(jt.origins)[:, None, :] * 8
    col = np.arange(512)
    return org + np.stack([col // 64, (col // 8) % 8, col % 8], -1)[None]


def _sphere(jt, center, radius):
    """Sphere SDF masked as mask_state leaves it: the null tile reads 0,
    which is "near" (0 < 0.1) but not "inside"."""
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    d = np.linalg.norm(_positions(jt) - np.asarray(center), axis=-1) - radius
    return (d * m).astype(np.float32)


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def _numpy_state(jstate):
    return (np.asarray(jstate.velocity), {k: np.asarray(v) for k, v in jstate.scalars.items()})


def _jax_state(np_state):
    vel, sc = np_state
    return JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})


def _assert_state_close(tstate, jstate):
    """``jstate``: a JAX FieldState or a (velocity, scalars) numpy pair."""
    tv, ts = convert.state_to_numpy(tstate)
    want, wsc = jstate if isinstance(jstate, tuple) else _numpy_state(jstate)
    np.testing.assert_allclose(tv, want, rtol=0, atol=REL * np.abs(want).max())
    assert sorted(ts) == sorted(wsc)
    for k, v in ts.items():
        w = wsc[k]
        if k == COLLISION_FIELD:
            np.testing.assert_allclose(v, w, rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_allclose(v, w, rtol=0, atol=REL * np.abs(w).max(), err_msg=k)


@pytest.fixture(scope="module")
def edge():
    """A sparse 5^3-tile box and a sphere that crosses its x = 0 face."""
    rng = np.random.default_rng(17)
    box = np.array([(x, y, z) for x in range(5) for y in range(5) for z in range(5)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.6])
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    vel = (rng.standard_normal((3, jt.capacity, 512)) * 2.0 * m).astype(np.float32)
    return jt, _port_topo(jt), vel, _sphere(jt, (2.0, 19.0, 21.0), 9.0)


@pytest.mark.parametrize("blend_denom", [None, 1.5])
def test_enforce_collision_matches_jax(edge, blend_denom):
    jt, tt, vel, sdf = edge
    inv_dx = 2.0
    kw = {} if blend_denom is None else dict(margin=0.1, blend_denom=blend_denom)
    want = np.asarray(jcoll.enforce_collision(jt, jnp.asarray(vel), jnp.asarray(sdf),
                                              inv_dx, **kw))
    got = tcoll.enforce_collision(tt, torch.from_numpy(vel), torch.from_numpy(sdf),
                                  inv_dx, **kw).numpy()
    _close(got, want, np.abs(want).max())
    inside = sdf < 0
    assert inside.sum() > 100 and np.all(got[:, inside] == 0.0)
    near = (sdf >= 0) & (sdf < 0.1)
    assert near.sum() > 100  # the null tile and padding rows are "near"
    np.testing.assert_array_equal(got[:, sdf >= 0.1], vel[:, sdf >= 0.1])


def test_sdf_normal_field_matches_jax(edge):
    jt, tt, _, sdf = edge
    want = np.asarray(jcoll.sdf_normal_field(jt, jnp.asarray(sdf), 2.0))
    got = tcoll.sdf_normal_field(tt, torch.from_numpy(sdf), 2.0).numpy()
    _close(got, want, 1.0)


def _box_state(jt, rng):
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    T = jt.capacity
    vel = (rng.standard_normal((3, T, 512)) * m).astype(np.float32)
    sc = {n: (rng.random((T, 512)) * m * s).astype(np.float32)
          for n, s in zip(NAMES, (1.0, 60.0, 0.3, 0.2, 0.5))}
    return vel, sc


def test_step_with_static_sdf_at_the_edge_matches_jax():
    """One step with collision on, on a dense 24^3 box whose solid crosses
    the domain's x = 0 face; the SDF is masked (the null tile reads 0)."""
    rng = np.random.default_rng(19)
    jt = jtopo.build_topology_dense((24, 24, 24))
    vel, sc = _box_state(jt, rng)
    sc[COLLISION_FIELD] = _sphere(jt, (3.0, 12.0, 12.0), 6.0)
    kw = dict(dt=0.2, iterations=6, halo_lag=1, has_collision=True)
    want = jstep(jt, JState(velocity=jnp.asarray(vel),
                            scalars={k: jnp.asarray(v) for k, v in sc.items()}),
                 jcfg.SolverParams(**kw))
    got = tstep(_port_topo(jt), convert.state_from_numpy(vel, sc, device="cpu"),
                tcfg.SolverParams(**kw))
    _assert_state_close(got, want)
    inside = sc[COLLISION_FIELD] < 0
    assert inside.sum() > 100 and not got.velocity[:, torch.from_numpy(inside)].any()


def test_collision_flag_without_sdf_field_and_sdf_without_flag():
    """``has_collision`` without a ``collision_sdf`` field steps as without
    collision; a ``collision_sdf`` field without the flag is carried over,
    not advected (the JAX package's step does both)."""
    rng = np.random.default_rng(23)
    jt = jtopo.build_topology(np.array([(x, y, 0) for x in range(3) for y in range(2)]))
    tt = _port_topo(jt)
    vel, sc = _box_state(jt, rng)
    params = tcfg.SolverParams(dt=0.1, iterations=4, halo_lag=1)
    st = convert.state_from_numpy(vel, sc, device="cpu")
    a = tstep(tt, st, params)
    b = tstep(tt, st, params.replace(has_collision=True))
    for k in ["velocity"] + list(NAMES):
        x = a.velocity if k == "velocity" else a.scalars[k]
        y = b.velocity if k == "velocity" else b.scalars[k]
        assert torch.equal(x, y), k
    sdf = _sphere(jt, (8.0, 8.0, 4.0), 3.0)
    c = tstep(tt, st.with_scalar(COLLISION_FIELD, torch.from_numpy(sdf)), params)
    np.testing.assert_array_equal(c.scalars[COLLISION_FIELD].numpy(), sdf)
    assert torch.equal(c.velocity, a.velocity)


# -- the moving collider --------------------------------------------------

PARAMS_KW = dict(dt=1.0 / 24.0, iterations=20, voxel_size=0.5, halo_lag=1)
CFG_KW = dict(center=(24.0, 12.0, 24.0), radius=8.0)
COL_KW = dict(center0=(14.0, 26.0, 24.0), velocity=(48.0, 0.0, 0.0), radius=6.0)
FRAMES = 3


@pytest.fixture(scope="module")
def collider():
    """The plume envelope of tests/test_torch_step.py united with the
    collider's shell over its sweep; JAX side: one ``collider_step`` from
    rest and a 3-frame ``run_collider(grow_every=0)``."""
    col = jcol.ColliderConfig(**COL_KW)
    params = jcfg.SolverParams(**PARAMS_KW)
    tiles = np.concatenate([tplume.build_plume_envelope(24, 64, 24, 24)] + [
        jcol.collider_tiles(col, f, params.dt) for f in range(FRAMES + 1)])
    jt = jtopo.build_topology(tiles)
    T = jt.capacity
    z = np.zeros((T, 512), np.float32)
    s0 = JState(velocity=jnp.zeros((3, T, 512), jnp.float32),
                scalars={n: jnp.asarray(z) for n in NAMES})
    frames = []  # numpy copies: run_collider donates each state to the next step
    # op by op: XLA takes minutes on the CPU to compile the collision step
    # (the gather sampler's SDF probes under lax.map); the ops are the same
    with jax.disable_jit():
        jcol.run_collider(FRAMES, params, jplume.PlumeConfig(**CFG_KW), col, topo=jt,
                          state=s0, grow_every=0,
                          on_frame=lambda f, t, s: frames.append(_numpy_state(s)))
        one = jcol.collider_step(jt, _jax_state(frames[0]), params.replace(has_collision=True),
                                 jplume.PlumeConfig(**CFG_KW), col, jnp.float32(1.0))
    return jt, frames, _numpy_state(one)


def test_collider_step_matches_jax(collider):
    jt, frames, one = collider
    tt = _port_topo(jt)
    got = tcol.collider_step(tt, convert.state_from_numpy(*frames[0], device="cpu"),
                             tcfg.SolverParams(**PARAMS_KW, has_collision=True),
                             tplume.PlumeConfig(**CFG_KW), tcol.ColliderConfig(**COL_KW), 1)
    _assert_state_close(got, one)


def test_run_collider_frames_match_jax(collider):
    jt, frames, _ = collider
    tt = _port_topo(jt)
    got = []
    tcol.run_collider(FRAMES, tcfg.SolverParams(**PARAMS_KW), tplume.PlumeConfig(**CFG_KW),
                      tcol.ColliderConfig(**COL_KW), topo=tt, grow_every=0,
                      on_frame=lambda f, t, s: got.append(s))
    assert len(got) == FRAMES
    for s, want in zip(got, frames):
        _assert_state_close(s, want)
    sdf = got[-1].scalars[COLLISION_FIELD]
    inside = sdf < 0
    assert inside.sum() > 100 and not got[-1].velocity[:, inside].any()
    assert float(got[-1].scalars["density"].max()) > 0


def test_collider_center_and_sdf_match_jax(collider):
    jt, _, _ = collider
    tt = _port_topo(jt)
    jc, tc = jcol.ColliderConfig(**COL_KW), tcol.ColliderConfig(**COL_KW)
    for f in (0, 7, 30):
        want_c = jcol.collider_center(jc, f, 1 / 24)
        got_c = tcol.collider_center(tc, f, 1 / 24)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_allclose(
            tcol.sphere_sdf(tt, got_c, tc.radius).numpy(),
            np.asarray(jcol.sphere_sdf(jt, want_c, jc.radius)), rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(tcol.collider_tiles(tc, f, 1 / 24),
                                      jcol.collider_tiles(jc, f, 1 / 24))


def test_config4_cell_topology():
    """The chip scripts' config-4 cell: the bench envelope united with the
    JAX package's collider shells for frames 0..30, bitwise, 4354 tiles at
    the bench's capacity 4608."""
    from bench import build_plume_envelope as bench_envelope
    from hnanosolver_tpu_torch.cells import CELLS, SWEEP_FRAMES

    cell = CELLS["c4"]
    col = jcol.ColliderConfig(center0=cell.collider.center0, velocity=cell.collider.velocity,
                              radius=cell.collider.radius)
    tiles = np.concatenate([bench_envelope(*cell.envelope)] + [
        jcol.collider_tiles(col, f, cell.params.dt) for f in range(SWEEP_FRAMES)])
    j = jtopo.build_topology(tiles, capacity=4608)
    t = cell.topology("cpu")
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.nbr.numpy(), np.asarray(j.nbr))
    assert (t.n_active, t.capacity) == (4354, 4608)
    assert cell.params.has_collision and cell.develop == 20
