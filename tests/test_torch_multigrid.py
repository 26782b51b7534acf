"""The port's multigrid pressure solver, its step and the projection entry
points against the JAX package on the CPU.

- The hierarchy's integer tables and masks are equal to JAX's.
- restrict / prolong / prolong_trilinear (merged and sequential forms)
  agree within 1e-6 * max|ref|: the same lane maps move the same values,
  and XLA may contract 0.75*a + 0.25*b into an FMA.
- V-cycles, FMG and the ``tol`` stop run the JAX side as its TPU path
  runs: its ``solve_pressure`` with ``backend="pallas"`` (interpret mode on
  the CPU) and its residual as the B6 Pallas kernel in interpret mode, with
  both packages' MAX_FUSED_ROWS lowered to 16, so that the 64-row fine
  level takes the pair-lagged B3 path, the 32-row level 1 the masked B3
  path and the 16-row level 2 B5 (config 5's mix of kernels). Tolerance
  1e-5 * max|p|: ulp-level differences (FMA contraction) carried through
  the levels of a cycle.
- ``step`` with ``pressure_solver="mg"`` and plume frames: every level is
  at most 2048 rows, so both packages run the textbook solve; REL = 1e-5
  per field, as in tests/test_torch_step.py.
- ``project`` / ``divergence_only``: 1e-5 * max|ref| (divergence alone:
  1e-6).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu import solver as jsolver
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.models import plume as jplume
from hnanosolver_tpu.ops import multigrid as jmg
from hnanosolver_tpu.ops import pallas_pressure as jpp
from hnanosolver_tpu.ops import pallas_stencil as jps
from hnanosolver_tpu.ops import pressure as jprs
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch import solver as tsolver
from hnanosolver_tpu_torch.models import plume as tplume
from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.ops import multigrid as tmg

torch.set_num_threads(1)

DX, OMEGA = 0.5, 1.2
REL_MG = 1e-5
REL = 1e-5
NAMES = ("density", "temperature", "fuel", "waste", "flame")


def _port_topo(jt):
    return convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                       np.asarray(jt.nbr), int(jt.n_active), device="cpu")


def _sparse_tiles():
    rng = np.random.default_rng(7)
    box = np.array([(x, y, z) for x in range(6) for y in range(4) for z in range(4)])
    return box[rng.random(len(box)) < 0.55] - np.array([2, 1, 3])


def _domains():
    return {
        "sparse": jtopo.build_topology(_sparse_tiles()),
        "dense_box": jtopo.build_topology_dense((24, 24, 24)),
    }


@pytest.fixture(scope="module")
def sparse():
    """A 64-row sparse domain, a random divergence, both hierarchies."""
    jt = _domains()["sparse"]
    assert jt.capacity == 64
    tt = _port_topo(jt)
    rng = np.random.default_rng(8)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    div = (rng.standard_normal((jt.capacity, 512)) * m).astype(np.float32)
    return jt, tt, div, jmg.build_hierarchy(jt, 2), tmg.build_hierarchy(tt, 2)


@pytest.mark.parametrize("mode", ["all", "any"])
@pytest.mark.parametrize("case", ["sparse", "dense_box"])
def test_hierarchy_equals_jax(case, mode):
    jt = _domains()[case]
    jh = jmg.build_hierarchy(jt, 3, mask_mode=mode)
    th = tmg.build_hierarchy(_port_topo(jt), 3, mask_mode=mode)
    assert len(jh) == len(th) == 3
    for jl, tl in zip(jh, th):
        for name in ("children", "parent", "octant", "mask"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(getattr(jl, name)), err_msg=name)
        for name in ("keys", "origins", "nbr"):
            np.testing.assert_array_equal(getattr(tl.topo, name).numpy(),
                                          np.asarray(getattr(jl.topo, name)), err_msg=name)
        assert tl.topo.n_active == int(jl.topo.n_active)
        assert tl.topo.device == torch.device("cpu")


def test_hierarchy_for_follows_the_solver(sparse):
    _, tt, _, _, _ = sparse
    assert tmg.hierarchy_for(tt, tcfg.SolverParams()) == ()
    h = tmg.hierarchy_for(tt, tcfg.SolverParams(pressure_solver="mg", mg_levels=3))
    assert len(h) == 3


@pytest.mark.parametrize("form", ["merged", "sequential"])
@pytest.mark.parametrize("op", ["restrict", "prolong", "prolong_trilinear"])
def test_transfer_operators_match_jax(sparse, monkeypatch, op, form):
    jt, _, _, jh, th = sparse
    budget = 1 << 60 if form == "merged" else 0
    monkeypatch.setattr(jmg, "PROLONG_MERGE_BUDGET", budget)
    monkeypatch.setattr(tmg, "PROLONG_MERGE_BUDGET", budget)
    rng = np.random.default_rng(9)
    lvl_j, lvl_t = jh[0], th[0]
    if op == "restrict":
        x = rng.standard_normal((jt.capacity, 512)).astype(np.float32)
        want = np.asarray(jmg.restrict(lvl_j, jnp.asarray(x)))
        got = tmg.restrict(lvl_t, torch.from_numpy(x)).numpy()
    else:
        x = rng.standard_normal((lvl_t.topo.capacity, 512)).astype(np.float32)
        x[0] = 0.0
        x[lvl_t.topo.n_active + 1:] = 0.0
        if op == "prolong":
            want = np.asarray(jmg.prolong(lvl_j, jnp.asarray(x), jt.capacity))
        else:
            want = np.asarray(jmg.prolong_trilinear(lvl_j, jnp.asarray(x)))
        got = getattr(tmg, op)(lvl_t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.fixture
def tpu_path(monkeypatch):
    """Both packages' solves as the JAX TPU path runs them (module doc)."""
    monkeypatch.setattr(jprs, "solve_pressure",
                        functools.partial(jprs.solve_pressure, backend="pallas"))
    monkeypatch.setattr(jprs, "residual", lambda topo, p, div, dx: jps.residual_fused(
        topo, p, div, dx, interpret=True))
    monkeypatch.setattr(jpp, "MAX_FUSED_ROWS", 16)
    monkeypatch.setattr(tcp, "MAX_FUSED_ROWS", 16)


MG_KW = dict(n_pre=2, n_post=2, n_coarsest=4)


def _close_mg(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL_MG * np.abs(want).max())


@pytest.mark.parametrize("smooth_lag", ["pair", True, False])
def test_v_cycle_matches_jax(sparse, tpu_path, smooth_lag):
    jt, tt, div, jh, th = sparse
    want = jmg.v_cycle(jt, jh, jnp.asarray(div), jnp.zeros_like(jnp.asarray(div)), DX,
                       OMEGA, smooth_lag=smooth_lag, **MG_KW)
    d = torch.from_numpy(div)
    got = tmg.v_cycle(tt, th, d, torch.zeros_like(d), DX, OMEGA, smooth_lag=smooth_lag,
                      **MG_KW)
    _close_mg(got, want)


@pytest.mark.parametrize("fmg", [True, False], ids=["fmg", "zero_guess"])
def test_solve_pressure_mg_matches_jax(sparse, tpu_path, fmg):
    jt, tt, div, jh, th = sparse
    want = jmg.solve_pressure_mg(jt, jh, jnp.asarray(div), 2, DX, OMEGA, fmg=fmg, **MG_KW)
    got = tmg.solve_pressure_mg(tt, th, torch.from_numpy(div), 2, DX, OMEGA, fmg=fmg,
                                **MG_KW)
    _close_mg(got, want)


def test_solve_pressure_mg_tol_matches_jax(sparse, tpu_path):
    """The tol stop: same cycle count as JAX, and fewer than the cap."""
    jt, tt, div, jh, th = sparse
    tol = 0.05
    want = jmg.solve_pressure_mg(jt, jh, jnp.asarray(div), 6, DX, OMEGA, tol=tol, **MG_KW)
    d = torch.from_numpy(div)
    got = tmg.solve_pressure_mg(tt, th, d, 6, DX, OMEGA, tol=tol, **MG_KW)
    _close_mg(got, want)
    capped = tmg.solve_pressure_mg(tt, th, d, 6, DX, OMEGA, **MG_KW)
    assert not torch.equal(got, capped)
    r = float(tsolver.prs.residual(tt, got, d, DX).abs().max())
    assert r <= tol * float(d.abs().max())


def _jax_state(vel, sc):
    return JState(velocity=jnp.asarray(vel),
                  scalars={k: jnp.asarray(v) for k, v in sc.items()})


def _assert_state_close(tstate, jstate):
    tv, ts = convert.state_to_numpy(tstate)
    want = np.asarray(jstate.velocity)
    np.testing.assert_allclose(tv, want, rtol=0, atol=REL * np.abs(want).max())
    for k, v in ts.items():
        w = np.asarray(jstate.scalars[k])
        np.testing.assert_allclose(v, w, rtol=0, atol=REL * np.abs(w).max(), err_msg=k)


MG_PARAMS = dict(pressure_solver="mg", iterations=2, mg_levels=2, mg_coarsest=8)


@pytest.fixture(scope="module")
def box_state():
    """The 24^3 dense box with a rotational velocity and smoke."""
    jt = jtopo.build_topology_dense((24, 24, 24))
    rng = np.random.default_rng(10)
    T = jt.capacity
    m = np.asarray(jtopo.active_mask(jt))[None, :, None]
    vel = (rng.standard_normal((3, T, 512)) * m).astype(np.float32)
    sc = {k: (rng.random((T, 512)) * m[0] * 0.5).astype(np.float32) for k in NAMES}
    return jt, vel, sc


def test_step_mg_box_matches_jax(box_state):
    jt, vel, sc = box_state
    kw = dict(dt=0.2, **MG_PARAMS)
    jp = jcfg.SolverParams(**kw)
    want = jsolver.step(jt, _jax_state(vel, sc), jp, tuple(jmg.hierarchy_for(jt, jp)))
    tt = _port_topo(jt)
    tp = tcfg.SolverParams(**kw)
    got = tsolver.step(tt, convert.state_from_numpy(vel, sc, device="cpu"), tp,
                       tmg.hierarchy_for(tt, tp))
    _assert_state_close(got, want)


def test_step_mg_without_hierarchy_is_rbgs(box_state):
    """"mg" with an empty hierarchy runs the RBGS solve, as in the JAX
    package (its solver.py:128): the reference's semantics."""
    jt, vel, sc = box_state
    tt = _port_topo(jt)
    st = convert.state_from_numpy(vel, sc, device="cpu")
    a = tsolver.step(tt, st, tcfg.SolverParams(dt=0.2, **MG_PARAMS))
    b = tsolver.step(tt, st, tcfg.SolverParams(dt=0.2, iterations=2))
    assert torch.equal(a.velocity, b.velocity)
    for k in NAMES:
        assert torch.equal(a.scalars[k], b.scalars[k])


def test_plume_frames_mg_match_jax():
    """3 plume frames from rest with the multigrid solver, run_plume's own
    hierarchy against the JAX step with JAX's."""
    jt = jtopo.build_topology(tplume.build_plume_envelope(24, 64, 24, 24))
    kw = dict(dt=1.0 / 24.0, voxel_size=0.5, **MG_PARAMS)
    cfg_kw = dict(center=(24.0, 12.0, 24.0), radius=8.0)
    jp = jcfg.SolverParams(**kw)
    jh = tuple(jmg.hierarchy_for(jt, jp))
    T = jt.capacity
    s = _jax_state(np.zeros((3, T, 512), np.float32),
                   {n: np.zeros((T, 512), np.float32) for n in NAMES})
    frames = []
    for _ in range(3):
        s = jplume.plume_step(jt, s, jp, jplume.PlumeConfig(**cfg_kw), jh)
        frames.append(s)
    got = []
    tplume.run_plume(3, tcfg.SolverParams(**kw), tplume.PlumeConfig(**cfg_kw),
                     topo=_port_topo(jt), grow_every=0,
                     on_frame=lambda f, t, st: got.append(st))
    for st, want in zip(got, frames):
        _assert_state_close(st, want)
    assert float(got[-1].velocity[1].max()) > 0


@pytest.fixture(scope="module")
def vel_field(sparse):
    jt, tt, _, _, _ = sparse
    rng = np.random.default_rng(12)
    m = np.asarray(jtopo.active_mask(jt))[None, :, None]
    return (rng.standard_normal((3, jt.capacity, 512)) * m).astype(np.float32)


@pytest.mark.parametrize("iters,lag,large", [(6, 3, False), (7, 3, False),
                                             (8, 4, True), (9, 4, True)],
                         ids=["small_lag", "small_rem", "large_lag", "large_rem"])
def test_project_matches_jax(sparse, vel_field, monkeypatch, iters, lag, large):
    """``large``: both packages' MAX_FUSED_ROWS below the 64 rows and the
    JAX solve on its Pallas path, so iterations % halo_lag == 0 runs lagged
    blocks (B3) and != 0 the textbook per-colour sweeps (B4) on both sides.
    Each case has its own static arguments: JAX's jit cache must not hand
    one case's trace to another."""
    jt, tt, _, _, _ = sparse
    if large:
        monkeypatch.setattr(jprs, "solve_pressure",
                            functools.partial(jprs.solve_pressure, backend="pallas"))
        monkeypatch.setattr(jpp, "MAX_FUSED_ROWS", 32)
        monkeypatch.setattr(tcp, "MAX_FUSED_ROWS", 32)
    want = np.asarray(jsolver.project(jt, jnp.asarray(vel_field), iters, 0.5, lag))
    got = tsolver.project(tt, torch.from_numpy(vel_field), iters, 0.5, lag).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def test_divergence_only_matches_jax(sparse, vel_field):
    jt, tt, _, _, _ = sparse
    want = np.asarray(jsolver.divergence_only(jt, jnp.asarray(vel_field), 0.5))
    got = tsolver.divergence_only(tt, torch.from_numpy(vel_field), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
