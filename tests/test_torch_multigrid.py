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
from hnanosolver_tpu_torch.core.topology import build_topology
from hnanosolver_tpu_torch.models import plume as tplume
from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.ops import cuda_transfer as tcu
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


# -- the transfer kernels MR and MP (ops/cuda_transfer.py) -----------------------
# The kernels run on the card only; here their wrappers run the plain
# versions, and the kernels' own indexing (csrc/mg_transfer.cu), written
# below in torch, is held bitwise to the plain chains on fields that are
# random on every row (the null and padding rows too).

def _planted():
    """Level 1 of a domain whose coarse tile A = (0,0,0) has its +y and +z
    face neighbours absent while the corner tile (0,1,1) beyond them exists
    (the fine tiles: A's 8 children and one child of the corner), with
    padding rows at both levels."""
    fine = np.array([(x, y, z) for x in range(2) for y in range(2) for z in range(2)]
                    + [(0, 2, 2), (1, 3, 3)])
    tt = build_topology(fine, device="cpu")
    return tt, tmg.build_hierarchy(tt, 1)[0]


def _restrict_by_blocks(children, fine):
    """MR's indexing: coarse lane (ox*4+a, oy*4+b, oz*4+c) of row t is the
    block sum of child children[t, o] at (2a, 2b, 2c), pairs along z, then y,
    then x, times 0.125."""
    Tc = children.shape[0]
    f = fine[children.reshape(-1).long()].reshape(Tc, 8, 8, 8, 8)

    def at(dx, dy, dz):
        return f[:, :, dx::2, dy::2, dz::2]

    s = (((at(0, 0, 0) + at(0, 0, 1)) + (at(0, 1, 0) + at(0, 1, 1)))
         + ((at(1, 0, 0) + at(1, 0, 1)) + (at(1, 1, 0) + at(1, 1, 1)))) * 0.125
    # [Tc, (ox, oy, oz), a, b, c] -> coarse lane (ox, a, oy, b, oz, c)
    return s.reshape(Tc, 2, 2, 2, 4, 4, 4).permute(0, 1, 4, 2, 5, 3, 6).reshape(Tc, 512)


def _prolong_by_neighbourhood(parent, octant, nbr, coarse):
    """MP's indexing: each fine row's 8 chain tiles (a face step off the
    octant's side of its parent, z, then y, then x), the coarse 6^3
    neighbourhood of its octant block through them, then 0.75/0.25 along
    x, y and z in turn."""
    Tf = parent.shape[0]
    P, o, nbr = parent.long(), octant.long(), nbr.long()
    ox, oy, oz = (o >> 2) & 1, (o >> 1) & 1, o & 1
    steps = (torch.where(oz == 1, 14, 12), torch.where(oy == 1, 16, 10),
             torch.where(ox == 1, 22, 4))
    tiles = []
    for k in range(8):
        t = P
        for bit, d in zip((4, 2, 1), steps):
            if k & bit:
                t = nbr[t, d]
        tiles.append(t)
    tiles = torch.stack(tiles, 1)  # [Tf, 8], entry zo*4 + yo*2 + xo
    r = torch.arange(6)
    cx = (ox[:, None] * 4 - 1 + r)[:, :, None, None]
    cy = (oy[:, None] * 4 - 1 + r)[:, None, :, None]
    cz = (oz[:, None] * 4 - 1 + r)[:, None, None, :]
    out_of = ((cz < 0) | (cz > 7)) * 4 + ((cy < 0) | (cy > 7)) * 2 + ((cx < 0) | (cx > 7))
    tile = tiles.gather(1, out_of.reshape(Tf, -1)).reshape(Tf, 6, 6, 6)
    nb = coarse[tile, (cx & 7) * 64 + (cy & 7) * 8 + (cz & 7)]  # [Tf, 6, 6, 6]
    v = torch.arange(8)
    c0, s = v // 2 + 1, torch.where(v % 2 == 1, 1, -1)

    def F(dx, dy, dz):  # each 0 or 1: a step toward the voxel's parity side
        return nb[:, (c0 + dx * s)[:, None, None], (c0 + dy * s)[None, :, None],
                  (c0 + dz * s)[None, None, :]]

    def lerp(a, b):
        return 0.75 * a + 0.25 * b

    x = {(j, k): lerp(F(0, j, k), F(1, j, k)) for j in (0, 1) for k in (0, 1)}
    y = {k: lerp(x[0, k], x[1, k]) for k in (0, 1)}
    return lerp(y[0], y[1]).reshape(Tf, 512)


def _transfer_case(case, sparse):
    """(level, fine rows) of a case: the sparse domain's levels 1-2, the
    planted level."""
    if case == "planted":
        tt, lvl = _planted()
        return lvl, tt.capacity
    _, tt, _, _, th = sparse
    k = int(case[-1])
    return th[k - 1], (tt.capacity if k == 1 else th[0].topo.capacity)


@pytest.mark.parametrize("op", ["restrict", "prolong_trilinear"])
@pytest.mark.parametrize("case", ["sparse_l1", "sparse_l2", "planted"])
def test_transfer_kernel_indexing_equals_plain(sparse, monkeypatch, case, op):
    """The kernels' indexing, bitwise the plain chains (merged and sequential
    forms alike), every row random: the null row and padding rows included."""
    lvl, Tf = _transfer_case(case, sparse)
    rng = np.random.default_rng(13)
    if op == "restrict":
        x = torch.from_numpy(rng.standard_normal((Tf, 512)).astype(np.float32))
        want = tmg.restrict_plain(lvl, x)
        assert torch.equal(_restrict_by_blocks(lvl.children, x), want)
        return
    x = torch.from_numpy(rng.standard_normal((lvl.topo.capacity, 512)).astype(np.float32))
    got = _prolong_by_neighbourhood(lvl.parent, lvl.octant, lvl.topo.nbr, x)
    for budget in (1 << 60, 0):
        monkeypatch.setattr(tmg, "PROLONG_MERGE_BUDGET", budget)
        assert torch.equal(got, tmg.prolong_trilinear_plain(lvl, x))


@pytest.mark.parametrize("form", ["plain", "fine_mask", "coarse_mask", "both_masks",
                                  "add", "fmg", "fmg_mask"])
def test_transfer_wrappers_equal_plain(sparse, form):
    """On CPU tensors the wrappers (and multigrid's entries) are the plain
    chains with the fused masks and the add as separate ops."""
    _, tt, _, _, th = sparse
    lvl, Tf, Tc = th[0], tt.capacity, th[0].topo.capacity
    rng = np.random.default_rng(14)

    def rand(rows, mask=False):
        a = rng.standard_normal((rows, 512)) if not mask else rng.random((rows, 512)) > 0.3
        return torch.from_numpy(a.astype(np.float32))

    if form in ("plain", "fine_mask", "coarse_mask", "both_masks"):
        fine = rand(Tf)
        fm = rand(Tf, True) if form in ("fine_mask", "both_masks") else None
        cm = rand(Tc, True) if form in ("coarse_mask", "both_masks") else None
        want = tmg.restrict_plain(lvl, fine if fm is None else fine * fm)
        want = want if cm is None else want * cm
        assert torch.equal(tmg.restrict(lvl, fine, fm, cm), want)
        assert torch.equal(tcu.restrict(lvl.children, fine, fm, cm), want)
        return
    coarse = rand(Tc)
    p = rand(Tf) if form == "add" else None
    m = rand(Tf, True) if form == "fmg_mask" else None
    want = tmg.prolong_trilinear_plain(lvl, coarse)
    want = want if p is None else p + want
    want = want if m is None else want * m
    assert torch.equal(tmg.prolong_trilinear(lvl, coarse, p, m), want)
    assert torch.equal(tcu.prolong_trilinear(lvl.parent, lvl.octant, lvl.topo.nbr, coarse, p,
                                             m), want)


def test_prolong_through_an_absent_face_tile_reads_zero():
    """A coarse value beyond a corner is reached through the face tiles: with
    the face tiles absent, the corner tile's values do not reach A's fine
    tiles although the nbr table's corner entry names it."""
    tt, lvl = _planted()
    keys = [tuple(o) for o in lvl.topo.origins.tolist()]
    a, corner = keys.index((0, 0, 0)), keys.index((0, 1, 1))
    assert int(lvl.topo.nbr[a, 1 * 9 + 2 * 3 + 2]) == corner  # the corner entry exists
    assert int(lvl.topo.nbr[a, 16]) == 0 and int(lvl.topo.nbr[a, 14]) == 0  # +y, +z absent
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((lvl.topo.capacity, 512)).astype(np.float32))
    x[0] = 0.0
    x[lvl.topo.n_active + 1:] = 0.0
    y = x.clone()
    y[corner] = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    ex, ey = tmg.prolong_trilinear_plain(lvl, x), tmg.prolong_trilinear_plain(lvl, y)
    in_a = lvl.parent == a
    assert int(in_a.sum()) == 8
    assert torch.equal(ex[in_a], ey[in_a])
    assert not torch.equal(ex[lvl.parent == corner], ey[lvl.parent == corner])


def test_prolong_rows_of_parent_zero_read_coarse_row_zero(sparse):
    """Fine rows with parent 0 (the null row, padding rows) get coarse row
    0's octant-0 view, as the plain gather gives it: nonzero where row 0 is."""
    _, tt, _, _, th = sparse
    lvl = th[0]
    zero = (lvl.parent == 0).nonzero()[:, 0]
    assert zero.numel() > 1 and int(zero[0]) == 0  # the null row and padding rows
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((lvl.topo.capacity, 512)).astype(np.float32))
    e = tmg.prolong_trilinear_plain(lvl, x)
    assert bool((e[zero] == e[0]).all()) and bool(e[0].abs().max() > 0)
    x[0] = 0.0
    assert bool(tmg.prolong_trilinear_plain(lvl, x)[zero].abs().max() < e[0].abs().max())
