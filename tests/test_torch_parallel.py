"""The port's multi-device step (``hnanosolver_tpu_torch/parallel``) against
the JAX package on the CPU.

- ``build_slabs`` / ``build_boxes`` tables and ``build_slab_hierarchy``'s
  maps are bitwise the JAX package's (host numpy on both sides), and
  ``scatter_state`` stacks to JAX's ``[D, ...]`` arrays bitwise.
- The sharded step over a mesh of ``cpu`` entries (4 slabs; a (2, 2, 2)
  box grid over 8) against JAX's ONE-device ``plume_step`` / ``step`` on the
  JAX tests' topologies (``tests/test_slab.py``, ``tests/test_boxes.py``),
  RBGS, multigrid with FMG on (both sides; the JAX box test pins it off)
  and with ``mg_tol``, at the JAX tests' tolerance (rtol 1e-4, atol 1e-5).
  On the CPU JAX's solve is the textbook per-colour one, which is what the
  sharded step runs. The JAX references run op by op under
  ``jax.disable_jit()`` (no whole-step compile), once per module.
- ``shard_map``'s failure contract: a thread that raises aborts the others
  and its error is re-raised in the caller; devices whose collective calls
  diverge raise.
- The one-device step's solve branches are unchanged (B5 at T <= 2048, B3
  blocks above), and a refresh hook runs the per-colour B4 solve even on a
  256-row slab, with the refresh at the JAX package's points.
"""

import functools
import sys
import threading

import jax
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
from hnanosolver_tpu.parallel import boxes as jboxes
from hnanosolver_tpu.parallel import slab as jslab
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch import solver as tsolver
from hnanosolver_tpu_torch.core.layout import positions_flat
from hnanosolver_tpu_torch.core.topology import active_mask
from hnanosolver_tpu_torch.fields import FieldState
from hnanosolver_tpu_torch.kernels import build as tbuild
from hnanosolver_tpu_torch.models import plume as tplume
from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.ops import multigrid as tmg
from hnanosolver_tpu_torch.parallel import boxes as tboxes
from hnanosolver_tpu_torch.parallel import sharding as tsharding
from hnanosolver_tpu_torch.parallel import slab as tslab
from hnanosolver_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_map

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5  # tests/test_slab.py's and tests/test_boxes.py's
NAMES = ("density", "temperature", "fuel", "waste", "flame")
GRIDS = ((2, 2, 2), (4, 2, 1), (1, 2, 4))
RBGS = dict(dt=0.2, iterations=4, voxel_size=0.5)
MG = dict(dt=0.2, iterations=2, voxel_size=0.5, pressure_solver="mg", mg_levels=1,
          mg_coarsest=4, mg_fmg=True)
# max|r| / max|div| reads 0.00439, 0.00300 after V-cycles 2 and 3 of this
# step (slab domain): the stop comes after 3 of the cap of 6, 17% clear of
# the bound on either side
MG_TOL = dict(MG, iterations=6, mg_tol=0.0036)
SOLVERS = {"rbgs": RBGS, "mg": MG, "mg_tol": MG_TOL}
JOIN_S = 60  # seconds a shard_map call of the failure tests may take
CAPACITY = 512  # both domains' (197 and 371 tiles)


def _slab_tiles():
    """tests/test_slab.py's _random_sparse_topology with its rng: a sparse
    topology over 16 x tile-layers (197 tiles)."""
    rng = np.random.default_rng(0)
    tiles = [(x, y, z) for x in range(16) for y in range(4) for z in range(4)
             if rng.random() < 0.75 or (y < 2 and z < 2)]
    return np.array(tiles, np.int32), rng, (40.0, 12.0, 12.0), 40.0


def _box_tiles():
    """tests/test_boxes.py's _sparse_box_topology with its rng (8^3 layers)."""
    rng = np.random.default_rng(0)
    tiles = [(x, y, z) for x in range(8) for y in range(8) for z in range(8)
             if rng.random() < 0.7 or (x < 2 and y < 2 and z < 2)]
    return np.array(tiles, np.int32), rng, (24.0, 24.0, 24.0), 60.0


@functools.lru_cache(maxsize=None)
def _domain(kind: str):
    """(JAX topology, port topology, numpy velocity, numpy scalars, emitter
    centre): the JAX tests' _demo_state made with numpy, so that both
    packages step the same values."""
    tiles, rng, c, width = _slab_tiles() if kind == "slab" else _box_tiles()
    # one capacity for both domains: JAX's op-by-op reference then compiles
    # each fine-level op once, not once a domain
    jt = jtopo.build_topology(tiles, capacity=CAPACITY)
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    px, py, pz = (p.to(torch.float32).numpy() for p in positions_flat(tt))
    m = active_mask(tt).numpy()[:, None]
    blob = (np.exp(-((px - c[0]) ** 2 + (py - c[1]) ** 2 + (pz - c[2]) ** 2) / width) * m)
    vel = (rng.standard_normal((3, tt.capacity, 512)).astype(np.float32) * 0.3) * m[None]
    zero = np.zeros_like(blob, np.float32)
    sc = {"density": blob.astype(np.float32),
          "temperature": ((23.0 + 40.0 * blob) * m).astype(np.float32),
          "fuel": (0.4 * blob).astype(np.float32), "waste": zero, "flame": zero}
    return jt, tt, vel, sc, c


def _port_state(kind: str) -> FieldState:
    _, _, vel, sc, _ = _domain(kind)
    return FieldState(velocity=torch.from_numpy(vel.copy()),
                      scalars={k: torch.from_numpy(v.copy()) for k, v in sc.items()})


def _jax_state(kind: str) -> JState:
    _, _, vel, sc, _ = _domain(kind)
    return JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})


def _decompose(kind: str, jt, tt):
    if kind == "slab":
        return jslab.build_slabs(jt, 4), tslab.build_slabs(tt, 4)
    return jboxes.build_boxes(jt, (2, 2, 2)), tboxes.build_boxes(tt, (2, 2, 2))


@functools.lru_cache(maxsize=None)
def _jax_step(kind: str, solver: str):
    """JAX's one-device step, op by op: the plume step for RBGS, ``step``
    with the global hierarchy for multigrid (the JAX tests' pairing)."""
    jt, _, _, _, c = _domain(kind)
    params = jcfg.SolverParams(**SOLVERS[solver])
    with jax.disable_jit():
        if solver == "rbgs":
            out = jplume.plume_step(jt, _jax_state(kind), params,
                                    jplume.PlumeConfig(center=c, radius=6.0))
        else:
            hier = tuple(jmg.build_hierarchy(jt, params.mg_levels))
            out = jsolver.step(jt, _jax_state(kind), params, hier)
        return np.asarray(out.velocity), {k: np.asarray(v) for k, v in out.scalars.items()}


def _leaves(x):
    """A JAX or port decomposition's leaves as numpy arrays."""
    leaves = x.tree_flatten()[0]
    return [np.asarray(a) for a in leaves]


@pytest.mark.parametrize("grid", ["slab"] + [f"{g[0]}{g[1]}{g[2]}" for g in GRIDS])
def test_decomposition_tables_equal_jax(grid):
    """Every leaf (keys, origins, nbr, n_rows, local_mask, exchange maps)
    bitwise, and the boxes' static (source, target) pairs equal."""
    kind = "slab" if grid == "slab" else "box"
    jt, tt, _, _, _ = _domain(kind)
    if grid == "slab":
        js, ts = jslab.build_slabs(jt, 4), tslab.build_slabs(tt, 4)
    else:
        g = tuple(int(c) for c in grid)
        js, ts = jboxes.build_boxes(jt, g), tboxes.build_boxes(tt, g)
        assert ts.perms == js.perms and ts.grid == tuple(js.grid)
    want, got = _leaves(js), _leaves(ts)
    assert len(got) == len(want)
    for i, (g_, w) in enumerate(zip(got, want)):
        assert g_.dtype == w.dtype and np.array_equal(g_, w), f"leaf {i}"
    # the null row is never a recv target; unused recv slots go to the trash
    # row, past every row in use
    recv = np.concatenate([x.ravel() for x in got[5:][2::4] + got[5:][3::4]])
    trash = ts.capacity - 1
    assert recv.min() >= 1 and recv.max() == trash
    assert trash >= int(ts.n_rows.max())


@pytest.mark.parametrize("kind", ["slab", "box"])
def test_slab_hierarchy_equals_jax(kind):
    jt, tt, _, _, _ = _domain(kind)
    js, ts = _decompose(kind, jt, tt)
    jh = jslab.build_slab_hierarchy(jt, js, 1)
    th = tslab.build_slab_hierarchy(tt, ts, 1)
    for name in ("children_local", "parent_global", "octant_local"):
        assert np.array_equal(getattr(th, name).numpy(), np.asarray(getattr(jh, name))), name
    assert np.array_equal(th.coarse_level.topo.keys.numpy(), np.asarray(jh.coarse_level.topo.keys))
    assert np.array_equal(th.coarse_level.mask.numpy(), np.asarray(jh.coarse_level.mask))


@pytest.mark.parametrize("kind", ["slab", "box"])
def test_scatter_gather_round_trip(kind):
    """scatter_state stacks to JAX's [D, ...] layout bitwise, each block on
    its mesh device; gather_state(scatter_state(s)) == s on active rows,
    with the null and padding rows 0."""
    jt, tt, _, _, _ = _domain(kind)
    js, ts = _decompose(kind, jt, tt)
    state = _port_state(kind)
    mesh = make_mesh(ts.n_devices, device="cpu")
    blocks = tslab.scatter_state(tt, ts, state, mesh)
    want = jslab.scatter_state(jt, js, _jax_state(kind))
    assert len(blocks) == ts.n_devices
    assert np.array_equal(torch.stack([b.velocity for b in blocks]).numpy(),
                          np.asarray(want.velocity))
    for k in NAMES:
        assert np.array_equal(torch.stack([b.scalars[k] for b in blocks]).numpy(),
                              np.asarray(want.scalars[k])), k
    back = tslab.gather_state(tt, ts, blocks)
    m = active_mask(tt)[:, None]
    assert torch.equal(back.velocity, state.velocity * m[None])
    for k in NAMES:
        assert torch.equal(back.scalars[k], state.scalars[k] * m), k


def _sharded(kind: str, solver: str):
    """The port's sharded step of ``kind`` and ``solver`` over a mesh of cpu
    entries, gathered: (velocity, scalars) as numpy."""
    jt, tt, _, _, c = _domain(kind)
    _, ts = _decompose(kind, jt, tt)
    params = tcfg.SolverParams(**SOLVERS[solver])
    mesh = make_mesh(ts.n_devices, device="cpu")
    if solver == "rbgs":
        fn = tslab.sharded_plume_step(mesh, ts, params, tplume.PlumeConfig(center=c, radius=6.0))
    else:
        fn = tslab.sharded_step(mesh, ts, params,
                                hierarchy=tslab.build_slab_hierarchy(tt, ts, params.mg_levels))
    out = tslab.gather_state(tt, ts, fn(ts, tslab.scatter_state(tt, ts, _port_state(kind), mesh)))
    return out.velocity.numpy(), {k: v.numpy() for k, v in out.scalars.items()}


@pytest.mark.parametrize("kind,solver", [("slab", "rbgs"), ("slab", "mg"), ("slab", "mg_tol"),
                                         ("box", "rbgs"), ("box", "mg")])
def test_sharded_step_matches_jax_one_device(kind, solver):
    """4 slabs / a (2,2,2) box grid against JAX's one-device step, every
    field on the active rows at the JAX tests' tolerance."""
    want_v, want_s = _jax_step(kind, solver)
    got_v, got_s = _sharded(kind, solver)
    m = active_mask(_domain(kind)[1]).numpy().astype(bool)
    assert np.abs(want_v[:, m]).max() > 0.1
    np.testing.assert_allclose(got_v[:, m], want_v[:, m], rtol=RTOL, atol=ATOL)
    for k in want_s:
        np.testing.assert_allclose(got_s[k][m], want_s[k][m], rtol=RTOL, atol=ATOL, err_msg=k)


def test_mg_tol_stops_early_and_together(monkeypatch):
    """The mg_tol case stops before its cap, on the same cycle on every
    slab (tol_reduce is a mesh-wide max), and on the cycle the one-device
    solve stops on."""
    cycles = {}
    real = tmg.v_cycle

    def spy(topo, *a, **k):
        if k.get("refresh") is not None or topo.capacity == CAPACITY:  # fine-level calls
            key = threading.current_thread().name
            cycles[key] = cycles.get(key, 0) + 1
        return real(topo, *a, **k)

    monkeypatch.setattr(tmg, "v_cycle", spy)
    _sharded("slab", "mg_tol")
    sharded = dict(cycles)
    cycles.clear()
    _, tt, _, _, _ = _domain("slab")
    params = tcfg.SolverParams(**MG_TOL)
    tsolver.step(tt, _port_state("slab"), params, tmg.hierarchy_for(tt, params))
    one = list(cycles.values())
    # FMG's fine V-cycle is one of the counted calls
    assert len(sharded) == 4 and len(set(sharded.values())) == 1
    assert one == [next(iter(sharded.values()))] == [1 + 3]


def test_make_sharded_step_equals_the_slab_path():
    """sharding.make_sharded_step (the slab path behind the JAX API) on a
    whole state and on shard_state's row blocks: both the gathered slab
    step, the state on the topology's device."""
    jt, tt, _, _, c = _domain("slab")
    params, cfg = tcfg.SolverParams(**RBGS), tplume.PlumeConfig(center=c, radius=6.0)
    mesh = make_mesh(4, device="cpu")
    run = tsharding.make_sharded_step(mesh, params, cfg)
    whole = run(tt, _port_state("slab"))
    rows = run(tt, tsharding.shard_state(mesh, _port_state("slab")))
    want_v, want_s = _sharded("slab", "rbgs")
    for got in (whole, rows):
        assert got.velocity.device == tt.device
        assert np.array_equal(got.velocity.numpy(), want_v)
        for k in NAMES:
            assert np.array_equal(got.scalars[k].numpy(), want_s[k]), k
    blocks = tsharding.shard_state(mesh, _port_state("slab"))
    assert [b.velocity.shape[1] for b in blocks] == [tt.capacity // 4] * 4
    assert len(tsharding.shard_topology(mesh, tt)) == 4


# -- shard_map: failures and collectives ------------------------------------


def _in_thread(fn):
    """Run ``fn`` in a thread joined with a timeout; return what it raised
    (or None) after checking that it ended."""
    out = {}

    def body():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out["error"] = e

    t = threading.Thread(target=body)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "shard_map hung"
    return out.get("error")


@pytest.mark.parametrize("where", ["before_a_collective", "between_collectives", "in_the_step"])
def test_a_failing_thread_aborts_the_others_and_reraises(where):
    mesh = make_mesh(4, device="cpu")
    threads_before = threading.active_count()

    class Boom(Exception):
        pass

    if where == "in_the_step":
        jt, tt, _, _, _ = _domain("slab")
        ts = tslab.build_slabs(tt, 4)
        calls = []

        def emit_fn(topo, state):
            calls.append(topo.capacity)
            if len(calls) == 3:
                raise Boom("emit failed on one device")
            return state

        fn = tslab.sharded_step(mesh, ts, tcfg.SolverParams(**RBGS), emit_fn=emit_fn)
        err = _in_thread(lambda: fn(ts, tslab.scatter_state(tt, ts, _port_state("slab"), mesh)))
    else:
        def body(axis):
            if where == "between_collectives":
                axis.psum(torch.ones(3))
            if axis.rank == 2:
                raise Boom(f"rank {axis.rank}")
            axis.psum(torch.ones(3))
            return axis.rank

        err = _in_thread(lambda: shard_map(body, mesh))
    assert isinstance(err, Boom)
    assert threading.active_count() == threads_before


def test_diverging_collectives_raise():
    def body(axis):
        axis.psum(torch.ones(1))
        if axis.rank == 0:
            axis.pmax(torch.ones(1))  # a call the others do not make
        return axis.rank

    err = _in_thread(lambda: shard_map(body, make_mesh(3, device="cpu")))
    assert isinstance(err, RuntimeError) and "diverged" in str(err)


@pytest.mark.parametrize("case", ["collectives", "launch_counter"])
def test_under_contention(case):
    """16 threads on few cores, the interpreter switching threads every
    microsecond. collectives: 200 rounds of psum, pmax and a ring ppermute
    under shard_map, each round's values distinct (a slot overwritten
    before it was read shows). launch_counter: plain threads (the sharded
    step's launch from several) adding to one LaunchCount lose no update."""
    n, rounds = 16, 200
    counter = tbuild.LaunchCount("stress")

    def body(axis):
        ring = tuple((i, (i + 1) % n) for i in range(n))
        for r in range(rounds):
            x = torch.tensor([float(r * n + axis.rank)])
            s, mx = axis.psum(x), axis.pmax(x)
            (left,) = axis.ppermute((x,), (ring,))
            assert s.item() == sum(r * n + i for i in range(n))
            assert mx.item() == r * n + n - 1
            assert left.item() == r * n + (axis.rank - 1) % n
        return axis.rank

    def add_many():
        for _ in range(20 * rounds):
            counter.add()

    def run():
        if case == "collectives":
            assert shard_map(body, Mesh(("cpu",) * n)) == list(range(n))
            return
        threads = [threading.Thread(target=add_many) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        err = _in_thread(run)
    finally:
        sys.setswitchinterval(old)
    assert err is None
    if case == "launch_counter":
        assert counter.n == n * 20 * rounds


# -- the one-device step's solve branches, and the refresh hook's -----------


def _spy_solvers(monkeypatch) -> dict:
    calls = {}
    for name, arg in (("fused", 2), ("lagged", 3), ("color", 3)):
        fn = getattr(tcp, f"rbsor_{name}")

        def spy(*a, _fn=fn, _name=name, _arg=arg, **k):
            calls.setdefault(_name, []).append(a[_arg])
            return _fn(*a, **k)

        monkeypatch.setattr(tcp, f"rbsor_{name}", spy)
    return calls


@pytest.mark.parametrize("case", ["no_hooks_B5", "no_hooks_B3", "refresh_B4", "slab_of_256"])
def test_solve_branch_of_the_step(monkeypatch, case):
    """Without hooks step_impl solves by B5 at T <= MAX_FUSED_ROWS and by
    B3 blocks above it (iterations 10 at halo_lag 5: two blocks of 5). A
    refresh hook (any function but the identity the step defaults to) runs
    textbook colour sweeps, refresh before each, even where B5 would fit:
    the 256-row slab of a one-device mesh, through the real exchange."""
    _, tt, _, _, c = _domain("slab")
    params = tcfg.SolverParams(**dict(RBGS, iterations=10))
    calls = _spy_solvers(monkeypatch)
    refreshes = []
    if case == "no_hooks_B3":
        monkeypatch.setattr(tcp, "MAX_FUSED_ROWS", 64)
    if case == "slab_of_256":
        ts = tslab.build_slabs(tt, 1)
        assert ts.capacity == 256
        mesh = make_mesh(1, device="cpu")
        tslab.sharded_step(mesh, ts, params)(ts, tslab.scatter_state(tt, ts, _port_state("slab")))
    elif case == "refresh_B4":
        def refresh(f):
            refreshes.append(tuple(f.shape))
            return f

        tsolver.step_impl(tt, _port_state("slab"), params, refresh=refresh)
    else:
        tsolver.step_impl(tt, _port_state("slab"), params)
    want = {"no_hooks_B5": {"fused": [10]}, "no_hooks_B3": {"lagged": [5, 5]}}.get(
        case, {"color": [0, 1] * 10})
    assert calls == want
    if case == "refresh_B4":
        # JAX's points: u* after advection and after vorticity, div, p, u*,
        # vel_out, each of the 5 scalars, and p before each colour sweep
        assert len(refreshes) == 6 + len(NAMES) + 2 * 10
