"""The port's own spans and counts (``utils/profiling.py``) on the CPU: the
phases of a frame, collision's refresh and passes, multigrid's transfers
and the growth pass under a CPU ``torch.profiler``; nothing recorded, no
range opened and nothing allocated without one; the growth and collision
counts against a count taken by hand; the launch counters' context."""

import collections
import contextlib
import sys
import threading
import time
import timeit
import tracemalloc

import pytest
import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core import activation
from hnanosolver_tpu_torch.fields import COLLISION_FIELD
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.models import collider, plume
from hnanosolver_tpu_torch.ops import collision, cuda_stencil, stencil
from hnanosolver_tpu_torch.ops.multigrid import hierarchy_for
from hnanosolver_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = plume.PlumeConfig(center=(32.0, 8.0, 32.0), radius=6.0)
RBGS = SolverParams(iterations=4, has_collision=True)
MG = SolverParams(pressure_solver="mg", iterations=1, mg_levels=2, mg_fmg=True)
PHASES = ("step.emit", "step.collide", "step.advect_velocity", "step.forces", "step.pressure",
          "step.project", "step.advect_scalars", "step.mask")
GROWTH = ("grow.occupancy", "grow.rebuild", "grow.remap", "grow.hierarchy")
FRAME = "plume.step"
# collide.enforce's parents in a frame with an SDF: the collide phase, the
# velocity advection's tail and the projection's two passes
ENFORCE_PARENTS = ["step.collide", "step.advect_velocity", "step.project", "step.project"]
TOL_NS = 50_000  # a record's host start and end against its profiler event


@pytest.fixture(autouse=True)
def _clean():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def start():
    """The toy emitter's topology and a state one frame on, with a collision
    SDF that leaves the whole domain free."""
    topo = plume.initial_topology(CFG, device="cpu")
    state = plume.plume_step(topo, plume.initial_state(topo), SolverParams(iterations=4), CFG)
    scalars = dict(state.scalars)
    scalars[COLLISION_FIELD] = torch.full_like(scalars["density"], 10.0)
    return topo, type(state)(velocity=state.velocity, scalars=scalars)


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _ancestors(r):
    out = []
    while r.parent is not None:
        r = r.parent
        out.append(r.name)
    return out


def _check_clock(prof, recs):
    """Each record's host start and end within TOL_NS of its profiler
    event (the same name, in the same order)."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    names = {r.name for r in recs}
    events = collections.defaultdict(list)
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name in names:
            events[e.name].append(e)
    mine = collections.defaultdict(list)
    for r in recs:
        mine[r.name].append(r)
    for name, rs in mine.items():
        assert len(events[name]) == len(rs), name
        for r, e in zip(rs, events[name]):
            assert abs(r.start_ns - t0 - e.time_range.start * 1e3) < TOL_NS, name
            assert abs(r.end_ns - t0 - e.time_range.end * 1e3) < TOL_NS, name


def test_a_frame_is_its_phase_spans(start):
    topo, state = start
    _, prof = _profiled(lambda: plume.plume_step(topo, state, RBGS, CFG))
    recs = profiling.records()
    frames = [r for r in recs if r.name == FRAME]
    assert len(frames) == 1 and frames[0].parent is None
    phases = [r for r in recs if r.name.startswith("step.")]
    assert [r.name for r in phases] == list(PHASES)
    assert all(r.parent is frames[0] for r in phases)
    # the SDF's four collision passes, each under its phase
    enforce = [r for r in recs if r.name == "collide.enforce"]
    assert [r.parent.name for r in enforce] == ENFORCE_PARENTS
    assert len(recs) == 1 + len(PHASES) + len(ENFORCE_PARENTS)
    for r in recs[1:]:
        assert r.frame == frames[0].frame and r.attrs == {}
        assert r.host_ms >= 0 and r.device_ms is None  # no card: host spans alone
    _check_clock(prof, recs)
    # the phases partition the frame: they lie inside it, one after another
    assert frames[0].start_ns <= phases[0].start_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    assert phases[-1].end_ns <= frames[0].end_ns


def test_multigrid_transfers_carry_their_level(start):
    topo, state = start
    state = type(state)(velocity=state.velocity,
                        scalars={k: v for k, v in state.scalars.items() if k != COLLISION_FIELD})
    hier = hierarchy_for(topo, MG)
    assert len(hier) == 2
    _, prof = _profiled(lambda: plume.plume_step(topo, state, MG, CFG, hier))
    recs = profiling.records()
    assert "step.collide" not in {r.name for r in recs}  # no SDF
    mg = [r for r in recs if r.name.startswith("mg.")]
    # the FMG start restricts to levels 1 and 2 and prolongs from 2 and 1, with
    # a V-cycle from level 1 (one transfer each at level 2) and one from level
    # 0 (one each at both levels); then the frame's one V-cycle from level 0
    by = collections.Counter((r.name, r.attrs["level"]) for r in mg)
    assert by == {("mg.restrict", 1): 3, ("mg.restrict", 2): 4,
                  ("mg.prolong", 1): 3, ("mg.prolong", 2): 4}
    for r in mg:
        assert set(r.attrs) == {"level"} and "step.pressure" in _ancestors(r)
        assert _ancestors(r)[-1] == FRAME
    _check_clock(prof, recs)


def test_a_grown_cook_spans_and_counts_its_growth(start):
    topo = plume.initial_topology(CFG, device="cpu")
    kept = []

    def on_frame(f, t, s):
        kept.append(t)

    passes, discarded = activation.passes.n, activation.discarded.n
    _, prof = _profiled(lambda: plume.run_plume(3, RBGS, CFG, topo=topo, on_frame=on_frame))
    recs = profiling.records()
    # by hand: a pass whose topology is the one before it was discarded
    by_hand = sum(t is prev for prev, t in zip([topo] + kept[:-1], kept))
    assert activation.passes.n - passes == 3
    assert activation.discarded.n - discarded == by_hand
    names = collections.Counter(r.name for r in recs)
    assert names[FRAME] == 3
    assert names["grow.occupancy"] == names["grow.rebuild"] == 3
    assert names["grow.remap"] == names["grow.hierarchy"] == 3 - by_hand >= 1
    assert set(PHASES) - {"step.collide"} <= set(names)  # no SDF in run_plume's state
    frame = None
    for r in recs:
        if r.name == FRAME:
            frame = r.frame
        elif r.name in GROWTH:  # after the step of its frame, under no span
            assert r.frame == frame and r.parent is None
        else:
            assert r.frame == frame and FRAME in _ancestors(r), r
    assert sorted({r.frame for r in recs}) == list(range(frame - 2, frame + 1))
    _check_clock(prof, recs)


def _fire_cook():
    from hnanosolver_tpu_torch.models import fire

    cfg = fire.FireConfig(center=(12.0, 8.0, 12.0), radius=7.0, height=3.0)
    fire.run_fire(2, fire.default_params().replace(iterations=4), cfg, device="cpu")


def _collider_cook():
    from hnanosolver_tpu_torch.models import collider

    col = collider.ColliderConfig(center0=(20.0, 30.0, 24.0), velocity=(48.0, 0.0, 0.0),
                                  radius=5.0)
    collider.run_collider(2, SolverParams(iterations=4),
                          plume.PlumeConfig(center=(24.0, 12.0, 24.0), radius=8.0), col,
                          device="cpu")


def _solve_cook(tmp_path):
    import numpy as np

    from hnanosolver_tpu_torch.io.vdb import VdbGrid, write_vdb
    from hnanosolver_tpu_torch.models import solve

    ijk = np.stack(np.meshgrid(*([np.arange(8)] * 3), indexing="ij"), -1).reshape(512, 3)
    org = (np.stack(np.meshgrid(*([np.arange(2)] * 3), indexing="ij"), -1).reshape(-1, 3)
           * 8).astype(np.int32)
    blob = np.exp(-(((org[:, None, :] + ijk[None]) - [8, 6, 8]) ** 2).sum(-1) / 12.0)
    vel = np.zeros((3, len(org), 512), np.float32)
    vel[1] = 1.5
    write_vdb(str(tmp_path / "feedback.vdb"), [
        VdbGrid("density", org, blob.astype(np.float32), 0.5, grid_class="fog volume"),
        VdbGrid("velocity", org, vel, 0.5, grid_class="staggered")])
    write_vdb(str(tmp_path / "source.vdb"), [
        VdbGrid("density", org, (0.5 * blob).astype(np.float32), 0.5)])
    inp = solve.load_inputs(str(tmp_path / "feedback.vdb"), str(tmp_path / "source.vdb"))
    solve.run_solve(inp, SolverParams(iterations=4), 2, warn=lambda m: None, device="cpu")


@pytest.mark.parametrize("model, cook", [("fire", _fire_cook), ("collider", _collider_cook),
                                         ("solve", _solve_cook)])
def test_every_models_cook_gives_each_frame_its_id(model, cook, tmp_path):
    """fire, collider and solve open their own frame span, as plume does: a
    two-frame cook holds two frame ids, each frame's emit and phase spans
    under it and its growth spans after it."""
    args = (tmp_path,) if model == "solve" else ()
    _, prof = _profiled(lambda: cook(*args))
    recs = profiling.records()
    name = f"{model}.step"
    frames = [r for r in recs if r.name == name]
    assert len(frames) == 2 and all(r.parent is None for r in frames)
    assert frames[1].frame == frames[0].frame + 1
    assert sorted({r.frame for r in recs}) == [r.frame for r in frames]
    for r in recs:
        if r.name in GROWTH:
            assert r.parent is None
        elif r.name != name:
            assert name in _ancestors(r), r
    for f in frames:
        mine = [r.name for r in recs if r.frame == f.frame and r.name.startswith("step.")]
        assert mine[0] == "step.emit" and set(PHASES) - {"step.collide"} <= set(mine)
        assert ("step.collide" in mine) == (model == "collider")
        assert [r.name for r in recs if r.frame == f.frame and r.name in GROWTH][:2] == [
            "grow.occupancy", "grow.rebuild"]
    _check_clock(prof, recs)


def test_no_profiler_no_record_no_range(start, monkeypatch):
    topo, state = start
    calls = collections.Counter()

    def counting(name, real):
        def make(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return make

    monkeypatch.setattr(profiling, "RANGE", counting("range", profiling.RANGE))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting("record_function", torch.profiler.record_function))
    monkeypatch.setattr(torch.cuda, "is_available", counting("cuda", torch.cuda.is_available))
    monkeypatch.setattr(torch.cuda, "Event", counting("event", torch.cuda.Event))
    plume.run_plume(2, RBGS, CFG, topo=plume.initial_topology(CFG, device="cpu"))
    plume.plume_step(topo, state, RBGS, CFG)
    assert profiling.records() == [] and not calls
    with profiling.force(False):
        _profiled(lambda: plume.plume_step(topo, state, RBGS, CFG))
    assert profiling.records() == [] and not calls
    _profiled(lambda: plume.plume_step(topo, state, RBGS, CFG))
    assert calls["range"] == len(profiling.records()) == 1 + len(PHASES) + len(ENFORCE_PARENTS)
    assert calls["record_function"] == calls["event"] == 0


def test_a_collider_frame_spans_its_collision(start):
    """``collider_step``: the SDF's refresh is ``collide.sdf`` inside
    ``step.emit``, and each of the frame's four ``enforce_collision`` calls
    is a ``collide.enforce`` under its phase; the count ``collide.enforces``
    advances by four a frame, traced or not, and untraced nothing is
    recorded."""
    topo, state = start
    col = collider.ColliderConfig(center0=(28.0, 10.0, 30.0), velocity=(48.0, 0.0, 0.0),
                                  radius=4.0)

    def frames(n):
        s = state
        for f in range(n):
            s = collider.collider_step(topo, s, RBGS, CFG, col, f)
        return s

    n0 = collision.enforces.n
    _, prof = _profiled(lambda: frames(2))
    assert collision.enforces.n - n0 == 2 * len(ENFORCE_PARENTS)
    recs = profiling.records()
    heads = [r for r in recs if r.name == "collider.step"]
    assert len(heads) == 2 and heads[1].frame == heads[0].frame + 1
    for head in heads:
        mine = [r for r in recs if r.frame == head.frame]
        sdf = [r for r in mine if r.name == "collide.sdf"]
        assert len(sdf) == 1 and sdf[0].parent.name == "step.emit"
        assert sdf[0].parent.parent is head
        enforce = [r for r in mine if r.name == "collide.enforce"]
        assert [r.parent.name for r in enforce] == ENFORCE_PARENTS
        assert all(r.parent.parent is head for r in enforce)
        assert all(r.host_ms >= 0 and r.device_ms is None for r in sdf + enforce)
    _check_clock(prof, recs)
    profiling.clear()
    n0 = collision.enforces.n
    frames(1)
    assert collision.enforces.n - n0 == len(ENFORCE_PARENTS)
    assert profiling.records() == []


def test_a_fire_frame_spans_its_confinement(start):
    """``fire_step`` (confinement at offset 1): one ``forces.vorticity``
    span inside ``step.forces`` and one more ``vorticity.applies``, traced
    or not; a plume frame (offset 0) holds neither."""
    from hnanosolver_tpu_torch.models import fire

    topo, state = start
    cfg = fire.FireConfig(center=(32.0, 8.0, 32.0), radius=6.0, height=3.0)
    params = fire.default_params().replace(iterations=4)
    assert int(params.combustion.factor_scale) == 1
    n0 = stencil.applies.n
    _, prof = _profiled(lambda: fire.fire_step(topo, state, params, cfg))
    assert stencil.applies.n - n0 == 1
    recs = profiling.records()
    vort = [r for r in recs if r.name == "forces.vorticity"]
    assert len(vort) == 1 and vort[0].parent.name == "step.forces"
    assert vort[0].parent.parent.name == "fire.step" and vort[0].frame == vort[0].parent.frame
    assert vort[0].host_ms >= 0 and vort[0].device_ms is None  # no card: a host span alone
    assert vort[0].parent.start_ns <= vort[0].start_ns <= vort[0].end_ns <= vort[0].parent.end_ns
    assert [r.name for r in recs if r.name.startswith("step.")] == [
        p for p in PHASES if p != "step.collide"]
    _check_clock(prof, recs)
    profiling.clear()
    fire.fire_step(topo, state, params, cfg)  # untraced: counted, not recorded
    assert stencil.applies.n - n0 == 2 and profiling.records() == []
    _profiled(lambda: plume.plume_step(topo, state, RBGS, CFG))
    assert "forces.vorticity" not in {r.name for r in profiling.records()}
    assert stencil.applies.n - n0 == 2


def test_an_off_confinement_span_reaches_no_profiler_entry(start, monkeypatch):
    """Off, the confinement's span reaches none of the profiler's entry
    points and records nothing; the count still adds."""
    def reached(*args, **kwargs):
        raise AssertionError("an off span reached the profiler")

    topo, state = start
    for name in ("Span", "RANGE"):
        monkeypatch.setattr(profiling, name, reached)
    monkeypatch.setattr(torch.cuda, "Event", reached)
    n0 = stencil.applies.n
    out = stencil.vorticity_confinement(topo, state.velocity, 1 / 24, 2.0, 2.0, 1.0)
    assert stencil.applies.n == n0 + 1 and profiling.records() == []
    assert not torch.equal(out, state.velocity)


def test_an_off_span_costs_under_a_microsecond_and_allocates_nothing(monkeypatch):
    """Off, a span and a launch's count reach none of the profiler's entry
    points and allocate nothing. Their cost is held to an empty
    ``contextlib.nullcontext`` timed in the same loop, not to the wall
    clock, which a loaded host stretches."""
    def reached(*args, **kwargs):
        raise AssertionError("an off span reached the profiler")

    def off():
        with profiling.span("mg.restrict", device=True, level=1):
            pass

    def empty():
        with contextlib.nullcontext():
            pass

    for name in ("Span", "RANGE"):
        monkeypatch.setattr(profiling, name, reached)
    monkeypatch.setattr(torch.cuda, "Event", reached)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", reached)
    assert profiling.span("x") is profiling.OFF
    assert profiling.frame("plume.step") is profiling.OFF
    counter = build.LaunchCount("probe")
    for _ in range(20_000):
        off()
        with counter.launch():
            pass
    assert counter.n == 20_000 and profiling.records() == []
    best_off = best_empty = float("inf")
    for _ in range(5):  # in turns, so that a loaded host slows both alike
        best_off = min(best_off, timeit.timeit(off, number=20_000))
        best_empty = min(best_empty, timeit.timeit(empty, number=20_000))
    assert best_off < 3 * best_empty, f"{best_off / best_empty:.2f} x an empty context"
    counter.n = 0
    tracemalloc.start()
    try:
        for _ in range(2_000):
            off()
            with counter.launch():
                pass
            counter.n = 0  # a small int: the count's own value allocates nothing
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = snap.filter_traces([tracemalloc.Filter(True, profiling.__file__),
                               tracemalloc.Filter(True, build.__file__)])
    assert here.statistics("lineno") == []
    with counter.launch():
        pass
    assert counter.n == 1


def test_no_span_while_a_graph_is_captured(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    counter = build.LaunchCount("captured")
    with profiling.force(True):
        assert profiling.span("step.emit", device=True) is profiling.OFF
        assert not profiling.tracing()
        with counter.launch():
            pass
    assert profiling.records() == [] and counter.n == 1  # still counted


def test_launch_counts_as_before_and_spans_while_traced(monkeypatch):
    """A wrapper's launch path (the library faked on the CPU): it counts a
    launch that returns 0, not one that fails, and is a host span
    ``launch.<name>`` under the span open around it while traced."""
    code = {"v": 0}

    class Lib:
        def hn_residual(self, *args):
            return code["v"]

    monkeypatch.setattr(build, "on_cpu", lambda device: False)
    monkeypatch.setattr(build, "library", lambda: Lib())
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    nbr = torch.zeros((2, 27), dtype=torch.int32)
    p = torch.zeros((2, 512))
    c = cuda_stencil.launches_residual
    n = c.n
    cuda_stencil.residual(nbr, p, p, 0.5)
    assert c.n == n + 1 and profiling.records() == []
    code["v"] = 1
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        cuda_stencil.residual(nbr, p, p, 0.5)
    assert c.n == n + 1
    code["v"] = 0
    with profiling.force(True):
        with profiling.span("step.pressure", device=True):
            cuda_stencil.residual(nbr, p, p, 0.5)
    assert c.n == n + 2
    outer, inner = profiling.records()
    assert inner.name == "launch.residual" and inner.parent is outer and inner.device_ms is None


def test_spans_from_many_threads_nest_in_their_own_thread():
    """The sharded step's threads open spans at once: each record's parent
    is its own thread's, none is lost, and a count loses no add."""
    n_threads, reps = 16, 200
    count = profiling.Count("stress")
    errors = []

    def work(i):
        try:
            for _ in range(reps):
                with profiling.span("outer", thread=i) as outer:
                    with profiling.span("inner", thread=i) as inner:
                        count.add()
                    assert inner.parent is outer and outer.parent is None
        except AssertionError as e:  # pragma: no cover - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.force(True):
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    recs = profiling.records()
    assert len(recs) == 2 * n_threads * reps and count.n == n_threads * reps
    for r in recs:
        if r.name == "inner":
            assert r.parent.attrs == r.attrs  # the outer span of its own thread


def test_records_hold_host_times_on_the_profilers_clock():
    """The profiler's clock is the epoch's (``time.time_ns``), which a
    range's stamps follow within TOL_NS; ``clear`` forgets the records."""
    before = time.time_ns()
    _, prof = _profiled(lambda: [_sleep_span() for _ in range(3)])
    recs = profiling.records()
    assert len(recs) == 3 and all(before < r.start_ns < r.end_ns for r in recs)
    assert all(r.host_ms >= 1.0 for r in recs)
    _check_clock(prof, recs)
    profiling.clear()
    assert profiling.records() == []


def _sleep_span():
    with profiling.span("sleep"):
        time.sleep(0.001)
