"""One run of one cell: set-up, the measured window, the traced segments
and the output check. ``run.py`` calls :func:`run`.

The window is a closed loop of one client, as a cook is: frame n + 1
starts when frame n has ended, and a frame ends at the
``torch.cuda.synchronize()`` that stands for its fields being ready for the
host. The program's frame and cook are the cell's scene's
(``scenes/<scene>.py``; the plume's are ``models.plume.plume_step`` and
``run_plume``), each given the frame's index within its cook. A fixed cell
steps the scene's frame with the multigrid hierarchy
``ops.multigrid.hierarchy_for`` made once in set-up, as ``run_plume``
does; a cook restarts from the seeded start every ``frames_per_cook``
frames. A grown cell runs the scene's cook cook after cook, growing every
frame, with an ``on_frame`` that synchronises and an
``utils.interrupt.Interrupter`` that trips at the window's end. Each
cook's start is the benchmark's input, not the program's work: it is drawn
between cooks with the frame clock stopped and outside every traced
segment. A frame's time runs from the end of the
frame before it (or from its cook's start being ready) to its own end, and
the window's seconds are the sum of its frames' times.

Set-up draws the start from the seed, runs the warm-up frames (a fixed
cell's first builds the program's kernels; a grown cell warms a whole cook,
every capacity it reaches) and checks with the program's launch counters
that one frame runs the traffic's pressure path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
import time

import numpy as np
import torch

import compare
import devtrace
import guard
import inputs
import roofline
import spec
from reference import topology as rt

# the harness's spans in a trace, around the scene's frame, the synchronize
# after it and the scene's cook: named for the plume's calls, and read so
SPANS = ("plume_step", "synchronize", "run_plume")
TRACE_SHARE = 0.25  # the most of a traced run's window, at its first cook's pace, it profiles


@dataclasses.dataclass
class Clock:
    t0: float  # the process's start
    excluded: float = 0.0  # set-up seconds spent on the output check
    marks: list = dataclasses.field(default_factory=list)  # (set-up phase, seconds at its end)

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter() - self.t0))


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    frame_s: list
    voxels: int
    window_s: float
    peak_bytes: int
    setup_s: float
    rec: devtrace.Record | None = None


class Program:
    """The system under test, ``hnanosolver_tpu_torch``, through its public
    frame path: the scene's ``Driver``."""

    def __init__(self, cell, device):
        from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
        from hnanosolver_tpu_torch.core import topology
        from hnanosolver_tpu_torch.fields import FieldState
        from hnanosolver_tpu_torch.kernels import build
        from hnanosolver_tpu_torch.ops import multigrid
        from hnanosolver_tpu_torch.utils import interrupt

        self.topology_mod, self.multigrid = topology, multigrid
        self.FieldState, self.LaunchCount, self.interrupt = FieldState, build.LaunchCount, interrupt
        self.device = device
        self.scalars = cell.config["scalars"]
        sv, pr = cell.config["solver"], cell.traffic["pressure"]
        kw = dict(dt=sv["dt"], voxel_size=sv["voxel_size"],
                  combustion=CombustionParams(**sv["combustion"]))
        if pr["solver"] == "mg":
            kw.update(pressure_solver="mg", iterations=pr["cycles"], mg_levels=pr["levels"],
                      mg_pre=pr["pre"], mg_post=pr["post"], mg_coarsest=pr["coarsest"],
                      mg_fmg=pr["fmg"])
        else:
            kw.update(pressure_solver="rbgs", iterations=pr["iterations"],
                      halo_lag=pr["halo_lag"])
        self.params = SolverParams(**kw, **cell.scene.SOLVER)
        self.driver = cell.scene.Driver(cell)

    def topology(self, tiles, capacity):
        return self.topology_mod.build_topology(tiles, capacity=capacity, device=self.device)

    def hierarchy(self, topo):
        return self.multigrid.hierarchy_for(topo, self.params)

    def state(self, fields: dict):
        """The configuration's scalars, then the scene's own fields."""
        names = self.scalars + [k for k in fields if k != "velocity" and k not in self.scalars]
        return self.FieldState(velocity=fields["velocity"], scalars={k: fields[k] for k in names})

    @staticmethod
    def fields(state) -> dict:
        return {"velocity": state.velocity, **state.scalars}

    @staticmethod
    def keys(topo) -> np.ndarray:
        return topo.keys.cpu().numpy()

    def step(self, topo, state, hier, index: int):
        """Frame ``index`` of its cook."""
        return self.driver.step(topo, state, self.params, hier, index)

    def cook(self, frames, topo, state, on_frame, stop):
        interrupter = None if stop is None else self.interrupt.Interrupter(poll=stop)
        return self.driver.cook(frames, self.params, topo, state, on_frame, interrupter)

    def launch_counts(self) -> dict:
        """Every kernel launch counter of the program's operators, by name."""
        out = {}
        for name, mod in list(sys.modules.items()):
            if name.startswith("hnanosolver_tpu_torch.ops.") and mod is not None:
                for v in vars(mod).values():
                    if isinstance(v, self.LaunchCount):
                        out[v.name] = v.n
        return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(fields: dict) -> dict:
    return {k: v.cpu() for k, v in fields.items()}


class Window:
    """Frame times, voxels and, in a traced run, its segments:
    ``torch.profiler`` over ``n_trace`` frames, then the per-layer metrics'
    program functions (``FUNCTION`` of a reader that ``NEEDS`` "timed")
    timed over ``n_timed`` frames, each call from a synchronize before it
    to one after it. A segment starts with a cook, from the window's second
    on (the first is left to the enqueue times, and its pace caps the
    traced frames at TRACE_SHARE of the window), and ends with it or
    sooner, so that none holds a cook's start; the next cooks' segments
    follow until each kind has its frames, and a traced window runs on
    until they are done."""

    def __init__(self, seconds: float, device, n_trace: int, n_timed: int, timed=()):
        self.seconds, self.device = seconds, device
        self.frame_s, self.voxels, self.window_s = [], 0, 0.0
        self.rec = devtrace.Record()
        self.todo = {"trace": n_trace, "timed": n_timed}
        self.timed = list(timed)  # (module, function) pairs of the program
        self.active, self.seg_frames, self.prof, self.restore = None, 0, None, []
        self.paced = False

    def begin(self) -> None:
        _sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._cook_ready(segment=False)

    def new_cook(self, make):
        """The next cook's start, ``make()``, drawn with the frame clock
        stopped and outside any segment."""
        self._stop()
        if not self.paced:  # the end of the window's first cook, untraced
            self.paced = True
            if self.todo["trace"]:
                pace = self.window_s / len(self.frame_s)
                self.todo["trace"] = max(1, min(self.todo["trace"],
                                                int(TRACE_SHARE * self.seconds / pace)))
        start = make()
        self._cook_ready()
        return start

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.active == "trace" else (
            contextlib.nullcontext())

    def frame_done(self, voxels: int, enqueue_s: float | None = None) -> bool:
        """Record a frame that ended now; True once the window is over."""
        t = time.perf_counter()
        self.frame_s.append(t - self.t_prev)
        self.window_s += t - self.t_prev
        self.t_prev = t
        self.voxels += voxels
        if self.active is None and enqueue_s is not None:
            self.rec.enqueue_s.append(enqueue_s)
        if self.active is not None:
            self.seg_frames += 1
            if self.seg_frames == self.todo[self.active]:
                self._stop()
                self.t_prev = time.perf_counter()
        return self.window_s >= self.seconds and self.active is None and not any(
            self.todo.values())

    def _cook_ready(self, segment: bool = True) -> None:
        _sync(self.device)
        kind = next((k for k, n in self.todo.items() if n > 0), None)
        if segment and kind is not None:
            self._start(kind)
        self.t_prev = time.perf_counter()

    def _start(self, kind: str) -> None:
        self.active, self.seg_frames = kind, 0
        if kind == "trace":
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        else:
            for mod_name, fn in self.timed:
                mod = importlib.import_module(mod_name)
                self.restore.append((mod, fn, getattr(mod, fn)))
                setattr(mod, fn, self._timed(f"{mod_name}.{fn}", getattr(mod, fn)))
        self.seg_t0 = time.perf_counter()

    def _timed(self, name: str, real):
        calls = self.rec.timed.setdefault(name, [])

        def call(*args, **kwargs):
            _sync(self.device)
            t = time.perf_counter()
            out = real(*args, **kwargs)
            _sync(self.device)
            calls.append(time.perf_counter() - t)
            return out
        return call

    def _stop(self) -> None:
        """End the segment running, if one is."""
        if self.active == "trace":
            self.rec.window_s += time.perf_counter() - self.seg_t0
            self.prof.stop()
            devtrace.read_profile(self.prof, self.rec, SPANS)
            self.prof = None
            self.rec.frames += self.seg_frames
        elif self.active == "timed":
            for mod, fn, real in self.restore:
                setattr(mod, fn, real)
            self.restore = []
            self.rec.timed_frames += self.seg_frames
        if self.active is not None:
            self.todo[self.active] -= self.seg_frames
        self.active = None


def _segments(cell, trace: bool) -> tuple:
    """(traced frames, timed frames, the functions to time) of a traced run:
    the traffic's ``trace_frames`` and ``timed_frames``, where a metric of
    the cell needs each."""
    if not trace:
        return 0, 0, []
    readers = [spec.reader(cell, m["name"]) for m in cell.per_layer]
    timed = sorted({r.FUNCTION for r in readers if r.NEEDS == "timed"})
    n_trace = cell.traffic["trace_frames"] if any(r.NEEDS == "trace" for r in readers) else 0
    return n_trace, cell.traffic["timed_frames"] if timed else 0, timed


def _check_launches(cell, prog, before: dict, after: dict) -> None:
    """Raise unless one frame made the launches the traffic states, each
    within [lo, hi] (hi None: no upper end)."""
    for name, (lo, hi) in cell.traffic.get("launches", {}).items():
        n = after.get(name, 0) - before.get(name, 0)
        if n < lo or (hi is not None and n > hi):
            raise RuntimeError(f"set-up: one frame made {n} {name} launches, expected "
                               f"[{lo}, {hi}]: the frame does not run the traffic's path")
    print(f"set-up: one frame's launches {({k: after[k] - before.get(k, 0) for k in after})}",
          file=sys.stderr)


def _fixed(cell, prog, topo, rows, seed, seconds, trace, dev, clock):
    tr = cell.traffic
    hier = prog.hierarchy(topo)
    clock.mark("hierarchy")

    def start(cook: int):
        return prog.state(inputs.start_fields(cell, rows, seed, dev, cook))

    state, first = start(0), None
    clock.mark("start")
    for i in range(tr["warmup_frames"]):
        before = prog.launch_counts()
        state = prog.step(topo, state, hier, i)
        _sync(dev)
        if i == 0:
            t = time.perf_counter()
            first = _host(prog.fields(state))
            clock.excluded += time.perf_counter() - t
    if dev.type == "cuda":
        _check_launches(cell, prog, before, prog.launch_counts())
    clock.mark("warm-up")
    state = None
    cook = 1
    state = start(cook)
    win = Window(seconds, dev, *_segments(cell, trace))
    voxels = rows.n_active * rt.TILE
    win.begin()
    setup_s = win.t_prev - clock.t0 - clock.excluded
    prev, in_cook = None, 0
    while True:
        if in_cook == tr["frames_per_cook"]:
            prev = state = None
            cook += 1
            state, in_cook = win.new_cook(lambda: start(cook)), 0
        prev = state
        with win.span(SPANS[0]):
            t = time.perf_counter()
            state = prog.step(topo, prev, hier, in_cook)
            enqueue = time.perf_counter() - t
        with win.span(SPANS[1]):
            _sync(dev)
        in_cook += 1
        if win.frame_done(voxels, enqueue):
            break
    keys = rows.keys
    return win, setup_s, (keys, first), (keys, prev), (keys, state), in_cook - 1


def _grown(cell, prog, topo0, rows, seed, seconds, trace, dev, clock):
    F = cell.traffic["frames_per_cook"]

    def start(cook: int):
        return prog.state(inputs.start_fields(cell, rows, seed, dev, cook))

    first = {}

    def warm(f, topo, state):
        _sync(dev)
        if f == 0:
            t = time.perf_counter()
            first["out"] = (prog.keys(topo), _host(prog.fields(state)))
            clock.excluded += time.perf_counter() - t

    prog.cook(F, topo0, start(0), warm, None)
    clock.mark("warm-up")
    win = Window(seconds, dev, *_segments(cell, trace))
    # inp: the input of the frame running; last_in / last_out / index: the
    # window's last frame, one frame past the time (its input is the frame
    # before's output, which the cook holds: nothing is held twice)
    st = dict(inp=(topo0, start(1)), final=False, done=False, last_in=None, last_out=None,
              index=None)

    def on_frame(f, topo, state):
        _sync(dev)
        voxels = st["inp"][0].n_active * rt.TILE
        st["inp"] = (topo, state)
        if st["final"]:
            st["last_out"], st["done"], st["index"] = (topo, state), True, f
            win.frame_done(voxels)
        elif win.frame_done(voxels):
            st["final"], st["last_in"] = True, (topo, state)

    win.begin()
    setup_s = win.t_prev - clock.t0 - clock.excluded
    cook = 1
    while True:
        if st["final"]:
            st["last_in"] = st["inp"]
        with win.span(SPANS[2]):
            prog.cook(F, topo0, st["inp"][1], on_frame, lambda: st["done"])
        if st["done"]:
            break
        cook += 1
        st["inp"] = None
        st["inp"] = (topo0, win.new_cook(lambda: start(cook)))
    (ti, si), (to, so), index = st["last_in"], st["last_out"], st["index"]
    st.clear()
    return win, setup_s, first["out"], (prog.keys(ti), si), (prog.keys(to), so), index


@dataclasses.dataclass
class Prepared:
    """What every run of a cell shares: the program, the tile list, its
    rows as the reference lays them out (on the host, no neighbour table)
    and the program's topology."""

    prog: Program
    tiles: np.ndarray
    rows: rt.Topo
    topo: object


def prepare(cell: spec.Cell, dev: torch.device, clock: Clock | None = None) -> Prepared:
    prog = Program(cell, dev)
    tiles, capacity = inputs.start_tiles(cell)
    rows = rt.build(tiles, capacity)
    topo = prog.topology(tiles, capacity)
    if not np.array_equal(prog.keys(topo), rows.keys):
        raise RuntimeError("the program's tile rows differ from the benchmark's")
    if clock is not None:
        clock.mark("topology")
    return Prepared(prog, tiles, rows, topo)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    dev = torch.device(device)
    clock = Clock(t0)
    clock.mark("imports")
    prep = prepare(cell, dev, clock)
    return run_prepared(cell, prep, seed, seconds, trace, dev, clock, keep=False)


def run_prepared(cell, prep: Prepared, seed, seconds, trace, dev, clock, keep=True) -> dict:
    """The window, its metrics and the output check from a prepared cell;
    without ``keep`` the program's topology is released before the check."""
    drive = _grown if cell.traffic["topology"] == "grow" else _fixed
    win, setup_s, first, last_in, last_out, last_index = drive(
        cell, prep.prog, prep.topo, prep.rows, seed, seconds, trace, dev, clock)
    print("set-up: " + ", ".join(f"{k} to {v:.2f} s" for k, v in clock.marks)
          + f"; {setup_s:.2f} s counted", file=sys.stderr)
    if not keep:
        prep.topo = None
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    guard.check("after the window")
    rec = win.rec if trace else None
    if rec is not None and cell.traffic["topology"] != "grow":
        rec.shapes = roofline.cell_shapes(cell, prep.tiles)
    result_run = Run(win.frame_s, win.voxels, win.window_s, peak, setup_s, rec)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell, m["name"]).read(result_run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": False, "attempted": len(win.frame_s), "failed": 0, "metrics": metrics,
           "device": device_info}
    if rec is not None:
        device_info.update(busy_s=rec.busy_s(), window_s=rec.window_s)
        out["breakdown"] = devtrace.breakdown(rec)
    del win, rec, result_run
    checks = output_check(cell, prep.prog, prep.rows, seed, dev, first, last_in, last_out,
                          last_index)
    out["correct"] = all(v["value"] <= v["limit"] for v in checks.values())
    out["checks"] = checks
    return out


def output_check(cell, prog, rows, seed, dev, first, last_in, last_out, last_index) -> dict:
    """The window's last frame (``last_index`` within its cook) from the
    program's own input, and the first frame (index 0) from the seeded
    start, each against the reference in float64 on its own tile index,
    built here. Run once the program's state is all but the last frame's
    freed."""
    t = time.perf_counter()
    keys_out, out = last_out[0], _host(prog.fields(last_out[1]))
    keys_in, inp = last_in[0], prog.fields(last_in[1])
    del last_in, last_out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_topo = rt.with_index(rows, dev)
    topo_in = ref_topo if np.array_equal(keys_in, rows.keys) else rt.from_keys(keys_in, dev)
    gap, off, gaps = compare.check_frame(cell, topo_in, compare.to64(inp, dev), keys_out, out,
                                         last_index)
    del inp, out, topo_in
    found = {"last_gap": gap, "last_tiles_off": off}
    start = compare.to64(inputs.start_fields(cell, rows, seed, dev), dev)
    gap0, off0, gaps0 = compare.check_frame(cell, ref_topo, start, first[0], first[1], 0)
    found.update(start_gap=gap0, start_tiles_off=off0)
    print(f"output check: last frame (index {last_index} of its cook) {gaps}, first frame "
          f"{gaps0}; {time.perf_counter() - t:.1f} s", file=sys.stderr)
    checks = {}
    for name, value in found.items():
        if value is not None:
            if name not in cell.limits:
                raise KeyError(f"checks/{cell.name}.json has no limit for {name}")
            checks[name] = {"value": value, "limit": cell.limits[name]}
    return checks
