"""torch.profiler integration, the JAX package's ``utils/profiling.py``:
the tracing layer above ``utils/timers.py``. The reference has only RAII
printf timers; a trace shows every kernel on the device's timeline
(Perfetto or chrome://tracing open the file).

The program's own spans and counts live here too:

- :func:`span` marks a phase of the program. It is off unless a
  ``torch.profiler`` session records: off, it returns one shared no-op
  context. On, it opens a profiler range (:data:`RANGE`: so the phase sits
  in the profiler's timeline beside its kernels, and in :func:`device_trace`'s
  Chrome trace) and appends a :class:`Span` record, read back with
  :func:`records` and emptied by :func:`clear`. A span is off while the
  current CUDA stream captures a graph.
- :func:`frame` is the span of one frame of a cook (each model's step opens
  one): entering it advances the frame id that every record carries.
- :class:`Count` is a named count, always on (``kernels/build.LaunchCount``
  is one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import threading
import time
from typing import Optional

import torch
from torch.autograd import _profiler_enabled

# A span's range in the profiler's timeline: torch's C++ range, a host
# operation alone (no copy of it on the device's rows). Not
# ``torch.profiler.record_function``, which dispatches an operator on entry and
# exit: under a profiler ~19 us against ~7, with its stamps up to ~0.5 ms from
# the host's own reads around them (a CPU build of torch 2.13). A torch
# without the C++ range fails here, at import.
RANGE = torch._C._profiler._RecordFunctionFast

_LOCK = threading.Lock()  # the records, the frame id and the event pool
_COUNT_LOCK = threading.Lock()  # every Count
_RECORDS: list = []
_LOCAL = threading.local()  # .stack: this thread's open spans
_POOL: dict = {}  # CUDA device index -> timing events free for reuse
_FORCED: Optional[bool] = None  # force(): spans on or off whatever the profiler
_frame = 0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace a block with ``torch.profiler``, CPU activity and, with a card,
    CUDA activity, and write it as a Chrome trace into ``log_dir`` (default
    ``hnano_trace`` under the temporary directory) when the block ends:

        with device_trace("trace") as d:
            state = step(topo, state, params)
            torch.cuda.synchronize()

    Yields the directory; the trace is ``trace_<pid>_<ms>.json`` there. The
    program's spans (:func:`span`) record while the block runs and appear in
    the trace as ranges on the host's rows."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "hnano_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


class _Off:
    """The context :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return None


OFF = _Off()


def tracing() -> bool:
    """Whether a span opened now records: a ``torch.profiler`` session
    records (or :func:`force` says so) and the current CUDA stream is not
    capturing a graph."""
    if not (_profiler_enabled() if _FORCED is None else _FORCED):
        return False
    return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def span(name: str, device: bool = False, **attrs):
    """A context around one phase of the program, named by a fixed string.
    Off (see :func:`tracing`) it is :data:`OFF` and records nothing. On, it
    is a :class:`Span`: a profiler range ``name`` (:data:`RANGE`) and a
    record with ``attrs`` (e.g. a multigrid ``level``), its parent (the
    innermost span open in this thread), the frame id (see :func:`frame`),
    its host start and end on the profiler's clock (``time.time_ns``) and,
    with ``device`` on a CUDA machine, two timing events on the current
    stream, read by :attr:`Span.device_ms`."""
    if not tracing():
        return OFF
    return Span(name, attrs, device)


def frame(name: str):
    """The host span of one frame of a cook, as :func:`span` (``name``:
    ``plume.step``, ``fire.step``, ``collider.step``, ``solve.step``):
    entering it advances the frame id, which this record and every record
    after it carry until the next frame's span is entered."""
    if not tracing():
        return OFF
    return Span(name, {}, starts_frame=True)


annotate = span  # the JAX package's name for a labelled range (its utils/profiling.annotate)


class Span:
    """One span's record (see :func:`span`). Host times in ns on the
    profiler's clock; ``end_ns`` is None while the span is open."""

    __slots__ = ("name", "attrs", "device", "starts_frame", "parent", "frame", "start_ns",
                 "end_ns", "_range", "_events", "_device_ms")

    def __init__(self, name: str, attrs: dict, device: bool = False, starts_frame: bool = False):
        self.name, self.attrs, self.device = name, attrs, device
        self.starts_frame = starts_frame
        self.parent, self.frame = None, 0
        self.start_ns, self.end_ns = 0, None
        self._range, self._events, self._device_ms = None, None, None

    def __enter__(self):
        global _frame
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.parent = stack[-1] if stack else None
        with _LOCK:
            if self.starts_frame:
                _frame += 1
            self.frame = _frame
            _RECORDS.append(self)
        self._range = RANGE(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        if self.device and torch.cuda.is_available():
            dev = torch.cuda.current_device()
            self._events = (dev, _event(dev), _event(dev))
            self._events[1].record()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[2].record()
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._range = None
        _LOCAL.stack.pop()
        return False

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Stream ms between the span's two events (waits for the second);
        None for a host span, an open one or one without a card."""
        if self._device_ms is None and self._events is not None and self.end_ns is not None:
            _, start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            _release(self._events)
            self._events = None
        return self._device_ms


def _event(dev: int):
    """A timing event for CUDA device ``dev`` (the current one), from the
    pool."""
    with _LOCK:
        free = _POOL.get(dev)
        if free:
            return free.pop()
    return torch.cuda.Event(enable_timing=True)


def _release(events) -> None:
    """(device, start, end) back to the pool."""
    with _LOCK:
        _POOL.setdefault(events[0], []).extend(events[1:])


def records() -> list:
    """Every span recorded since the last :func:`clear`, in the order they
    were entered."""
    with _LOCK:
        return list(_RECORDS)


def clear() -> None:
    """Forget every record (their events go back to the pool)."""
    with _LOCK:
        done, _RECORDS[:] = list(_RECORDS), []
    for r in done:
        if r._events is not None:
            _release(r._events)
            r._events = None


@contextlib.contextmanager
def force(on: Optional[bool]):
    """For tests and cost measurements only: spans on (True) or off (False)
    inside the block, whatever the profiler does."""
    global _FORCED
    before, _FORCED = _FORCED, on
    try:
        yield
    finally:
        _FORCED = before


@dataclasses.dataclass(eq=False)
class Count:
    """A named count, always on. Several threads may add (the sharded step),
    so :meth:`add` takes a lock (``n += 1`` is a read-modify-write)."""

    name: str
    n: int = 0

    def add(self, k: int = 1) -> None:
        with _COUNT_LOCK:
            self.n += k
