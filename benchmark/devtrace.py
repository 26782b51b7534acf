"""What the traced segments of the window recorded, for the per-layer
readers in ``metrics/``: the device's operations from ``torch.profiler``
(kernels, copies, fills), the host's operations beside them, the segments'
wall time on the host clock, and the timed calls of program functions.
Each segment is a profiler session of its own; their events are laid one
after another on one time line. ``breakdown`` is the result line's: the device
operations that took most time, and the idle gaps between them by what the
host was doing at the time."""

from __future__ import annotations

import collections
import dataclasses
import statistics

import torch

TOP = 10  # entries a breakdown list


@dataclasses.dataclass
class Record:
    """What the readers read. Device times in microseconds."""

    device_ops: list = dataclasses.field(default_factory=list)  # (name, start, end)
    host_ops: list = dataclasses.field(default_factory=list)  # (name, start, end)
    frames: int = 0  # frames in the traced segments
    window_s: float = 0.0  # their wall time
    cuts: list = dataclasses.field(default_factory=list)  # where each segment starts
    enqueue_s: list = dataclasses.field(default_factory=list)  # untraced frames' step calls
    timed: dict = dataclasses.field(default_factory=dict)  # "module.function": [seconds a call]
    timed_frames: int = 0  # frames in the timed segments
    shapes: dict | None = None  # roofline.cell_shapes, fixed cells only

    def device_ms(self, name_has: str = "") -> float | None:
        """Device ms a traced frame in operations whose name contains
        ``name_has``; None where none ran."""
        sel = [e - s for n, s, e in self.device_ops if name_has in n]
        if not sel or not self.frames:
            return None
        return sum(sel) / 1e3 / self.frames

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def median_enqueue_ms(self) -> float | None:
        return statistics.median(self.enqueue_s) * 1e3 if self.enqueue_s else None


def read_profile(prof, rec: Record, spans=()) -> None:
    """One segment's profiler events into ``rec``, after those of the
    segments before it. The device timeline's copies of host spans
    (``record_function`` annotations, the harness's ``spans``) are not
    device operations and are left out."""
    events = list(prof.events())
    spans = set(spans) | {e.name for e in events if getattr(e, "is_user_annotation", False)}
    if not events:
        return
    first = min(float(e.time_range.start) for e in events)
    before = [e for _, _, e in rec.device_ops + rec.host_ops]
    shift = (max(before) + 1.0 if before else 0.0) - first
    rec.cuts.append(first + shift)
    for e in events:
        item = (e.name, float(e.time_range.start) + shift, float(e.time_range.end) + shift)
        if e.device_type != torch.autograd.DeviceType.CUDA:
            rec.host_ops.append(item)
        elif e.name not in spans and not getattr(e, "is_user_annotation", False):
            rec.device_ops.append(item)


def breakdown(rec: Record) -> dict:
    by_name = collections.Counter()
    for n, s, e in rec.device_ops:
        by_name[n] += (e - s) / 1e6
    gaps, end = [], None
    for _, s, e in sorted(rec.device_ops, key=lambda x: x[1]):
        if end is not None and s > end and not any(end < c <= s for c in rec.cuts):
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    # one sweep in time order: each gap is labelled by the innermost host
    # operation open at its middle (the latest opened and not yet closed)
    events = [(s, 0, i) for i, (_, s, _) in enumerate(rec.host_ops)]
    events += [(e, 2, i) for i, (_, _, e) in enumerate(rec.host_ops)]
    events += [(0.5 * (a + b), 1, g) for g, (a, b) in enumerate(gaps)]
    events.sort(key=lambda x: (x[0], x[1]))
    idle, stack, closed = collections.Counter(), [], set()
    for _, kind, i in events:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            closed.add(i)
        else:
            while stack and stack[-1] in closed:
                stack.pop()
            label = rec.host_ops[stack[-1]][0] if stack else "(no traced host operation)"
            idle[label] += (gaps[i][1] - gaps[i][0]) / 1e6
    return {"device_ops": [[n, s] for n, s in by_name.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}
