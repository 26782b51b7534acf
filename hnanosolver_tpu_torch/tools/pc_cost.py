"""What a PC launch (the row copies of ``csrc/probe_copy.cu``) costs on the
card, part by part: where its fixed cost of a few microseconds a launch
goes.

- The cases: v5 (no copy: the floor), v2 (64 single-row copies, one batch)
  and phase 15's JSON launch (``probe_dmacost``'s 4,096 row starts, span 8,
  n 512, 8 reps), each on 1 block and on one block an SM.
- The designs: ``hn_row_copy_parts`` takes the design's parts one by one
  (:data:`PARTS`): "before" is none of them (one thread issues every copy,
  the whole stage zeroed and every row start read, block 0's threads write
  it out, a cluster launch, the shared-memory attribute set every call),
  "+part" the design before with that part alone, "-part" the design
  without it, "design" all of them (``hn_row_copy``'s). Warp issue applies
  to copies of fewer than 8 rows and the bulk write-out to launches of more
  than one block (``csrc/probe_copy.cu``). Each is checked bitwise against
  the plain version (``ops/probe.py``) first.
- Per case and design: the device time of a launch (``torch.profiler``'s
  kernel durations, the mean over :data:`BATCH` launches; the median of
  ``--rounds`` passes over the designs in turn) and the span
  chip_smoke times (``timing.median_ms`` over runs of :data:`SPAN_BATCH`
  calls behind the spin): where the span exceeds the device time, the
  difference lies between launches (the queue, the launch latency), not in
  the kernel. Each part's saving alone is t(before) - t(+part), within the
  design t(-part) - t(design).
- The launch alone: an empty body (:data:`EMPTY`) at the case's shared
  memory, as a plain launch and as a cluster of one.
- The host: us a wrapper call (``cuda_probe.row_copy``) and a C-entry call
  (``kernel_call``), on the host clock over calls without a sync (the
  enqueue).
- Against n: the device time of every design at n in :data:`SWEEP_N`
  single-row copies (v2's rows): the zero fill, the write-out and the
  serial issue as n grows.

Run: python -m hnanosolver_tpu_torch.tools.pc_cost [--rounds N] (the card
only: it times launches; ~1 minute)
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.core.topology import resolve_device
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops import cuda_probe, probe
from hnanosolver_tpu_torch.timing import median_ms
from hnanosolver_tpu_torch.tools import ctas_all, parser, probe_dmabisect, probe_dmacost

# csrc/probe_copy.cu's parts of the design, one bit each
PARTS = {"warp issue": 1, "set-up sized to n": 2, "bulk write-out": 4, "plain launch": 8,
         "attribute once": 16}
EMPTY = 32  # the kernel returns at once: the launch alone
BEFORE = 0
DESIGN = sum(PARTS.values())
KERNEL = "row_copy_kernel"
BATCH = 20  # launches a profiled window
PROFILE_TRIES = 5  # profiled windows before device_us gives up
SPAN_BATCH = 5  # calls a timed span, as chip_smoke's PC spans
HOST_CALLS = 200  # calls a host-clock window (fewer than the launch queue holds)
SWEEP_N = (0, 8, 64)


def designs() -> dict[str, int]:
    """Design name -> parts: the design before, it with each part alone, the
    design without each part, and the design."""
    return {"before": BEFORE, **{f"+{k}": v for k, v in PARTS.items()},
            **{f"-{k}": DESIGN & ~v for k, v in PARTS.items()}, "design": DESIGN}


def cases(dev: torch.device) -> dict[str, tuple[torch.Tensor, dict]]:
    """Case name -> (source, ``row_copy`` arguments without ``ctas``)."""
    xb = probe_dmabisect.source(dev)
    bisect = {name: kw for name, kw, _, _ in probe_dmabisect.cases(xb)}
    xc, rows_c = probe_dmacost.inputs(dev)
    return {"v5": (xb, bisect["v5_dynread_vmem"]),
            "v2": (xb, bisect["v2_fori64"]),
            "JSON launch": (xc, dict(rows=rows_c, n=probe_dmacost.NS[1], span=8,
                                     reps=probe_dmacost.REPS))}


def sweep(dev: torch.device) -> dict[int, tuple[torch.Tensor, dict]]:
    """n -> (source, arguments): n single-row copies of v2's rows."""
    x, kw = cases(dev)["v2"]
    return {n: (x, dict(kw, n=n)) for n in SWEEP_N}


def parts_us(t: dict[str, float]) -> dict[str, tuple[float, float]]:
    """Each part's saving from times by design name: (alone, t(before) -
    t(+part); within the design, t(-part) - t(design))."""
    return {k: (t["before"] - t[f"+{k}"], t[f"-{k}"] - t["design"]) for k in PARTS}


def kernel_call(src: torch.Tensor, parts: int, rows: torch.Tensor, n: int, span: int = 1,
                reps: int = 1, step: int = 1, onchip_rows: int = 0, count=None,
                ctas: int = 1) -> Callable[[], tuple]:
    """A call of the C entry ``hn_row_copy_parts`` with ``parts``, into a
    fixed stage and acc (no allocation, no wrapper check a call; no launch
    counted)."""
    probe.check_copy_args(src, rows, n, span, reps, step, onchip_rows, count, ctas)
    stage = torch.empty((probe.STAGE_ROWS, TILE), dtype=torch.float32, device=src.device)
    acc = torch.empty(ctas, dtype=torch.float32, device=src.device)
    lib, s = build.library(), build.stream_ptr(src.device)
    cnt = 0 if count is None else count.data_ptr()

    def call():
        code = lib.hn_row_copy_parts(src.data_ptr(), src.shape[0], rows.data_ptr(), rows.numel(),
                                     cnt, n, span, step, reps, onchip_rows, ctas,
                                     stage.data_ptr(), acc.data_ptr(), parts, s)
        build.check(code, "hn_row_copy_parts")
        return stage, acc

    return call


def device_us(call: Callable[[], object], launches: int = BATCH) -> float:
    """Mean device us of the PC kernel over ``launches`` calls, from
    ``torch.profiler``'s kernel durations. On the card the profiler now and
    then records few or none of a window's kernels: the mean is taken over
    those it recorded if that is at least half, else the window is run
    again, up to PROFILE_TRIES times."""
    call()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                call()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and KERNEL in e.key:
                us = getattr(e, "self_device_time_total", None)
                total += float(e.self_cuda_time_total if us is None else us)
                count += int(e.count)
        if launches // 2 <= count <= launches:
            return total / count
    raise RuntimeError(f"the profiler saw {count} {KERNEL} launches of {launches} in each of "
                       f"{PROFILE_TRIES} windows")


def device_times(calls: dict[str, Callable[[], object]], rounds: int) -> dict[str, float]:
    """Name -> the median of :func:`device_us` over ``rounds`` passes that
    take the calls in turn (a drift of the card's clock falls on all)."""
    runs = {k: [] for k in calls}
    for _ in range(rounds):
        for k, c in calls.items():
            runs[k].append(device_us(c))
    return {k: statistics.median(v) for k, v in runs.items()}


def span_us(call: Callable[[], object], rounds: int) -> float:
    """us a call: the median of runs of SPAN_BATCH calls behind the spin."""
    return median_ms(call, rounds, SPAN_BATCH) * 1e3


def host_us(call: Callable[[], object]) -> float:
    """Host us a call, over HOST_CALLS calls without a sync (the enqueue)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / HOST_CALLS


def checked(x: torch.Tensor, kw: dict) -> dict[str, Callable[[], tuple]]:
    """Design name -> its call, each checked bitwise against the plain
    version on these arguments."""
    want = probe.row_copy(x, **kw)
    calls = {}
    for name, parts in designs().items():
        calls[name] = kernel_call(x, parts, **kw)
        got = calls[name]()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"PC design {name!r} differs from its plain version: {kw}")
    return calls


def breakdown(x: torch.Tensor, kw: dict, rounds: int = 3) -> dict:
    """One case's parts (us): device and span time of every design, the
    empty launch plain and clustered, the host's time a call."""
    calls = checked(x, kw)
    dev = device_times(calls, rounds)
    empty = {form: device_us(kernel_call(x, EMPTY | PARTS["attribute once"] | bit, **kw))
             for form, bit in (("plain", PARTS["plain launch"]), ("cluster", 0))}
    return {"device": dev, "parts": parts_us(dev),
            "span": {k: span_us(calls[k], rounds) for k in ("before", "design")},
            "empty": empty,
            "host": {"wrapper": host_us(lambda: cuda_probe.row_copy(x, **kw)),
                     "C entry": host_us(calls["design"]),
                     "C entry, before": host_us(calls["before"])}}


def line(label: str, b: dict) -> str:
    d, sp, e, h = b["device"], b["span"], b["empty"], b["host"]
    return (f"{label}: device us a launch {d['before']:.2f} before, {d['design']:.2f} the "
            f"design; span {sp['before']:.2f} / {sp['design']:.2f}; parts saved (alone / "
            f"within the design) "
            + ", ".join(f"{k} {a:.2f} / {w:.2f}" for k, (a, w) in b["parts"].items())
            + f"; empty launch plain {e['plain']:.2f}, cluster {e['cluster']:.2f}; host us a "
            f"call: wrapper {h['wrapper']:.2f}, C entry {h['C entry']:.2f} (before "
            f"{h['C entry, before']:.2f})")


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("pc_cost: the card only (it times launches)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"pc_cost on {card}: device us from torch.profiler (mean of {BATCH} launches), span "
          f"us a call (median of {args.rounds} runs of {SPAN_BATCH} behind the spin)",
          flush=True)
    for g in (1, ctas_all(dev)):
        for name, (x, kw) in cases(dev).items():
            print(line(f"{name}, {g} block{'s' * (g > 1)}", breakdown(x, dict(kw, ctas=g),
                                                                      args.rounds)), flush=True)
        for n, (x, kw) in sweep(dev).items():
            t = device_times(checked(x, dict(kw, ctas=g)), args.rounds)
            print(f"n={n} single-row copies, {g} block{'s' * (g > 1)}: device us "
                  + ", ".join(f"{k} {v:.2f}" for k, v in t.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
