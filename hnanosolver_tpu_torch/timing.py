"""Per-call times of a callable: CUDA events on the card, the host clock on
the CPU. ``chip_smoke.py`` and the probe scripts (``tools/``) time with it.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch

# a spin of ~1 ms on the card ahead of a timed span: the calls of the span
# queue behind it, so that the span holds their device time and not the
# host's launch latency
SPIN_CYCLES = 2_000_000


def time_ms(fn: Callable[[], object], reps: int, batch: int = 1, spin: bool = False,
            before: Optional[Callable[[], object]] = None, device="cuda") -> list[float]:
    """``reps`` samples of the per-call time (ms) of ``fn``, each sample a
    run of ``batch`` back-to-back calls: between two CUDA events on the
    card, behind the spin when ``spin`` is set (a kernel's time; without
    it a span keeps the host time of a host-bound step), by the host clock
    on the CPU. ``before`` runs ahead of each sample, outside the span."""
    on_card = torch.device(device).type == "cuda"
    out = []
    for _ in range(reps):
        if before is not None:
            before()
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            for _ in range(batch):
                fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / batch)
        else:
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / batch)
    return out


def median_ms(fn: Callable[[], object], reps: int = 5, batch: int = 1,
              before: Optional[Callable[[], object]] = None, device="cuda") -> float:
    """The median of :func:`time_ms` behind the spin, after one warm-up
    call."""
    fn()
    return statistics.median(time_ms(fn, reps, batch, True, before, device))


def paired_ms(kernel: Callable[[], object], plain: Callable[[], object], reps: int = 5,
              batch: int = 10) -> tuple[float, float]:
    """Median per-call ms of kernel and plain on the card over runs of
    ``batch`` calls behind the spin, measured in turns (plain, kernel,
    kernel, plain) after a warm-up."""
    kernel(), plain()
    p = time_ms(plain, reps, batch, True)
    k = time_ms(kernel, reps, batch, True) + time_ms(kernel, reps, batch, True)
    p += time_ms(plain, reps, batch, True)
    return statistics.median(k), statistics.median(p)
