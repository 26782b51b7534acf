"""torch.profiler integration, the JAX package's ``utils/profiling.py``:
the tracing layer above ``utils/timers.py``. The reference has only RAII
printf timers; a trace shows every kernel on the device's timeline
(Perfetto or chrome://tracing open the file)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Trace a block with ``torch.profiler``, CPU activity and, with a card,
    CUDA activity, and write it as a Chrome trace into ``log_dir`` (default
    ``hnano_trace`` under the temporary directory) when the block ends:

        with device_trace("trace") as d:
            state = step(topo, state, params)
            torch.cuda.synchronize()

    Yields the directory; the trace is ``trace_<pid>_<ms>.json`` there."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "hnano_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """A labelled range for a step's phase inside a trace."""
    return torch.profiler.record_function(name)
