"""The program's own spans and counts (``hnanosolver_tpu_torch/utils/
profiling.py``) for the per-layer readers in ``metrics/``. A span records
only while a profiler session does, so every record of a run is one of its
traced segments' (a process runs one cell). Where the program has no such
span or count, or the run recorded none, a reader gets None; nothing here
raises for want of them.

A span's device ms is stream time between two CUDA events recorded on the
current stream at its start and its end. In a device-bound cell that is the
phase's device time; in a host-bound cell, where the device waits on the
host, it is the host's pace through the phase."""

from __future__ import annotations


def _records() -> list | None:
    try:
        from hnanosolver_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    return None if read is None else read()


def ms_a_frame(run, names, clock: str = "device") -> float | None:
    """ms a traced frame in the spans named ``names``, summed: their
    ``device_ms`` or, with ``clock="host"``, their ``host_ms``; None where
    none was recorded or one has no such time."""
    recs, rec = _records(), run.rec
    if not recs or rec is None or not rec.frames:
        return None
    ms = [getattr(r, f"{clock}_ms") for r in recs if r.name in names]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / rec.frames


def count(module: str, name: str) -> int | None:
    """The program's always-on count ``name`` (a ``profiling.Count``
    attribute of the program module ``module``), None where it has none."""
    import importlib

    try:
        mod = importlib.import_module(module)
    except ImportError:
        return None
    c = getattr(mod, name, None)
    return getattr(c, "n", None)
