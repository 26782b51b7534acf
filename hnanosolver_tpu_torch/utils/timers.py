"""Timing and bandwidth instrumentation, the JAX package's
``utils/timers.py`` on PyTorch.

The reference wraps every phase in RAII timers that print elapsed ms and a
modeled effective bandwidth ``voxels * bytes_per_voxel / time``
(``reference/src/Utils/ScopedTimer.hpp:11-24``,
``reference/src/Cuda/Utils.cuh:246-277``). Here the same accounting is a
context manager that fences on its result, plus the voxel-updates/s
metric. The bytes/voxel constants are the reference's own models
(HNanoSolver.cu call sites), kept for bandwidth reporting beside the JAX
package's.

Times come from ``timing.time_ms``: CUDA events on the card, the host
clock on the CPU. ``Profiler.scope`` reads the host clock around its block
and a synchronise on the result's device, as the JAX package's
``block_until_ready`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from hnanosolver_tpu_torch.timing import time_ms

# bytes/voxel models from the reference's ScopedTimerGPU call sites
# (``reference/src/Cuda/HNanoSolver.cu:163,173,182,212,227,258,279,343``)
REFERENCE_BYTES_PER_VOXEL = {
    "advect_velocity": 132,
    "vorticity": 516,
    "divergence": 88,
    "combustion": 36,
    "buoyancy": 28,
    "pressure_per_iter": 48,
    "projection": 48,
    "advect_scalars": 76,
}


def full_step_bytes_per_voxel(iterations: int, num_scalars: int = 5) -> int:
    """Modeled HBM traffic per active voxel for one full step, using the
    reference's accounting (pressure counted per iteration)."""
    b = REFERENCE_BYTES_PER_VOXEL
    return (
        b["advect_velocity"]
        + b["vorticity"]
        + b["divergence"]
        + b["combustion"]
        + b["buoyancy"]
        + b["pressure_per_iter"] * iterations
        + b["projection"]
        + b["advect_scalars"]
    )


@dataclasses.dataclass
class TimerRecord:
    name: str
    elapsed_s: float
    voxels: int = 0
    bytes_per_voxel: int = 0

    @property
    def voxel_updates_per_s(self) -> float:
        return self.voxels / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def modeled_gb_per_s(self) -> float:
        return (
            self.voxels * self.bytes_per_voxel / 1e9 / self.elapsed_s
            if self.elapsed_s > 0
            else 0.0
        )

    def __str__(self):
        s = f"{self.name} Time: {self.elapsed_s * 1e3:.3f} ms"
        if self.voxels:
            s += f" | {self.voxel_updates_per_s / 1e6:.1f} Mvox/s"
        if self.bytes_per_voxel:
            s += f" | {self.modeled_gb_per_s:.1f} GB/s (modeled)"
        return s


def first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor of a tensor, a FieldState-like object (its
    ``velocity``), a sequence or a dict; None if there is none."""
    if isinstance(tree, torch.Tensor):
        return tree
    if hasattr(tree, "velocity"):
        return tree.velocity
    if isinstance(tree, dict):
        tree = list(tree.values())
    for x in tree if isinstance(tree, (list, tuple)) else ():
        t = first_tensor(x)
        if t is not None:
            return t
    return None


def fence(tree) -> None:
    """Wait until the device that holds ``tree``'s first tensor has finished
    its work (a no-op on the CPU)."""
    t = first_tensor(tree)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _device(tree) -> torch.device:
    t = first_tensor(tree)
    return t.device if t is not None else torch.device("cpu")


@dataclasses.dataclass
class Profiler:
    """Collects TimerRecords; ``scope`` waits until the block's result (put
    under ``out["result"]``) is computed, so a record measures the device's
    work (the reference's cudaEvent timers sync in their destructor)."""

    records: List[TimerRecord] = dataclasses.field(default_factory=list)
    verbose: bool = False

    @contextlib.contextmanager
    def scope(self, name: str, voxels: int = 0, bytes_per_voxel: int = 0):
        out: Dict[str, object] = {}
        t0 = time.perf_counter()
        yield out
        if "result" in out:
            fence(out["result"])
        rec = TimerRecord(name, time.perf_counter() - t0, voxels, bytes_per_voxel)
        self.records.append(rec)
        if self.verbose:
            print(rec)

    def total(self, name: Optional[str] = None) -> float:
        return sum(r.elapsed_s for r in self.records if name is None or r.name == name)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kw) -> float:
    """Median seconds a call of ``fn`` after ``warmup`` calls, on the device
    of its first tensor argument (CUDA events on the card, the host clock on
    the CPU)."""
    for _ in range(warmup):
        fence(fn(*args, **kw))
    ms = time_ms(lambda: fence(fn(*args, **kw)), iters,
                 device=_device([*args, *kw.values()]))
    return statistics.median(ms) / 1e3


def chain_slope(fn: Callable, x0, lo: int, hi: int, repeats: int) -> float:
    """Seconds per application of ``fn`` (a map from a tensor tree to a like
    tree): the best of ``repeats`` runs of ``hi`` dependent applications
    against the best of ``lo``, over ``hi - lo``; the difference cancels
    each run's fixed cost (its launch and the fence)."""
    def run(k):
        x = x0
        for _ in range(k):
            x = fn(x)
        fence(x)

    dev = _device(x0)
    run(lo)  # warm
    run(hi)
    best = {k: min(time_ms(lambda: run(k), repeats, device=dev)) for k in (lo, hi)}
    return max(best[hi] - best[lo], 1e-6) / 1e3 / (hi - lo)


def time_chained(step_fn: Callable, state, n_steps: int = 8, repeats: int = 3) -> float:
    """Seconds a step: ``n_steps`` dependent applications of ``step_fn``
    against one (:func:`chain_slope`)."""
    return chain_slope(step_fn, state, 1, n_steps, repeats)
