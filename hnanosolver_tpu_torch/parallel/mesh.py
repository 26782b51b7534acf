"""A device mesh and ``shard_map`` for the sharded step, the port's form of
the JAX package's ``jax.sharding.Mesh`` and ``shard_map`` with its
collectives (``ppermute``, ``psum``, ``pmax``).

JAX's ``shard_map`` is single-controller: one Python process drives every
device. So is this one, with one thread a device:

- :class:`Mesh` is D ``torch.device`` entries and an axis name. The same
  device may appear more than once: D slabs on one card, or D entries of
  ``cpu`` (the port's form of the JAX tests' forced host devices).
- A sharded array is a list of D per-device blocks, block d on
  ``mesh.devices[d]``.
- :func:`shard_map` runs ``fn(axis, *blocks_d)`` for each d in its own
  thread, under its device; ``axis`` (:class:`AxisComm`) carries the
  collectives. Every device makes the same sequence of collective calls.
- A collective posts this device's value, meets the others at one
  ``threading.Barrier`` and reads what it needs from theirs (across cards
  by a peer copy; on one device the copy is a no-op). Posted values are
  double-buffered by call parity, so one barrier a call suffices: a device
  can overwrite a slot only after the next barrier, which every device
  reaches only once it has read the slot.
- The kernels and torch ops of all devices go to each device's current
  stream, the default one in every thread, so a value posted before a
  barrier is ready, in stream order, for any op enqueued after it.

- One thread at a time runs between collectives: it holds the group's turn
  lock, which it lets go only to wait at a barrier. The threads share one
  interpreter lock, and a torch op lets that lock go and takes it back;
  with the other threads runnable, every op would hand it to another
  thread (a context switch an op, ~50 us on the card's host, PERF.md
  section 6). Waiting on the turn lock, they do not contend for it. The
  host work is serial either way; the devices' work stays asynchronous.

A thread that raises aborts the barrier, so the others leave their wait
with ``BrokenBarrierError``; :func:`shard_map` joins every thread and
re-raises the first original error. Devices that make different
collective calls (a divergent stopping decision, say) raise at the first
barrier where the calls differ, or at the closing one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Sequence

import torch

from hnanosolver_tpu_torch.core.topology import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[d]`` holds block d of every sharded array."""

    devices: tuple
    axis: str = "x"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_indexed(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device with its index."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: int | None = None, axis: str = "x", device=None) -> Mesh:
    """A mesh of ``n_devices`` entries: with ``device`` (e.g. ``"cpu"`` or
    ``"cuda:0"``) that device n times (default 1), else the first
    ``n_devices`` CUDA cards (default all), raising when there are fewer."""
    if device is not None:
        return Mesh((resolve_device(device),) * (n_devices or 1), axis)
    resolve_device(None)  # raises without a card
    count = torch.cuda.device_count()
    n = n_devices or count
    if count < n:
        raise ValueError(f"need {n} devices, have {count}")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


class _Group:
    """What the D threads of one :func:`shard_map` call share."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = ([None] * n, [None] * n)
        self.turn = threading.Lock()  # held by the one thread that runs


class AxisComm:
    """One device's end of a mesh axis inside :func:`shard_map`: its rank,
    its device and the collectives over the axis."""

    def __init__(self, group: _Group, name: str, rank: int, device: torch.device):
        self._group = group
        self._calls = 0
        self._turn = False  # this thread holds the group's turn lock
        self.name = name
        self.rank = rank
        self.device = device

    def _take_turn(self) -> None:
        self._group.turn.acquire()
        self._turn = True

    def _give_turn(self) -> None:
        if self._turn:
            self._turn = False
            self._group.turn.release()

    def _exchange(self, kind: str, value) -> list:
        """Post ``value``, wait for every device, return all D posted values."""
        slot = self._group.slots[self._calls & 1]
        self._calls += 1
        slot[self.rank] = (kind, value)
        self._give_turn()
        self._group.barrier.wait()
        self._take_turn()
        kinds = sorted({k for k, _ in slot})
        if len(kinds) != 1:
            raise RuntimeError(f"the devices of mesh axis {self.name!r} diverged: the "
                               f"collectives {kinds} met at one barrier")
        return [v for _, v in slot]

    def ppermute(self, xs: Sequence[torch.Tensor], perms: Sequence) -> list:
        """``lax.ppermute`` of each ``xs[i]`` along ``perms[i]`` ((source,
        target) pairs), all behind one barrier. Entry i is the value sent to
        this device, on its device, or None where no pair targets it (JAX
        gives zeros there)."""
        posted = self._exchange("ppermute", tuple(xs))
        out = []
        for i, perm in enumerate(perms):
            src = next((s for s, t in perm if t == self.rank), None)
            out.append(None if src is None else posted[src][i].to(self.device))
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every device's ``x``, added in rank order (the same
        value on every device)."""
        posted = self._exchange("psum", x)
        total = posted[0].to(self.device)
        for v in posted[1:]:
            total = total + v.to(self.device)
        return total

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every device's ``x``."""
        posted = self._exchange("pmax", x)
        out = posted[0].to(self.device)
        for v in posted[1:]:
            out = torch.maximum(out, v.to(self.device))
        return out


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_map(fn: Callable, mesh: Mesh, *blocks: Sequence) -> list:
    """``[fn(axis_d, *(b[d] for b in blocks)) for d]``, each call in its own
    thread under ``mesh.devices[d]``, with ``axis_d`` its :class:`AxisComm`.
    Each of ``blocks`` has one entry a device. Raises the first error of any
    thread once every thread has ended."""
    n = mesh.size
    if any(len(b) != n for b in blocks):
        raise ValueError(f"every argument needs {n} blocks, one a device")
    group = _Group(n)
    results, errors = [None] * n, [None] * n

    def run(d: int):
        dev = mesh.devices[d]
        axis = AxisComm(group, mesh.axis, d, dev)
        try:
            with _on(dev):
                axis._take_turn()
                results[d] = fn(axis, *(b[d] for b in blocks))
                axis._exchange("exit", None)  # every device made the same calls
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller below
            errors[d] = e
            group.barrier.abort()
        finally:
            axis._give_turn()

    threads = [threading.Thread(target=run, args=(d,), name=f"shard_map-{mesh.axis}{d}")
               for d in range(n)]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except BaseException:
        group.barrier.abort()
        for t in threads:
            t.join()
        raise
    raised = [e for e in errors if e is not None]
    if raised:
        raise next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)),
                   raised[0])
    return results
