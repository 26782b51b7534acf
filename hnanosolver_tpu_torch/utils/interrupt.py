"""Cooperative cancellation — the HoudiniInterrupter analog.

The reference adapts Houdini's interrupt system to OpenVDB ops
(`reference/src/Utils/Utils.hpp:177-213`, constructed in every cook,
e.g. `SOP_HNanoSolver.cpp:103`) but never polls it inside the GPU pipeline,
so a cook cannot actually be cancelled once launched. Here the host driver
loops poll between frames — the natural cancellation point, a step being
one queue of device launches — and stop cleanly with the last
completed state, which the callers checkpoint.

Sources of interruption:
  - ``Interrupter.interrupt()`` from any thread (a UI, a watchdog)
  - SIGINT/SIGTERM when installed as a signal handler (``install_signals``)
  - a user ``poll`` callback (the Houdini ``opInterrupt`` analog)
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional


class Interrupted(RuntimeError):
    """Raised by ``check()`` when a cancellation was requested."""


class Interrupter:
    def __init__(self, poll: Optional[Callable[[], bool]] = None):
        self._event = threading.Event()
        self._poll = poll
        self._prev_handlers = []

    def interrupt(self) -> None:
        self._event.set()

    def was_interrupted(self) -> bool:
        if self._event.is_set():
            return True
        if self._poll is not None and self._poll():
            self._event.set()
            return True
        return False

    def check(self, where: str = "") -> None:
        """Raise ``Interrupted`` if cancellation was requested."""
        if self.was_interrupted():
            raise Interrupted(f"interrupted{f' at {where}' if where else ''}")

    # -- optional signal wiring (host driver processes) ---------------------
    def install_signals(self, signals=(signal.SIGINT, signal.SIGTERM)):
        for s in signals:
            self._prev_handlers.append((s, signal.getsignal(s)))
            signal.signal(s, lambda *_: self.interrupt())
        return self

    def restore_signals(self):
        for s, h in self._prev_handlers:
            signal.signal(s, h)
        self._prev_handlers.clear()

    def __enter__(self):
        return self.install_signals()

    def __exit__(self, *exc):
        self.restore_signals()
        return False
