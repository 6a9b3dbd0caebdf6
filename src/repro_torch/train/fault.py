"""Fault tolerance for long-running training (PyTorch).

Counterpart of ``repro.train.fault``:

  * ``Heartbeat`` — a watchdog thread that marks the process wedged if the
    training loop stops reporting progress; it fires a callback.
  * ``StragglerMonitor`` — an EMA of step times; steps slower than
    ``factor``× the EMA are recorded so a coordinator can evict the slow
    host.
  * ``retrying`` — wraps a step function; transient device errors call
    ``on_failure`` (where a loop restores from checkpoint) and retry.

The transient error is ``torch.AcceleratorError`` (:data:`RETRIABLE`): a
device-side fault reported by the CUDA runtime.  Not every such error can
be recovered in the same process: after a *sticky* CUDA error (an illegal
address, a trapped kernel) the CUDA context is dead, so the restore itself
raises and the error propagates.  Recovery is then a new process that
resumes from the checkpoint (``checkpoint.resume``).  Programming errors
(plain ``RuntimeError``) and ``torch.cuda.OutOfMemoryError`` are not
transient and are never retried.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

RETRIABLE = (torch.AcceleratorError,)


class Heartbeat:
    def __init__(self, timeout_s: float, on_stall: Callable[[], None]):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self.stalled = False

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def _watch(self):
        while not self._stop.wait(self.timeout_s / 4):
            if time.monotonic() - self._last > self.timeout_s:
                self.stalled = True
                try:
                    self.on_stall()
                finally:
                    return


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, ema: float = 0.9):
        self.factor = factor
        self.ema_coef = ema
        self.ema: Optional[float] = None
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.factor * self.ema
        if slow:
            self.events.append((step, dt, self.ema))
        self.ema = self.ema_coef * self.ema + (1 - self.ema_coef) * dt
        return slow


def retrying(fn: Callable, *, retries: int = 2,
             on_failure: Optional[Callable[[int, Exception], None]] = None,
             retriable: tuple = RETRIABLE):
    """Retry a step function on transient device errors;
    ``on_failure(attempt, e)`` is where the loop restores from checkpoint."""

    def wrapped(*a, **kw):
        for attempt in range(retries + 1):
            try:
                return fn(*a, **kw)
            except retriable as e:
                if attempt == retries:
                    raise
                if on_failure is not None:
                    on_failure(attempt, e)
        raise AssertionError("unreachable")

    return wrapped
