"""The hook pipeline: ordered callbacks on an event protocol.

Counterpart of ``repro.run.hooks``, holding the hooks ported so far
(history, logging, timing).  Events, dispatched in hook-list order by
``repro_torch.run.runner.run``:

  ``on_run_start(ctx)``     once, before the first step;
  ``on_step_end(ctx, ev)``  after every completed step, with a
                            :class:`StepEvent`;
  ``on_exit(ctx)``          once, after the last step (also on the exception
                            path).

The reference's ``on_eval`` and ``on_recover`` events come with the eval hook
and fault recovery, which are not ported yet.

Hooks are host-side only: they see host scalars and never read a device
value themselves.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


@dataclasses.dataclass
class StepEvent:
    """What ``on_step_end`` sees: the 0-based step index, **host** scalars
    (loss, metrics dict, hparams dict — the runner performs ONE bundled
    device-to-host transfer per step and converts to Python floats before
    dispatch), and the host wall-clock seconds since the previous step."""

    step: int
    loss: Any
    metrics: Any
    hparams: dict
    dt: float


class Hook:
    """Base class: every event defaults to a no-op, so hooks implement
    only what they observe."""

    def on_run_start(self, ctx) -> None:
        pass

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        pass

    def on_exit(self, ctx) -> None:
        pass


class HistoryHook(Hook):
    """Captures the training curve.  The dict has the reference's keys; the
    eval ones stay empty until the eval hook is ported."""

    def __init__(self):
        self.history = {"step": [], "loss": [], "accuracy": [], "lr": [],
                        "eval_loss": [], "eval_step": []}

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        self.history["step"].append(ev.step)
        self.history["loss"].append(ev.loss)
        self.history["accuracy"].append(ev.metrics["accuracy"])
        self.history["lr"].append(ev.hparams["lr"])



class LoggingHook(Hook):
    def __init__(self, every: int, log_fn: Callable[[str], None] = print,
                 total: Optional[int] = None):
        self.every = every
        self.log = log_fn
        self.total = total

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        last = self.total is not None and ev.step == self.total - 1
        if self.every and (ev.step % self.every == 0 or last):
            self.log(f"step {ev.step:5d} loss {ev.loss:.4f} "
                     f"acc {ev.metrics['accuracy']:.3f} "
                     f"lr {ev.hparams['lr']:.2e} "
                     f"({ev.dt*1e3:.0f} ms)")


class TimingHook(Hook):
    """Wall-clock accounting: total run seconds, mean us/step, and each
    step's seconds (``ev.dt`` ends at the step's one host transfer, which
    waits for the device, so it is the step's real time)."""

    def __init__(self):
        self.t0 = None
        self.wall_s = 0.0
        self.n_steps = 0
        self.step_s: list = []

    def on_run_start(self, ctx) -> None:
        self.t0 = time.time()

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        self.n_steps += 1
        self.step_s.append(ev.dt)

    def on_exit(self, ctx) -> None:
        if self.t0 is not None:
            self.wall_s = time.time() - self.t0

    @property
    def us_per_step(self) -> float:
        return self.wall_s / max(self.n_steps, 1) * 1e6
