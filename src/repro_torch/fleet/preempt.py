"""Preemption safety: SIGTERM/SIGINT → boundary checkpoint → resumable exit.

A copy of ``repro.fleet.preempt`` over the port's run layer (host logic).

Preemptible capacity is the cheapest capacity there is, and the paper's
whole pitch is lowering the hardware barrier — so a run must treat
"the scheduler wants this machine back" as a normal event, not a crash.
The protocol:

  1. :class:`PreemptionHook` installs SIGTERM/SIGINT handlers for the
     duration of the run (main thread only; originals restored on exit).
  2. A first signal only sets a flag — the in-flight step finishes.
  3. At the next step boundary the hook saves ``(params, opt_state)``
     through the run's checkpoint manager (even between regular
     ``checkpoint.every`` boundaries), writes the manager's
     ``_PREEMPTED.json`` marker, and raises :class:`Preempted`.
  4. ``run()``'s ``finally`` gives every hook its ``on_exit`` (metrics
     files close, async saves drain), then the launcher maps
     :class:`Preempted` to :data:`PREEMPTED_EXIT_CODE` (75, EX_TEMPFAIL:
     "retry me") so schedulers and sweep launchers can distinguish
     preemption from success (0) and crash (anything else).
  5. A second signal restores the original handlers, so a double Ctrl-C
     still force-quits a wedged run.

The resumed run (``checkpoint.resume=True``) restores the boundary
checkpoint, consumes (clears) the marker, and — because the data/eval
streams are pure functions of the step — reproduces the uninterrupted
run bitwise (``tests/test_torch_preempt.py`` and ``chip_smoke.py``'s
``resume`` phase show it).
"""
from __future__ import annotations

import signal
import threading
from typing import Optional

from repro_torch.run import hooks as hooks_lib

# EX_TEMPFAIL: the sysexits.h "temporary failure; retry" code.
PREEMPTED_EXIT_CODE = 75

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class Preempted(Exception):
    """The run checkpointed and exited on a preemption signal; it is
    resumable from ``step`` (also recorded in the checkpoint dir's
    ``_PREEMPTED.json`` marker)."""

    def __init__(self, step: int, signum: int):
        self.step = step
        self.signum = signum
        super().__init__(f"preempted by signal {signum}; "
                         f"checkpointed at step {step} (resumable)")


class PreemptionHook(hooks_lib.Hook):
    """Catch SIGTERM/SIGINT, checkpoint at the next step boundary, exit
    resumable.  Registered by the default pipeline whenever the run has a
    checkpoint manager (``spec.fault.preempt``); placed *after*
    CheckpointHook so a boundary that coincides with a scheduled save
    reuses it instead of saving twice."""

    def __init__(self, manager=None):
        self.manager = manager         # default: ctx.ckpt_manager
        self.requested: Optional[int] = None
        self.fired = False
        self._originals: dict = {}

    # signal handlers are process-global state: only install when we own
    # the main thread (signal.signal raises ValueError elsewhere)
    def _installable(self) -> bool:
        return threading.current_thread() is threading.main_thread()

    def _handler(self, signum, frame) -> None:
        if self.requested is not None:
            # second signal: restore default behavior → force quit works
            self._restore()
            signal.raise_signal(signum)
            return
        self.requested = signum

    def _restore(self) -> None:
        for sig, original in self._originals.items():
            signal.signal(sig, original)
        self._originals = {}

    def on_run_start(self, ctx) -> None:
        if self.manager is None:
            self.manager = ctx.ckpt_manager
        if self.manager is not None:
            # this run consumes any marker a preempted predecessor left
            self.manager.clear_preempt_marker()
        if self._installable():
            for sig in _SIGNALS:
                self._originals[sig] = signal.signal(sig, self._handler)

    def on_step_end(self, ctx, ev: hooks_lib.StepEvent) -> None:
        if self.requested is None:
            return
        step = ev.step + 1
        signum = self.requested
        if self.manager is not None:
            if self.manager.latest_step() != step:
                # off-boundary save: the whole point of the protocol
                self.manager.save(step, (ctx.params, ctx.opt_state),
                                  extra={"data_step": step,
                                         "preempted": True})
            self.manager.wait()        # durable before we report resumable
            self.manager.write_preempt_marker(step, signum=int(signum))
        metrics = hooks_lib.find_metrics_hook(ctx.hooks)
        if metrics is not None:
            metrics.annotate("preempted", step, signum=int(signum))
        self.fired = True
        ctx.log(f"preempted (signal {signum}): checkpointed step {step}, "
                f"exiting resumable")
        raise Preempted(step, signum)

    def on_exit(self, ctx) -> None:
        self._restore()
