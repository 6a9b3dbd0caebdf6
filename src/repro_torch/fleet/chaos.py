"""Fault-injection harness (PyTorch): kill runs at configurable steps,
resume them, and prove recovery is exact.  A copy of ``repro.fleet.chaos``
over the port's ``run`` and ``CheckpointManager`` (host logic).

The rewind contract says a fault-recovered run reproduces the uninterrupted
run bitwise — history, eval curve, metrics JSONL and final state.  This
module extends that contract from in-process transient errors to *process
deaths*: :func:`chaos_run` executes a spec as a sequence of runs, each
killed at a scheduled step boundary (after the checkpoint hooks for that
boundary fired, like a preemption; or with the boundary's checkpoint
destroyed, like a crash mid-write), each restarted via the normal
``checkpoint.resume`` path, until one survives to the end.  Because the
data/eval streams are pure functions of the step and checkpoints are atomic,
the surviving run's record must equal the uninterrupted run's.

The sentinel extends the harness from process deaths to *optimizer faults*:
pass ``inject=Injection(kind="nan_grads", at_step=k)`` (re-exported here
from :mod:`repro_torch.sentinel.inject`) through ``run_kw`` and the step
guard takes the hit instead of the moments — injected chaos runs must
complete, skip the poisoned update bitwise, and still resume bitwise across
kills.  ``run_kw`` also carries ``device=`` (``"cpu"`` off the card).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.run import hooks as hooks_lib
from repro_torch.sentinel.inject import INJECT_KINDS, Injection  # noqa: F401 (re-export)


class SimulatedKill(BaseException):
    """The chaos harness killed the run at ``step`` (boundary).  Derives
    from BaseException so no retry/recovery machinery can swallow it —
    like a real SIGKILL, nothing in the run layer gets to object."""

    def __init__(self, step: int):
        self.step = step
        super().__init__(f"chaos kill at step boundary {step}")


class KillAtHook(hooks_lib.Hook):
    """Raise :class:`SimulatedKill` at the ``at_step`` boundary.  As a
    user hook it runs after the default pipeline, so the boundary's
    checkpoint/metrics writes have already happened — the kill lands
    between "state durable" and "next step", the preemption-shaped
    worst case for bookkeeping."""

    def __init__(self, at_step: int):
        self.at_step = at_step

    def on_step_end(self, ctx, ev: hooks_lib.StepEvent) -> None:
        if ev.step + 1 == self.at_step:
            raise SimulatedKill(self.at_step)


def _wreck_latest(manager_dir) -> None:
    """Turn the newest checkpoint into a crash-mid-write orphan (delete
    its ``_COMPLETE`` marker) — the ``gc_incomplete`` machinery must then
    resume from the previous complete step."""
    from pathlib import Path
    steps = sorted(Path(manager_dir).glob("step_*"))
    if steps:
        marker = steps[-1] / "_COMPLETE"
        if marker.exists():
            marker.unlink()


@dataclasses.dataclass
class ChaosReport:
    kills: list            # [(step, resumed_from_step)]
    result: object         # final RunResult


def chaos_run(spec, kill_at: Sequence[int], *, wreck_last_save: bool = False,
              log_fn=lambda s: None, **run_kw) -> ChaosReport:
    """Run ``spec`` to completion through ``len(kill_at)`` kill/restore
    cycles.

    ``spec`` must have a checkpoint dir (``every > 0``); every attempt
    runs with ``resume=True`` + ``gc_incomplete=True`` so each restart is
    exactly what a re-invoked launcher would do.  ``wreck_last_save=True``
    additionally corrupts the newest checkpoint after each kill (crash
    mid-write), forcing resume from the previous complete step.
    ``run_kw`` is forwarded to every ``run()`` call (e.g. ``arch=`` for
    ad-hoc configs).
    """
    from repro_torch.run.runner import run

    ck = spec.checkpoint
    if not (ck.dir and ck.every):
        raise ValueError("chaos_run requires checkpoint.dir and .every")
    spec = dataclasses.replace(
        spec, checkpoint=dataclasses.replace(ck, resume=True,
                                             gc_incomplete=True))

    kills = []
    for at in kill_at:
        try:
            run(spec, hooks=(KillAtHook(at),), log_fn=log_fn, **run_kw)
            raise AssertionError(
                f"kill at step {at} never fired (total={spec.steps.total})")
        except SimulatedKill:
            pass
        if wreck_last_save:
            _wreck_latest(ck.dir)
        from repro_torch.checkpoint.manager import CheckpointManager
        # discovery already ignores incomplete dirs; the *next* run's
        # gc_incomplete reclaims them (the crash-mid-write machinery)
        resumed_from = CheckpointManager(ck.dir).latest_step() or 0
        kills.append((at, resumed_from))
        log_fn(f"chaos: killed at {at}, next resume from {resumed_from}")

    result = run(spec, log_fn=log_fn, **run_kw)
    return ChaosReport(kills=kills, result=result)
