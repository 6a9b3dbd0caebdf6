"""Host-side sentinel policy — budget, escalation, and data quarantine.

A copy of ``repro.sentinel.policy`` (host logic; the port imports nothing of
``repro``).  The guard (``guard.py``) already made the step safe on the
device: an anomalous update was discarded before the host ever saw the
verdict.  This module owns everything that happens *after* the verdict rides
the runner's one per-step transfer:

* :class:`SentinelMonitor` — lifetime anomaly count against the budget, the
  consecutive-anomaly streak that escalates skip → rollback, the quarantined
  batch ranges, and an exact host mirror of the device
  :class:`~repro_torch.sentinel.guard.SentinelState` (persisted in checkpoint
  extra so resume/rollback rebuild the device state bitwise);
* :class:`AnomalyBudgetExceeded` — deliberately a plain ``RuntimeError``, NOT
  one of the runner's retriable fault types
  (``repro_torch.train.fault.RETRIABLE``): exhausting the budget must abort
  the run loudly, not trigger another restore cycle;
* :func:`quarantined_batch_iter` — the step-keyed data stream with
  quarantined ranges swapped to an alternate seed stream, so a rollback
  replay takes a different data path past the poison batch while every step
  outside the range stays bitwise on the primary stream.
"""
from __future__ import annotations

from repro_torch.sentinel.guard import SNAPSHOT_KEYS
from repro_torch.sentinel.spec import SentinelSpec

#: Seed offset of the quarantine replacement stream — disjoint from the
#: train stream (offset 0) and the eval stream (EVAL_SEED_OFFSET = 999).
QUARANTINE_SEED_OFFSET = 7777


class AnomalyBudgetExceeded(RuntimeError):
    """The run consumed its whole anomaly budget — fail loudly."""


class SentinelMonitor:
    """Host mirror of the sentinel: counters, escalation, quarantine.

    ``observe`` must run on every step's verdict (it keeps the device-
    state snapshot current for checkpointing); the runner acts on its
    boolean return *after* the hook pipeline has seen the step.
    """

    def __init__(self, sspec: SentinelSpec):
        self.spec = sspec
        self.anomalies = 0                 # lifetime count vs budget
        self.streak = 0                    # consecutive anomalies
        self.rollbacks = 0
        self.quarantined: list = []        # [lo, hi) step ranges
        self.snapshot: dict = {}           # last device-state snapshot

    # -- verdict intake ------------------------------------------------

    def observe(self, step: int, verdict: dict) -> bool:
        """Ingest one step's verdict; returns True when anomalous."""
        self.snapshot = {k: float(verdict[k]) for k in SNAPSHOT_KEYS}
        anomalous = verdict.get("anomaly", 0.0) > 0.0
        if anomalous:
            self.anomalies += 1
            self.streak += 1
        else:
            self.streak = 0
        return anomalous

    @staticmethod
    def classify(verdict: dict) -> str:
        """The dominant anomaly reason, in detection-priority order."""
        for reason in ("nonfinite", "spike", "trust"):
            if verdict.get(reason, 0.0) > 0.0:
                return reason
        return "unknown"

    # -- policy --------------------------------------------------------

    def exhausted(self) -> bool:
        return self.anomalies > self.spec.budget

    def wants_rollback(self) -> bool:
        return ("rollback" in self.spec.ladder
                and self.streak >= self.spec.rollback_after)

    def quarantine(self, lo: int, hi: int):
        """Mark steps [lo, hi) as quarantined and reset the streak (the
        replay takes a different data path, so the streak starts over)."""
        self.rollbacks += 1
        self.streak = 0
        if self.spec.quarantine and hi > lo:
            self.quarantined.append([int(lo), int(hi)])

    def is_quarantined(self, step: int) -> bool:
        return any(lo <= step < hi for lo, hi in self.quarantined)

    # -- persistence (checkpoint extra) --------------------------------

    def to_extra(self) -> dict:
        return {"anomalies": self.anomalies, "streak": self.streak,
                "rollbacks": self.rollbacks,
                "quarantined": [list(r) for r in self.quarantined],
                "state": dict(self.snapshot)}

    def load_extra(self, extra: dict):
        self.anomalies = int(extra.get("anomalies", 0))
        self.streak = int(extra.get("streak", 0))
        self.rollbacks = int(extra.get("rollbacks", 0))
        self.quarantined = [list(r) for r in extra.get("quarantined", [])]
        self.snapshot = dict(extra.get("state", {}))


def quarantined_batch_iter(spec, arch, start_step: int,
                           monitor: SentinelMonitor):
    """Step-keyed train stream with quarantined ranges substituted.

    Batches are a pure function of (spec, step), so substitution is
    exact: outside a quarantined range the primary stream's batch is
    yielded bitwise; inside, the batch comes from the same pipeline
    seeded with :data:`QUARANTINE_SEED_OFFSET` — deterministic across
    re-runs and resumes alike.
    """
    from repro_torch.run.data import make_batch_iter
    primary = make_batch_iter(spec, arch, start_step)
    step = start_step
    while True:
        batch = next(primary)
        if monitor.is_quarantined(step):
            batch = next(make_batch_iter(
                spec, arch, step, seed_offset=QUARANTINE_SEED_OFFSET))
        yield batch
        step += 1
