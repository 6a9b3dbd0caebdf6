"""SentinelSpec — declarative configuration for the training sentinel.

One frozen dataclass rides :class:`repro_torch.run.spec.RunSpec` (field
``sentinel``) and parameterises the whole detection → policy → recovery
stack:

* **detection thresholds** — spike EMA decay/warmup/factor and the
  per-group trust-ratio ceiling — consumed by
  :func:`repro_torch.sentinel.guard.guard_step`;
* **policy ladder** — an ordered tuple of rungs drawn from
  ``("skip", "backoff", "rollback")``.  ``skip`` is mandatory and always
  first: every anomalous update is discarded in-graph before any host
  policy runs, so the moments can never be poisoned no matter what the
  host decides afterwards;
* **budget** — a lifetime anomaly allowance; exhausting it raises
  :class:`repro_torch.sentinel.policy.AnomalyBudgetExceeded` (loud failure,
  not silent degradation).

A copy of ``repro.sentinel.spec`` (the port imports nothing of ``repro``), so
that ``RunSpec.to_json()`` is byte-identical in both packages.  The guard is
``repro_torch.sentinel.guard``, the policies ``repro_torch.sentinel.policy``.
"""
from __future__ import annotations

import dataclasses

#: Valid policy rungs, in escalation order.
LADDER_RUNGS = ("skip", "backoff", "rollback")


@dataclasses.dataclass(frozen=True)
class SentinelSpec:
    """Anomaly-guard configuration (all fields have safe defaults).

    enabled        master switch; off keeps the 4-arg step signature and
                   adds zero overhead to the program.
    ladder         policy rungs, ``"skip"`` first.  ``backoff`` adds a
                   transient lr scale-down after each anomaly;
                   ``rollback`` restores the last-good checkpoint after
                   ``rollback_after`` consecutive anomalies and
                   quarantines the offending batch range.
    ema_decay      decay of the update-norm EMA used as the spike
                   reference.
    warmup         number of *clean* steps before the spike guard arms.
    spike_factor   anomaly when ``update_norm > spike_factor * ema``
                   (bias-corrected).
    trust_max      per-GroupSpec trust-ratio ceiling (0 disables the
                   trust guard).
    backoff_scale  lr multiplier while a backoff window is active.
    backoff_window number of clean steps a backoff persists.
    rollback_after consecutive anomalies that escalate skip → rollback.
    budget         lifetime anomaly allowance before the run aborts.
    quarantine     replay rolled-back steps from the quarantine data
                   stream instead of re-feeding the offending batches.
    """

    enabled: bool = False
    ladder: tuple = ("skip",)
    ema_decay: float = 0.9
    warmup: int = 5
    spike_factor: float = 10.0
    trust_max: float = 0.0
    backoff_scale: float = 0.1
    backoff_window: int = 8
    rollback_after: int = 3
    budget: int = 8
    quarantine: bool = True

    def __post_init__(self):
        ladder = tuple(self.ladder)
        object.__setattr__(self, "ladder", ladder)
        if not ladder or ladder[0] != "skip":
            raise ValueError(
                f"sentinel ladder must start with 'skip', got {ladder!r}")
        for rung in ladder:
            if rung not in LADDER_RUNGS:
                raise ValueError(
                    f"unknown sentinel rung {rung!r}; valid: {LADDER_RUNGS}")
        if len(set(ladder)) != len(ladder):
            raise ValueError(f"duplicate sentinel rungs in {ladder!r}")
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {self.ema_decay}")
        if self.warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {self.warmup}")
        if self.spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {self.spike_factor}")
        if self.trust_max < 0.0:
            raise ValueError(f"trust_max must be >= 0, got {self.trust_max}")
        if not 0.0 < self.backoff_scale <= 1.0:
            raise ValueError(
                f"backoff_scale must be in (0, 1], got {self.backoff_scale}")
        if self.backoff_window < 1:
            raise ValueError(
                f"backoff_window must be >= 1, got {self.backoff_window}")
        if self.rollback_after < 1:
            raise ValueError(
                f"rollback_after must be >= 1, got {self.rollback_after}")
        if self.budget < 1:
            raise ValueError(f"budget must be >= 1, got {self.budget}")
