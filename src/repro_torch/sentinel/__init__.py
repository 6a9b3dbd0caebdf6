"""Training sentinel (PyTorch) — in-step anomaly guard, policy ladder, and
fault-injection proof harness.  Counterpart of ``repro.sentinel``.

Detection lives in the step program (``guard.py``: device tensors, no host
sync), policy and quarantine on the host (``policy.py``), and the
deterministic fault injectors that prove the whole loop in ``inject.py``.
"""
from repro_torch.sentinel.guard import (SNAPSHOT_KEYS, SentinelState,
                                        guard_step, init_sentinel_state,
                                        state_from_snapshot)
from repro_torch.sentinel.inject import INJECT_KINDS, Injection
from repro_torch.sentinel.policy import (QUARANTINE_SEED_OFFSET,
                                         AnomalyBudgetExceeded,
                                         SentinelMonitor,
                                         quarantined_batch_iter)
from repro_torch.sentinel.spec import LADDER_RUNGS, SentinelSpec

__all__ = [
    "SNAPSHOT_KEYS", "SentinelState", "guard_step", "init_sentinel_state",
    "state_from_snapshot", "INJECT_KINDS", "Injection",
    "QUARANTINE_SEED_OFFSET", "AnomalyBudgetExceeded", "SentinelMonitor",
    "quarantined_batch_iter", "LADDER_RUNGS", "SentinelSpec",
]
