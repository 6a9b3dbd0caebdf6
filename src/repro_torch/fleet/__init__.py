"""The resilience layer over the Run API (PyTorch).  Ported so far:

  * ``preempt``  — SIGTERM/SIGINT → boundary checkpoint → resumable marker
                   → exit :data:`PREEMPTED_EXIT_CODE`;
  * ``chaos``    — fault injection: kill/resume cycles, and the sentinel's
                   injected optimizer faults, that must stay bitwise-equal
                   to the uninterrupted run.

The reference's ``elastic`` and ``sweep`` come with scale-out.
"""
from repro_torch.fleet.chaos import (INJECT_KINDS, ChaosReport, Injection,
                                     KillAtHook, SimulatedKill, chaos_run)
from repro_torch.fleet.preempt import (PREEMPTED_EXIT_CODE, Preempted,
                                       PreemptionHook)

__all__ = ["Preempted", "PreemptionHook", "PREEMPTED_EXIT_CODE",
           "SimulatedKill", "KillAtHook", "chaos_run", "ChaosReport",
           "Injection", "INJECT_KINDS"]
