"""The resilience layer over the Run API (PyTorch).  Ported so far:

  * ``preempt``  — SIGTERM/SIGINT → boundary checkpoint → resumable marker
                   → exit :data:`PREEMPTED_EXIT_CODE`.

The reference's ``elastic``, ``chaos`` and ``sweep`` come with scale-out.
"""
from repro_torch.fleet.preempt import (PREEMPTED_EXIT_CODE, Preempted,
                                       PreemptionHook)

__all__ = ["Preempted", "PreemptionHook", "PREEMPTED_EXIT_CODE"]
