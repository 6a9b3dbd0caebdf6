"""The resilience layer over the Run API (PyTorch).  Ported so far:

  * ``preempt``  — SIGTERM/SIGINT → boundary checkpoint → resumable marker
                   → exit :data:`PREEMPTED_EXIT_CODE`;
  * ``chaos``    — fault injection: kill/resume cycles, and the sentinel's
                   injected optimizer faults, that must stay bitwise-equal
                   to the uninterrupted run;
  * ``sweep``    — fan a base RunSpec across declarative overrides into
                   crash-isolated, individually resumable members with
                   one merged, ranked report (``launch/sweep.py`` CLI);
  * ``elastic``  — run a RunSpec ZeRO-3 sharded on ``spec.mesh.shape`` and
                   resume it on another mesh (``run()`` hands a spec with
                   a mesh shape to :func:`run_elastic`).
"""
from repro_torch.fleet.chaos import (INJECT_KINDS, ChaosReport, Injection,
                                     KillAtHook, SimulatedKill, chaos_run)
from repro_torch.fleet.elastic import (ElasticCheckpoints, mesh_from_spec,
                                       program_shardings, run_elastic)
from repro_torch.fleet.preempt import (PREEMPTED_EXIT_CODE, Preempted,
                                       PreemptionHook)
from repro_torch.fleet.sweep import (SweepMember, apply_overrides,
                                     build_report, expand_grid, materialize,
                                     member_name, run_sweep)

__all__ = ["Preempted", "PreemptionHook", "PREEMPTED_EXIT_CODE",
           "SimulatedKill", "KillAtHook", "chaos_run", "ChaosReport",
           "Injection", "INJECT_KINDS",
           "expand_grid", "apply_overrides", "materialize", "member_name",
           "SweepMember", "run_sweep", "build_report",
           "mesh_from_spec", "program_shardings", "ElasticCheckpoints",
           "run_elastic"]
