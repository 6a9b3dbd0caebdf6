"""Run API v1 (PyTorch) — declarative RunSpec + step program + hook pipeline.

    spec = RunSpec(model=ModelSpec("h2o-danube-1.8b", smoke=True),
                   data=DataConfig(vocab=0, seq_len=128, global_batch=8),
                   opt=OptSpec(name="adalomo"), steps=StepSpec(total=100))
    result = run(spec)                     # on the card; device="cpu" for CPU
"""
from repro_torch.run.hooks import (CheckpointHook, EvalHook, HeartbeatHook,
                                   HistoryHook, Hook, LoggingHook,
                                   MetricsHook, ProfilerHook, StepEvent,
                                   StragglerHook, TimingHook,
                                   find_metrics_hook)
from repro_torch.run.program import StepProgram, build_step_program
from repro_torch.run.runner import RunContext, RunResult, run
from repro_torch.run.spec import (DEFAULT_LRS, CheckpointSpec, EvalSpec,
                                  FaultSpec, MeshSpec, ModelSpec, OptSpec,
                                  ProfileSpec, RunSpec, StepSpec)
from repro_torch.sentinel.spec import SentinelSpec
from repro_torch.telemetry.probes import ObservabilitySpec

__all__ = [
    "RunSpec", "ModelSpec", "OptSpec", "StepSpec", "MeshSpec",
    "CheckpointSpec", "EvalSpec", "FaultSpec", "ProfileSpec",
    "ObservabilitySpec", "SentinelSpec", "DEFAULT_LRS",
    "StepProgram", "build_step_program",
    "Hook", "StepEvent", "HistoryHook", "LoggingHook", "MetricsHook",
    "EvalHook", "CheckpointHook", "HeartbeatHook", "StragglerHook",
    "TimingHook", "ProfilerHook", "find_metrics_hook",
    "run", "RunResult", "RunContext",
]
