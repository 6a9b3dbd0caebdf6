"""RunSpec — the declarative, serializable description of one run.

The port's copy of ``repro.run.spec``: the same dataclasses with the same
fields and defaults, so ``RunSpec.to_json()`` is byte-identical in both
packages and one spec file drives both.  Fields of layers that are not ported
yet (sentinel, observe, mesh.shape, packing) are kept for that reason;
``build_step_program``/``run`` raise ``NotImplementedError`` when a spec turns
one on.

A :class:`RunSpec` is everything the run layer needs to reconstruct a
training (or dry-run) scenario: which architecture at which shape, the
data configuration, the Opt-v2 optimizer (rule name + static factory
kwargs + dynamic hparams + schedule), mesh/sharding mode, microbatching,
and the checkpoint / eval / fault policies.  It is plain data — nested
frozen dataclasses of JSON-scalar fields — so a spec round-trips through
``to_json`` / ``from_json`` losslessly and can be logged next to every
artifact.  ``launch/train.py`` is just ``RunSpec.from_cli()`` + ``run()``.

Two things are deliberately *not* in the spec:

* **Param groups.**  ``GroupSpec`` predicates are Python callables and
  can't serialize; ``build_step_program(spec, groups=...)`` takes them as
  a Python-level argument.  The default (``None``) is the paper-standard
  no-decay-on-1-D grouping whenever the rule has a ``weight_decay``
  hparam.
* **Live objects** (archs, iterators, hooks).  ``run()`` accepts those as
  overrides for programmatic callers (benchmarks warm-starting params,
  tests injecting batch iterators); the spec stays declarative.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional

from repro_torch.data.pipeline import DataConfig
from repro_torch.sentinel.spec import SentinelSpec
from repro_torch.telemetry.probes import ObservabilitySpec

# Paper hyper-parameters (Table 6/7): AdaLomo lr ≈ 5e-4 (IT) / 1e-3
# (pretrain); AdamW 1e-5..2e-5; LOMO/SGD 1e-2.
DEFAULT_LRS = {"adalomo": 5e-4, "adafactor": 5e-4, "adamw": 2e-5,
               "lomo": 1e-2, "sgd": 1e-2, "sgd_momentum": 1e-2,
               "sgd_variance": 5e-4}

# Optimizers whose update is fused into the backward scan by default
# (LOMO-mechanism rules); the baselines default to the unfused path.
FUSED_BY_DEFAULT = ("adalomo", "lomo", "sgd")

SCHEDULES = ("cosine", "constant")
MESH_KINDS = ("none", "single", "multi")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Which architecture, at which scale."""

    arch: str                      # registry id (or a label for ad-hoc archs)
    smoke: bool = False            # reduced CPU-sized config


@dataclasses.dataclass(frozen=True)
class OptSpec:
    """Opt-v2 optimizer: rule + schedule + dynamic hparams.

    ``kwargs`` are *static* rule-factory kwargs (``backend=``, ``cfg=``...);
    ``hparams`` are extra *dynamic* hyperparameters merged into the
    per-step hparams dict.  ``lr=None``
    picks the paper default for the rule (:data:`DEFAULT_LRS`).
    """

    name: str = "adalomo"
    lr: Optional[float] = None
    schedule: str = "cosine"
    warmup_frac: float = 0.03
    kwargs: dict = dataclasses.field(default_factory=dict)
    hparams: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule {self.schedule!r} not in {SCHEDULES}")

    def resolved_lr(self) -> float:
        if self.lr is not None:
            return self.lr
        return DEFAULT_LRS.get(self.name, 1e-3)


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """The step program's shape: length, fusion, microbatching.

    ``fused=None`` resolves by rule family (:data:`FUSED_BY_DEFAULT`).
    ``microbatches=k`` splits the global batch into k sequential
    microbatches inside one step: the fused path does LOMO-style
    sequential per-microbatch *updates*; the unfused path accumulates
    gradients (see ``build_step_program``).
    """

    total: int = 100
    microbatches: int = 1
    fused: Optional[bool] = None

    def __post_init__(self):
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, "
                             f"got {self.microbatches}")

    def resolved_fused(self, opt_name: str) -> bool:
        if self.fused is not None:
            return self.fused
        return opt_name in FUSED_BY_DEFAULT


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh + sharding mode (consumed by dry-run / multi-device paths).

    ``optimized=False`` is the paper-faithful baseline: no activation
    sharding policy, no gradient reduce-scatter constraint.

    ``shape`` is the *elastic* knob: a concrete device-mesh shape
    (1-D = data only, 2-D = (data, model), 3-D = (pod, data, model)).
    When set, ``run()`` executes the step sharded on that mesh
    (the elastic fleet layer), and checkpoint restore re-shards onto it —
    the same RunSpec resumes on a smaller/larger mesh by changing only
    this field.  ``None`` keeps the single-process path.
    """

    kind: str = "none"             # "none" | "single" | "multi"
    optimized: bool = True
    shape: Optional[tuple] = None  # e.g. (4, 2) = 4-way data x 2-way model

    def __post_init__(self):
        if self.kind not in MESH_KINDS:
            raise ValueError(f"mesh kind {self.kind!r} not in {MESH_KINDS}")
        if self.shape is not None:
            shape = tuple(int(n) for n in self.shape)
            if not shape or len(shape) > 3 or any(n < 1 for n in shape):
                raise ValueError(
                    f"mesh shape must be 1-3 positive ints, got {self.shape}")
            # normalize (JSON round-trips lists) so specs compare equal
            object.__setattr__(self, "shape", shape)

    def n_devices(self) -> int:
        n = 1
        for s in self.shape or ():
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """Profiler trace for a step window (ProfilerHook).

    ``dir=None`` disables.  The trace covers steps ``[start, start+steps)``
    (0-based); the artifact directory gets a ``profile.runspec.json``
    sidecar stamping which RunSpec produced it.
    """

    dir: Optional[str] = None
    start: int = 1                 # skip step 0 (compile)
    steps: int = 2

    def __post_init__(self):
        if self.start < 0 or self.steps < 1:
            raise ValueError(
                f"profile window start={self.start} steps={self.steps}")


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    dir: Optional[str] = None
    every: int = 0                 # 0 = disabled
    resume: bool = False
    keep_last: int = 3
    gc_incomplete: bool = False    # GC crash-orphaned partial step dirs


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    every: int = 0                 # 0 = disabled
    n_batches: int = 4


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    heartbeat_timeout_s: float = 0.0   # 0 = disabled
    # Max transient-failure recoveries per run: each restores the latest
    # complete checkpoint and rewinds the data stream (donated step
    # buffers make blind re-invocation impossible — see run()).
    retries: int = 2
    # Preemption safety (the fleet layer): catch SIGTERM/SIGINT,
    # checkpoint at the next step boundary, write a resumable marker and
    # raise Preempted (launchers exit PREEMPTED_EXIT_CODE).  Only active
    # when the run has a checkpoint manager and owns the main thread.
    preempt: bool = True
    # Deterministic (jitterless) exponential backoff between transient-
    # failure recoveries: attempt n sleeps min(base * 2**(n-1), max).
    # base 0.0 = no sleep (restore immediately).
    retry_backoff_s: float = 0.0
    retry_backoff_max_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One run, declaratively.  See module docstring."""

    model: ModelSpec
    data: Optional[DataConfig] = None
    opt: OptSpec = dataclasses.field(default_factory=OptSpec)
    steps: StepSpec = dataclasses.field(default_factory=StepSpec)
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    checkpoint: CheckpointSpec = dataclasses.field(
        default_factory=CheckpointSpec)
    eval: EvalSpec = dataclasses.field(default_factory=EvalSpec)
    fault: FaultSpec = dataclasses.field(default_factory=FaultSpec)
    profile: ProfileSpec = dataclasses.field(default_factory=ProfileSpec)
    observe: ObservabilitySpec = dataclasses.field(
        default_factory=ObservabilitySpec)
    sentinel: SentinelSpec = dataclasses.field(default_factory=SentinelSpec)
    log_every: int = 10
    seed: int = 0
    # JSONL metrics export (MetricsHook): step, loss, tokens/s, padding
    # efficiency.  None = disabled.
    metrics_path: Optional[str] = None

    def __post_init__(self):
        if (self.data is not None and self.steps.microbatches > 1
                and self.data.global_batch % self.steps.microbatches):
            raise ValueError(
                f"global_batch={self.data.global_batch} not divisible by "
                f"microbatches={self.steps.microbatches}")

    # ---------------- serialization ----------------
    def to_dict(self) -> dict:
        # JSON-canonical: tuples (e.g. ObservabilitySpec.hist_range)
        # become lists so to_dict() == json round-trip of itself;
        # from_dict normalizes back to tuples.
        def canon(x):
            if isinstance(x, dict):
                return {k: canon(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [canon(v) for v in x]
            return x

        return canon(dataclasses.asdict(self))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunSpec":
        d = dict(d)

        def sub(key, klass):
            if d.get(key) is not None:
                d[key] = klass(**d[key])

        sub("model", ModelSpec)
        sub("data", DataConfig)
        sub("opt", OptSpec)
        sub("steps", StepSpec)
        sub("mesh", MeshSpec)
        sub("checkpoint", CheckpointSpec)
        sub("eval", EvalSpec)
        sub("fault", FaultSpec)
        sub("profile", ProfileSpec)
        sub("observe", ObservabilitySpec)
        sub("sentinel", SentinelSpec)
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        return cls.from_dict(json.loads(text))

    # ---------------- CLI ----------------
    @classmethod
    def from_cli(cls, argv=None) -> "RunSpec":
        import argparse
        ap = argparse.ArgumentParser()
        add_cli_args(ap)
        return from_cli_args(ap.parse_args(argv))


def add_cli_args(ap) -> None:
    """Install the RunSpec flag set on an argparse parser (shared by
    ``launch/train.py``; kept here so the CLI surface and the spec can't
    drift)."""
    ap.add_argument("--arch", default=None,
                    help="architecture registry id (required unless --spec)")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--optimizer", default="adalomo")
    ap.add_argument("--lr", type=float, default=None,
                    help="base lr (default: paper value for the optimizer)")
    ap.add_argument("--schedule", default="cosine", choices=SCHEDULES)
    ap.add_argument("--weight-decay", type=float, default=None,
                    help="decoupled weight decay (Opt v2 dynamic hparam; "
                         "1-D params are auto-grouped to no-decay)")
    ap.add_argument("--opt-backend", default=None,
                    choices=["auto", "torch", "cuda"],
                    help="AdaLomo update backend (CUDA kernels for CUDA "
                         "tensors)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--source", default="synthetic",
                    choices=["synthetic", "memmap"])
    ap.add_argument("--data-path", default=None,
                    help="packed .bin token file (--source memmap)")
    ap.add_argument("--packing", action="store_true",
                    help="segment-packed ragged batches (PackedBatch "
                         "layout: segment ids, per-segment positions, "
                         "loss mask)")
    ap.add_argument("--metrics-path", default=None,
                    help="JSONL metrics file (MetricsHook): step, loss, "
                         "tokens/s, padding efficiency")
    ap.add_argument("--observe-every", type=int, default=0,
                    help="record optimizer-health probes (group update/"
                         "param norm ratios, effective-lr histogram) every "
                         "N steps into the metrics stream; 0 = off")
    ap.add_argument("--observe-factored-every", type=int, default=0,
                    help="factored-moment reconstruction-error probe "
                         "cadence (0 = follow --observe-every)")
    ap.add_argument("--observe-tensors", type=int, default=2,
                    help="how many of the largest moment tensors the "
                         "reconstruction probe samples")
    ap.add_argument("--mesh-shape", default=None,
                    help="elastic device-mesh shape, e.g. 4x2 = 4-way data "
                         "x 2-way model (runs the step sharded; checkpoint "
                         "restore re-shards onto it)")
    ap.add_argument("--profile-dir", default=None,
                    help="profiler trace output dir (ProfilerHook)")
    ap.add_argument("--profile-start", type=int, default=1,
                    help="first profiled step (0-based; default skips the "
                         "compile step)")
    ap.add_argument("--profile-steps", type=int, default=2,
                    help="number of steps in the trace window")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable the SIGTERM/SIGINT "
                         "checkpoint-and-exit-resumable handler")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--gc-incomplete", action="store_true",
                    help="GC crash-orphaned partial checkpoint dirs at start")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0)
    ap.add_argument("--retry-backoff", type=float, default=0.0,
                    help="transient-failure retry backoff base seconds "
                         "(deterministic: attempt n sleeps base * 2^(n-1), "
                         "capped at 30s; 0 = restore immediately)")
    ap.add_argument("--sentinel", action="store_true",
                    help="enable the training sentinel: in-graph anomaly "
                         "guards (non-finite / update-norm spike / trust "
                         "ratio) with skip/backoff/rollback policies")
    ap.add_argument("--sentinel-ladder", default="skip",
                    help="comma-joined policy rungs, 'skip' first "
                         "(skip[,backoff][,rollback])")
    ap.add_argument("--sentinel-spike-factor", type=float, default=10.0,
                    help="anomaly when update norm exceeds this multiple "
                         "of its clean-step EMA")
    ap.add_argument("--sentinel-trust-max", type=float, default=0.0,
                    help="per-group trust-ratio ceiling (0 = guard off)")
    ap.add_argument("--sentinel-budget", type=int, default=8,
                    help="lifetime anomaly allowance before the run "
                         "aborts loudly")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)


def parse_mesh_shape(text: Optional[str]) -> Optional[tuple]:
    """``"4x2"`` / ``"4,2"`` → ``(4, 2)`` with a clear CLI error."""
    if not text:
        return None
    try:
        shape = tuple(int(p) for p in text.replace(",", "x").split("x") if p)
        if not shape or any(n < 1 for n in shape):
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"--mesh-shape: expected e.g. 4x2 or 2x2x2, got {text!r}")
    return shape


def from_cli_args(args) -> RunSpec:
    """Build a RunSpec from parsed :func:`add_cli_args` flags."""
    if not args.arch:
        raise SystemExit("--arch is required (or pass --spec <file.json>)")
    hparams = ({} if args.weight_decay is None
               else {"weight_decay": args.weight_decay})
    kwargs = ({} if args.opt_backend is None
              else {"backend": args.opt_backend})
    mesh_shape = parse_mesh_shape(args.mesh_shape)
    return RunSpec(
        model=ModelSpec(arch=args.arch, smoke=args.smoke),
        # vocab=0 → resolved from the arch config by run()
        data=DataConfig(vocab=0, seq_len=args.seq, global_batch=args.batch,
                        seed=args.seed, source=args.source,
                        path=args.data_path, packing=args.packing),
        opt=OptSpec(name=args.optimizer, lr=args.lr, schedule=args.schedule,
                    kwargs=kwargs, hparams=hparams),
        steps=StepSpec(total=args.steps, microbatches=args.microbatches,
                       fused=(False if args.unfused else None)),
        mesh=(MeshSpec(kind="multi", shape=mesh_shape)
              if mesh_shape else MeshSpec()),
        checkpoint=CheckpointSpec(dir=args.ckpt_dir, every=args.ckpt_every,
                                  resume=args.resume,
                                  gc_incomplete=args.gc_incomplete),
        eval=EvalSpec(every=args.eval_every),
        fault=FaultSpec(heartbeat_timeout_s=args.heartbeat_timeout,
                        preempt=not args.no_preempt,
                        retry_backoff_s=args.retry_backoff),
        profile=ProfileSpec(dir=args.profile_dir, start=args.profile_start,
                            steps=args.profile_steps),
        observe=ObservabilitySpec(
            optimizer_every=args.observe_every,
            factored_every=args.observe_factored_every,
            sample_tensors=args.observe_tensors),
        sentinel=SentinelSpec(
            enabled=args.sentinel,
            ladder=tuple(p for p in args.sentinel_ladder.split(",") if p),
            spike_factor=args.sentinel_spike_factor,
            trust_max=args.sentinel_trust_max,
            budget=args.sentinel_budget),
        log_every=args.log_every,
        seed=args.seed,
        metrics_path=args.metrics_path)
