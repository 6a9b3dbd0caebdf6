"""Legacy Trainer — a thin compatibility shim over the Run API (PyTorch).

Counterpart of ``repro.train.loop``: ``Trainer``/``TrainConfig`` map 1:1 onto
a :class:`~repro_torch.run.spec.RunSpec`; new code should build a RunSpec
directly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.run.hooks import EvalHook, StragglerHook
from repro_torch.run.program import build_step_program
from repro_torch.run.runner import run
from repro_torch.run.spec import (CheckpointSpec, EvalSpec, FaultSpec,
                                  ModelSpec, OptSpec, RunSpec, StepSpec)
from repro_torch.train.fault import StragglerMonitor


@dataclasses.dataclass
class TrainConfig:
    optimizer: str = "adalomo"
    lr: float = 5e-4
    total_steps: int = 100
    warmup_frac: float = 0.03
    schedule: str = "cosine"          # "cosine" | "constant"
    fused: bool = True                # LOMO-style fused backward
    microbatches: int = 1
    eval_every: int = 0
    ckpt_every: int = 0
    ckpt_dir: Optional[str] = None
    heartbeat_timeout_s: float = 0.0  # 0 = disabled
    log_every: int = 10
    # Rule-construction kwargs forwarded to the registry factory.
    opt_kwargs: dict = dataclasses.field(default_factory=dict)
    # Extra dynamic hyperparameters passed with the per-step lr.
    hparams: dict = dataclasses.field(default_factory=dict)
    # Param groups: () for none.  None = no weight decay on 1-D tensors.
    groups: Optional[tuple] = None

    def to_run_spec(self, arch) -> RunSpec:
        """The equivalent RunSpec (data supplied at fit time via
        iterators, so ``spec.data`` stays None)."""
        return RunSpec(
            model=ModelSpec(arch=arch.arch_id),
            data=None,
            opt=OptSpec(name=self.optimizer, lr=self.lr,
                        schedule=self.schedule,
                        warmup_frac=self.warmup_frac,
                        kwargs=self.opt_kwargs, hparams=self.hparams),
            steps=StepSpec(total=self.total_steps,
                           microbatches=self.microbatches,
                           fused=self.fused),
            checkpoint=CheckpointSpec(dir=self.ckpt_dir,
                                      every=self.ckpt_every),
            eval=EvalSpec(every=self.eval_every),
            fault=FaultSpec(heartbeat_timeout_s=self.heartbeat_timeout_s),
            log_every=self.log_every)


class Trainer:
    """Compat shim: ``Trainer(arch, tcfg).fit(...)`` ≡ ``run(spec, ...)``.
    ``device`` as for ``run``: the card unless the caller asks for the
    CPU."""

    def __init__(self, arch, tcfg: TrainConfig, *, device="cuda",
                 log_fn: Callable[[str], None] = print):
        self.arch = arch
        self.tcfg = tcfg
        self.log = log_fn
        self.spec = tcfg.to_run_spec(arch)
        self._program = build_step_program(self.spec, arch,
                                           groups=tcfg.groups, device=device)
        self.opt = self._program.opt
        self.straggler = StragglerMonitor()

    def init(self, seed: int = 0):
        return self._program.init(seed)

    def hparams_at(self, step: int) -> dict:
        """The dynamic hparams for (1-based) ``step``: scheduled lr plus
        any TrainConfig extras."""
        return self._program.hparams_fn(step)

    def fit(self, params, opt_state, batch_iter, *, start_step: int = 0,
            eval_iter=None, ckpt_manager=None) -> dict:
        hooks = [StragglerHook(self.straggler)]
        if eval_iter is not None and self.tcfg.eval_every:
            hooks.append(EvalHook(eval_iter, self.tcfg.eval_every))
        res = run(self.spec, program=self._program, params=params,
                  opt_state=opt_state, batch_iter=batch_iter,
                  ckpt_manager=ckpt_manager, start_step=start_step,
                  hooks=hooks, log_fn=self.log)
        return {"params": res.params, "opt_state": res.opt_state,
                "history": res.history}

    def evaluate(self, params, eval_iter, n_batches: int = 4) -> dict:
        hook = EvalHook(eval_iter, every=0, n_batches=n_batches)
        return hook.evaluate(_EvalCtx(self._program, params))


@dataclasses.dataclass
class _EvalCtx:
    program: object
    params: object
