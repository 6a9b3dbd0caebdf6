"""StepProgram — the one place a train step is assembled (PyTorch).

Counterpart of ``repro.run.program``.  ``build_step_program(spec, arch, opt)``
owns the step-construction matrix:

  * **fused × unfused** — LOMO/AdaLomo's update-in-the-backward-loop vs the
    ``torch.autograd.grad`` + ``Opt.step`` baseline path;
  * **microbatching** — a Python loop: the fused path does LOMO-style
    *sequential per-microbatch updates* (classic accumulation would
    materialize the full gradient — exactly what LOMO avoids); the unfused
    path accumulates gradients and applies one update.

PyTorch runs eagerly, so there is nothing to compile or lower: the program's
``step`` is a plain function.  It updates ``(params, opt_state)`` **in place** — the torch form of the
reference's ``donate_argnums=(0, 1)`` — and returns the objects it was
given.  ``hparams_fn(step)`` returns the dynamic hparams (host floats) for the
1-based step; they reach the device as data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.api import Opt, no_decay_1d
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.run.spec import RunSpec
from repro_torch.train.schedules import constant, warmup_cosine


def check_ported(spec: RunSpec) -> None:
    """Raise ``NotImplementedError`` for a spec that turns on a layer the
    port does not have yet, naming it."""
    d = spec.data
    unported = [
        (spec.sentinel.enabled, "sentinel.enabled", "the training sentinel"),
        (spec.observe.enabled, "observe.optimizer_every",
         "the optimizer-health probes (telemetry)"),
        (spec.mesh.shape is not None, "mesh.shape",
         "sharded execution (scale-out)"),
        (d is not None and d.packing, "data.packing",
         "segment-packed batches"),
    ]
    for on, field, what in unported:
        if on:
            raise NotImplementedError(
                f"RunSpec.{field}: {what} is not ported to repro_torch yet")


def _split_microbatches(batch: dict, k: int) -> list:
    """[k*b, ...] -> k batches of [b, ...], with a clear divisibility
    error."""
    for x in batch.values():
        if x.shape[0] % k:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by microbatches={k}")
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def _mean(values: list):
    return torch.stack(list(values)).mean()


@dataclasses.dataclass
class StepProgram:
    """One training step + everything needed to drive it.

    ``step(params, opt_state, batch, hparams)`` runs one step **in place**
    and returns ``(params, opt_state, loss, metrics)`` with loss and metrics
    as 0-d device tensors.  ``hparams_fn(step)`` returns the dynamic hparams
    for the 1-based step.  ``device`` is where ``init`` allocates.
    """

    spec: RunSpec
    arch: Any
    opt: Opt
    fused: bool
    step: Callable
    hparams_fn: Callable[[int], dict]
    device: torch.device
    _loss_fn: Any = None

    @property
    def loss_fn(self):
        """(params, batch) -> (loss, metrics): the arch's loss, built on
        first use (eval)."""
        if self._loss_fn is None:
            self._loss_fn = self.arch.make_loss_fn()
        return self._loss_fn

    def init(self, seed: int = 0):
        params = self.arch.init_params(seed, device=self.device)
        return params, self.opt.init(params)


def build_step_program(spec: RunSpec, arch=None, opt: Optional[Opt] = None,
                       *, groups=None, global_grad_norm=None,
                       device="cuda") -> StepProgram:
    """Assemble the :class:`StepProgram` for ``spec``.

    ``arch`` defaults to the registry lookup of ``spec.model``.
    ``groups=None`` applies the paper-standard no-decay-on-1-D grouping when
    the rule has a ``weight_decay`` hparam.  ``device`` (the card unless the
    caller asks for the CPU) is where the program's ``init`` allocates;
    without a CUDA device the default raises.
    """
    check_ported(spec)
    device = resolve_device(device)
    if arch is None:
        from repro_torch.models.registry import get_arch
        arch = get_arch(spec.model.arch, smoke=spec.model.smoke)
    if opt is None:
        rule = opt_lib.get_rule(spec.opt.name, **spec.opt.kwargs)
        if groups is None:
            groups = ((no_decay_1d(),)
                      if "weight_decay" in rule.hparams else ())
        opt = Opt(rule, groups=groups)

    fused = spec.steps.resolved_fused(spec.opt.name)
    k = spec.steps.microbatches
    base_lr = spec.opt.resolved_lr()
    lr_fn = (warmup_cosine(base_lr, spec.steps.total, spec.opt.warmup_frac)
             if spec.opt.schedule == "cosine" else constant(base_lr))
    extras = dict(spec.opt.hparams)

    def hparams_fn(step: int) -> dict:
        """Dynamic hparams for the 1-based ``step``: scheduled lr + spec
        extras.  The schedule is authoritative for lr."""
        return {**extras, "lr": lr_fn(step)}

    if fused:
        step_kw = arch.make_fused_train_step(
            opt, global_grad_norm=global_grad_norm)

        def one_step(params, opt_state, batch, hp):
            if k == 1:
                return step_kw(params, opt_state, batch, hparams=hp)
            # LOMO-style: sequential updates per microbatch.
            losses, metrics = [], []
            for b in _split_microbatches(batch, k):
                params, opt_state, loss, m = step_kw(params, opt_state, b,
                                                     hparams=hp)
                losses.append(loss)
                metrics.append(m)
            return (params, opt_state, _mean(losses),
                    {name: _mean([m[name] for m in metrics])
                     for name in metrics[0]})
    else:
        if global_grad_norm is not None:
            raise ValueError("global_grad_norm requires the fused path")
        loss_fn = arch.make_loss_fn()

        def loss_and_grads(params, batch):
            p_req = tree_map(lambda t: t.detach().requires_grad_(True),
                             params)
            with torch.enable_grad():
                loss, metrics = loss_fn(p_req, batch)
            leaves = tree_leaves(p_req)
            grads = torch.autograd.grad(loss, leaves)
            it = iter(grads)
            return (loss.detach(), {n: v.detach() for n, v in metrics.items()},
                    tree_map(lambda _: next(it), p_req))

        def one_step(params, opt_state, batch, hp):
            if k == 1:
                loss, metrics, grads = loss_and_grads(params, batch)
            else:
                losses, ms, grads = [], [], None
                for b in _split_microbatches(batch, k):
                    loss, m, g = loss_and_grads(params, b)
                    losses.append(loss)
                    ms.append(m)
                    grads = g if grads is None else tree_map(torch.add,
                                                             grads, g)
                grads = tree_map(lambda g: g / k, grads)
                loss = _mean(losses)
                metrics = {name: _mean([m[name] for m in ms])
                           for name in ms[0]}
            params, opt_state = opt.step(params, grads, opt_state, hp)
            return params, opt_state, loss, metrics

    return StepProgram(spec=spec, arch=arch, opt=opt, fused=fused,
                       step=one_step, hparams_fn=hparams_fn,
                       device=device)
