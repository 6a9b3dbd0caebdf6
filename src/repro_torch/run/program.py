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

With ``spec.sentinel.enabled`` the step is wrapped by the sentinel guard
(``repro_torch.sentinel.guard``) and takes and returns a ``SentinelState``
as a fifth item; with ``spec.observe`` enabled the optimizer-health probes
(``repro_torch.telemetry.probes``) ride the metrics — inside the guard when
both are on.  Either wrapper keeps one pre-step :class:`Snapshot` of params
and moments, whose buffers the program owns from step to step.

With ``zero`` (a ``sharding.zero.Zero3``, built by ``fleet.elastic`` for
``spec.mesh.shape``) the step runs ZeRO-3 sharded, fused or unfused:
``init`` returns this rank's resting shards, and the step takes the
**global** batch, every rank the same, keeping its rows and sequence tile
of each microbatch (so microbatch i is the single-device run's microbatch
i) and agreeing on a pending preemption signal through the step's metrics
(``"preempt"``, summed over the ranks and read with the step's one
transfer).  The unfused step gathers the whole params once a step
(``Zero3.gather``: the MoE expert stacks stay split over ``model``), takes
``torch.autograd.grad`` of this rank's share of the loss (the model's own
normalisation by the global token count, under the mesh's activation
policy), lands each microbatch's gradients as the leaves rest
(``Zero3.scatter``: rank-ordered fp32 sums), accumulates the shards and
steps them (``Opt.step(shards=)``).  Its memory a rank: the whole params
and one microbatch's whole gradients, beside the sharded params and
state.  The sentinel's verdict and the probes are reduced over the ranks
inside the step (``sentinel/guard.py``, ``telemetry/probes.py``), and
``loss_fn`` (evaluation) gathers as the step does.
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
from repro_torch.sharding.act import use_policy
from repro_torch.train.schedules import constant, warmup_cosine


def _split_microbatches(batch: dict, k: int) -> list:
    """[k*b, ...] -> k batches of [b, ...], with a clear divisibility
    error."""
    for x in batch.values():
        if x.shape[0] % k:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by microbatches={k}")
    return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for name, x in batch.items()} for i in range(k)]


def _apply_loss_mask(batch: dict) -> dict:
    """Packed-batch loss contract: slots where ``loss_mask`` is False
    (padding, cross-segment label shifts) never reach the loss.  The packer
    already emits -1 labels there; masking again at step entry makes the
    contract hold for any injected batch iterator too."""
    if "loss_mask" not in batch:
        return batch
    return {**batch, "labels": torch.where(batch["loss_mask"],
                                           batch["labels"], -1)}


def _mean(values: list):
    return torch.stack(list(values)).mean()


@dataclasses.dataclass
class StepProgram:
    """One training step + everything needed to drive it.

    ``step(params, opt_state, batch, hparams)`` runs one step **in place**
    and returns ``(params, opt_state, loss, metrics)`` with loss and metrics
    as device tensors; with the sentinel on it is ``step(params, opt_state,
    batch, hparams, sent)`` and returns ``sent'`` fifth.  ``hparams_fn(step)``
    returns the dynamic hparams for the 1-based step.  ``device`` is where
    ``init`` and ``init_sentinel`` allocate; ``snapshot`` is the pre-step
    copy the guard or the probes keep (None when neither is on).
    """

    spec: RunSpec
    arch: Any
    opt: Opt
    fused: bool
    step: Callable
    hparams_fn: Callable[[int], dict]
    device: torch.device
    snapshot: Any = None
    _loss_fn: Any = None
    zero: Any = None

    @property
    def loss_fn(self):
        """(params, batch) -> (loss, metrics): the arch's loss, built on
        first use (eval)."""
        if self._loss_fn is None:
            self._loss_fn = (self.arch.make_loss_fn() if self.zero is None
                             else self.arch.make_loss_fn(zero=self.zero))
        return self._loss_fn

    def init(self, seed: int = 0):
        """Fresh ``(params, opt_state)``; on a mesh this rank's resting
        shards (the whole model is drawn from the seed, then cut leaf by
        leaf, each whole tensor freed as its block is made, and on the
        card the freed memory handed back, for the other ranks of a
        shared card)."""
        params = self.arch.init_params(seed, device=self.device)
        state = self.opt.init(params)
        if self.zero is not None:
            params, state = self.zero.shard_tree((params, state), state,
                                                 in_place=True)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return params, state

    # ---------------- sentinel ----------------
    @property
    def sentinel_enabled(self) -> bool:
        return self.spec.sentinel.enabled

    def init_sentinel(self):
        """Fresh device SentinelState, or None when the guard is off."""
        if not self.sentinel_enabled:
            return None
        from repro_torch.sentinel.guard import init_sentinel_state
        return init_sentinel_state(self.device)

    # ---------------- introspection ----------------
    def abstract_args(self) -> tuple:
        """``(params, opt_state, batch, hparams[, sentinel])`` on the meta
        device: the step's signature from the spec, nothing allocated.  The
        params and state are the whole model's (as the reference's
        ``ShapeDtypeStruct``s), the batch the global batch, each hparam a
        0-d float32; the sentinel slot only when the guard is on."""
        if self.spec.data is None:
            raise ValueError("abstract_args requires spec.data")
        meta = torch.device("meta")
        params = self.arch.init_params(self.spec.seed, device=meta)
        state = self.opt.init(params)
        d = self.spec.data
        batch = {k: torch.empty(shape, dtype=dt, device=meta)
                 for k, (shape, dt) in self.arch.train_batch_specs(
                     d.global_batch, d.seq_len, packed=d.packing).items()}
        hp = {k: torch.empty((), dtype=torch.float32, device=meta)
              for k in self.hparams_fn(1)}
        if self.sentinel_enabled:
            from repro_torch.sentinel.guard import init_sentinel_state
            return params, state, batch, hp, init_sentinel_state(meta)
        return params, state, batch, hp


def build_step_program(spec: RunSpec, arch=None, opt: Optional[Opt] = None,
                       *, groups=None, global_grad_norm=None,
                       device="cuda", inject=None, zero=None) -> StepProgram:
    """Assemble the :class:`StepProgram` for ``spec``.

    ``arch`` defaults to the registry lookup of ``spec.model``.
    ``groups=None`` applies the paper-standard no-decay-on-1-D grouping when
    the rule has a ``weight_decay`` hparam.  ``device`` (the card unless the
    caller asks for the CPU) is where the program's ``init`` allocates;
    without a CUDA device the default raises.  ``inject`` (an
    :class:`~repro_torch.sentinel.inject.Injection`) arms the fault injector
    inside the sentinel guard — it requires ``spec.sentinel.enabled``
    because the guard owns the injection point.  ``zero`` runs the step
    ZeRO-3 sharded (module docstring; ``fleet.elastic.run_elastic``).
    """
    device = resolve_device(device)
    if arch is None:
        from repro_torch.models.registry import get_arch
        arch = get_arch(spec.model.arch, smoke=spec.model.smoke)
    if spec.data is not None and spec.data.packing:
        # fail at build time, not at the first step, for unsupported archs
        arch.train_batch_specs(spec.data.global_batch, spec.data.seq_len,
                               packed=True)
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

    def rows(b):
        """On a mesh, this rank's rows and tile of a global (micro)batch."""
        return b if zero is None else zero.rows(b)

    def with_preempt(params, opt_state, loss, metrics):
        """On a mesh, the pending preemption signal summed over the ranks
        into the metrics (read with the step's one transfer)."""
        if zero is not None:
            from repro_torch.fleet.preempt import pending_signal
            from repro_torch.sharding import collectives as C
            flag = torch.full((), pending_signal(), dtype=torch.float32,
                              device=loss.device)
            metrics["preempt"] = C.all_reduce_exact(flag, zero.world)
        return params, opt_state, loss, metrics

    if fused:
        step_kw = arch.make_fused_train_step(
            opt, global_grad_norm=global_grad_norm, param_constraint=zero,
            grad_constraint=zero)

        def one_step(params, opt_state, batch, hp):
            batch = _apply_loss_mask(batch)
            if k == 1:
                out = step_kw(params, opt_state, rows(batch), hparams=hp)
            else:
                # LOMO-style: sequential updates per microbatch.
                losses, metrics = [], []
                for b in _split_microbatches(batch, k):
                    params, opt_state, loss, m = step_kw(
                        params, opt_state, rows(b), hparams=hp)
                    losses.append(loss)
                    metrics.append(m)
                out = (params, opt_state, _mean(losses),
                       {name: _mean([m[name] for m in metrics])
                        for name in metrics[0]})
            return with_preempt(*out)
    else:
        if global_grad_norm is not None:
            raise ValueError("global_grad_norm requires the fused path")
        loss_fn = arch.make_loss_fn()
        shards = None if zero is None else zero.tree_shards()

        def loss_and_grads(params, batch):
            """(loss, metrics, grads) of one (micro)batch; on a mesh
            ``params`` are the whole tensors gathered for the step, the
            batch is cut to this rank's rows and tile, and the gradients
            land as each leaf rests, summed over the ranks."""
            p_req = tree_map(lambda t: t.detach().requires_grad_(True),
                             params)
            policy = None if zero is None else zero.policy
            with torch.enable_grad(), use_policy(policy):
                loss, metrics = loss_fn(p_req, rows(batch))
                grads = torch.autograd.grad(loss, tree_leaves(p_req))
            metrics = {n: v.detach() for n, v in metrics.items()}
            it = iter(grads)
            grads = tree_map(lambda _: next(it), p_req)
            if zero is None:
                return loss.detach(), metrics, grads
            return metrics["loss"], metrics, zero.scatter(grads, zero.dims)

        def one_step(params, opt_state, batch, hp):
            batch = _apply_loss_mask(batch)
            # on a mesh the whole params, gathered once for the step
            whole = params if zero is None else zero.gather(params,
                                                            zero.dims)
            if k == 1:
                loss, metrics, grads = loss_and_grads(whole, batch)
            else:
                # the gradients of each microbatch are scattered before
                # the next one runs: the shards accumulate
                losses, ms, grads = [], [], None
                for b in _split_microbatches(batch, k):
                    loss, m, g = loss_and_grads(whole, b)
                    losses.append(loss)
                    ms.append(m)
                    grads = g if grads is None else tree_map(torch.add,
                                                             grads, g)
                grads = tree_map(lambda g: g / k, grads)
                loss = _mean(losses)
                metrics = {name: _mean([m[name] for m in ms])
                           for name in ms[0]}
            del whole              # before the update's temporaries
            params, opt_state = opt.step(params, grads, opt_state, hp,
                                         shards=shards)
            return with_preempt(params, opt_state, loss, metrics)

    if inject is not None and not spec.sentinel.enabled:
        raise ValueError("fault injection requires spec.sentinel.enabled "
                         "(the sentinel guard owns the injection point)")
    snapshot = None
    if spec.sentinel.enabled:
        # One guard a step, around the whole microbatch loop: snapshot,
        # in-place step, injection, detection, and the torch.where commit,
        # with the verdict in metrics["sentinel"].  With probes on, the
        # guard computes them itself on the COMMITTED transition.
        from repro_torch.sentinel.guard import guard_step
        one_step = guard_step(
            one_step, opt=opt, sspec=spec.sentinel,
            ospec=spec.observe if spec.observe.enabled else None,
            inject=inject, zero=zero)
        snapshot = one_step.snapshot
    elif spec.observe.enabled:
        from repro_torch.telemetry.probes import instrument_step
        one_step = instrument_step(one_step, opt=opt, ospec=spec.observe,
                                   zero=zero)
        snapshot = one_step.snapshot
    return StepProgram(spec=spec, arch=arch, opt=opt, fused=fused,
                       step=one_step, hparams_fn=hparams_fn,
                       device=device, snapshot=snapshot, zero=zero)
