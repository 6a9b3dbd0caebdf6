"""Optimizer rules (Opt v2, PyTorch): AdaLomo and LOMO's SGD.

Counterpart of ``repro.core.optimizers``, holding the rules ported so far.
Every optimizer is an :class:`repro_torch.core.api.UpdateRule`:

    rule.init(param, factored=None, batch_dims=0)            -> state
    rule.update(param, grad, state, hp, step, batch_dims=0)  -> (param, state)

``update`` writes **in place** into ``param`` and the state's tensors and
returns them.  ``hp`` is a resolved dict of dynamic hyperparameters (floats
or 0-d tensors); ``step`` is the 1-based global step as float32.  The same
rule runs unfused via ``Opt.step``, fused into the backward loop
(``core/fused.py``), and — for AdaLomo — on the CUDA kernels via
``backend="cuda"``.  LOMO is ``sgd()`` under the fused engine.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional

import torch

from repro_torch.core import adalomo as _adalomo
from repro_torch.core.api import (GroupSpec, Opt, UpdateRule, make_rule,
                                  no_decay_1d)

__all__ = ["adalomo", "sgd", "REGISTRY", "get_rule", "get_opt", "Opt",
           "GroupSpec", "UpdateRule", "no_decay_1d"]


# --------------------------------------------------------------------------
# AdaLomo — one rule, two backends (plain PyTorch / CUDA kernels)
# --------------------------------------------------------------------------

_BACKENDS = ("auto", "torch", "cuda")


def adalomo(cfg: Optional[_adalomo.AdaLomoConfig] = None, *,
            backend: str = "auto",
            lr: float = _adalomo.DEFAULT_HPARAMS["lr"],
            beta: float = _adalomo.DEFAULT_HPARAMS["beta"],
            weight_decay: float = _adalomo.DEFAULT_HPARAMS["weight_decay"],
            clip: float = _adalomo.DEFAULT_HPARAMS["clip"]) -> UpdateRule:
    """AdaLomo (paper Alg. 1) with backend dispatch.

    ``backend="cuda"`` routes factored ≥2-D tensors through the CUDA kernels
    (``kernels/adalomo_update``) and raises for a tensor that is not on a
    CUDA device; 1-D/unfactored tensors and ``backend="torch"`` use the plain
    path — same math, same state.  ``"auto"`` is ``"cuda"`` for a CUDA tensor
    and ``"torch"`` for a CPU tensor.  ``lr``/``beta``/``weight_decay``/
    ``clip`` set the rule's *default* dynamic hparams.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r} not in {_BACKENDS}")
    cfg = cfg or _adalomo.AdaLomoConfig()

    def init_fn(param, *, factored=None, batch_dims=0):
        c = cfg if factored is None else dataclasses.replace(
            cfg, factored=factored)
        return _adalomo.init_state(param, c, batch_dims=batch_dims)

    def use_kernel(param) -> bool:
        if backend == "cuda" and not param.is_cuda:
            raise ValueError(
                "adalomo(backend='cuda') was given a tensor on "
                f"{param.device}; the CUDA kernels take CUDA tensors only "
                "(use backend='torch' or 'auto' on the CPU)")
        return backend == "cuda" or (backend == "auto" and param.is_cuda)

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0):
        if (use_kernel(param) and state.v is None
                and param.ndim - batch_dims >= 2):
            from repro_torch.kernels.adalomo_update.ops import adalomo_update
            adalomo_update(param, grad.contiguous(), state.r, state.c,
                           hp["lr"], step, hp["beta"], hp["weight_decay"],
                           hp["clip"], cfg=cfg)
            return param, state
        new_p, new_s = _adalomo.update_tensor(
            param, grad, state, lr=hp["lr"], step=step, beta=hp["beta"],
            weight_decay=hp["weight_decay"], clip=hp["clip"], cfg=cfg,
            batch_dims=batch_dims)
        param.copy_(new_p)
        for old, new in zip(state, new_s):
            if old is not None:
                old.copy_(new)
        return param, state

    return make_rule("adalomo", init_fn, update_fn,
                     hparams=dict(lr=lr, beta=beta,
                                  weight_decay=weight_decay, clip=clip))


# --------------------------------------------------------------------------
# SGD (paper Eq. 1) — LOMO is fused sgd()
# --------------------------------------------------------------------------

def sgd(*, lr: float = 1e-3) -> UpdateRule:
    """Plain SGD — the LOMO update rule (paper Eq. 1)."""

    def init_fn(param, *, factored=None, batch_dims=0):
        del factored, batch_dims
        return ()

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0):
        del step, batch_dims
        p32 = param.to(torch.float32)
        param.copy_((p32 - hp["lr"] * grad.to(torch.float32)).to(param.dtype))
        return param, state

    return make_rule("sgd", init_fn, update_fn, hparams=dict(lr=lr))


# --------------------------------------------------------------------------
# Registry (the rules ported so far)
# --------------------------------------------------------------------------

REGISTRY: dict[str, Callable[..., UpdateRule]] = {
    "adalomo": adalomo,
    "lomo": sgd,       # LOMO == fused SGD
    "sgd": sgd,
}


def _accepted_kwargs(factory) -> set:
    sig = inspect.signature(factory)
    return {p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}


def get_rule(name: str, **kwargs) -> UpdateRule:
    """Build a rule by registry name; unknown kwargs raise a KeyError
    naming the kwargs this rule accepts (not a bare TypeError)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(REGISTRY)}")
    factory = REGISTRY[name]
    accepted = _accepted_kwargs(factory)
    unknown = sorted(set(kwargs) - accepted)
    if unknown:
        raise KeyError(
            f"optimizer {name!r} does not accept {unknown}; accepted "
            f"kwargs: {sorted(accepted)} (dynamic hyperparameters can also "
            f"be passed per step via the hparams argument)")
    return factory(**kwargs)


def get_opt(name: str, *, groups: tuple = (), **kwargs) -> Opt:
    """``Opt(get_rule(name, **kwargs), groups)`` — the one-stop constructor."""
    return Opt(get_rule(name, **kwargs), groups=groups)
