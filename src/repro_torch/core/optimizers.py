"""Optimizer rules (Opt v2, PyTorch): AdaLomo + the baselines the paper
compares to.

Counterpart of ``repro.core.optimizers``.  Every optimizer is an
:class:`repro_torch.core.api.UpdateRule`:

    rule.init(param, factored=None, batch_dims=0)            -> state
    rule.update(param, grad, state, hp, step, batch_dims=0)  -> (param, state)

``update`` writes **in place** into ``param`` and the state's tensors and
returns them.  ``hp`` is a resolved dict of dynamic hyperparameters (floats
or 0-d tensors); ``step`` is the 1-based global step as float32.  The same
rule runs unfused via ``Opt.step``, fused into the backward loop
(``core/fused.py``), and — for AdaLomo — on the CUDA kernels via
``backend="cuda"``.  LOMO is ``sgd()`` under the fused engine; the paper's
§2.2 ablations are ``sgd_momentum()`` (Eq. 3) and ``sgd_variance()``
(Eq. 4); ``adamw()`` and ``adafactor()`` are the Table-1 baselines.

The baselines are plain tensor maths, as in the reference: fp32 throughout,
one cast at the write of ``param``, hyperparameters and ``step`` used as
(device) tensors, so nothing is read back to the host.  ``batch_dims``
counts leading dims that index independent tensors (the layer stacks the
reference ``vmap``s over); the elementwise rules do not depend on it, and
Adafactor takes its statistics, RMS and factoring decision per slice.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import adalomo as _adalomo
from repro_torch.core.api import (GroupSpec, Opt, UpdateRule, make_rule,
                                  no_decay_1d)
from repro_torch.core.tree import leading_pieces

__all__ = ["adalomo", "sgd", "sgd_momentum", "sgd_variance", "adamw",
           "adafactor", "MomentumState", "VarianceState", "AdamState",
           "AdafactorConfig", "REGISTRY", "get_rule", "get_opt", "Opt",
           "GroupSpec", "UpdateRule", "no_decay_1d"]

Tensor = torch.Tensor
_F32 = torch.float32


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
    ``clip`` set the rule's *default* dynamic hparams.  ``update`` takes
    ``shard`` (a ``sharding.zero.TensorShard``) for one rank's ZeRO-3 shard
    of a tensor: its statistics are then summed over the ranks (the
    kernels' sharded entries, or ``core.adalomo.update_tensor_sharded``).
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r} not in {_BACKENDS}")
    cfg = cfg or _adalomo.AdaLomoConfig()

    def init_fn(param, *, factored=None, batch_dims=0):
        c = cfg if factored is None else dataclasses.replace(
            cfg, factored=factored)
        return _adalomo.init_state(param, c, batch_dims=batch_dims)

    def use_kernel(param) -> bool:
        # a meta tensor takes the card's path (the dry run records the
        # kernels' launches, kernels/dry.py)
        on_card = param.is_cuda or param.device.type == "meta"
        if backend == "cuda" and not on_card:
            raise ValueError(
                "adalomo(backend='cuda') was given a tensor on "
                f"{param.device}; the CUDA kernels take CUDA tensors only "
                "(use backend='torch' or 'auto' on the CPU)")
        return backend == "cuda" or (backend == "auto" and on_card)

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0, shard=None):
        if (use_kernel(param) and state.v is None
                and param.ndim - batch_dims >= 2):
            from repro_torch.kernels.adalomo_update.ops import adalomo_update
            adalomo_update(param, grad.contiguous(), state.r, state.c,
                           hp["lr"], step, hp["beta"], hp["weight_decay"],
                           hp["clip"], cfg=cfg, shard=shard)
            return param, state
        kw = dict(lr=hp["lr"], step=step, beta=hp["beta"],
                  weight_decay=hp["weight_decay"], clip=hp["clip"], cfg=cfg)
        if shard is not None:
            new_p, new_s = _adalomo.update_tensor_sharded(param, grad, state,
                                                          shard=shard, **kw)
        else:
            new_p, new_s = _adalomo.update_tensor(param, grad, state,
                                                  batch_dims=batch_dims, **kw)
        param.copy_(new_p)
        for old, new in zip(state, new_s):
            if old is not None:
                old.copy_(new)
        return param, state

    return make_rule("adalomo", init_fn, update_fn,
                     hparams=dict(lr=lr, beta=beta,
                                  weight_decay=weight_decay, clip=clip))


# --------------------------------------------------------------------------
# SGD family (paper Eq. 1, 3, 4) — LOMO is fused sgd()
# --------------------------------------------------------------------------

def sgd(*, lr: float = 1e-3) -> UpdateRule:
    """Plain SGD — the LOMO update rule (paper Eq. 1).  In place, piece by
    piece (``leading_pieces``): each piece in fp32, cast once at its write,
    so the result is the whole-leaf update's, bit for bit.  Elementwise, so
    a ZeRO-3 shard (``shard``) needs nothing of the other ranks."""

    def init_fn(param, *, factored=None, batch_dims=0):
        del factored, batch_dims
        return ()

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0, shard=None):
        del step, batch_dims, shard
        for p, g in zip(leading_pieces(param), leading_pieces(grad)):
            p.copy_((p.to(_F32) - hp["lr"] * g.to(_F32)).to(p.dtype))
        return param, state

    return make_rule("sgd", init_fn, update_fn, hparams=dict(lr=lr))


def _zeros32(param: Tensor) -> Tensor:
    return torch.zeros(param.shape, dtype=_F32, device=param.device)


class MomentumState(NamedTuple):
    m: Tensor


def sgd_momentum(*, lr: float = 1e-3, beta1: float = 0.9,
                 bias_correction: bool = True) -> UpdateRule:
    """First-moment-only ablation (paper Eq. 3).  Elementwise, so a ZeRO-3
    shard (``shard``) needs nothing of the other ranks."""

    def init_fn(param, *, factored=None, batch_dims=0):
        del factored, batch_dims
        return MomentumState(m=_zeros32(param))

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0, shard=None):
        del batch_dims, shard          # elementwise: a shard is whole to it
        b1 = hp["beta1"]
        m = state.m.mul_(b1).add_((1.0 - b1) * grad.to(_F32))
        m_hat = m / (1.0 - b1 ** step) if bias_correction else m
        param.copy_((param.to(_F32) - hp["lr"] * m_hat).to(param.dtype))
        return param, state

    return make_rule("sgd_momentum", init_fn, update_fn,
                     hparams=dict(lr=lr, beta1=beta1))


class VarianceState(NamedTuple):
    v: Tensor


def sgd_variance(*, lr: float = 1e-3, beta2: float = 0.999,
                 eps: float = 1e-8,
                 bias_correction: bool = True) -> UpdateRule:
    """Second-moment-only ablation (paper Eq. 4) — the 'SGD with variance'
    curve in Fig. 1/6 that motivates AdaLomo.  Elementwise, as
    :func:`sgd_momentum`."""

    def init_fn(param, *, factored=None, batch_dims=0):
        del factored, batch_dims
        return VarianceState(v=_zeros32(param))

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0, shard=None):
        del batch_dims, shard          # elementwise: a shard is whole to it
        b2 = hp["beta2"]
        g32 = grad.to(_F32)
        v = state.v.mul_(b2).add_((1.0 - b2) * torch.square(g32))
        v_hat = v / (1.0 - b2 ** step) if bias_correction else v
        upd = g32 / (torch.sqrt(v_hat) + hp["eps"])
        param.copy_((param.to(_F32) - hp["lr"] * upd).to(param.dtype))
        return param, state

    return make_rule("sgd_variance", init_fn, update_fn,
                     hparams=dict(lr=lr, beta2=beta2, eps=eps))


# --------------------------------------------------------------------------
# AdamW (paper Eq. 2 + decoupled weight decay) — the de-facto baseline
# --------------------------------------------------------------------------

class AdamState(NamedTuple):
    m: Tensor
    v: Tensor


def adamw(*, lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0) -> UpdateRule:
    """AdamW: fp32 m and v (8 bytes a parameter); the fp32 copy of θ is
    decayed before the update is subtracted.  Elementwise, as
    :func:`sgd_momentum`."""

    def init_fn(param, *, factored=None, batch_dims=0):
        del factored, batch_dims
        return AdamState(m=_zeros32(param), v=_zeros32(param))

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0, shard=None):
        del batch_dims, shard          # elementwise: a shard is whole to it
        b1, b2, lr = hp["beta1"], hp["beta2"], hp["lr"]
        g32 = grad.to(_F32)
        # the moments are updated in place: the same products and sums as
        # b*s + (1-b)*g, with fewer whole-tensor temporaries
        m = state.m.mul_(b1).add_((1.0 - b1) * g32)
        v = state.v.mul_(b2).add_((1.0 - b2) * torch.square(g32))
        del g32
        upd = (m / (1.0 - b1 ** step)).div_(
            (v / (1.0 - b2 ** step)).sqrt_().add_(hp["eps"]))
        p32 = param.to(_F32) * (1.0 - lr * hp["weight_decay"])
        param.copy_(p32.sub_(upd.mul_(lr)).to(param.dtype))
        return param, state

    return make_rule("adamw", init_fn, update_fn,
                     hparams=dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                                  weight_decay=weight_decay))


# --------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018) — the factored-moment baseline.
# AdaLomo's Table-1 claim: a factored state like this one, but O(1) grads
# because the update happens inside the backward pass.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    """Structural config; decay_rate/clip/weight_decay are dynamic hparams."""

    eps_stat: float = 1e-30
    eps_rms: float = 1e-3
    min_dim_size_to_factor: int = 16
    factored: bool = True
    relative_step_scale: bool = True  # multiply update by max(eps2, RMS(θ))


def adafactor(cfg: Optional[AdafactorConfig] = None, *, lr: float = 1e-3,
              decay_rate: float = 0.8, clip: float = 1.0,
              weight_decay: float = 0.0) -> UpdateRule:
    """Adafactor: row and column *means* of g², folded by
    ``beta2t = 1 - step^(-decay_rate)``; its own arithmetic, never AdaLomo's
    sums, β-EMA or kernels.  AdaLomo's state container and init are shared,
    with Adafactor's factoring thresholds.

    ``update`` takes ``shard`` (a ``sharding.zero.TensorShard``) for one
    rank's ZeRO-3 block of a matrix: the row means are the row sums summed
    over the column blocks over the whole n, the column means likewise over
    the row blocks and the whole m, ``reconstruct_v``'s Σr is summed over
    the row blocks, and the two RMS values (the clip on u, and θ's scale)
    sum their squares over all the blocks and divide by ``n_total``."""
    cfg = cfg or AdafactorConfig()
    al_cfg = _adalomo.AdaLomoConfig(
        min_dim_size_to_factor=cfg.min_dim_size_to_factor,
        factored=cfg.factored, eps_stat=cfg.eps_stat)

    def init_fn(param, *, factored=None, batch_dims=0):
        c = al_cfg if factored is None else dataclasses.replace(
            al_cfg, factored=factored)
        return _adalomo.init_state(param, c, batch_dims=batch_dims)

    def moment_sharded(g2, state, beta2t, shard):
        """(new state, v̂) of one block: the means and Σr over the ranks
        holding the other blocks."""
        if state.v is not None:
            v = beta2t * state.v + (1.0 - beta2t) * g2
            return _adalomo.FactoredState(r=None, c=None, v=v), v
        m, n = shard.whole_mn(g2.shape[-2], g2.shape[-1])
        r = beta2t * state.r + (1.0 - beta2t) * (
            shard.over_cols(torch.sum(g2, dim=-1)) / n)
        raw = shard.over_rows(torch.cat(
            [torch.sum(g2, dim=-2), torch.sum(r, dim=-1, keepdim=True)], -1))
        c = beta2t * state.c + (1.0 - beta2t) * (raw[..., :-1] / m)
        v = (r[..., :, None] * c[..., None, :]) / torch.clamp_min(
            raw[..., -1:, None], cfg.eps_stat)
        return _adalomo.FactoredState(r=r, c=c, v=None), v

    @torch.no_grad()
    def update_fn(param, grad, state, hp, step, *, batch_dims=0, shard=None):
        g32 = grad.to(_F32)
        g2 = torch.square(g32) + cfg.eps_stat
        beta2t = 1.0 - step ** (-hp["decay_rate"])
        if shard is not None:
            new, v = moment_sharded(g2, state, beta2t, shard)
        elif state.v is not None:
            new = _adalomo.FactoredState(
                r=None, c=None, v=beta2t * state.v + (1.0 - beta2t) * g2)
        else:
            new = _adalomo.FactoredState(
                r=beta2t * state.r + (1.0 - beta2t) * torch.mean(g2, dim=-1),
                c=beta2t * state.c + (1.0 - beta2t) * torch.mean(g2, dim=-2),
                v=None)
        del g2
        if shard is None:
            v = _adalomo.reconstruct_v(new, al_cfg)
        u = g32 * torch.rsqrt(v + cfg.eps_stat)
        del g32, v
        p32 = param.to(_F32)
        if shard is None:
            # per layer slice: the trailing one or two dims form "the matrix"
            axes = _adalomo._matrix_axes(u.ndim - batch_dims)
            rms_u = _adalomo._rms(u, axes)
            rms_p = _adalomo._rms(p32, axes) if cfg.relative_step_scale \
                else None
        else:
            sq = shard.sum(torch.stack(
                [torch.sum(torch.square(u), dim=(-2, -1)),
                 torch.sum(torch.square(p32), dim=(-2, -1))], dim=-1))
            rms_u = torch.sqrt(sq[..., 0, None, None] / shard.n_total)
            rms_p = torch.sqrt(sq[..., 1, None, None] / shard.n_total)
        u = u / torch.clamp_min(rms_u / hp["clip"], 1.0)
        if cfg.relative_step_scale:
            u = u * torch.clamp_min(rms_p, cfg.eps_rms)
        p32 = p32 * (1.0 - hp["lr"] * hp["weight_decay"])
        param.copy_((p32 - hp["lr"] * u).to(param.dtype))
        for old, x in zip(state, new):
            if old is not None:
                old.copy_(x)
        return param, state

    return make_rule("adafactor", init_fn, update_fn,
                     hparams=dict(lr=lr, decay_rate=decay_rate, clip=clip,
                                  weight_decay=weight_decay))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

# Every rule's update takes ``shard`` (a ZeRO-3 block of a tensor, 2-D
# blocks included), so every rule runs on a mesh, fused or unfused.
REGISTRY: dict[str, Callable[..., UpdateRule]] = {
    "adalomo": adalomo,
    "lomo": sgd,       # LOMO == fused SGD
    "sgd": sgd,
    "sgd_momentum": sgd_momentum,
    "sgd_variance": sgd_variance,
    "adamw": adamw,
    "adafactor": adafactor,
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
