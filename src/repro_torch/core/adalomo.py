"""AdaLomo: low-memory optimization with adaptive learning rate (PyTorch).

Counterpart of ``repro.core.adalomo``: the paper's Algorithm 1 as pure
per-tensor functions on ``torch`` tensors.  The functions here return new
tensors and mutate nothing; the rule in ``core/optimizers.py`` writes their
results in place.

State per m×n parameter is the factored second moment (r ∈ R^m, c ∈ R^n),
paper Eq. (5)-(7):

    r_t = β r_{t-1} + (1-β) rowsum(g²)
    c_t = β c_{t-1} + (1-β) colsum(g²)
    v_t = outer(r_t, c_t) / sum(r_t)

followed by the grouped update normalization of Alg. 1 line 11:

    u  = g / (sqrt(v̂) + ε)
    û  = u / max(1, RMS(u)/d) * max(ε₂, RMS(θ))
    θ ← θ - α û

1-D parameters keep the unfactored v.  Leading dimensions beyond the
trailing matrix dims (experts ``[E,m,n]``) are independent groups.  Where
JAX ``vmap``s over the layer dim of a stack, the port writes the batch
dimension out: ``batch_dims=1`` says the first dim of ``[L, ...]`` indexes
independent tensors, so a stacked norm scale ``[L, d]`` is L 1-D tensors and
not one L×d matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdaLomoConfig:
    """*Structural* configuration of AdaLomo (paper §3.1 / Alg. 1).

    The dynamic hyperparameters — lr, β, weight decay, clip threshold d —
    are call-time arguments (DEFAULT_HPARAMS, ``core/api.py``).
    """

    eps_div: float = 1e-8          # ε added to sqrt(v̂) in the division
    eps_stat: float = 1e-30        # tiny floor inside the statistics
    eps_rms: float = 1e-3          # ε₂: floor of the parameter-scale term
    min_dim_size_to_factor: int = 16
    factored: bool = True
    bias_correction: bool = True
    # Alg.1 line 10 literally reads u = g / v (no sqrt); off by default.
    literal_div_v: bool = False
    # dtype for the statistics; fp32 regardless of param dtype.
    state_dtype: Any = torch.float32


DEFAULT_HPARAMS = {"lr": 1e-3, "beta": 0.999, "weight_decay": 0.0,
                   "clip": 1.0}


class FactoredState(NamedTuple):
    """Second-moment state for one tensor: (r, c) if factored else v."""

    r: Optional[Tensor]
    c: Optional[Tensor]
    v: Optional[Tensor]


def device_scalar(x, device) -> Tensor:
    """``x`` as a 0-d float32 tensor on ``device``.  A host float is written
    by a fill — no copy from host memory, no synchronisation; a tensor is
    kept (moved or cast if it must be)."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _should_factor(shape: tuple, cfg: AdaLomoConfig) -> bool:
    if not cfg.factored or len(shape) < 2:
        return False
    return min(shape[-2], shape[-1]) >= cfg.min_dim_size_to_factor


def init_state(param: Tensor, cfg: AdaLomoConfig, *, batch_dims: int = 0
               ) -> FactoredState:
    """O(m+n) state for an m×n tensor; O(m) unfactored state otherwise.
    Allocated on ``param``'s device."""
    shape = tuple(param.shape)
    dt, dev = cfg.state_dtype, param.device
    if _should_factor(shape[batch_dims:], cfg):
        r = torch.zeros(shape[:-1], dtype=dt, device=dev)              # (..., m)
        c = torch.zeros(shape[:-2] + shape[-1:], dtype=dt, device=dev)  # (..., n)
        return FactoredState(r=r, c=c, v=None)
    return FactoredState(r=None, c=None,
                         v=torch.zeros(shape, dtype=dt, device=dev))


def state_bytes(param: Tensor, cfg: AdaLomoConfig) -> int:
    """Analytic optimizer-state footprint (nothing is allocated)."""
    st = init_state(torch.empty(param.shape, dtype=param.dtype,
                                device="meta"), cfg)
    return sum(x.numel() * x.element_size() for x in st if x is not None)


def _matrix_axes(ndim: int) -> tuple:
    """Axes forming 'the parameter matrix' — trailing two (or one if 1-D)."""
    return (-1,) if ndim < 2 else (-2, -1)


def _rms(x: Tensor, axes: tuple) -> Tensor:
    return torch.sqrt(torch.mean(torch.square(x), dim=axes, keepdim=True))


def update_moment(grad: Tensor, state: FactoredState, *, beta,
                  cfg: AdaLomoConfig) -> FactoredState:
    """EMA update of the (possibly factored) second moment. Paper Eq.(6)(7)."""
    g2 = torch.square(grad.to(cfg.state_dtype)) + cfg.eps_stat
    b = beta
    if state.v is not None:
        return FactoredState(r=None, c=None, v=b * state.v + (1.0 - b) * g2)
    r = b * state.r + (1.0 - b) * torch.sum(g2, dim=-1)
    c = b * state.c + (1.0 - b) * torch.sum(g2, dim=-2)
    return FactoredState(r=r, c=c, v=None)


def reconstruct_v(state: FactoredState, cfg: AdaLomoConfig) -> Tensor:
    """v = outer(r, c) / sum(r) — rank-1 reconstruction, paper Eq.(5)."""
    if state.v is not None:
        return state.v
    denom = torch.sum(state.r, dim=-1, keepdim=True)  # (..., 1)
    return (state.r[..., :, None] * state.c[..., None, :]) / torch.clamp_min(
        denom[..., None], cfg.eps_stat)


def compute_update(param: Tensor, grad: Tensor, state: FactoredState, *,
                   step, beta=DEFAULT_HPARAMS["beta"],
                   clip=DEFAULT_HPARAMS["clip"], cfg: AdaLomoConfig,
                   batch_dims: int = 0) -> tuple:
    """Return (û, new_state): the grouped-normalized update of Alg. 1.

    ``step`` is the 1-based global step (float or 0-d tensor, for bias
    correction).  ``beta``/``clip`` may be floats or 0-d tensors.  û is in
    fp32; the caller applies ``θ ← θ - lr·û`` (and weight decay).
    """
    dt = cfg.state_dtype
    new_state = update_moment(grad, state, beta=beta, cfg=cfg)
    v = reconstruct_v(new_state, cfg)
    if cfg.bias_correction:
        correction = 1.0 - torch.as_tensor(beta, dtype=dt) \
            ** torch.as_tensor(step, dtype=dt)
        v_hat = v / torch.clamp_min(correction, cfg.eps_stat)
    else:
        v_hat = v
    g32 = grad.to(dt)
    if cfg.literal_div_v:  # Alg.1 line 10 verbatim
        u = g32 / (v_hat + cfg.eps_div)
    else:
        u = g32 / (torch.sqrt(v_hat) + cfg.eps_div)
    axes = _matrix_axes(u.ndim - batch_dims)
    # Grouped update normalization (Alg.1 line 11): per-matrix trust ratio.
    rms_u = _rms(u, axes)
    u = u / torch.clamp_min(rms_u / clip, 1.0)
    p32 = param.to(dt)
    scale = torch.clamp_min(_rms(p32, axes), cfg.eps_rms)
    u = u * scale
    return u, new_state


def update_tensor(param: Tensor, grad: Tensor, state: FactoredState, *,
                  lr, step, beta=DEFAULT_HPARAMS["beta"],
                  weight_decay=DEFAULT_HPARAMS["weight_decay"],
                  clip=DEFAULT_HPARAMS["clip"], cfg: AdaLomoConfig,
                  batch_dims: int = 0) -> tuple:
    """One AdaLomo step for a single tensor: θ ← θ - α·û (Alg.1 line 12).

    Decoupled weight decay pre-scales θ, but the RMS(θ) trust scale inside
    ``compute_update`` is taken from the *un-decayed* θ.  Computed in fp32
    and cast once, at the end, to the parameter's dtype.
    """
    u, new_state = compute_update(param, grad, state, step=step, beta=beta,
                                  clip=clip, cfg=cfg, batch_dims=batch_dims)
    p32 = param.to(cfg.state_dtype)
    p32 = p32 * (1.0 - lr * weight_decay)
    new_param = (p32 - lr * u).to(param.dtype)
    return new_param, new_state
