"""Shared neural-net layers (PyTorch): the dense GQA transformer block and
the decode-attention oracle.  Counterpart of ``repro.models.layers``.

Pure functions over explicit parameter dicts, weights kept ``[d_in, d_out]``
(``x @ w``) as the reference keeps them.

Where the reference asks for an fp32 product of low-precision operands
(``preferred_element_type=float32``: attention scores, logits), the port
casts the operands to fp32 and multiplies in fp32: exact products of the
bf16 values, fp32 sums, fp32 output.  ``torch.matmul`` on bf16 operands
would round its output to bf16 first.  fp32 inputs are untouched.

Only the direct attention branch (sequences up to 2048) is ported; the
dispatcher names the missing branch for longer ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# Sequences at or below this use the direct einsum attention path.
_DIRECT_ATTN_MAX_SEQ = 2048
_Q_BLOCK = 1024

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def norm_apply(params: dict, x: Tensor, *, kind: str, eps: float = 1e-6
               ) -> Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps)
    raise NotImplementedError(
        f"norm kind {kind!r}: only 'rmsnorm' is ported (layernorm comes "
        "with the encoder-decoder family)")


def norm_init(d: int, kind: str, *, device) -> dict:
    if kind == "rmsnorm":
        # stored as (scale - 1) so zeros-init == identity; see rmsnorm().
        return {"scale": torch.zeros((d,), dtype=torch.float32,
                                     device=device)}
    raise NotImplementedError(f"norm kind {kind!r}: only 'rmsnorm' is ported")


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_sincos(positions: Tensor, d_rot: int, theta: float = 10000.0
                ) -> tuple:
    """positions: (...,) int -> sin/cos tables (..., d_rot/2) fp32."""
    half = d_rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: Tensor, sin: Tensor, cos: Tensor, rope_pct: float = 1.0
               ) -> Tensor:
    """x: (..., S, H, dh); sin/cos: (S, d_rot/2) or broadcastable."""
    dh = x.shape[-1]
    d_rot = int(dh * rope_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = torch.chunk(xr.to(torch.float32), 2, dim=-1)
    # sin/cos broadcast over batch & head dims: (S, half) -> (S, 1, half)
    s = sin[..., :, None, :]
    c = cos[..., :, None, :]
    rot = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([rot.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# Masks (computed from positions on the fly)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaskSpec:
    causal: bool = True
    window: Optional[int] = None       # SWA: attend to [pos-window+1, pos]


def _mask_block(q_pos: Tensor, kv_pos: Tensor, spec: MaskSpec) -> Tensor:
    """Bool mask block (..., Sq, Skv) from position vectors."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q_pos.device)
    if spec.causal:
        m = m & (q >= k)
    if spec.window is not None:
        m = m & (q - k < spec.window)
    return m


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def _direct_attention(q, k, v, mask, scale):
    """q: [B,Sq,K,G,dh] k/v: [B,Skv,K,dh] mask: broadcastable [B,1,1,Sq,Skv]."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def attention(
    q: Tensor,              # [B, Sq, H, dh]
    k: Tensor,              # [B, Skv, K, dh]
    v: Tensor,              # [B, Skv, K, dh]
    *,
    spec: MaskSpec,
    q_pos: Tensor,          # (Sq,) int positions
    kv_pos: Tensor,         # (Skv,) int
    scale: Optional[float] = None,
) -> Tensor:
    """GQA attention dispatcher. Returns [B, Sq, H, dv] (dv = v head dim)."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    if H % K or k.shape[-1] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form grouped-query attention")
    dv = v.shape[-1]
    G = H // K
    qg = q.reshape(B, Sq, K, G, dh)
    scale = scale if scale is not None else dh ** -0.5
    Skv = k.shape[1]

    if max(Sq, Skv) <= _DIRECT_ATTN_MAX_SEQ:
        mask = _mask_block(q_pos, kv_pos, spec)
        mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
        out = _direct_attention(qg, k, v, mask, scale)
    elif spec.window is not None and Skv > spec.window + _Q_BLOCK:
        raise NotImplementedError(
            f"sequence length {max(Sq, Skv)} > {_DIRECT_ATTN_MAX_SEQ} with a "
            "sliding window needs _swa_gather_attention, which is not "
            "ported yet")
    else:
        raise NotImplementedError(
            f"sequence length {max(Sq, Skv)} > {_DIRECT_ATTN_MAX_SEQ} needs "
            "_flash_attention/_block_attention, which are not ported yet")
    return out.reshape(B, Sq, H, dv)


def decode_attention(
    q: Tensor,              # [B, 1, H, dh]
    k_cache: Tensor,        # [B, W, K, dh]  (ring buffer or linear cache)
    v_cache: Tensor,
    *,
    kv_pos: Tensor,         # [B, W] int absolute positions, -1 = empty
    q_pos: Tensor,          # [B] int
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> Tensor:
    """Single-token decode attention over a KV cache, the dense oracle of
    the decode kernels: fp32 scores, a ``NEG_INF`` mask, softmax.  A row
    with no valid position softmaxes to uniform (mean of V), where the
    kernels return 0."""
    B, _, H, dh = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(B, 1, K, G, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        valid = valid & (q_pos[:, None] - kv_pos < window)
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, dh)


# --------------------------------------------------------------------------
# Dense / linear helpers
# --------------------------------------------------------------------------

def dense(x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


ACTS = {
    "silu": F.silu,
    # the reference's jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def glu_mlp(params: dict, x: Tensor, act: str = "silu") -> Tensor:
    """SwiGLU/GeGLU: down( act(gate(x)) * up(x) )."""
    g = dense(x, params["w_gate"])
    u = dense(x, params["w_up"])
    return dense(ACTS[act](g) * u, params["w_down"])


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------

def _normal(shape: tuple, gen: Optional[torch.Generator], device) -> Tensor:
    """Standard normal fp32 draws from ``gen``; on the meta device (shape
    bookkeeping) nothing is drawn."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.device.type != "meta":
        out.normal_(generator=gen)
    return out


def linear_init(gen, d_in: int, d_out: int, *, scale: float = 1.0,
                dtype=torch.float32, device) -> Tensor:
    std = scale * (d_in ** -0.5)
    return (_normal((d_in, d_out), gen, device) * std).to(dtype)


def embed_init(gen, vocab: int, d: int, *, dtype=torch.float32, device
               ) -> Tensor:
    return (_normal((vocab, d), gen, device) * 0.02).to(dtype)
