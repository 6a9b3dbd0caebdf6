"""Shared neural-net layers (PyTorch): the dense GQA transformer block and
the decode-attention oracle.  Counterpart of ``repro.models.layers``.

Pure functions over explicit parameter dicts, weights kept ``[d_in, d_out]``
(``x @ w``) as the reference keeps them.

Where the reference asks for an fp32 product of low-precision operands
(``preferred_element_type=float32``: attention scores, logits), the port
casts the operands to fp32 and multiplies in fp32: exact products of the
bf16 values, fp32 sums, fp32 output.  ``torch.matmul`` on bf16 operands
would round its output to bf16 first.  fp32 inputs are untouched.

The attention dispatcher has the reference's three branches: direct
attention up to 2048 tokens, the sliding-window gather past ``window + 1024``
and, between them or without a window, blockwise online-softmax attention
whose gradient (``_flash_attention``, a ``torch.autograd.Function``)
recomputes the probabilities blockwise.  Packed-segment batches
(``MaskSpec.segmented``) carry per-row ``(B, S)`` positions and segment ids
through the direct and blockwise/flash branches, where attention never
crosses a segment, forward or backward; as in the reference they never take
the window gather.  Prefix-LM masks (``MaskSpec.has_prefix`` with a ``(B,)``
``prefix_len``) open the first ``prefix_len[b]`` keys of row b to every
query, in the direct and blockwise/flash branches, forward and recomputing
backward; a prefix batch never takes the window gather either, and a packed
batch refuses a prefix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.tree import leading_pieces, tree_map

Tensor = torch.Tensor

# Sequences at or below this use the direct einsum attention path.
_DIRECT_ATTN_MAX_SEQ = 2048
_Q_BLOCK = 1024
_KV_BLOCK = 1024

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layernorm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5
              ) -> Tensor:
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def norm_apply(params: dict, x: Tensor, *, kind: str, eps: float = 1e-6
               ) -> Tensor:
    # as in the reference, both kinds take this eps (1e-6), not
    # layernorm's own default of 1e-5
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps)
    return layernorm(x, params["scale"], params["bias"], eps)


def norm_init(d: int, kind: str, *, device,
              out: Optional[dict] = None) -> dict:
    """The norm's fp32 leaves, written into ``out`` where it is given."""
    if out is None:
        keys = ("scale",) if kind == "rmsnorm" else ("scale", "bias")
        out = {k: torch.empty((d,), dtype=torch.float32, device=device)
               for k in keys}
    # rmsnorm stores (scale - 1) so zeros-init == identity; see rmsnorm().
    out["scale"].fill_(0.0 if kind == "rmsnorm" else 1.0)
    if "bias" in out:
        out["bias"].zero_()
    return out


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
    """x: (..., S, H, dh); sin/cos: (S, d_rot/2), or (B, S, d_rot/2) for
    per-row positions (packed batches restart them at every document)."""
    dh = x.shape[-1]
    d_rot = int(dh * rope_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = torch.chunk(xr.to(torch.float32), 2, dim=-1)
    # over the head dim: (S, half) -> (S, 1, half) broadcasts over batch
    # and heads, (B, S, half) -> (B, S, 1, half) over heads only
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
    # prefix-LM: kv positions < prefix_len[b] are visible to every query
    has_prefix: bool = False
    # packed-segment batches: attention also requires equal segment ids
    # (q_seg/kv_seg travel beside the positions); incompatible with
    # has_prefix
    segmented: bool = False


def _mask_block(q_pos: Tensor, kv_pos: Tensor, spec: MaskSpec,
                q_seg: Optional[Tensor] = None,
                kv_seg: Optional[Tensor] = None,
                prefix_len: Optional[Tensor] = None) -> Tensor:
    """Bool mask block (..., Sq, Skv) from position (and segment) vectors;
    with a prefix, ``(B, ..., Sq, Skv)`` for ``prefix_len`` of shape
    ``(B,)``."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q_pos.device)
    if spec.causal:
        m = m & (q >= k)
    if spec.window is not None:
        m = m & (q - k < spec.window)
    if q_seg is not None:
        m = m & (q_seg[..., :, None] == kv_seg[..., None, :])
    if spec.has_prefix and prefix_len is not None:
        pl = prefix_len.reshape(tuple(prefix_len.shape) + (1,) * q.ndim)
        m = m | (k < pl)
        if spec.window is not None:
            m = m & ((q - k < spec.window) | (k < pl))
    return m


def _scan_block_mask(qp: Tensor, kp: Tensor, qs: Optional[Tensor],
                     ks: Optional[Tensor], spec: MaskSpec,
                     prefix_len: Optional[Tensor] = None) -> Tensor:
    """Mask for one (query block, KV block) pair of the blockwise loops.

    qp ``(T, qb)`` shared by the rows, or ``(B, T, qb)`` per row (packed
    segments); kp ``(kb,)`` or ``(B, kb)`` to match; qs/ks segment-id blocks
    of the same shapes, or None; prefix_len ``(B,)`` with shared metadata
    only.  Returns a mask broadcastable against score blocks
    ``[B, T, K, G, qb, kb]``: ``(1, T, 1, 1, qb, kb)`` for metadata shared
    by the rows and no prefix, ``(B, T, 1, 1, qb, kb)`` otherwise."""
    if spec.has_prefix and prefix_len is not None:   # lifted to (B,T,qb,kb)
        return _mask_block(qp, kp, spec, qs, ks,
                           prefix_len)[:, :, None, None]
    if qp.ndim == 3:                    # per row: lift kp/ks over the tiles
        kp, ks = kp[:, None], None if ks is None else ks[:, None]
        return _mask_block(qp, kp, spec, qs, ks)[:, :, None, None]
    return _mask_block(qp, kp, spec, qs, ks)[None, :, None, None]


def _q_meta_blocks(a: Tensor, T: int, Sloc: int, pq: int, qb: int,
                   fill: int) -> Tensor:
    """Tile, pad and block query metadata (positions or segment ids):
    ``(Sq,)`` -> ``[nq, T, qb]``; ``(B, Sq)`` -> ``[nq, B, T, qb]``."""
    a = a.reshape(tuple(a.shape[:-1]) + (T, Sloc))
    if pq:
        a = F.pad(a, (0, pq), value=fill)
    a = a.reshape(tuple(a.shape[:-1]) + ((Sloc + pq) // qb, qb))
    return a.movedim(-2, 0)


def _kv_meta_blocks(a: Tensor, pk: int, kb: int, fill: int) -> Tensor:
    """Pad and block KV metadata: ``(Skv,)`` -> ``[nk, kb]``; ``(B, Skv)``
    -> ``[nk, B, kb]``."""
    if pk:
        a = F.pad(a, (0, pk), value=fill)
    return a.reshape(tuple(a.shape[:-1]) + (-1, kb)).movedim(-2, 0)


# Fill values for padded metadata slots: a padded query (pos -1, seg -1)
# and a padded KV slot (pos 2**30, seg -2) can never pass the causal,
# window or segment-equality terms against a real slot.
_QPOS_FILL, _KPOS_FILL = -1, 2 ** 30
_QSEG_FILL, _KSEG_FILL = -1, -2


def _meta_blocks(q_pos, kv_pos, q_seg, kv_seg, T, Sloc, pq, qb, pk, kb):
    """The blocked metadata of both loops: ``(qps, kps, qss, kss)``; the
    segment blocks are None for an unpacked batch."""
    qps = _q_meta_blocks(q_pos, T, Sloc, pq, qb, _QPOS_FILL)
    kps = _kv_meta_blocks(kv_pos, pk, kb, _KPOS_FILL)
    if q_seg is None:
        return qps, kps, None, None
    return (qps, kps, _q_meta_blocks(q_seg, T, Sloc, pq, qb, _QSEG_FILL),
            _kv_meta_blocks(kv_seg, pk, kb, _KSEG_FILL))


def _per_row(q_pos, kv_pos, q_seg, B: int) -> tuple:
    """Shared ``(S,)`` positions of a packed batch as ``(B, S)`` rows, as
    the reference broadcasts them."""
    if q_seg is not None and q_pos.ndim == 1:
        return q_pos.expand(B, -1), kv_pos.expand(B, -1)
    return q_pos, kv_pos


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


def _block_geometry(Sq: int, Skv: int, q_block: int, kv_block: int,
                    tiles: int) -> tuple:
    """(T, Sloc, qb, kb, pq, pk): query tiles, their length, the block
    sizes and the padding that makes each a whole number of blocks."""
    T = tiles if (tiles > 1 and Sq % tiles == 0) else 1
    Sloc = Sq // T
    qb = min(q_block, Sloc)
    kb = min(kv_block, Skv)
    return T, Sloc, qb, kb, (-Sloc) % qb, (-Skv) % kb


def _pad_q_tiles(x: Tensor, T: int, Sloc: int, pq: int) -> Tensor:
    """``[B, Sq, ...]`` -> ``[B, T, Sloc + pq, ...]``, zero-padded in each
    tile."""
    x = x.reshape((x.shape[0], T, Sloc) + tuple(x.shape[2:]))
    if pq:
        x = F.pad(x, (0, 0) * (x.ndim - 3) + (0, pq))
    return x


def _pad_kv(x: Tensor, pk: int) -> Tensor:
    return F.pad(x, (0, 0, 0, 0, 0, pk)) if pk else x


def _block_attention(q, k, v, q_pos, kv_pos, spec, scale, q_block: int,
                     kv_block: int, tiles: int = 1,
                     return_lse: bool = False, q_seg=None, kv_seg=None,
                     prefix_len=None):
    """Two-level blockwise attention with an online softmax (flash-style).

    q ``[B,Sq,K,G,dh]``; k/v ``[B,Skv,K,dh]``; positions ``(Sq,)`` and
    ``(Skv,)`` shared by the rows, or ``(B, Sq)`` and ``(B, Skv)`` per row
    for packed-segment batches (then q_seg/kv_seg carry matching segment ids
    and attention never crosses a segment); prefix_len ``(B,)`` for
    prefix-LM masks.  Loops over query blocks
    (outer) and KV blocks (inner); score blocks ``[B,T,K,G,qb,kb]`` are the
    only O(S·block) intermediates.  ``tiles`` > 1 splits the query sequence
    into T tiles carried as a tensor dim (the reference shards it over a
    mesh; here it only reshapes)."""
    B, Sq, K, G, dh = q.shape
    dv = v.shape[-1]
    Skv = k.shape[1]
    q_pos, kv_pos = _per_row(q_pos, kv_pos, q_seg, B)
    T, Sloc, qb, kb, pq, pk = _block_geometry(Sq, Skv, q_block, kv_block,
                                              tiles)
    qps, kps, qss, kss = _meta_blocks(q_pos, kv_pos, q_seg, kv_seg, T, Sloc,
                                      pq, qb, pk, kb)
    Slp = Sloc + pq
    nq = Slp // qb
    qs = _pad_q_tiles(q, T, Sloc, pq).reshape(B, T, nq, qb, K, G, dh)
    ks = _pad_kv(k, pk).reshape(B, -1, kb, K, dh)
    vs = _pad_kv(v, pk).reshape(B, -1, kb, K, dv)
    nk = ks.shape[1]

    outs, lses = [], []
    for i in range(nq):
        qi = qs[:, :, i].to(torch.float32)           # [B,T,qb,K,G,dh]
        m_run = q.new_full((B, T, K, G, qb), NEG_INF, dtype=torch.float32)
        l_run = q.new_zeros((B, T, K, G, qb), dtype=torch.float32)
        acc = q.new_zeros((B, T, K, G, qb, dv), dtype=torch.float32)
        for j in range(nk):
            vj = vs[:, j]
            logits = torch.einsum("btqkgd,bskd->btkgqs", qi,
                                  ks[:, j].to(torch.float32)) * scale
            mask = _scan_block_mask(qps[i], kps[j],
                                    None if qss is None else qss[i],
                                    None if kss is None else kss[j], spec,
                                    prefix_len)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("btkgqs,bskd->btkgqd", p.to(vj.dtype), vj)
            acc = acc * corr[..., None] + pv.to(torch.float32)
            m_run = m_new
        l_safe = torch.clamp_min(l_run, 1e-30)
        out = (acc / l_safe[..., None]).to(v.dtype)
        outs.append(out.permute(0, 1, 4, 2, 3, 5))    # [B,T,qb,K,G,dv]
        lses.append((m_run + torch.log(l_safe)).permute(0, 1, 4, 2, 3))
    out = torch.stack(outs, dim=2).reshape(B, T, Slp, K, G, dv)
    lse = torch.stack(lses, dim=2).reshape(B, T, Slp, K, G)
    out = out[:, :, :Sloc].reshape(B, Sq, K, G, dv)
    if return_lse:
        return out, lse[:, :, :Sloc].reshape(B, Sq, K, G)
    return out


class _FlashAttention(torch.autograd.Function):
    """Blockwise attention whose backward saves only ``(q, k, v, out, lse)``
    and recomputes the probabilities block by block, as FlashAttention's
    backward does (the reference's ``jax.custom_vjp``).  Segment masking
    (packed batches) and the prefix (prefix-LM) are part of the recomputed
    mask, so masked terms drop out of dq, dk and dv as they do out of the
    forward; prefix_len is a non-differentiable input."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, spec, scale, q_block, kv_block,
                tiles, q_seg, kv_seg, prefix_len):
        out, lse = _block_attention(q, k, v, q_pos, kv_pos, spec, scale,
                                    q_block, kv_block, tiles,
                                    return_lse=True, q_seg=q_seg,
                                    kv_seg=kv_seg, prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (q_pos, kv_pos, q_seg, kv_seg, prefix_len, spec, scale,
                    q_block, kv_block, tiles)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        (q_pos, kv_pos, q_seg, kv_seg, prefix_len, spec, scale, q_block,
         kv_block, tiles) = ctx.meta
        B, Sq, K, G, dh = q.shape
        q_pos, kv_pos = _per_row(q_pos, kv_pos, q_seg, B)
        dvd = v.shape[-1]
        Skv = k.shape[1]
        T, Sloc, qb, kb, pq, pk = _block_geometry(Sq, Skv, q_block,
                                                  kv_block, tiles)
        f32 = torch.float32
        D = torch.sum(dout.to(f32) * out.to(f32), dim=-1)       # [B,Sq,K,G]
        Slp = Sloc + pq
        nq = Slp // qb

        def blocks(x):          # [B, Sq, ...] -> [B, T, nq, qb, ...]
            x = _pad_q_tiles(x, T, Sloc, pq)
            return x.reshape((B, T, nq, qb) + tuple(x.shape[3:]))

        qs, dos, lses, Ds = blocks(q), blocks(dout), blocks(lse), blocks(D)
        qps, kps, qss, kss = _meta_blocks(q_pos, kv_pos, q_seg, kv_seg, T,
                                          Sloc, pq, qb, pk, kb)
        ks = _pad_kv(k, pk).reshape(B, -1, kb, K, dh).to(f32)
        vs = _pad_kv(v, pk).reshape(B, -1, kb, K, dvd).to(f32)
        nk = ks.shape[1]
        dk = torch.zeros_like(ks)
        dv = torch.zeros_like(vs)
        dqs = []
        for i in range(nq):
            qi = qs[:, :, i].to(f32)                     # [B,T,qb,K,G,dh]
            doi = dos[:, :, i].to(f32)
            lse_t = lses[:, :, i].permute(0, 1, 3, 4, 2)  # [B,T,K,G,qb]
            D_t = Ds[:, :, i].permute(0, 1, 3, 4, 2)
            dq_i = torch.zeros_like(qi)
            for j in range(nk):
                ki, vi = ks[:, j], vs[:, j]
                logits = torch.einsum("btqkgd,bskd->btkgqs", qi, ki) * scale
                mask = _scan_block_mask(qps[i], kps[j],
                                        None if qss is None else qss[i],
                                        None if kss is None else kss[j],
                                        spec, prefix_len)
                p = torch.where(mask, torch.exp(logits - lse_t[..., None]),
                                0.0)
                dv[:, j] += torch.einsum("btkgqs,btqkgv->bskv", p, doi)
                dp = torch.einsum("btqkgv,bskv->btkgqs", doi, vi)
                ds = p * (dp - D_t[..., None])
                dq_i += torch.einsum("btkgqs,bskd->btqkgd", ds, ki) * scale
                dk[:, j] += torch.einsum("btkgqs,btqkgd->bskd", ds,
                                         qi) * scale
            dqs.append(dq_i)
        dq = torch.stack(dqs, dim=2).reshape(B, T, Slp, K, G, dh)
        dq = dq[:, :, :Sloc].reshape(B, Sq, K, G, dh)
        dk = dk.reshape(B, -1, K, dh)[:, :Skv]
        dv = dv.reshape(B, -1, K, dvd)[:, :Skv]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None, None, None, None)


def _flash_attention(q, k, v, q_pos, kv_pos, spec, scale, q_block: int,
                     kv_block: int, tiles: int = 1, q_seg=None, kv_seg=None,
                     prefix_len=None):
    """Blockwise attention with the recomputing backward of
    ``_FlashAttention``; where no gradient is asked for (``torch.no_grad``,
    or inputs that do not require one) only the forward runs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, q_pos, kv_pos, spec, scale,
                                     q_block, kv_block, tiles, q_seg, kv_seg,
                                     prefix_len)
    return _block_attention(q, k, v, q_pos, kv_pos, spec, scale, q_block,
                            kv_block, tiles, q_seg=q_seg, kv_seg=kv_seg,
                            prefix_len=prefix_len)


def _swa_gather_attention(q, k, v, q_pos, kv_pos, spec, scale, q_block: int,
                          q_offset: int = 0):
    """Sliding-window path: each query block gathers only its KV window —
    O(S·(W+qb)) work instead of O(S²).  ``q_offset``: the KV index of the
    first query (a sequence tile's queries against the whole sequence's
    K/V)."""
    B, Sq, K, G, dh = q.shape
    W = spec.window
    qb = min(q_block, Sq)
    pq = (-Sq) % qb
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        q_pos = F.pad(q_pos, (0, pq), value=-1)
    nq = q.shape[1] // qb
    span = W + qb          # window slice length per query block
    # KV padded on the left by span: padded index p is original p - span
    k_pad = F.pad(k, (0, 0, 0, 0, span, 0))
    v_pad = F.pad(v, (0, 0, 0, 0, span, 0))
    kvp_pad = F.pad(kv_pos, (span, 0), value=-(2 ** 30))
    outs = []
    for i in range(nq):
        # the window covering original [s - W, s + qb) starts at padded
        # index s + qb; like the reference's dynamic_slice, the start is
        # clamped so that the slice stays inside the padded KV
        p0 = min(q_offset + (i + 1) * qb, k_pad.shape[1] - span)
        qi = q[:, i * qb:(i + 1) * qb]
        ki = k_pad[:, p0:p0 + span]
        vi = v_pad[:, p0:p0 + span]
        mask = _mask_block(q_pos[i * qb:(i + 1) * qb],
                           kvp_pad[p0:p0 + span], spec)
        outs.append(_direct_attention(qi, ki, vi, mask[None, None, None],
                                      scale))
    return torch.cat(outs, dim=1)[:, :Sq]


def attention(
    q: Tensor,              # [B, Sq, H, dh]
    k: Tensor,              # [B, Skv, K, dh]
    v: Tensor,              # [B, Skv, K, dh]
    *,
    spec: MaskSpec,
    q_pos: Tensor,          # (Sq,) int positions, or (B, Sq) when packed
    kv_pos: Tensor,         # (Skv,) int, or (B, Skv)
    prefix_len: Optional[Tensor] = None,    # (B,) for prefix-LM
    q_seg: Optional[Tensor] = None,     # (B, Sq) segment ids (packed)
    kv_seg: Optional[Tensor] = None,    # (B, Skv)
    scale: Optional[float] = None,
    force_direct: bool = False,
    q_offset: int = 0,
) -> Tensor:
    """GQA attention dispatcher. Returns [B, Sq, H, dv] (dv = v head dim).

    Direct attention up to 2048 tokens; past that, the window gather for a
    sliding window shorter than the keys less a query block, and the
    blockwise/flash branch otherwise.  A packed batch (segment ids) or a
    prefix-LM batch never takes the gather, whose windows neither mask
    cuts; a packed batch with a prefix is refused.

    Sequence parallelism: q may be a tile of the sequence (``q_pos`` its
    absolute positions, ``q_offset`` the KV index of its first query) and
    k/v the whole sequence (``kv_pos`` all positions); every branch masks
    from the positions, so a tile attends as its rows of the whole
    sequence's attention do, and the branch is chosen by the whole
    sequence's length."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    if H % K or k.shape[-1] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form grouped-query attention")
    if spec.segmented != (q_seg is not None):
        raise ValueError("MaskSpec.segmented must match whether segment ids "
                         f"are passed (segmented={spec.segmented}, q_seg "
                         f"{'given' if q_seg is not None else 'None'})")
    if q_seg is not None and spec.has_prefix:
        raise ValueError("packed-segment batches are incompatible with "
                         "prefix-LM masks")
    dv = v.shape[-1]
    G = H // K
    qg = q.reshape(B, Sq, K, G, dh)
    scale = scale if scale is not None else dh ** -0.5
    Skv = k.shape[1]

    if force_direct or max(Sq, Skv) <= _DIRECT_ATTN_MAX_SEQ:
        mask = _mask_block(q_pos, kv_pos, spec, q_seg, kv_seg, prefix_len)
        mask = mask[None, None, None] if mask.ndim == 2 else mask[:, None, None]
        out = _direct_attention(qg, k, v, mask, scale)
    elif (spec.window is not None and not spec.has_prefix and q_seg is None
          and Skv > spec.window + _Q_BLOCK):
        out = _swa_gather_attention(qg, k, v, q_pos, kv_pos, spec, scale,
                                    _Q_BLOCK, q_offset)
    else:
        # one query tile: the reference's seq_tiles() without a mesh, and
        # this rank's tile with one (its queries are the tile already)
        out = _flash_attention(qg, k, v, q_pos, kv_pos, spec, scale,
                               _Q_BLOCK, _KV_BLOCK, tiles=1, q_seg=q_seg,
                               kv_seg=kv_seg, prefix_len=prefix_len)
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


def mlp(params: dict, x: Tensor, act: str = "gelu") -> Tensor:
    """Plain 2-layer MLP with biases (whisper): down( act(up(x)) )."""
    h = ACTS[act](dense(x, params["w_up"], params.get("b_up")))
    return dense(h, params["w_down"], params.get("b_down"))


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------

# A random init of more than this many elements is drawn piece by piece
# (deepseek-v3-671b's expert stacks are 3.76 G elements: one fp32 draw of a
# whole stack would be 15 GB beside the model); a smaller one takes one draw.
_NORMAL_WHOLE_MAX = 1 << 30


def normal_init(gen, shape: tuple, std: float, *, dtype, device,
                out: Optional[Tensor] = None) -> Tensor:
    """``std`` times standard normal draws from ``gen``, in ``dtype``,
    written into ``out`` (a tensor of ``shape``, e.g. one layer of a stack)
    where one is given.  A tensor of at most ``_NORMAL_WHOLE_MAX`` elements
    is one fp32 draw; a larger one is drawn in ``leading_pieces``, so no fp32
    copy of the whole tensor exists.  On the meta device (shape bookkeeping,
    the dry run) the same tensors are made and nothing is drawn."""
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    whole = math.prod(shape) <= _NORMAL_WHOLE_MAX
    for part in [out] if whole else leading_pieces(out):
        draw = torch.empty(part.shape, dtype=torch.float32, device=device)
        if draw.device.type != "meta":
            part.copy_(draw.normal_(generator=gen).mul_(std))
    return out


def linear_init(gen, d_in: int, d_out: int, *, scale: float = 1.0,
                dtype=torch.float32, device, out: Optional[Tensor] = None
                ) -> Tensor:
    return normal_init(gen, (d_in, d_out), scale * (d_in ** -0.5),
                       dtype=dtype, device=device, out=out)


def zeros_init(shape: tuple, *, dtype, device, out: Optional[Tensor] = None
               ) -> Tensor:
    """Zeros of ``shape`` in ``dtype``, written into ``out`` where one is
    given (on the meta device nothing is written)."""
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type != "meta":
        out.zero_()
    return out


def mlp_init(gen, d: int, d_ff: int, *, dtype, device,
             out: Optional[dict] = None) -> dict:
    """The plain MLP's leaves (``mlp``): ``w_up`` then ``w_down`` drawn
    from ``gen`` at unit scale, zero biases; written into ``out`` where it
    is given."""
    o = out or {}
    return {
        "w_up": linear_init(gen, d, d_ff, dtype=dtype, device=device,
                            out=o.get("w_up")),
        "b_up": zeros_init((d_ff,), dtype=dtype, device=device,
                           out=o.get("b_up")),
        "w_down": linear_init(gen, d_ff, d, dtype=dtype, device=device,
                              out=o.get("w_down")),
        "b_down": zeros_init((d,), dtype=dtype, device=device,
                             out=o.get("b_down")),
    }


def embed_init(gen, vocab: int, d: int, *, dtype=torch.float32, device
               ) -> Tensor:
    return normal_init(gen, (vocab, d), 0.02, dtype=dtype, device=device)


def stacked_blocks(n_layers: int, block_init, gen, device) -> dict:
    """The ``[n_layers, ...]`` layer stack, allocated once with each layer
    drawn straight into it by ``block_init(gen, device, out)`` (``out``:
    views of that layer of the stack; None and the meta device give the
    shapes, the meta device drawing nothing), in layer order, so no copy of
    a layer is ever made."""
    # the shapes, taken off a block made on the meta device (and dropped
    # before the stack is made: a dry run counts meta tensors as the card's)
    shapes = tree_map(lambda t: (t.shape, t.dtype),
                      block_init(None, torch.device("meta"), None))
    blocks = tree_map(
        lambda s: torch.empty((n_layers,) + s[0], dtype=s[1], device=device),
        shapes)
    for i in range(n_layers):
        block_init(gen, device, tree_map(lambda t: t[i], blocks))
    return blocks


def init_generator(seed: int, device) -> tuple:
    """``(device, generator)``: the resolved device and a generator seeded
    with ``seed`` on it (None on the meta device, where nothing is drawn)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return dev, None
    dev = resolve_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return dev, gen
