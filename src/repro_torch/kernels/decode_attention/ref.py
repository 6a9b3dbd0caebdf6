"""Plain PyTorch oracles of the decode-attention kernels: exactly
``models.layers.decode_attention`` (the serving path's attention).
Counterpart of ``repro.kernels.decode_attention.ref``."""
from __future__ import annotations

import torch

from repro_torch.models.layers import decode_attention


def decode_attention_ref(q, k_cache, v_cache, *, kv_pos, q_pos,
                         window=None, scale=None):
    """q: [B,H,dh]; caches: [B,W,K,dh]; kv_pos: [B,W]; q_pos: [B].
    Returns [B,H,dh]."""
    out = decode_attention(q[:, None], k_cache, v_cache, kv_pos=kv_pos,
                           q_pos=q_pos, window=window, scale=scale)
    return out[:, 0]


def ring_decode_attention_ref(q, k_cache, v_cache, kv_pos, q_pos, *,
                              window=None, scale=None):
    """Plain version of K4: ``decode_attention_ref`` with the batch-shared
    slot positions ``kv_pos [W]`` and query position ``q_pos`` (an int or a
    0-d int tensor) broadcast over the batch.  q: [B,H,dh]; caches:
    [B,W,K,dh].  Returns [B,H,dh]."""
    B, W = q.shape[0], kv_pos.shape[0]
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=q.device)
    return decode_attention_ref(q, k_cache, v_cache,
                                kv_pos=kv_pos[None].expand(B, W),
                                q_pos=q_pos.expand(B), window=window,
                                scale=scale)


def ring_decode_attention_partial_ref(q, k_cache, v_cache, kv_pos, q_pos, *,
                                      window=None, scale=None):
    """Plain version of K4's partial entry, over one block of a ring's slots
    (``kv_pos [W]`` their positions): ``(o [B,H,dh], lse [B,H])``, both
    float32.  ``o`` is the softmax-weighted sum of the block's valid V rows
    in fp32 and ``lse`` the log-sum-exp of each head's scaled scores over
    them; a head with no valid slot gets ``o = 0`` and ``lse = -inf`` (not
    the dense oracle's mean of V), so that a merge weighs it 0."""
    B, H, dh = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = scale if scale is not None else dh ** -0.5
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=q.device)
    s = torch.einsum("bkgd,bwkd->bkgw",
                     q.reshape(B, K, G, dh).to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    valid = (kv_pos >= 0) & (kv_pos <= q_pos)
    if window is not None:
        valid = valid & (q_pos - kv_pos < window)
    s = torch.where(valid, s, -torch.inf)
    m = torch.clamp_min(torch.amax(s, dim=-1, keepdim=True),
                        torch.finfo(torch.float32).min)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgw,bwkd->bkgd", p, v_cache.to(torch.float32))
    o = o / torch.clamp_min(l, 1e-30)
    lse = torch.where(l > 0, m + torch.log(l), -torch.inf)
    return o.reshape(B, H, dh), lse.reshape(B, H)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, seq_lens,
                               *, window=None, scale=None):
    """Dense oracle for the paged kernel: gather each sequence's pages into
    a contiguous cache and run the exact serving-path attention.

    q: [B,H,dh]; k_pages/v_pages: [N, ps, K, dh]; block_tables: [B,P];
    seq_lens: [B] (counts include the current token). Returns [B,H,dh]."""
    B = q.shape[0]
    _, ps, K, dh = k_pages.shape
    P = block_tables.shape[1]
    bt = block_tables.long()
    kc = k_pages[bt].reshape(B, P * ps, K, dh)
    vc = v_pages[bt].reshape(B, P * ps, K, dh)
    pos = torch.arange(P * ps, dtype=torch.int32, device=q.device)
    seq_lens = seq_lens.to(torch.int32)
    kv_pos = torch.where(pos[None, :] < seq_lens[:, None], pos[None, :], -1)
    q_pos = torch.clamp_min(seq_lens - 1, 0)
    out = decode_attention(q[:, None], kc, vc, kv_pos=kv_pos, q_pos=q_pos,
                           window=window, scale=scale)
    return out[:, 0]
