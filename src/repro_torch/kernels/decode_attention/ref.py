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
