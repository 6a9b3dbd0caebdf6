"""Decode attention with kernel/oracle dispatch.  Counterpart of
``repro.kernels.decode_attention.ops``: ``decode_attention`` over a ring
cache (K4), ``decode_attention_partial`` over one rank's block of a ring
split over ranks (K4's partial entry) and ``paged_decode_attention`` over a
page pool (K3).

``use_kernel=None`` takes the CUDA kernel for a CUDA tensor (and records its
launch for a meta tensor, ``kernels/dry.py``) and the plain PyTorch oracle
for a CPU tensor; ``False`` asks for the oracle on any device
(the reference's own switch, ``PagedServeConfig.use_kernel``); ``True`` asks
for the kernel and raises on a CPU tensor.  Nothing falls back.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import dry
from repro_torch.kernels.decode_attention import decode_attention as K
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, ring_decode_attention_partial_ref,
    ring_decode_attention_ref)


def _kernel_wanted(q, use_kernel: Optional[bool], what: str) -> bool:
    if use_kernel is None:
        return not dry.plain(q)
    if use_kernel and dry.plain(q):
        raise ValueError(f"{what}: use_kernel=True needs CUDA tensors; the "
                         "kernel has no CPU version (use_kernel=None picks "
                         "the plain one there)")
    return bool(use_kernel)


def decode_attention(q, k_cache, v_cache, kv_pos, q_pos, *, scale=None,
                     window: Optional[int] = None, kv_block: int = 512,
                     use_kernel: Optional[bool] = None):
    """Drop-in for ``models.layers.decode_attention`` when positions are
    uniform across the batch (the serving engine's layout).

    q: [B,1,H,dh] -> [B,1,H,dh]; caches [B,W,K,dh]; kv_pos: [W] int32;
    q_pos: a 0-d int32 tensor or an int.  ``kv_block`` (the TPU kernel's
    block of cache slots) is accepted for the reference's signature; the
    result does not depend on it."""
    del kv_block
    if _kernel_wanted(q, use_kernel, "decode_attention"):
        out = K.decode_attention(q[:, 0], k_cache, v_cache, kv_pos, q_pos,
                                 scale=scale, window=window)
        return out[:, None]
    out = ring_decode_attention_ref(q[:, 0], k_cache, v_cache, kv_pos, q_pos,
                                    window=window, scale=scale)
    return out[:, None]


def decode_attention_partial(q, k_cache, v_cache, kv_pos, q_pos, *,
                             scale=None, window: Optional[int] = None,
                             use_kernel: Optional[bool] = None):
    """``decode_attention`` over one block of a ring's slots: q ``[B,1,H,dh]``
    -> ``(o [B,H,dh], lse [B,H])`` in fp32, for a merge over the blocks
    (``serve/sharded.py``); a head with no valid slot gets ``o = 0`` and
    ``lse = -inf``."""
    if _kernel_wanted(q, use_kernel, "decode_attention_partial"):
        return K.decode_attention_partial(q[:, 0], k_cache, v_cache, kv_pos,
                                          q_pos, scale=scale, window=window)
    return ring_decode_attention_partial_ref(q[:, 0], k_cache, v_cache,
                                             kv_pos, q_pos, window=window,
                                             scale=scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           scale=None, window: Optional[int] = None,
                           use_kernel: Optional[bool] = None):
    """q: [B,1,H,dh]; k_pages/v_pages: [N, ps, K, dh]; block_tables: [B,P]
    int32; seq_lens: [B] int32 incl. the current token. Returns [B,1,H,dh]."""
    if _kernel_wanted(q, use_kernel, "paged_decode_attention"):
        out = K.paged_decode_attention(q[:, 0], k_pages, v_pages,
                                       block_tables, seq_lens, scale=scale,
                                       window=window)
        return out[:, None]
    out = paged_decode_attention_ref(q[:, 0], k_pages, v_pages, block_tables,
                                     seq_lens, window=window, scale=scale)
    return out[:, None]
