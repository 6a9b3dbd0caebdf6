"""Paged decode attention with kernel/oracle dispatch.  Counterpart of
``repro.kernels.decode_attention.ops.paged_decode_attention``.

``use_kernel=None`` takes the CUDA kernel (K3) for a CUDA tensor and the
plain PyTorch gather oracle for a CPU tensor; ``False`` asks for the oracle
on any device (the reference's own switch, ``PagedServeConfig.use_kernel``);
``True`` asks for the kernel and raises on a CPU tensor.  Nothing falls back.
(The uniform-position ``decode_attention`` of the reference reaches K4,
which waits for the legacy-engine slice.)
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.decode_attention import decode_attention as K
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           scale=None, window: Optional[int] = None,
                           use_kernel: Optional[bool] = None):
    """q: [B,1,H,dh]; k_pages/v_pages: [N, ps, K, dh]; block_tables: [B,P]
    int32; seq_lens: [B] int32 incl. the current token. Returns [B,1,H,dh]."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if use_kernel:
        if not q.is_cuda:
            raise ValueError("paged_decode_attention: use_kernel=True needs "
                             "CUDA tensors; the kernel has no CPU version "
                             "(use_kernel=None picks the plain one there)")
        out = K.paged_decode_attention(q[:, 0], k_pages, v_pages,
                                       block_tables, seq_lens, scale=scale,
                                       window=window)
        return out[:, None]
    out = paged_decode_attention_ref(q[:, 0], k_pages, v_pages, block_tables,
                                     seq_lens, window=window, scale=scale)
    return out[:, None]
