"""The hand-written Hopper paged decode-attention kernel, its wrapper and its
plain PyTorch version.

Replaces the TPU kernel K3 of ``repro.kernels.decode_attention.decode_attention``:
``paged_decode_attention_pallas`` / ``_paged_decode_kernel`` — one-token GQA
flash-decoding over a shared page pool, online softmax in fp32, optional
sliding window.  (K4, ``decode_attention_pallas`` over a contiguous ring
cache, belongs to the legacy engine and is not ported yet.)

Source: ``csrc/paged_decode_attention.cu`` (CUDA C++ for sm_90a, plain C
interface, built at first use by ``kernels/build.py``).  Bound by bytes: the
live K/V rows must be read once; one block per (sequence, KV head) walks
only the tokens inside ``seq_lens`` (and the window), so the block table's
tail is never touched.  No float atomics: the same inputs give bit-identical
outputs.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.  ``paged_decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref

Tensor = torch.Tensor

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "paged_decode_attention.cu",)
LIB_NAME = "decode_attention"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    if getattr(lib, "_pda_bound", False):
        return lib
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode_max_group.argtypes = []
    lib.paged_decode_max_group.restype = ci
    lib.paged_decode_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, ci, vp]
    lib.paged_decode_attention_launch.restype = ci
    lib._pda_bound = True
    return lib


def _check(name: str, t: Tensor, shape: tuple, dtypes: tuple, device) -> None:
    if not isinstance(t, Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def paged_decode_attention(q: Tensor, k_pages: Tensor, v_pages: Tensor,
                           block_tables: Tensor, seq_lens: Tensor, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None) -> Tensor:
    """Paged flash-decoding: each sequence reads its own page list.

    q ``[B,H,dh]``; k_pages/v_pages ``[N,ps,K,dh]`` (the pool shared by all
    sequences), all float32 or all bfloat16; block_tables ``[B,P]`` int32
    page ids in logical order (entries past a sequence's last page are
    never read; an id outside ``[0, N)`` before it stops the kernel with a
    CUDA error); seq_lens ``[B]`` int32 token counts
    *including* the token written this step.  Returns ``[B,H,dh]`` in q's
    dtype.  A sequence with no valid token gets 0 (the plain version,
    like the dense oracle, gives mean(V) there).
    """
    if not q.is_cuda:
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          seq_lens, window=window,
                                          scale=scale)
    B, H, dh = q.shape
    N, ps, K, _ = k_pages.shape
    P = block_tables.shape[1] if block_tables.ndim == 2 else -1
    dev = q.device
    _check("q", q, (B, H, dh), tuple(_DTYPE_CODE), dev)
    _check("k_pages", k_pages, (N, ps, K, dh), (q.dtype,), dev)
    _check("v_pages", v_pages, (N, ps, K, dh), (q.dtype,), dev)
    _check("block_tables", block_tables, (B, P), (torch.int32,), dev)
    _check("seq_lens", seq_lens, (B,), (torch.int32,), dev)
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    lib = _library()
    if H % K or H // K > lib.paged_decode_max_group():
        raise ValueError(f"{H} query heads over {K} KV heads: the kernel "
                         f"takes groups of 1..{lib.paged_decode_max_group()}")
    scale = scale if scale is not None else dh ** -0.5
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, K, dh, N, ps, P, float(scale),
            int(window or 0), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA error {err} at "
                           "launch")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
