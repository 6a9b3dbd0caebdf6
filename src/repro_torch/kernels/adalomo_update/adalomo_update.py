"""The two hand-written Hopper kernels of the AdaLomo update, their wrappers
and their plain PyTorch versions.

Replace the TPU kernels of ``repro.kernels.adalomo_update.adalomo_update``:

  K1 ``adalomo_stats``  (``stats_pallas`` / ``_stats_kernel``) — one sweep of
     g: row and column sums of ``g² + eps_stat`` folded into r and c.
  K2 ``adalomo_update`` (``update_pallas`` / ``_update_kernel``) — the
     grouped-normalized update written into θ in place, u never stored.

Sources: ``csrc/adalomo_stats.cu``, ``csrc/adalomo_update.cu`` (CUDA C++ for
sm_90a, plain C interface, built at first use by ``kernels/build.py``).

Both are bound by bytes, not operations: a few flops per element against
2-4 bytes per element and pass.  The function must move g once, θ twice (read
and write) and O(m+n) state; this first design reads g three times and θ
twice (K1, then K2's partial-sums pass and apply pass), because Σr' is needed
before u and Σu² before the write.  Hopper's blocks run in no order, so the
TPU kernels' accumulation across a sequential grid becomes per-block partial
sums added in block order by a following launch; edges are bounds checks, not
padding.  No float atomics: the same inputs give bit-identical outputs.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.  ``adalomo_stats.launches`` / ``adalomo_update.launches``
count the kernel launches of each wrapper.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

Tensor = torch.Tensor

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "adalomo_stats.cu", _CSRC / "adalomo_update.cu")
LIB_NAME = "adalomo_update"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    if getattr(lib, "_adalomo_bound", False):
        return lib
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adalomo_rows_per_block.argtypes = []
    lib.adalomo_rows_per_block.restype = ci
    lib.adalomo_stats_launch.argtypes = [vp, ci, vp, vp, vp, vp, cf, ci, ci,
                                         ci, vp]
    lib.adalomo_stats_launch.restype = ci
    lib.adalomo_update_launch.argtypes = [vp, ci, vp, ci, vp, vp, vp, vp, cf,
                                          cf, ci, ci, ci, ci, vp]
    lib.adalomo_update_launch.restype = ci
    lib._adalomo_bound = True
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


def _geometry(x: Tensor) -> tuple:
    if x.ndim < 2:
        raise ValueError(f"expected [..., m, n], got shape {tuple(x.shape)}")
    lead = tuple(x.shape[:-2])
    L = 1
    for d in lead:
        L *= d
    m, n = x.shape[-2], x.shape[-1]
    if L < 1 or m < 1 or n < 1 or L > 65535:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    return lead, L, m, n


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# --------------------------------------------------------------------------
# K1: factored second-moment statistics
# --------------------------------------------------------------------------

def adalomo_stats_ref(grad: Tensor, r: Tensor, c: Tensor, beta, *,
                      eps_stat: float) -> tuple:
    """Plain PyTorch version of K1.  Returns new ``(r', c')``."""
    g2 = torch.square(grad.to(torch.float32)) + eps_stat
    return (beta * r + (1.0 - beta) * g2.sum(dim=-1),
            beta * c + (1.0 - beta) * g2.sum(dim=-2))


def adalomo_stats(grad: Tensor, r: Tensor, c: Tensor, beta: Tensor, *,
                  eps_stat: float) -> tuple:
    """r ← βr + (1−β)·rowsum(g²+eps_stat), c likewise, **in place**.

    grad ``[..., m, n]`` float32 or bfloat16; r ``[..., m]``, c ``[..., n]``
    float32; ``beta`` a float32 tensor of one element on grad's device.
    Returns ``(r, c)``.
    """
    if not grad.is_cuda:
        nr, nc = adalomo_stats_ref(grad, r, c, beta, eps_stat=eps_stat)
        r.copy_(nr)
        c.copy_(nc)
        return r, c
    lead, L, m, n = _geometry(grad)
    dev = grad.device
    _check("grad", grad, grad.shape, tuple(_DTYPE_CODE), dev)
    _check("r", r, lead + (m,), (torch.float32,), dev)
    _check("c", c, lead + (n,), (torch.float32,), dev)
    _check("beta", beta, beta.shape, (torch.float32,), dev)
    if beta.numel() != 1:
        raise ValueError("beta: expected one element")
    lib = _library()
    nrb = -(-m // lib.adalomo_rows_per_block())
    col_part = torch.empty((L, nrb, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.adalomo_stats_launch(
            grad.data_ptr(), _DTYPE_CODE[grad.dtype], r.data_ptr(),
            c.data_ptr(), col_part.data_ptr(), beta.data_ptr(),
            float(eps_stat), L, m, n,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "adalomo_stats")
    adalomo_stats.launches += 1
    return r, c


adalomo_stats.launches = 0


# --------------------------------------------------------------------------
# K2: grouped-normalized update, applied in place
# --------------------------------------------------------------------------

def adalomo_update_ref(param: Tensor, grad: Tensor, r: Tensor, c: Tensor,
                       scal: Tensor, *, eps_div: float, eps_rms: float,
                       literal: bool) -> Tensor:
    """Plain PyTorch version of K2.  Returns the new parameter."""
    inv, lr, decay, clip = (scal[..., i, None, None] for i in range(4))
    g = grad.to(torch.float32)
    p = param.to(torch.float32)
    v_hat = (r[..., :, None] * c[..., None, :]) * inv
    u = g / (v_hat + eps_div) if literal else g / (torch.sqrt(v_hat)
                                                   + eps_div)
    rms_u = torch.sqrt(torch.mean(u * u, dim=(-2, -1), keepdim=True))
    rms_p = torch.sqrt(torch.mean(p * p, dim=(-2, -1), keepdim=True))
    scale = torch.clamp_min(rms_p, eps_rms) / torch.clamp_min(rms_u / clip,
                                                              1.0)
    return (p * decay - lr * u * scale).to(param.dtype)


def adalomo_update(param: Tensor, grad: Tensor, r: Tensor, c: Tensor,
                   scal: Tensor, *, eps_div: float, eps_rms: float,
                   literal: bool) -> Tensor:
    """θ ← θ·decay − lr·u·max(eps_rms,RMS θ)/max(1,RMS u/clip), **in place**.

    param, grad ``[..., m, n]`` float32 or bfloat16; r ``[..., m]``,
    c ``[..., n]`` float32 (already updated by :func:`adalomo_stats`);
    scal ``[..., 4]`` float32 = (inv_denom_corr, lr, decay, clip) per slice.
    Returns ``param``.
    """
    if not param.is_cuda:
        param.copy_(adalomo_update_ref(param, grad, r, c, scal,
                                       eps_div=eps_div, eps_rms=eps_rms,
                                       literal=literal))
        return param
    lead, L, m, n = _geometry(param)
    dev = param.device
    _check("param", param, param.shape, tuple(_DTYPE_CODE), dev)
    _check("grad", grad, param.shape, tuple(_DTYPE_CODE), dev)
    _check("r", r, lead + (m,), (torch.float32,), dev)
    _check("c", c, lead + (n,), (torch.float32,), dev)
    _check("scal", scal, lead + (4,), (torch.float32,), dev)
    lib = _library()
    nrb = -(-m // lib.adalomo_rows_per_block())
    partials = torch.empty((L, nrb, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.adalomo_update_launch(
            param.data_ptr(), _DTYPE_CODE[param.dtype], grad.data_ptr(),
            _DTYPE_CODE[grad.dtype], r.data_ptr(), c.data_ptr(),
            scal.data_ptr(), partials.data_ptr(), float(eps_div),
            float(eps_rms), int(bool(literal)), L, m, n,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "adalomo_update")
    adalomo_update.launches += 1
    return param


adalomo_update.launches = 0
