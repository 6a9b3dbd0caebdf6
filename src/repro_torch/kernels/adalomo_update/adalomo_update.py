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
and write) and O(m+n) state; the design reads g three times and θ twice (K1,
then K2's partial-sums pass and apply pass), because Σr' is needed before u
and Σu² before the write.  Hopper's blocks run in no order, so the TPU
kernels' accumulation across a sequential grid becomes per-block partial sums
added in a fixed order: K1 in its own launch, where the last block of each
row band and of each column strip (integer tickets, :func:`stats_tiling`)
folds that band's or strip's partials; K2 by its second launch.  Both read
16 bytes a thread and load over grids of small tiles; edges are bounds
checks, not padding.  K1's tiles are R × 256 (R from the shapes), a warp
reading a tile row; K2's are 16 × 128 (:func:`update_tiling`), and its
apply pass walks them in reverse so the re-read finds the partials pass's
last tiles in L2.  No float atomics: the same inputs give bit-identical
outputs.

Sharded entries, for a ZeRO-3 row, column or 2-D block shard of a tensor
whose statistics are summed over the ranks between launches:
:func:`adalomo_stats_partial` (K1 with the sharded axes' sums left raw),
:func:`adalomo_stats_fold` (the β-EMA fold of the summed vector),
:func:`adalomo_update_partials` (K2's partials launch and their sum, a
shard's ``(Σu², Σθ²)``) and :func:`adalomo_update_apply` (K2's apply launch
from the global sums and the global element count).

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.  A meta tensor takes the CUDA tensor's path up to the launch
and records the launch instead (``kernels/dry.py``, the dry run).  Each
wrapper's ``launches`` attribute counts its kernel launches (one a call).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import dry
from repro_torch.kernels.build import load_library
from repro_torch.kernels.tickets import ticket_counters

Tensor = torch.Tensor

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "adalomo_stats.cu", _CSRC / "adalomo_update.cu")
LIB_NAME = "adalomo_update"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

SMS = 132

# K1's tile: STATS_COLS columns (kStatsCols of csrc/adalomo_stats.cu, checked
# when the library is bound) by one of STATS_ROWS rows, the shortest that
# leaves at most STATS_MAX_BANDS row bands (a column fold adds one partial a
# band).
STATS_COLS = 256
STATS_ROWS = (64, 128, 256)
STATS_MAX_BANDS = 128

# K2's tile (kTileRows x kTileCols of csrc/adalomo_update.cu, checked when the
# library is bound) and its grid: about BLOCKS_PER_SM blocks on each of the
# H100's 132 SMs.
TILE_ROWS, TILE_COLS = 16, 128
BLOCKS_PER_SM = 4


class StatsTiling(NamedTuple):
    """How K1 cuts each [m, n] slice: ``bands`` row bands of ``rows`` rows by
    ``strips`` column strips of STATS_COLS, one block per (strip, band,
    slice).  Partials and tickets are laid out as the kernel's C interface
    says."""
    rows: int
    bands: int
    strips: int

    def blocks(self, L: int) -> int:
        return L * self.bands * self.strips

    def tile(self, band: int, strip: int) -> tuple:
        """(first row, first column) of the block (strip, band)."""
        return band * self.rows, strip * STATS_COLS

    def row_partials_shape(self, L: int) -> tuple:
        return (L, self.strips, self.bands * self.rows)

    def col_partials_shape(self, L: int) -> tuple:
        return (L, self.bands, self.strips * STATS_COLS)

    def tickets(self, L: int) -> int:
        return L * (self.bands + self.strips)


def stats_tiling(L: int, m: int, n: int) -> StatsTiling:
    """K1's tiling of ``L`` slices of [m, n]: the shortest tile of
    STATS_ROWS that leaves at most STATS_MAX_BANDS row bands, so short
    matrices get many small blocks and tall ones no long column folds.
    Depends on the shapes only."""
    rows = next((r for r in STATS_ROWS if -(-m // r) <= STATS_MAX_BANDS),
                STATS_ROWS[-1])
    return StatsTiling(rows, -(-m // rows), -(-n // STATS_COLS))


class UpdateTiling(NamedTuple):
    """How K2 cuts each [m, n] slice: tiles of TILE_ROWS x TILE_COLS in
    row-major order, ``blocks`` blocks a slice, block b taking tiles b,
    b + blocks, ... (the apply launch walks them in reverse)."""
    row_tiles: int
    col_tiles: int
    blocks: int

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles

    def tile(self, t: int) -> tuple:
        """(first row, first column) of tile t."""
        return (t // self.col_tiles * TILE_ROWS,
                t % self.col_tiles * TILE_COLS)

    def walk(self, b: int) -> range:
        """The tiles of block b, in the partials launch's order."""
        return range(b, self.tiles, self.blocks)

    def partials_shape(self, L: int) -> tuple:
        return (L, self.blocks, 2)


def update_tiling(L: int, m: int, n: int) -> UpdateTiling:
    """K2's tiling of ``L`` slices of [m, n]: as many blocks as tiles, up to
    BLOCKS_PER_SM * SMS over all slices.  Depends on the shapes only."""
    row_tiles, col_tiles = -(-m // TILE_ROWS), -(-n // TILE_COLS)
    blocks = max(1, min(row_tiles * col_tiles,
                        -(-SMS * BLOCKS_PER_SM // L)))
    return UpdateTiling(row_tiles, col_tiles, blocks)


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    if getattr(lib, "_adalomo_bound", False):
        return lib
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.adalomo_stats_launch.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, cf,
                                         ci, ci, ci, ci, vp]
    lib.adalomo_stats_launch.restype = ci
    lib.adalomo_update_launch.argtypes = [vp, ci, vp, ci, vp, vp, vp, vp, cf,
                                          cf, ci, ci, ci, ci, ci, vp]
    lib.adalomo_update_launch.restype = ci
    lib.adalomo_stats_partial_launch.argtypes = [vp, ci, vp, vp, vp, vp, vp,
                                                 vp, cf, ci, ci, ci, ci, vp,
                                                 ci, ci, vp]
    lib.adalomo_stats_partial_launch.restype = ci
    lib.adalomo_stats_fold_launch.argtypes = [vp, vp, ci, ci, ci, vp, vp]
    lib.adalomo_stats_fold_launch.restype = ci
    lib.adalomo_update_partials_launch.argtypes = [vp, ci, vp, ci, vp, vp, vp,
                                                   vp, vp, cf, cf, ci, ci, ci,
                                                   ci, ci, vp]
    lib.adalomo_update_partials_launch.restype = ci
    lib.adalomo_update_apply_launch.argtypes = [vp, ci, vp, ci, vp, vp, vp,
                                                vp, ctypes.c_longlong, cf, cf,
                                                ci, ci, ci, ci, ci, vp]
    lib.adalomo_update_apply_launch.restype = ci
    for fn in (lib.adalomo_update_tile_rows, lib.adalomo_update_tile_cols,
               lib.adalomo_stats_tile_cols):
        fn.argtypes, fn.restype = [], ci
    tile = (lib.adalomo_update_tile_rows(), lib.adalomo_update_tile_cols())
    if tile != (TILE_ROWS, TILE_COLS):
        raise RuntimeError(f"adalomo_update: the kernel's tile {tile} is not "
                           f"the wrapper's {(TILE_ROWS, TILE_COLS)}")
    if lib.adalomo_stats_tile_cols() != STATS_COLS:
        raise RuntimeError(f"adalomo_stats: the kernel's tile of "
                           f"{lib.adalomo_stats_tile_cols()} columns is not "
                           f"the wrapper's {STATS_COLS}")
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
    Returns ``(r, c)``.  One launch over the tiles of :func:`stats_tiling`;
    its partials are made here and its tickets come from
    ``ticket_counters``, so launches on two streams at once must not
    overlap.
    """
    if dry.plain(grad):
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
    tiling = stats_tiling(L, m, n)
    row_part = torch.empty(tiling.row_partials_shape(L), dtype=torch.float32,
                           device=dev)
    col_part = torch.empty(tiling.col_partials_shape(L), dtype=torch.float32,
                           device=dev)
    tickets = ticket_counters("adalomo_stats", dev, tiling.tickets(L))
    if dry.is_dry(grad):
        dry.adalomo("adalomo_stats", grad, grad)
    else:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.adalomo_stats_launch(
                grad.data_ptr(), _DTYPE_CODE[grad.dtype], r.data_ptr(),
                c.data_ptr(), row_part.data_ptr(), col_part.data_ptr(),
                tickets.data_ptr(), beta.data_ptr(), float(eps_stat), L, m,
                n, tiling.rows, torch.cuda.current_stream(dev).cuda_stream)
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
    if dry.plain(param):
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
    tiling = update_tiling(L, m, n)
    partials = torch.empty(tiling.partials_shape(L), dtype=torch.float32,
                           device=dev)
    if dry.is_dry(param):
        dry.adalomo("adalomo_update", param, grad)
    else:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.adalomo_update_launch(
                param.data_ptr(), _DTYPE_CODE[param.dtype], grad.data_ptr(),
                _DTYPE_CODE[grad.dtype], r.data_ptr(), c.data_ptr(),
                scal.data_ptr(), partials.data_ptr(), float(eps_div),
                float(eps_rms), int(bool(literal)), L, m, n, tiling.blocks,
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "adalomo_update")
    adalomo_update.launches += 1
    return param


adalomo_update.launches = 0


# --------------------------------------------------------------------------
# Sharded entries: a ZeRO-3 shard of [..., m, n], rows (axis -2) or columns
# (axis -1) split over the ranks
# --------------------------------------------------------------------------

def _axis(axis: int) -> int:
    if axis not in (-2, -1, BOTH):
        raise ValueError(f"axis: expected -2 (a row shard), -1 (a column "
                         f"shard) or {BOTH} (a block split both ways), got "
                         f"{axis}")
    return axis


# ``axis`` of a block split by rows and by columns (the model axis' 2-D
# ZeRO-3 shard; ``sharding.zero.TensorShard.axis``)
BOTH = 0


def _both_buffer(lead: tuple, m: int, n: int, device) -> tuple:
    """K1 mode 3's output: one fp32 buffer, the raw row sums ``[..., m]``
    first and the raw column sums ``[..., n + 1]`` after them (the last
    column left for the caller's Σr': 0 on the CPU, not written on the
    card), both views contiguous."""
    L = 1
    for d in lead:
        L *= d
    make = (torch.empty if torch.device(device).type in ("cuda", "meta")
            else torch.zeros)
    buf = make(L * (m + n + 1), dtype=torch.float32, device=device)
    return (buf[:L * m].view(lead + (m,)),
            buf[L * m:].view(lead + (n + 1,)))


def adalomo_stats_partial_ref(grad: Tensor, r: Tensor, c: Tensor, beta, *,
                              eps_stat: float, axis: int) -> tuple:
    """Plain PyTorch version of :func:`adalomo_stats_partial`.  Returns
    ``(r', c', raw)``, mutating nothing."""
    g2 = torch.square(grad.to(torch.float32)) + eps_stat
    if _axis(axis) == BOTH:
        rows, cols = _both_buffer(tuple(grad.shape[:-2]), grad.shape[-2],
                                  grad.shape[-1], grad.device)
        rows.copy_(g2.sum(dim=-1))
        cols[..., :-1] = g2.sum(dim=-2)
        return r, c, (rows, cols)
    if axis == -2:
        r = beta * r + (1.0 - beta) * g2.sum(dim=-1)
        return r, c, torch.cat([g2.sum(dim=-2), r.sum(dim=-1)[..., None]],
                               dim=-1)
    c = beta * c + (1.0 - beta) * g2.sum(dim=-2)
    return r, c, g2.sum(dim=-1)


def adalomo_stats_partial(grad: Tensor, r: Tensor, c: Tensor, beta: Tensor,
                          *, eps_stat: float, axis: int):
    """K1 on one rank's shard ``grad [..., m, n]`` of a tensor.

    ``axis=-2``, a row shard: r (``[..., m]``, this shard's rows) is folded
    in place as by :func:`adalomo_stats`; c is left as it is, and the result
    ``[..., n + 1]`` holds the shard's raw column sums of ``g²+eps_stat``
    and, last, the shard's Σr'.  ``axis=-1``, a column shard: c is folded
    in place, r left, and the result ``[..., m]`` holds the raw row sums.
    Summed over the ranks, the result is what the whole tensor's fold needs:
    :func:`adalomo_stats_fold` then folds it into the other state vector.
    ``axis=BOTH``, a block split by rows and columns (kernel mode 3): r and
    c are both left, and the result is ``(rows [..., m], cols [..., n +
    1])``, views of one buffer: the raw row sums, and the raw column sums
    with a last column for the caller to fill with Σr' (summed over the
    column blocks, rows fold r; then, with Σr' written, cols summed over
    the row blocks fold c).
    """
    if dry.plain(grad):
        nr, nc, raw = adalomo_stats_partial_ref(grad, r, c, beta,
                                                eps_stat=eps_stat, axis=axis)
        r.copy_(nr)
        c.copy_(nc)
        return raw
    lead, L, m, n = _geometry(grad)
    dev = grad.device
    _check("grad", grad, grad.shape, tuple(_DTYPE_CODE), dev)
    _check("r", r, lead + (m,), (torch.float32,), dev)
    _check("c", c, lead + (n,), (torch.float32,), dev)
    _check("beta", beta, beta.shape, (torch.float32,), dev)
    if beta.numel() != 1:
        raise ValueError("beta: expected one element")
    mode = {-2: 1, -1: 2, BOTH: 3}[_axis(axis)]
    if mode == 3:
        raw = _both_buffer(lead, m, n, dev)
        ptr, width = raw[0].data_ptr(), n + 1
    else:
        width = n + 1 if mode == 1 else m
        raw = torch.empty(lead + (width,), dtype=torch.float32, device=dev)
        ptr = raw.data_ptr()
    tiling = stats_tiling(L, m, n)
    row_part = torch.empty(tiling.row_partials_shape(L), dtype=torch.float32,
                           device=dev)
    col_part = torch.empty(tiling.col_partials_shape(L), dtype=torch.float32,
                           device=dev)
    tickets = ticket_counters("adalomo_stats", dev, tiling.tickets(L))
    if dry.is_dry(grad):
        dry.adalomo("adalomo_stats_partial", grad, grad,
                    extra=4 * L * (m + n + 1 if mode == 3 else width))
    else:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.adalomo_stats_partial_launch(
                grad.data_ptr(), _DTYPE_CODE[grad.dtype], r.data_ptr(),
                c.data_ptr(), row_part.data_ptr(), col_part.data_ptr(),
                tickets.data_ptr(), beta.data_ptr(), float(eps_stat), L, m,
                n, tiling.rows, ptr, mode, width,
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "adalomo_stats_partial")
    adalomo_stats_partial.launches += 1
    adalomo_stats_partial.both_launches += mode == 3
    if mode == 1:
        # the shard's sum of its folded r, packed beside the column sums so
        # that one sum over the ranks carries both
        raw[..., n] = torch.sum(r, dim=-1)
    return raw


adalomo_stats_partial.launches = 0
adalomo_stats_partial.both_launches = 0     # of them, mode 3's (axis BOTH)


def adalomo_stats_fold_ref(dst: Tensor, src: Tensor, beta) -> Tensor:
    """Plain PyTorch version of :func:`adalomo_stats_fold`: the new dst."""
    return beta * dst + (1.0 - beta) * src[..., :dst.shape[-1]]


def adalomo_stats_fold(dst: Tensor, src: Tensor, beta: Tensor) -> Tensor:
    """``dst ← β·dst + (1−β)·src[..., :k]`` **in place**, dst ``[..., k]``
    and src ``[..., ≥ k]`` float32 (statistics summed over the ranks, read
    from :func:`adalomo_stats_partial`'s buffer).  Returns ``dst``."""
    if dry.plain(dst):
        dst.copy_(adalomo_stats_fold_ref(dst, src, beta))
        return dst
    dev = dst.device
    lead, k = tuple(dst.shape[:-1]), dst.shape[-1]
    _check("dst", dst, dst.shape, (torch.float32,), dev)
    _check("src", src, lead + (src.shape[-1],), (torch.float32,), dev)
    _check("beta", beta, beta.shape, (torch.float32,), dev)
    if src.shape[-1] < k or beta.numel() != 1:
        raise ValueError(f"src {tuple(src.shape)} does not cover dst "
                         f"{tuple(dst.shape)}, or beta is not one element")
    L = max(1, math.prod(lead))
    if dry.is_dry(dst):
        dry.stats_fold(dst, src)
    else:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.adalomo_stats_fold_launch(
                dst.data_ptr(), src.data_ptr(), src.shape[-1], k, L,
                beta.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "adalomo_stats_fold")
    adalomo_stats_fold.launches += 1
    return dst


adalomo_stats_fold.launches = 0


def _direction(param, grad, r, c, scal, eps_div, literal):
    inv = scal[..., 0, None, None]
    v_hat = (r[..., :, None] * c[..., None, :]) * inv
    g = grad.to(torch.float32)
    return g / (v_hat + eps_div) if literal else g / (torch.sqrt(v_hat)
                                                      + eps_div)


def adalomo_update_partials_ref(param: Tensor, grad: Tensor, r: Tensor,
                                c: Tensor, scal: Tensor, *, eps_div: float,
                                eps_rms: float, literal: bool) -> Tensor:
    """Plain PyTorch version of :func:`adalomo_update_partials`."""
    del eps_rms
    u = _direction(param, grad, r, c, scal, eps_div, literal)
    p = param.to(torch.float32)
    return torch.stack([torch.sum(u * u, dim=(-2, -1)),
                        torch.sum(p * p, dim=(-2, -1))], dim=-1)


def adalomo_update_partials(param: Tensor, grad: Tensor, r: Tensor,
                            c: Tensor, scal: Tensor, *, eps_div: float,
                            eps_rms: float, literal: bool) -> Tensor:
    """K2's first half on a shard: ``[..., 2]`` float32 = (Σu², Σθ²) over
    each slice of the shard, added in a fixed block order; θ is not
    written.  Arguments as :func:`adalomo_update`'s."""
    if dry.plain(param):
        return adalomo_update_partials_ref(param, grad, r, c, scal,
                                           eps_div=eps_div, eps_rms=eps_rms,
                                           literal=literal)
    lead, L, m, n = _geometry(param)
    dev = param.device
    _check("param", param, param.shape, tuple(_DTYPE_CODE), dev)
    _check("grad", grad, param.shape, tuple(_DTYPE_CODE), dev)
    _check("r", r, lead + (m,), (torch.float32,), dev)
    _check("c", c, lead + (n,), (torch.float32,), dev)
    _check("scal", scal, lead + (4,), (torch.float32,), dev)
    tiling = update_tiling(L, m, n)
    partials = torch.empty(tiling.partials_shape(L), dtype=torch.float32,
                           device=dev)
    sums = torch.empty(lead + (2,), dtype=torch.float32, device=dev)
    if dry.is_dry(param):
        dry.adalomo("adalomo_update_partials", param, grad)
    else:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.adalomo_update_partials_launch(
                param.data_ptr(), _DTYPE_CODE[param.dtype], grad.data_ptr(),
                _DTYPE_CODE[grad.dtype], r.data_ptr(), c.data_ptr(),
                scal.data_ptr(), partials.data_ptr(), sums.data_ptr(),
                float(eps_div), float(eps_rms), int(bool(literal)), L, m, n,
                tiling.blocks, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "adalomo_update_partials")
    adalomo_update_partials.launches += 1
    return sums


adalomo_update_partials.launches = 0


def adalomo_update_apply_ref(param: Tensor, grad: Tensor, r: Tensor,
                             c: Tensor, scal: Tensor, sums: Tensor,
                             n_total: int, *, eps_div: float, eps_rms: float,
                             literal: bool) -> Tensor:
    """Plain PyTorch version of :func:`adalomo_update_apply`: the new
    parameter."""
    _, lr, decay, clip = (scal[..., i, None, None] for i in range(4))
    u = _direction(param, grad, r, c, scal, eps_div, literal)
    p = param.to(torch.float32)
    rms_u = torch.sqrt(sums[..., 0, None, None] / float(n_total))
    rms_p = torch.sqrt(sums[..., 1, None, None] / float(n_total))
    scale = torch.clamp_min(rms_p, eps_rms) / torch.clamp_min(rms_u / clip,
                                                              1.0)
    return (p * decay - lr * u * scale).to(param.dtype)


def adalomo_update_apply(param: Tensor, grad: Tensor, r: Tensor, c: Tensor,
                         scal: Tensor, sums: Tensor, n_total: int, *,
                         eps_div: float, eps_rms: float,
                         literal: bool) -> Tensor:
    """K2's second half on a shard, θ updated **in place**: RMS(u) and
    RMS(θ) from ``sums [..., 2]`` (the whole tensor's Σu², Σθ², summed over
    the ranks) divided by ``n_total``, the whole tensor's element count a
    slice — not the shard's.  Returns ``param``."""
    if dry.plain(param):
        param.copy_(adalomo_update_apply_ref(
            param, grad, r, c, scal, sums, n_total, eps_div=eps_div,
            eps_rms=eps_rms, literal=literal))
        return param
    lead, L, m, n = _geometry(param)
    dev = param.device
    _check("param", param, param.shape, tuple(_DTYPE_CODE), dev)
    _check("grad", grad, param.shape, tuple(_DTYPE_CODE), dev)
    _check("r", r, lead + (m,), (torch.float32,), dev)
    _check("c", c, lead + (n,), (torch.float32,), dev)
    _check("scal", scal, lead + (4,), (torch.float32,), dev)
    _check("sums", sums, lead + (2,), (torch.float32,), dev)
    if int(n_total) < m * n:
        raise ValueError(f"n_total {n_total} is less than the shard's "
                         f"{m} x {n} elements")
    tiling = update_tiling(L, m, n)
    if dry.is_dry(param):
        dry.adalomo("adalomo_update_apply", param, grad)
    else:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.adalomo_update_apply_launch(
                param.data_ptr(), _DTYPE_CODE[param.dtype], grad.data_ptr(),
                _DTYPE_CODE[grad.dtype], r.data_ptr(), c.data_ptr(),
                scal.data_ptr(), sums.data_ptr(), int(n_total),
                float(eps_div), float(eps_rms), int(bool(literal)), L, m, n,
                tiling.blocks, torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "adalomo_update_apply")
    adalomo_update_apply.launches += 1
    return param


adalomo_update_apply.launches = 0
