"""The hand-written Hopper decode-attention kernels, their wrappers and their
plain PyTorch versions.

Replace the two TPU kernels of
``repro.kernels.decode_attention.decode_attention``, both one-token GQA
flash-decoding with an online softmax in fp32 and an optional sliding
window:

* K3 ``paged_decode_attention`` (``paged_decode_attention_pallas`` /
  ``_paged_decode_kernel``) over a shared page pool, for ``PagedEngine``;
* K4 ``decode_attention`` (``decode_attention_pallas`` / ``_decode_kernel``)
  over a contiguous ring cache with positions shared by the batch, for the
  legacy ``Engine``; its partial entry ``decode_attention_partial`` over one
  rank's block of a ring split over ranks (``serve/sharded.py``), returning
  the fp32 output and each head's log-sum-exp for a merge over the ranks.

Sources: ``csrc/paged_decode_attention.cu`` and ``csrc/decode_attention.cu``
over the warp loop of ``csrc/decode_mma.cuh`` (bf16) and the tile loop of
``csrc/decode_tiles.cuh`` (fp32) (CUDA C++ for sm_90a, plain C interface,
one library built at first use by ``kernels/build.py``, one ``nvcc`` per
source).  Bound by bytes: the valid K/V rows must be read once, and only they
are read.  Both kernels split each (sequence, KV head) into runs of slots
(K4: ``ring_split``; K3: ``paged_split``, each block cutting its own run of
the sequence's live tokens on the device, as ``paged_runs`` does), sized by
the blocks an SM the head dim's bf16 loop fits (``blocks_per_sm``), stream
them through shared memory with ``cp.async`` and (bf16) tensor-core
products, and the last run to finish combines the runs' states in a fixed
order (each run's weight taken once, then sums of FMAs), all in one launch;
K3's lanes load the page ids a step ahead.  Head dim 256 takes the wide
loop, all four warps of a block on each step.  No float atomics: the same
inputs give bit-identical outputs.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.  A meta tensor takes the CUDA tensor's path up to the launch
and records the launch instead (``kernels/dry.py``, the dry run).  Each
wrapper's ``.launches`` counts its kernel's launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import dry
from repro_torch.kernels.build import load_library
from repro_torch.kernels.tickets import ticket_counters
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, ring_decode_attention_partial_ref,
    ring_decode_attention_ref)

Tensor = torch.Tensor

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "paged_decode_attention.cu", _CSRC / "decode_attention.cu")
LIB_NAME = "decode_attention"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 24, 32, 64, 80, 120, 128, 160, 256)
_STEP = 16                  # slots a warp takes in one step
_RING_STEP = 64             # slots a K4 block's four warps take in one round
_SMS = 132                  # the H100's streaming multiprocessors
_AIM = 2                    # K3 and K4 aim at about two blocks on each SM
_SM_SMEM = 233_472          # shared memory an SM (228 KB), and
_BLOCK_RESERVE = 1_024      # what the runtime keeps of it a block
WIDE_HEAD_DIMS = (256,)     # the bf16 wide loop's (csrc/decode_mma.cuh)
GROUP_RUNS = 8              # runs a first-level combine takes (kGroupRuns)
# the most runs a (sequence, KV head) the wide loop's split makes (the
# kernels take up to GROUP_RUNS ** 2): past 32 its two-level combine costs
# more than the blocks it adds buy (chip_smoke.py --phases timing on an
# H100: 4 x 4096 at dh 256, 64 runs 0.0209-0.0210 ms, 32 runs 0.0194-0.0195)
WIDE_MAX_RUNS = 32
# the largest query group a KV head the kernels take (kMaxG of
# csrc/decode_tiles.cuh, read from the library on the card; the meta
# device's dry launches use this copy)
MAX_GROUP = 8


def bf16_smem_bytes(dh: int) -> int:
    """The dynamic shared memory a block of K3's and K4's bf16 loop takes
    at head dim ``dh`` (``bf16_smem_bytes`` of csrc/decode_mma.cuh): the wide
    loop's four stages of 16 K and 16 V rows, padded by 8 elements, its
    quarter scores and slot masks; the narrow loop's three stages a warp,
    rows rounded up to whole 16-wide k-steps."""
    if dh in WIDE_HEAD_DIMS:
        return 4 * 2 * _STEP * (dh + 8) * 2 + 2 * 4 * MAX_GROUP * 20 * 4 + 16
    return 4 * 3 * 2 * _STEP * (-(-dh // 16) * 16 + 8) * 2


def blocks_per_sm(dh: int) -> int:
    """The blocks an SM that K3 and K4 aim at, at head dim ``dh``: two, or
    one where the bf16 loop's shared memory lets only one sit on an SM
    (``chip_smoke.py`` holds it against the card's occupancy)."""
    fits = _SM_SMEM // (bf16_smem_bytes(dh) + _BLOCK_RESERVE)
    return max(1, min(_AIM, fits))


def _rounds_per_run(rounds: int, B: int, K: int, dh: int) -> int:
    """The rounds of ``_RING_STEP`` slots a run takes when each of B * K
    (sequence, KV head) pairs has ``rounds`` of them: near one wave of
    ``blocks_per_sm(dh)`` blocks on each SM, and at the wide loop's head dim
    no more than ``WIDE_MAX_RUNS`` runs a pair."""
    per_run = max(1, -(-rounds * B * K // (_SMS * blocks_per_sm(dh))))
    if dh in WIDE_HEAD_DIMS:
        per_run = max(per_run, -(-rounds // WIDE_MAX_RUNS))
    return per_run


def ring_split(B: int, K: int, W: int, dh: int) -> tuple:
    """(S, span): K4 splits the W slots into S runs of ``span`` slots (whole
    rounds of ``_RING_STEP``; ``_rounds_per_run``).  Depends on the shapes
    only."""
    rounds = -(-W // _RING_STEP)
    per_run = _rounds_per_run(rounds, B, K, dh)
    return -(-rounds // per_run), per_run * _RING_STEP


def run_groups(S: int, dh: int) -> int:
    """The group states of one (sequence, KV head) split into S runs
    (``run_groups`` of csrc/decode_mma.cuh): at the wide loop's head dim,
    past ``GROUP_RUNS`` runs, the runs are combined in groups of
    ``GROUP_RUNS`` first."""
    return (-(-S // GROUP_RUNS)
            if dh in WIDE_HEAD_DIMS and S > GROUP_RUNS else 0)


def state_floats(G: int, dh: int) -> int:
    """The floats of one run's state (``state_floats`` of
    csrc/decode_mma.cuh): ``G * (dh + 2)``, at the wide loop's head dim
    rounded up to whole 16-byte pieces."""
    if dh in WIDE_HEAD_DIMS:
        return -(-G * (dh + 2) // 4) * 4
    return G * (dh + 2)


def _workspace(B: int, K: int, S: int, G: int, dh: int, device,
               counters) -> tuple:
    """``(part, counters)`` of one launch: the fp32 run and group states,
    ``B * K * (S + run_groups(S, dh))`` of ``state_floats(G, dh)``, and
    the kernel's tickets (``counters``: ``ring_counters`` or
    ``paged_counters``), ``1 + run_groups(S, dh)`` a (sequence, KV head)."""
    NG = run_groups(S, dh)
    part = torch.empty(B * K * (S + NG) * state_floats(G, dh),
                       dtype=torch.float32, device=device)
    return part, counters(device, B * K * (1 + NG))


def ring_counters(device, n: int) -> Tensor:
    """K4's tickets on ``device``: at least ``n`` int32 zeros, allocated and
    zeroed once (each launch leaves them at 0)."""
    return ticket_counters("decode_attention", device, n)


def paged_split(B: int, K: int, P: int, ps: int, dh: int) -> int:
    """S: K3 splits each sequence's live tokens into S runs, with S from the
    shapes only (the table's P * ps slots in rounds of ``_RING_STEP``, cut
    as ``ring_split`` cuts a ring, so that the runs fill about one wave when
    the sequences fill their tables).  A shorter sequence gets the same S
    runs, each shorter."""
    rounds = -(-P * ps // _RING_STEP)
    return -(-rounds // _rounds_per_run(rounds, B, K, dh))


def paged_runs(n_all: int, window: Optional[int], cap: int, S: int) -> list:
    """The S runs ``[t_lo, t_hi)`` of K3's blocks for one sequence of
    ``n_all`` tokens in a table of ``cap`` slots, as the kernel's
    ``paged_run`` computes them on the device: the live range ``[lo, n)``,
    ``n = min(n_all, cap)``, ``lo = max(0, n_all - window)``, from lo rounded
    down to a multiple of 16, cut into S runs of whole 16-slot steps.  A run
    past the end is empty; the kernel attends to ``[max(t_lo, lo), t_hi)``."""
    n_all = max(n_all, 0)
    n = min(n_all, cap)
    lo = max(0, n_all - window) if window else 0
    if lo >= n:
        return [(0, 0)] * S
    a = lo // _STEP * _STEP
    steps = -(-(n - a) // _STEP)
    per = -(-steps // S)
    runs = []
    for run in range(S):
        t_lo = min(n, a + run * per * _STEP)
        runs.append((t_lo, min(n, t_lo + per * _STEP)))
    return runs


def paged_counters(device, n: int) -> Tensor:
    """K3's tickets on ``device``, its own (not K4's): at least ``n`` int32
    zeros, allocated and zeroed once (each launch leaves them at 0)."""
    return ticket_counters("paged_decode_attention", device, n)


def _library() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    if getattr(lib, "_pda_bound", False):
        return lib
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode_max_group.argtypes = []
    lib.paged_decode_max_group.restype = ci
    lib.paged_decode_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
        cf, ci, vp]
    lib.paged_decode_attention_launch.restype = ci
    lib.decode_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf,
        ci, vp]
    lib.decode_attention_launch.restype = ci
    lib.decode_attention_partial_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
        cf, ci, vp]
    lib.decode_attention_partial_launch.restype = ci
    for fn in (lib.decode_attention_block_step, lib.paged_decode_step):
        fn.argtypes, fn.restype = [], ci
    if lib.decode_attention_block_step() != _RING_STEP:
        raise RuntimeError("decode_attention: the kernel's round of "
                           f"{lib.decode_attention_block_step()} slots is "
                           f"not the wrapper's {_RING_STEP}")
    if lib.paged_decode_step() != _STEP:
        raise RuntimeError("paged_decode_attention: the kernel's step of "
                           f"{lib.paged_decode_step()} slots is not the "
                           f"wrapper's {_STEP}")
    lib.decode_attention_usage.argtypes = [ci, ci, ci, vp]
    lib.decode_attention_usage.restype = ci
    lib.paged_decode_attention_usage.argtypes = [ci, ci, vp]
    lib.paged_decode_attention_usage.restype = ci
    lib.decode_attention_group_runs.argtypes = []
    lib.decode_attention_group_runs.restype = ci
    if lib.decode_attention_group_runs() != GROUP_RUNS:
        raise RuntimeError("decode_attention: the kernel's groups of "
                           f"{lib.decode_attention_group_runs()} runs are "
                           f"not the wrapper's {GROUP_RUNS}")
    lib.decode_attention_bf16_smem.argtypes = [ci]
    lib.decode_attention_bf16_smem.restype = ci
    for dh in HEAD_DIMS:
        got = lib.decode_attention_bf16_smem(dh)
        if got != bf16_smem_bytes(dh):
            raise RuntimeError(
                f"decode_attention: the bf16 loop's {got} bytes of shared "
                f"memory at dh {dh} are not the wrapper's "
                f"{bf16_smem_bytes(dh)}")
    lib.max_group = lib.paged_decode_max_group()
    lib._pda_bound = True
    return lib


def kernel_usage(entry: str, dtype: torch.dtype, dh: int) -> dict:
    """What the card gives one kernel instance, read through the library:
    ``entry`` ``"paged"`` (K3), ``"ring"`` (K4) or ``"partial"`` (K4's
    partial entry) at ``dtype`` and head dim ``dh`` -> its blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), dynamic shared
    memory a block, registers and local memory a thread.  Needs the card."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    if entry == "paged":
        err = lib.paged_decode_attention_usage(_DTYPE_CODE[dtype], dh, out)
    else:
        err = lib.decode_attention_usage(int(entry == "partial"),
                                         _DTYPE_CODE[dtype], dh, out)
    if err != 0:
        raise RuntimeError(f"kernel_usage({entry}, {dtype}, {dh}): CUDA "
                           f"error {err}")
    return dict(zip(("blocks_per_sm", "smem_bytes", "registers",
                     "local_bytes"), out))


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
    like the dense oracle, gives mean(V) there).  One launch over the
    ``paged_split`` runs of each (sequence, KV head): the last run to
    finish combines the runs' states, kept in an fp32 workspace made here,
    in run order (tickets from ``paged_counters``), so launches on two
    streams at once must not overlap.
    """
    if dry.plain(q):
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
    max_group = MAX_GROUP if dry.is_dry(q) else _library().max_group
    if H % K or H // K > max_group:
        raise ValueError(f"{H} query heads over {K} KV heads: the kernel "
                         f"takes groups of 1..{max_group}")
    scale = scale if scale is not None else dh ** -0.5
    S = paged_split(B, K, P, ps, dh)
    part, counters = _workspace(B, K, S, H // K, dh, dev, paged_counters)
    out = torch.empty_like(q)
    if dry.is_dry(q):
        dry.paged(q, k_pages, block_tables)
        paged_decode_attention.launches += 1
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), part.data_ptr(),
            counters.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], B, H,
            K, dh, N, ps, P, S, float(scale), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: CUDA error {err} at "
                           "launch")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _ring_args(q: Tensor, k_cache: Tensor, v_cache: Tensor, kv_pos: Tensor,
               q_pos, scale) -> tuple:
    """K4's checks and launch decisions, shared by its two entries: ``(B,
    H, dh, K, W, S, span, scale, q_pos, part, counters)``, ``q_pos`` a 0-d
    int32 tensor on q's device (an int is uploaded once, without blocking
    the host), the runs of ``ring_split``, the fp32 workspace and the
    tickets."""
    B, H, dh = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    if not isinstance(q_pos, Tensor):
        q_pos = torch.tensor(int(q_pos), dtype=torch.int32)
        q_pos = (q_pos.to(dev) if dry.is_dry(q) else
                 q_pos.pin_memory().to(dev, non_blocking=True))
    _check("q", q, (B, H, dh), tuple(_DTYPE_CODE), dev)
    _check("k_cache", k_cache, (B, W, K, dh), (q.dtype,), dev)
    _check("v_cache", v_cache, (B, W, K, dh), (q.dtype,), dev)
    _check("kv_pos", kv_pos, (W,), (torch.int32,), dev)
    _check("q_pos", q_pos, (), (torch.int32,), dev)
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    max_group = MAX_GROUP if dry.is_dry(q) else _library().max_group
    if H % K or H // K > max_group:
        raise ValueError(f"{H} query heads over {K} KV heads: the kernel "
                         f"takes groups of 1..{max_group}")
    scale = scale if scale is not None else dh ** -0.5
    S, span = ring_split(B, K, W, dh)
    part, counters = _workspace(B, K, S, H // K, dh, dev, ring_counters)
    return (B, H, dh, K, W, S, span, scale, q_pos, part, counters)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     kv_pos: Tensor, q_pos, *, scale: Optional[float] = None,
                     window: Optional[int] = None) -> Tensor:
    """Flash-decoding over a ring cache whose slot positions the batch shares.

    q ``[B,H,dh]``; k_cache/v_cache ``[B,W,K,dh]``, all float32 or all
    bfloat16; kv_pos ``[W]`` int32 absolute position of each slot (-1 =
    empty); q_pos the query's position, a 0-d int32 tensor on q's device or
    a Python int (uploaded once, without blocking the host).  Slot t is
    attended to when ``0 <= kv_pos[t] <= q_pos`` and, with a window,
    ``q_pos - kv_pos[t] < window``.  Returns ``[B,H,dh]`` in q's dtype; a
    row with no valid slot gets 0 (the plain version gives mean(V) there).
    One launch over the slot runs of ``ring_split``: the last run of each
    (sequence, KV head) to finish combines the runs' states, kept in an fp32
    workspace made here, in run order (tickets from ``ring_counters``).  The
    tickets are per device: launches on two streams at once must not
    overlap.
    """
    if dry.plain(q):
        return ring_decode_attention_ref(q, k_cache, v_cache, kv_pos, q_pos,
                                         window=window, scale=scale)
    B, H, dh, K, W, S, span, scale, q_pos, part, counters = _ring_args(
        q, k_cache, v_cache, kv_pos, q_pos, scale)
    dev = q.device
    out = torch.empty_like(q)
    if dry.is_dry(q):
        dry.ring(q, k_cache, v_cache, kv_pos, q_pos)
        decode_attention.launches += 1
        return out
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_pos.data_ptr(), q_pos.data_ptr(), part.data_ptr(),
            counters.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], B, H,
            K, dh, W, S, span, float(scale), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention: CUDA error {err} at launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_partial(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                             kv_pos: Tensor, q_pos, *,
                             scale: Optional[float] = None,
                             window: Optional[int] = None) -> tuple:
    """K4 over one block of a ring's slots (a rank's block of a ring split
    over ranks): ``(o [B,H,dh], lse [B,H])``, both float32 — the attention
    over the block's valid slots, kept in fp32, and the log-sum-exp of each
    head's scaled scores over them; a head with no valid slot gets ``o = 0``
    and ``lse = -inf``.  Arguments, checks, runs and tickets as
    :func:`decode_attention` (``kv_pos [W]`` the block's slot positions).
    The blocks' pairs merge as ``sum_r e^(lse_r - M) o_r / sum_r e^(lse_r -
    M)``, ``M = max_r lse_r`` (``serve/sharded.py::combine_partials``)."""
    if dry.plain(q):
        return ring_decode_attention_partial_ref(q, k_cache, v_cache, kv_pos,
                                                 q_pos, window=window,
                                                 scale=scale)
    B, H, dh, K, W, S, span, scale, q_pos, part, counters = _ring_args(
        q, k_cache, v_cache, kv_pos, q_pos, scale)
    dev = q.device
    o = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    if dry.is_dry(q):
        dry.ring_partial(q, k_cache, v_cache, kv_pos, q_pos)
        decode_attention_partial.launches += 1
        return o, lse
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.decode_attention_partial_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_pos.data_ptr(), q_pos.data_ptr(), part.data_ptr(),
            counters.data_ptr(), o.data_ptr(), lse.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, K, dh, W, S, span, float(scale),
            int(window or 0), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_partial: CUDA error {err} at "
                           "launch")
    decode_attention_partial.launches += 1
    return o, lse


decode_attention_partial.launches = 0
