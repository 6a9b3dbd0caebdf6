"""Kernel roofline counter registry: analytic FLOPs and minimum bytes of
each kernel at a shape.  Counterpart of ``repro.telemetry.kernels`` (a
copy: the port imports nothing of the JAX package).

Every kernel gets a counter function that derives its arithmetic work and
minimum memory traffic *from the shape alone* — the numerator of
achieved-vs-peak roofline fractions, and the denominator of arithmetic
intensity.  The counts model the algorithm the kernel implements (what
any implementation must do), not one backend's instruction stream, so
they are the same for the plain PyTorch version and the CUDA kernel.

The counts are the reference's, number for number.  They are not the
bounds ``chip_smoke.py`` prints beside each kernel's time: that script
bounds K1 and K2 apart, where ``adalomo_update`` counts them as one
kernel, counts K3's traffic by live rows where ``paged_decode_attention``
counts whole pages, and has a bound for K4, which has no counter here
(``PERF.md`` §6 sets the two side by side).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class KernelCounters:
    """Analytic cost of one kernel launch at one shape."""

    kernel: str
    flops: float           # arithmetic operations (adds + muls + divs...)
    bytes: float           # minimum HBM traffic (reads + writes)
    shape: dict            # the shape key these counts were derived from
    note: str = ""

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOPs/byte — the roofline x-axis."""
        return self.flops / max(self.bytes, 1.0)

    def record(self, **extra) -> dict:
        """As a schema-v1 ``kernel`` stream record."""
        return {"kernel": self.kernel, "flops": self.flops,
                "bytes": self.bytes, "intensity": self.intensity,
                "shape": dict(self.shape), **extra}


# --------------------------------------------------------------------------
# adalomo_update — fused factored-moment + grouped-norm update, one m×n
# tensor (kernels/adalomo_update: K1's statistics and K2's update, one
# [L, m, n] stack ``stacks`` matrices)
# --------------------------------------------------------------------------

def adalomo_update_counters(m: int, n: int, *, stacks: int = 1,
                            itemsize: int = 4) -> KernelCounters:
    """Per-element work (both passes over the tile grid):

    stats pass — g² (1), accumulate into the r row-sum and c col-sum
    marginals (2); EMA fold of r/c is O(m+n).  update pass — v̂ = r·c·
    inv_denom (2), û = g/(√v̂+ε) (3, incl. the rsqrt), û² accumulation for
    the grouped RMS norm (2), trust-ratio scale + clip (2), θ ← decay·θ −
    lr·û (3) — 13 FLOPs/element + 6(m+n) for the marginal EMAs and the
    final r/c writes.

    Traffic: the stats pass reads g; the update pass reads θ and g and
    writes θ (4 m·n elements at ``itemsize``); r and c are read+written
    in f32 by both passes (≈ 4(m+n) f32 round-trips).
    """
    e = m * n
    flops = stacks * (13.0 * e + 6.0 * (m + n))
    bytes_ = stacks * (4.0 * e * itemsize + 4.0 * (m + n) * 4)
    return KernelCounters(
        kernel="adalomo_update", flops=flops, bytes=bytes_,
        shape={"m": m, "n": n, "stacks": stacks, "itemsize": itemsize},
        note="fused factored-moment + grouped-norm update, 2 grid passes")


# --------------------------------------------------------------------------
# paged_decode_attention — one decode step over the paged KV pool
# (kernels/decode_attention; q [B, H, dh] against block-tabled pages)
# --------------------------------------------------------------------------

def paged_decode_attention_counters(batch: int, q_heads: int, kv_heads: int,
                                    head_dim: int, seq_len: int, *,
                                    page_size: int = 16,
                                    pages_per_seq: int = 0,
                                    itemsize: int = 4) -> KernelCounters:
    """Per (batch row × q head): q·K over L cached tokens (2·L·dh), a
    5-op/token streaming softmax (exp, max/sum folds, scale), and the
    attention-weighted V sum (2·L·dh) — ``4·B·H·L·dh + 5·B·H·L`` FLOPs.

    Traffic is *page-granular*: the kernel streams whole K/V pages
    through on-chip memory, so each sequence moves ``ceil(L / page_size)`` pages —
    or the full fixed grid of ``pages_per_seq`` when given (the
    ``max_pages_per_seq`` cost the ROADMAP's ragged-grid item targets;
    pass it to model today's kernel, omit it for the ideal).  K/V pages
    are stored per kv head (GQA shares them across ``q_heads/kv_heads``
    query heads), plus the q read and the output write.
    """
    L = seq_len
    flops = batch * q_heads * (4.0 * L * head_dim + 5.0 * L)
    touched = pages_per_seq or math.ceil(L / page_size)
    kv_bytes = (batch * touched * page_size * kv_heads * head_dim
                * itemsize * 2)                       # K and V
    qo_bytes = 2 * batch * q_heads * head_dim * itemsize
    return KernelCounters(
        kernel="paged_decode_attention", flops=flops,
        bytes=float(kv_bytes + qo_bytes),
        shape={"batch": batch, "q_heads": q_heads, "kv_heads": kv_heads,
               "head_dim": head_dim, "seq_len": seq_len,
               "page_size": page_size, "pages_per_seq": pages_per_seq,
               "itemsize": itemsize},
        note="page-granular KV streaming; GQA shares pages across q heads")


REGISTRY: Dict[str, Callable[..., KernelCounters]] = {
    "adalomo_update": adalomo_update_counters,
    "paged_decode_attention": paged_decode_attention_counters,
}


def counters_for(kernel: str, **shape) -> KernelCounters:
    """Look up + evaluate a registered counter function."""
    if kernel not in REGISTRY:
        raise KeyError(f"no roofline counters registered for {kernel!r}; "
                       f"known: {sorted(REGISTRY)}")
    return REGISTRY[kernel](**shape)


def zoo_cases() -> list:
    """Analytic roofline rows at production config-zoo scale
    (``configs/shapes.py`` decode cells on a dense-7B-ish head layout,
    and the matching train-step update shapes) — no timing, pure model;
    the scale the ROADMAP kernel-speed program optimizes for."""
    from repro_torch.configs.shapes import SHAPES
    cases = []
    for cell in ("decode_32k", "long_500k"):
        s = SHAPES[cell]
        cases.append(("paged_decode_attention",
                      {"batch": s.global_batch, "q_heads": 32,
                       "kv_heads": 8, "head_dim": 128,
                       "seq_len": s.seq_len, "page_size": 16},
                      cell))
    # train_4k's per-tensor update: a d_model x d_ff projection (4096 wide)
    cases.append(("adalomo_update",
                  {"m": 4096, "n": 11008}, "train_4k"))
    return cases
