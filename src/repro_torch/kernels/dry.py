"""Kernel launches on the meta device: the dry run's record of what the card
would launch.

A wrapper given meta tensors takes the launch decisions a CUDA tensor takes
(the same checks, tilings and workspace allocations, on the meta device),
then calls :func:`launch` where it would call the library: one record, under
the kernel's name, with its shape and its FLOPs and bytes, and the wrapper's
``launches`` count goes up by one as on the card.  A CPU tensor keeps the
plain version and a CUDA tensor the kernel; neither records anything here.
A recorder called by the wrapper, not a ``torch.library.custom_op``: the
wrappers write into their arguments in place and branch on shapes in
Python, and the record is made once, where the launch would be, with no
op registered or dispatched for it.

Costs, from ``repro_torch.telemetry.kernels`` (the reference's counters):

  * K1 + K2 (``adalomo_update_counters(m, n, stacks=L)``, 13 FLOPs an
    element + 6(m + n) a slice, 4 m·n elements and 4(m + n) fp32 round
    trips of traffic) are split between the launches: K1
    (``adalomo_stats`` and the sharded ``adalomo_stats_partial``) takes
    the statistics pass, 3 FLOPs an element + 3(m + n), g read once and
    r, c read and written; K2 (``adalomo_update``, and
    ``adalomo_update_apply`` on a shard) the rest, 10 FLOPs an element +
    3(m + n), θ and g read, θ written, r, c read and written.  K1 + K2 is
    the counter.  A shard's K2 partials launch (``adalomo_update_partials``)
    reads θ, g, r and c and does the 10 FLOPs an element less θ's write's
    3; K1's partial entry adds the raw sums it writes, and the fold
    (``adalomo_stats_fold``) 3 FLOPs and three fp32 accesses an element of
    the vector it folds;
  * K3 (``paged_decode_attention_counters``) at the table's full grid of
    ``P`` pages a sequence: on the meta device no sequence length is
    known, so the count is the most the launch could need;
  * K4 has no counter there: its FLOPs are its two products,
    4·B·Hq·W·dh, and its bytes its operands plus its result; its partial
    entry (``decode_attention_partial``, a rank's block of W slots) the
    same over the block, its result the fp32 ``o`` and ``lse``.
"""
from __future__ import annotations

import torch

from repro_torch.telemetry.kernels import (adalomo_update_counters,
                                           paged_decode_attention_counters)

Tensor = torch.Tensor

# the records of the launches made while a trace is recording (a list), or
# None
SINK = None


def is_dry(t: Tensor) -> bool:
    """True for a tensor on the meta device."""
    return t.device.type == "meta"


def plain(t: Tensor) -> bool:
    """True where a wrapper takes its plain version: a tensor on neither
    the card nor the meta device."""
    return not (t.is_cuda or is_dry(t))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, Tensor))


def launch(kernel: str, shape: dict, flops: float, nbytes: float) -> None:
    """Record one launch of ``kernel`` (into :data:`SINK`, when set)."""
    if SINK is not None:
        SINK.append({"kernel": kernel, "shape": dict(shape),
                     "flops": float(flops), "bytes": float(nbytes)})


def _slices(x: Tensor) -> tuple:
    L = 1
    for d in x.shape[:-2]:
        L *= d
    return L, x.shape[-2], x.shape[-1]


def stats_cost(grad: Tensor) -> tuple:
    """K1's share of ``adalomo_update_counters``: ``(flops, bytes)``."""
    L, m, n = _slices(grad)
    e = m * n
    return (L * (3.0 * e + 3.0 * (m + n)),
            L * (1.0 * e * grad.element_size() + 8.0 * (m + n)))


def update_cost(param: Tensor, grad: Tensor) -> tuple:
    """K2's share: the counter less K1's."""
    L, m, n = _slices(param)
    whole = adalomo_update_counters(m, n, stacks=L,
                                    itemsize=param.element_size())
    f1, b1 = stats_cost(param)
    return whole.flops - f1, whole.bytes - b1


def adalomo(kernel: str, param: Tensor, grad: Tensor, *, extra: int = 0
            ) -> None:
    """Record a launch of one of K1's or K2's entries on ``param`` /
    ``grad`` ``[..., m, n]`` (``extra``: bytes of a raw-sums output)."""
    L, m, n = _slices(grad)
    shape = {"L": L, "m": m, "n": n, "dtype": str(grad.dtype)[6:]}
    if kernel in ("adalomo_stats", "adalomo_stats_partial"):
        f, b = stats_cost(grad)
    elif kernel in ("adalomo_update", "adalomo_update_apply"):
        f, b = update_cost(param, grad)
    elif kernel == "adalomo_update_partials":
        f, b = update_cost(param, grad)
        f -= L * 3.0 * m * n
        b -= L * 1.0 * m * n * param.element_size()
    else:
        raise KeyError(kernel)
    launch(kernel, shape, f, b + extra)


def stats_fold(dst: Tensor, src: Tensor) -> None:
    k = dst.shape[-1]
    L = max(1, dst.numel() // k)
    launch("adalomo_stats_fold", {"L": L, "k": k}, 3.0 * L * k,
           3.0 * 4 * L * k)


def paged(q: Tensor, k_pages: Tensor, block_tables: Tensor) -> None:
    B, H, dh = q.shape
    _, ps, K, _ = k_pages.shape
    P = block_tables.shape[1]
    c = paged_decode_attention_counters(B, H, K, dh, P * ps, page_size=ps,
                                        pages_per_seq=P,
                                        itemsize=q.element_size())
    launch("paged_decode_attention", c.shape, c.flops, c.bytes)


def ring(q: Tensor, k_cache: Tensor, *operands) -> None:
    """K4: 4·B·Hq·W·dh FLOPs; its operands and its result, in bytes."""
    B, H, dh = q.shape
    W = k_cache.shape[1]
    launch("decode_attention",
           {"B": B, "H": H, "K": k_cache.shape[2], "dh": dh, "W": W},
           4.0 * B * H * W * dh, _nbytes(q, k_cache, *operands) + _nbytes(q))


def ring_partial(q: Tensor, k_cache: Tensor, *operands) -> None:
    """K4's partial entry: as :func:`ring` over the block's slots, its
    result ``o [B,H,dh]`` and ``lse [B,H]`` in fp32."""
    B, H, dh = q.shape
    W = k_cache.shape[1]
    launch("decode_attention_partial",
           {"B": B, "H": H, "K": k_cache.shape[2], "dh": dh, "W": W},
           4.0 * B * H * W * dh,
           _nbytes(q, k_cache, *operands) + 4 * B * H * (dh + 1))
