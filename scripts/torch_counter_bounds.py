"""The kernel roofline counters' bytes and operations
(``repro_torch.telemetry.kernels``, the JAX package's counts) beside the
ones ``chip_smoke.py`` divides by the card's rates for its ``bound_ms``,
at the shapes ``PERF.md`` §6 times: K1 + K2 on h2o-danube-1.8b's 170 bf16
matrices (one train step), and K3 at 8 sequences × 1024 cached tokens
(danube's 32 query and 8 KV heads, head dim 80, pages of 16, bf16, 24
launches a decode step).  Arithmetic only; runs on the CPU.

    PYTHONPATH=src python scripts/torch_counter_bounds.py

``chip_smoke.py``'s counts, restated here because that script stops on a
machine with no card: K1 reads g and reads and writes r and c, ``L·m·n·elt
+ 2·4L(m+n)`` bytes and 4 operations an element; K2 reads θ and g, writes
θ, reads r and c and its scalars, ``3·L·m·n·elt + 4L(m+n) + 16L`` bytes and
13 operations an element (``phase_kernels``'s ``time_shape``); K3 reads the
live K/V rows, q, the used block-table entries and the lengths and writes
the output, 4·dh + 4 operations a live token and query head
(``k3_bound_ms``).
"""
from __future__ import annotations

import math

from repro_torch.telemetry.kernels import (adalomo_update_counters,
                                           paged_decode_attention_counters)

DANUBE_MATRICES = {(2560, 2560): 48, (2560, 640): 48, (2560, 6912): 48,
                   (6912, 2560): 24, (32000, 2560): 1, (2560, 32000): 1}
K3_CASE = dict(batch=8, q_heads=32, kv_heads=8, head_dim=80, seq_len=1024,
               page_size=16)
K3_LAUNCHES = 24
ELT = 2                                   # bf16


def k1_k2_smoke(m: int, n: int, elt: int = ELT) -> tuple:
    """(bytes, operations) of K1 then K2 on one ``[m, n]`` matrix, as
    ``chip_smoke.py`` bounds them."""
    state = 4 * (m + n)
    nbytes = (m * n * elt + 2 * state) + (3 * m * n * elt + state + 16)
    return nbytes, (4 + 13) * m * n


def k3_smoke(batch, q_heads, kv_heads, head_dim, seq_len, page_size,
             elt: int = ELT) -> tuple:
    """(bytes, operations) of one K3 launch, as ``chip_smoke.py``'s
    ``k3_bound_ms`` counts them (every row live: no window cuts 1024)."""
    live = batch * seq_len
    nbytes = (live * kv_heads * head_dim * 2 * elt
              + 2 * batch * q_heads * head_dim * elt
              + 4 * batch * math.ceil(seq_len / page_size) + 4 * batch)
    return nbytes, live * q_heads * (4 * head_dim + 4)


def rows() -> list:
    reg_b = reg_f = smoke_b = smoke_f = 0
    for (m, n), count in DANUBE_MATRICES.items():
        c = adalomo_update_counters(m, n, itemsize=ELT)
        b, f = k1_k2_smoke(m, n)
        reg_b += count * c.bytes
        reg_f += count * c.flops
        smoke_b += count * b
        smoke_f += count * f
    c = paged_decode_attention_counters(**K3_CASE, itemsize=ELT)
    b, f = k3_smoke(**K3_CASE)
    return [("K1 + K2", "danube's 170 bf16 matrices, a step", reg_b,
             smoke_b, reg_f, smoke_f),
            ("K3", f"8 x 1024, 32/8 heads, dh 80, bf16, {K3_LAUNCHES} "
                   f"launches", K3_LAUNCHES * c.bytes, K3_LAUNCHES * b,
             K3_LAUNCHES * c.flops, K3_LAUNCHES * f)]


def main() -> None:
    print("| kernel | work | registry bytes | chip_smoke.py bytes | "
          "ratio | registry FLOPs | chip_smoke.py operations |")
    print("|---|---|---|---|---|---|---|")
    for name, work, rb, sb, rf, sf in rows():
        print(f"| {name} | {work} | {rb:,.0f} | {sb:,.0f} | {rb / sb:.4f} "
              f"| {rf:,.0f} | {sf:,.0f} |")
    print("K4 (decode_attention over a ring): no registry counter; "
          "chip_smoke.py's k4_bound_ms only")


if __name__ == "__main__":
    main()
