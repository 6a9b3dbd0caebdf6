"""Integer ticket counters of the kernels that finish a reduction inside
their own launch (K1, K3, K4).

A block that has written its partial result draws a ticket; the block that
draws the last one of its group does the group's fold and sets the counter
back to 0.  So the counters are allocated and zeroed once a device and
kernel, never per launch: a launch allocates nothing that must be zeroed and
can be captured in a CUDA graph.  Each kernel keeps its own counters, so that
one kernel's "one launch at a time" does not tie it to another's.
"""
from __future__ import annotations

import torch

_BUFFERS: dict = {}     # (kernel, device) -> int32 buffers, newest last


def ticket_counters(kernel: str, device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device`` for ``kernel``, the same
    tensor on every call that fits in it.  A larger request makes a new
    buffer; the old one is kept, since a captured graph may still point at
    it."""
    bufs = _BUFFERS.setdefault((kernel, torch.device(device)), [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return bufs[-1]
