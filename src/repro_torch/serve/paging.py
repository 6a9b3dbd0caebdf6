"""Paged KV cache: fixed-size pages + host-side block-table allocator.

A copy of ``repro.serve.paging`` (free of JAX), so the port imports nothing
of ``repro``.

The device holds one shared pool of KV pages per layer
(``[L, num_pages, page_size, K, dh]``, see
``models.transformer.init_page_pool``).  Sequences own *logical* runs of
pages through a block table — an int32 row of page ids in logical order —
so a sequence's cache never needs to be contiguous and freed pages are
immediately reusable by newly admitted requests (vLLM's PagedAttention
layout, at repro scale).

Page 0 is reserved as the **scratch page**: frozen batch rows and masked
scatter writes are routed there, so the allocator never hands it out and
garbage written to it is never read (every read is masked by ``seq_lens``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


class OutOfPages(RuntimeError):
    """Raised when an allocation cannot be satisfied; callers preempt."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Number of pages needed to hold n_tokens."""
    return max(0, -(-n_tokens // page_size))


@dataclasses.dataclass
class PageAllocator:
    """Free-list allocator over the shared page pool (page 0 reserved)."""

    num_pages: int
    page_size: int

    def __post_init__(self):
        assert self.num_pages >= 2, "need at least scratch + 1 usable page"
        # pop() from the tail → pages are handed out in ascending id order,
        # which keeps smoke-test block tables readable.
        self._free = list(range(self.num_pages - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Atomically allocate n pages or raise OutOfPages."""
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            assert 0 < p < self.num_pages, p
            assert p not in self._free, f"double free of page {p}"
            self._free.append(p)


def build_block_tables(page_lists: list[list[int]],
                       max_pages_per_seq: int) -> np.ndarray:
    """Render per-slot page lists as the fixed-shape [B, P] device input.

    Unallocated tail entries point at the scratch page 0; they are never
    read because attention masks positions >= seq_len."""
    B = len(page_lists)
    table = np.zeros((B, max_pages_per_seq), np.int32)
    for i, pages in enumerate(page_lists):
        assert len(pages) <= max_pages_per_seq, (i, len(pages))
        table[i, :len(pages)] = pages
    return table
