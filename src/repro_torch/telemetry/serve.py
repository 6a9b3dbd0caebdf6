"""Serve-engine gauges: pool/scheduler/timing observability for the
continuous-batching engine (DESIGN.md §"Telemetry v1").  A copy of
``repro.telemetry.serve``.

:class:`ServeTelemetry` samples the engine's *host-side bookkeeping* at
chunk boundaries — the page allocator's free list, the scheduler's slot
table and queue, and the lifecycle counters — plus the prefill-vs-decode
wall-time split the engine accumulates.  Nothing here reads a device
array: the sample is O(batch) host arithmetic after the chunk's one
sanctioned ``.cpu()``, so the gauge path adds zero host syncs to the
decode loop.

Gauge record (one per sampled chunk boundary)::

    {"gauge": "serve", "t_s": <s since attach>,
     "pool_util":   allocated / allocatable pages   (page 0 excluded),
     "pool_free":   free pages,
     "block_table_occupancy": owned page slots / (max_batch * P),
     "queue_depth": waiting requests, "running": active slots,
     "admitted": ..., "preempted": ..., "finished": ...,   # cumulative
     "evicted_pages": ..., "timed_out": ...,               # cumulative
     "prefill_s": ..., "decode_s": ..., "chunks": ...}     # cumulative
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.telemetry.writer import TelemetryWriter


class ServeTelemetry:
    """Owns the serve gauge stream for one engine.

    ``every`` is the sampling cadence in chunk boundaries (1 = every
    chunk).  The engine calls :meth:`note_prefill` / :meth:`note_decode`
    with wall seconds as they happen and :meth:`sample` after each
    ``step()``; everything else is derived here.
    """

    def __init__(self, path, *, every: int = 1, **meta):
        self.writer = TelemetryWriter(path, stream="serve", **meta)
        self.every = max(1, int(every))
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.chunks = 0
        self._t0 = time.monotonic()

    # -- time accounting (called by the engine) ------------------------
    def note_prefill(self, dt_s: float) -> None:
        self.prefill_s += dt_s

    def note_decode(self, dt_s: float) -> None:
        self.decode_s += dt_s
        self.chunks += 1

    # -- sampling -------------------------------------------------------
    def sample(self, engine, *, force: bool = False) -> Optional[dict]:
        """Emit one gauge record from the engine's host state (cadenced;
        ``force=True`` samples regardless, e.g. a final drain sample)."""
        if not force and (self.chunks % self.every):
            return None
        alloc = engine.allocator
        sched = engine.scheduler
        usable = alloc.num_pages - 1          # page 0 is scratch
        owned = sum(len(r.pages) for r in sched.running())
        slots = sched.n_slots * sched.max_pages_per_seq
        rec = {
            "pool_util": (usable - alloc.n_free) / max(usable, 1),
            "pool_free": alloc.n_free,
            "block_table_occupancy": owned / max(slots, 1),
            "queue_depth": len(sched.queue),
            "running": len(sched.running()),
            **sched.counters,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "chunks": self.chunks,
        }
        self.writer.gauge("serve", time.monotonic() - self._t0, **rec)
        return rec

    def close(self) -> None:
        self.writer.close()
