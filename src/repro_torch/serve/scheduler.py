"""Request scheduler for the continuous-batching engine.

A copy of ``repro.serve.scheduler`` (free of JAX) over the port's
``serve.paging``.

Owns the decode-slot table and the FIFO admission queue.  Between decode
chunks the engine asks the scheduler to

  * ``admit_next()`` queued requests into free slots (only when the page
    allocator can cover the request's prompt — admission is all-or-nothing
    so a half-admitted request never wedges the pool);
  * ``ensure_ahead()`` pages for the tokens the next chunk will write,
    preempting the most-recently-admitted request when the pool is
    exhausted (preempted requests release every page and are requeued at
    the *front*; on re-admission they prefill over prompt + generated
    tokens, which reproduces the decode state exactly);
  * ``finish()`` sequences whose done-mask bit is set (EOS or budget
    exhausted), returning their pages to the allocator;
  * ``expire()`` requests whose TTL deadline has passed — timed-out
    sequences are evicted at the chunk boundary (queued ones are simply
    dropped), their pages go back to the pool immediately, and the
    ``timed_out`` lifetime counter feeds the serve gauges.

The scheduler is pure host-side bookkeeping — it never touches device
arrays — so its policies are unit-testable without compiling anything.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from repro_torch.serve.paging import OutOfPages, PageAllocator, pages_for

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"
TIMED_OUT = "timed_out"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out: list[int] = dataclasses.field(default_factory=list)
    pages: list[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    status: str = QUEUED
    n_cached: int = 0          # tokens currently in the KV cache
    n_preempted: int = 0
    deadline_s: Optional[float] = None   # absolute clock time; None = no TTL

    @property
    def tokens(self) -> list[int]:
        """Prompt + generated so far — what a (re-)prefill runs over."""
        return self.prompt + self.out

    @property
    def budget(self) -> int:
        """Tokens this request may still emit."""
        return self.max_new_tokens - len(self.out)

    @property
    def max_total_len(self) -> int:
        # the final emitted token is never written to the cache, hence -1
        return len(self.prompt) + self.max_new_tokens - 1


class Scheduler:
    def __init__(self, n_slots: int, allocator: PageAllocator,
                 max_pages_per_seq: int):
        self.n_slots = n_slots
        self.alloc = allocator
        self.max_pages_per_seq = max_pages_per_seq
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.queue: deque[Request] = deque()
        self._admit_counter = 0
        self._admit_idx: dict[int, int] = {}   # rid -> admission order
        # lifetime counters sampled by the serve telemetry gauges
        self.counters = {"admitted": 0, "preempted": 0, "finished": 0,
                         "evicted_pages": 0, "timed_out": 0}

    # ---- queries ----------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def running(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    def free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def page_lists(self) -> list[list[int]]:
        return [r.pages if r is not None else [] for r in self.slots]

    # ---- lifecycle --------------------------------------------------------
    def submit(self, req: Request) -> None:
        max_len = self.max_pages_per_seq * self.alloc.page_size
        if req.max_total_len > max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds per-seq capacity "
                f"{max_len}")
        # a request must fit the pool *alone*, else admission (or the
        # self-preemption cycle) can never make progress -> run() livelock
        pool = self.alloc.num_pages - 1   # page 0 is scratch
        need = pages_for(req.max_total_len, self.alloc.page_size)
        if need > pool:
            raise ValueError(
                f"request {req.rid}: needs up to {need} pages but the "
                f"pool only has {pool}")
        self.queue.append(req)

    def admit_next(self) -> Optional[Request]:
        """Admit the head-of-queue request if a slot + prompt pages exist."""
        slot = self.free_slot()
        if slot is None or not self.queue:
            return None
        req = self.queue[0]
        need = pages_for(len(req.tokens), self.alloc.page_size)
        if need > self.alloc.n_free:
            return None
        self.queue.popleft()
        req.pages = self.alloc.alloc(need)
        req.slot = slot
        req.status = RUNNING
        req.n_cached = 0
        self.slots[slot] = req
        self._admit_idx[req.rid] = self._admit_counter
        self._admit_counter += 1
        self.counters["admitted"] += 1
        return req

    def ensure_ahead(self, req: Request, lookahead: int) -> None:
        """Grow req's page list to cover `lookahead` more cached tokens.

        Raises OutOfPages (caller decides whom to preempt)."""
        target = min(req.n_cached + lookahead, req.max_total_len)
        need = pages_for(target, self.alloc.page_size) - len(req.pages)
        if need > 0:
            req.pages.extend(self.alloc.alloc(need))

    def preempt_latest(self) -> Optional[Request]:
        """Evict the most-recently-admitted running request; requeue it at
        the front so it is the first to come back when pages free up."""
        running = self.running()
        if not running:
            return None
        victim = max(running, key=lambda r: self._admit_idx[r.rid])
        self.counters["preempted"] += 1
        self.counters["evicted_pages"] += len(victim.pages)
        self.alloc.free(victim.pages)
        self.slots[victim.slot] = None
        victim.pages = []
        victim.slot = None
        victim.status = QUEUED
        victim.n_cached = 0
        victim.n_preempted += 1
        self.queue.appendleft(victim)
        return victim

    def expire(self, now: float) -> list[Request]:
        """Evict every request whose ``deadline_s`` has passed.  Running
        victims release all pages and their slot; queued victims are just
        dropped.  Partial output stays on the request (``req.out``) so the
        caller can still hand back what was generated.  Returns the
        newly timed-out requests."""
        expired = []
        for req in self.running():
            if req.deadline_s is not None and now >= req.deadline_s:
                self.alloc.free(req.pages)
                self.slots[req.slot] = None
                req.pages = []
                req.slot = None
                req.status = TIMED_OUT
                self.counters["timed_out"] += 1
                expired.append(req)
        for req in [r for r in self.queue
                    if r.deadline_s is not None and now >= r.deadline_s]:
            self.queue.remove(req)
            req.status = TIMED_OUT
            self.counters["timed_out"] += 1
            expired.append(req)
        return expired

    def finish(self, req: Request) -> None:
        """EOS / budget exhausted: release pages, free the slot."""
        self.alloc.free(req.pages)
        self.slots[req.slot] = None
        req.pages = []
        req.slot = None
        req.status = FINISHED
        self.counters["finished"] += 1
