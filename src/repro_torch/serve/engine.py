"""Serving engines (PyTorch): legacy static batching over a ring cache, and
continuous batching over paged KV.  Counterpart of ``repro.serve.engine``.

``Engine`` is the static-batch path: one prefill of the right-padded batch
(its ring cache sized to the prompt, ``models/transformer.make_prefill_step``),
then one decode step per token through the ring-cache kernel of
``kernels/decode_attention`` (K4) on a CUDA device, or its plain version on
the CPU or when ``use_kernel=False``; finished rows are frozen on the device
and the host syncs once per step (one bundled copy of tokens and done mask).
It refuses an encoder-decoder model, whose prefill returns the encoder's
output (the reference's fails on it); that family is served by its step
functions.

``PagedEngine`` is the production-shaped path:

  * a shared KV **page pool** on the device (``serve/paging.py`` allocates,
    ``models/transformer.make_paged_decode_step`` reads it through the
    hand-written CUDA kernel of ``kernels/decode_attention`` on a CUDA
    device, or the plain gather oracle on the CPU or when
    ``use_kernel=False``);
  * a **scheduler** (``serve/scheduler.py``) that admits / preempts /
    retires sequences between decode chunks — requests join and leave the
    batch mid-flight;
  * **bucketed prefill**: prompts are right-padded to power-of-two length
    buckets so a bounded set of input shapes ever runs, and prefill K/V is
    scattered into the page pool in place;
  * one **fixed-shape decode chunk**: ``chunk`` decode steps run on the
    device with the done mask, the budget and EOS kept as tensor ops; the
    host syncs once per chunk (one bundled ``.cpu()`` of tokens + state) and
    once per admission (its first token), and the chunk's inputs go up as
    one non-blocking copy, so decoding never blocks per token.

PyTorch runs eagerly, so "compile counts" become counts of the distinct
input signatures (shapes and dtypes) the decode chunk and the prefill have
run with: ``decode_compile_count()`` stays 1 and ``prefill_compile_count()``
within the warmed bucket set.  Sampling draws from the engine's own
``torch.Generator`` (seeded from ``scfg.seed``): greedy is an argmax,
temperature sampling an argmax over Gumbel-perturbed logits, neither syncs.
The JAX package draws other random numbers, so only greedy output is
comparable between the two.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tree import tree_leaves
from repro_torch.serve.paging import (OutOfPages, PageAllocator,
                                      build_block_tables)
from repro_torch.serve.scheduler import RUNNING, Request, Scheduler
from repro_torch.telemetry.serve import ServeTelemetry

Tensor = torch.Tensor


def _sample_tokens(logits: Tensor, temperature: float,
                   generator: torch.Generator) -> Tensor:
    """Greedy (temperature<=0) or temperature sampling -> int32 ids."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, 1e-20)))
    return torch.argmax(logits / temperature + gumbel,
                        dim=-1).to(torch.int32)


def _engine_device(params, device) -> torch.device:
    """The engine's device (a CUDA device with its index), checked to hold
    every parameter."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    on = {leaf.device for leaf in tree_leaves(params)}
    if on != {dev}:
        raise ValueError(f"params lie on {sorted(map(str, on))}, the "
                         f"engine runs on {dev}")
    return dev


def _upload(host: np.ndarray, device: torch.device, dtype=np.int32
            ) -> Tensor:
    """One host array on ``device`` as ``dtype`` (int32 unless asked).  On
    a CUDA device a pinned staging copy goes up non-blocking: the host never
    waits."""
    t = torch.from_numpy(np.ascontiguousarray(host, dtype=dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    max_len: int = 256            # kept for the reference's signature; the
    #                               ring is sized to the prompt and the
    #                               window, as the reference does
    temperature: float = 0.0      # 0 = greedy
    eos_id: int = -1              # -1 = never stop early
    seed: int = 0
    use_kernel: Optional[bool] = None   # None = CUDA kernel on a CUDA
    #                                     device; False = plain version


class Engine:
    """Legacy static-batch engine: prefill once, decode one token a step."""

    def __init__(self, arch, params, scfg: ServeConfig, *, device="cuda"):
        if arch.family == "encdec":
            # the reference's Engine samples from the encoder prefill's
            # output and fails on a broadcast; refuse instead
            raise ValueError(
                f"{arch.arch_id}: the legacy Engine serves decoder-only "
                "models; an encoder-decoder model is served by its step "
                "functions: arch.make_prefill_step(max_decode_len=...) on "
                "the frames, then arch.make_decode_step() a token a step")
        self.device = _engine_device(params, device)
        self.arch = arch
        self.params = params
        self.scfg = scfg
        self._prefill = arch.make_prefill_step()
        self._decode = arch.make_decode_step(use_kernel=scfg.use_kernel)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)

    def _sample_step(self, logits: Tensor, tok_prev: Tensor, done: Tensor
                     ) -> tuple:
        tok = _sample_tokens(logits, self.scfg.temperature, self._gen)
        tok = torch.where(done, tok_prev, tok)      # freeze finished rows
        if self.scfg.eos_id >= 0:
            done = done | (tok == self.scfg.eos_id)
        return tok, done

    def generate(self, prompts: list[list[int]], *,
                 extras: Optional[dict] = None) -> list[list[int]]:
        """prompts: batch of token-id lists, right-padded with token 0 to the
        longest; every row's first token is sampled at that length - 1, as
        the reference does.  ``extras``: the model's other prefill inputs as
        host arrays (a modality-prefix model's ``prefix_embed [B, n, d]`` and
        ``prefix_len [B]``), uploaded beside the tokens in the dtypes of
        ``arch.train_batch_specs``; a leaf the model does not take raises
        ``ValueError`` (the reference passes it on unread)."""
        scfg = self.scfg
        B = len(prompts)
        toks = np.zeros((B, max(len(p) for p in prompts)), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        batch = {"tokens": _upload(toks, self.device)}
        if extras:
            batch.update(self._extras(extras, *toks.shape))
        logits, cache = self._prefill(self.params, batch)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        tok, done = self._sample_step(
            logits, torch.zeros(B, dtype=torch.int32, device=self.device),
            done)
        out = [[] for _ in range(B)]
        emitted_done = np.zeros(B, bool)
        for t in range(scfg.max_new_tokens):
            # ONE host sync per decode step: tokens + done mask together.
            host = torch.stack([tok, done.to(torch.int32)]).cpu().numpy()
            for i in range(B):
                if not emitted_done[i]:
                    out[i].append(int(host[0, i]))
            emitted_done = host[1].astype(bool)
            if emitted_done.all() or t == scfg.max_new_tokens - 1:
                break
            logits, cache = self._decode(self.params, cache,
                                         {"tokens": tok[:, None]})
            tok, done = self._sample_step(logits, tok, done)
        return out

    def _extras(self, extras: dict, B: int, S: int) -> dict:
        specs = self.arch.train_batch_specs(B, S, labels=False)
        takes = sorted(set(specs) - {"tokens"})
        foreign = sorted(set(extras) - set(takes))
        if foreign:
            raise ValueError(f"extras {foreign} are not inputs of "
                             f"{self.arch.arch_id} (it takes {takes})")
        return {k: _upload(v, self.device, np.dtype(
            str(specs[k][1]).removeprefix("torch."))) for k, v in
            extras.items()}


@dataclasses.dataclass
class PagedServeConfig:
    page_size: int = 16
    num_pages: int = 128          # shared pool size (incl. scratch page 0)
    max_batch: int = 4            # decode slots
    max_pages_per_seq: int = 16   # block-table width P
    chunk: int = 8                # decode steps between host syncs
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy
    eos_id: int = -1
    seed: int = 0
    bucket_min: int = 16          # smallest prefill bucket
    use_kernel: Optional[bool] = None   # None = CUDA kernel on a CUDA
    #                                     device; False = plain version
    telemetry_path: Optional[str] = None  # serve-gauge JSONL stream
    telemetry_every: int = 1            # sample cadence in chunks
    ttl_s: float = 0.0                  # default request TTL; 0 = none


def _bucket_len(n: int, lo: int) -> int:
    b = max(lo, 1)
    while b < n:
        b *= 2
    return b


def _signature(*tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


class PagedEngine:
    def __init__(self, arch, params, scfg: PagedServeConfig, *,
                 clock=time.monotonic, device="cuda"):
        arch.paged_family()                 # raises for MLA and prefix-LM
        self.device = dev = _engine_device(params, device)
        self.arch = arch
        self.params = params
        self.scfg = scfg
        # injectable monotonic clock: TTL tests advance a fake clock
        # instead of sleeping
        self.clock = clock
        B, ps = scfg.max_batch, scfg.page_size

        self.allocator = PageAllocator(scfg.num_pages, ps)
        self.scheduler = Scheduler(B, self.allocator, scfg.max_pages_per_seq)
        self._rid = itertools.count()
        self.requests: dict[int, Request] = {}
        # gauges read only host bookkeeping (allocator/scheduler state),
        # so sampling never adds a device sync to the serving hot path
        self.telemetry = (ServeTelemetry(scfg.telemetry_path,
                                         every=scfg.telemetry_every)
                          if scfg.telemetry_path else None)

        # --- device state -------------------------------------------------
        self._pages = arch.init_page_pool(scfg.num_pages, ps, device=dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(scfg.seed)
        self.chunk_count = 0
        self._decode_sigs: set = set()
        self._prefill_sigs: set = set()
        # host mirrors of the per-slot decode state (refreshed each chunk)
        self._tok = np.zeros(B, np.int32)
        self._n = np.zeros(B, np.int32)        # tokens in cache
        self._budget = np.zeros(B, np.int32)   # tokens still to emit
        self._done = np.ones(B, bool)          # empty slots are "done"

        self._prefill = arch.make_prefill_kv_step()
        self._decode = arch.make_paged_decode_step(use_kernel=scfg.use_kernel)

    # ------------------------------------------------------------------ API
    def submit(self, prompt: list[int],
               max_new_tokens: Optional[int] = None,
               ttl_s: Optional[float] = None) -> int:
        """Queue a request; it joins the running batch at the next chunk
        boundary (mid-flight admission). Returns the request id.

        ``ttl_s`` overrides ``scfg.ttl_s`` for this request; a request
        still unfinished when its deadline passes is evicted at the next
        chunk boundary (status ``timed_out``, pages reclaimed, partial
        output kept)."""
        if max_new_tokens is None:
            max_new_tokens = self.scfg.max_new_tokens
        if ttl_s is None:
            ttl_s = self.scfg.ttl_s
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      deadline_s=(self.clock() + ttl_s if ttl_s > 0
                                  else None))
        self.requests[req.rid] = req
        self.scheduler.submit(req)
        return req.rid

    def generate(self, prompts: list[list[int]],
                 max_new_tokens: Optional[int] = None) -> list[list[int]]:
        """Convenience: submit a batch, run to completion, return outputs
        in submission order."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        self.run()
        return [self.requests[r].out for r in rids]

    def run(self) -> None:
        while self.scheduler.has_work():
            self.step()
        if self.telemetry is not None:
            self.telemetry.sample(self, force=True)

    def output(self, rid: int) -> list[int]:
        return self.requests[rid].out

    def decode_compile_count(self) -> int:
        """Distinct input signatures the decode chunk has run with."""
        return len(self._decode_sigs)

    def prefill_compile_count(self) -> int:
        """Distinct input signatures (bucket lengths) prefill has run with."""
        return len(self._prefill_sigs)

    def warmup(self, prompt_lens: list[int]) -> None:
        """Run the decode chunk + the whole pow-2 prefill-bucket ladder
        spanning prompt_lens once, without touching live state (every write
        lands on the scratch page)."""
        lo = _bucket_len(min(prompt_lens), self.scfg.bucket_min)
        hi = _bucket_len(max(prompt_lens), self.scfg.bucket_min)
        b = lo
        bt_row = np.zeros(self.scfg.max_pages_per_seq, np.int32)
        while b <= hi:
            self._prefill_into_pages(np.zeros(b, np.int32), 1, bt_row)
            b *= 2
        # all slots done=True → every write is routed to the scratch page
        self._run_chunk()

    # ---------------------------------------------------------- scheduling
    def step(self) -> None:
        """One scheduling round: expire, admit, decode one chunk, retire."""
        if self.scheduler.expire(self.clock()):
            # deactivate the freed slots before the next chunk runs
            for i, r in enumerate(self.scheduler.slots):
                if r is None:
                    self._done[i] = True
        self._admit_all()
        if not self.scheduler.running():
            return
        self._ensure_ahead_all()
        t0 = time.perf_counter()
        toks = self._run_chunk()
        if self.telemetry is not None:
            self.telemetry.note_decode(time.perf_counter() - t0)
            # sample before _collect retires finished sequences, so the
            # gauge sees the pool pressure the chunk actually ran under
            self.telemetry.sample(self)
        self._collect(toks)

    def _admit_all(self) -> None:
        while True:
            req = self.scheduler.admit_next()
            if req is None:
                return
            self._start(req)

    def _start(self, req: Request) -> None:
        """(Re-)prefill req's tokens, scatter K/V into its pages, sample
        the first new token (the admission's one host sync), and activate
        its slot."""
        scfg = self.scfg
        t0 = time.perf_counter()
        tokens = req.tokens
        n = len(tokens)
        toks = np.zeros(_bucket_len(n, scfg.bucket_min), np.int32)
        toks[:n] = tokens
        bt_row = np.zeros(scfg.max_pages_per_seq, np.int32)
        bt_row[:len(req.pages)] = req.pages
        logits = self._prefill_into_pages(toks, n, bt_row)
        t0_tok = int(_sample_tokens(logits, scfg.temperature,
                                    self._gen).cpu()[0])
        if self.telemetry is not None:
            self.telemetry.note_prefill(time.perf_counter() - t0)
        if req.max_new_tokens > 0:
            req.out.append(t0_tok)
        req.n_cached = n
        s = req.slot
        if (scfg.eos_id >= 0 and t0_tok == scfg.eos_id) or req.budget <= 0:
            self.scheduler.finish(req)
            self._done[s] = True
            return
        self._tok[s] = t0_tok
        self._n[s] = n
        self._budget[s] = req.budget
        self._done[s] = False

    def _ensure_ahead_all(self) -> None:
        """Guarantee every running sequence has pages for the next chunk's
        writes, preempting the youngest sequences on pool exhaustion."""
        for req in sorted(self.scheduler.running(),
                          key=lambda r: self.scheduler._admit_idx[r.rid]):
            if req.status != RUNNING:
                continue   # preempted by an earlier iteration
            while True:
                try:
                    self.scheduler.ensure_ahead(req, self.scfg.chunk)
                    break
                except OutOfPages:
                    victim = self.scheduler.preempt_latest()
                    if victim is None:
                        raise
                    # deactivate every slot without a running request
                    for i, r in enumerate(self.scheduler.slots):
                        if r is None:
                            self._done[i] = True
                    if victim is req:
                        break

    def _run_chunk(self) -> np.ndarray:
        """Execute one fixed-shape decode chunk: one upload, one sync."""
        B, P = self.scfg.max_batch, self.scfg.max_pages_per_seq
        tables = build_block_tables(self.scheduler.page_lists(), P)
        up = _upload(np.concatenate(
            [self._tok, self._n, self._budget, self._done.astype(np.int32),
             tables.ravel()]), self.device)
        tok, n, budget, done, tables_d = torch.split(up, [B, B, B, B, B * P])
        done = done.to(torch.bool)
        tables_d = tables_d.view(B, P)
        self._decode_sigs.add(_signature(tok, n, budget, done, tables_d,
                                         self._pages["k"], self._pages["v"]))
        tok, n, budget, done, toks = self._decode_chunk(tok, n, budget, done,
                                                        tables_d)
        # ONE transfer per chunk boundary: all post-chunk state together.
        # repro-lint: disable=T2 — this IS the sanctioned single sync.
        host = torch.cat([tok, n, budget, done.to(torch.int32),
                          toks.reshape(-1)]).cpu().numpy()
        self._tok, self._n, self._budget = (host[:B].copy(),
                                            host[B:2 * B].copy(),
                                            host[2 * B:3 * B].copy())
        self._done = host[3 * B:4 * B].astype(bool)
        self.chunk_count += 1
        return host[4 * B:].reshape(B, self.scfg.chunk)

    def _collect(self, toks: np.ndarray) -> None:
        """Append emitted tokens; retire finished sequences (frees pages)."""
        for req in list(self.scheduler.running()):
            s = req.slot
            req.out.extend(int(t) for t in toks[s] if t >= 0)
            req.n_cached = int(self._n[s])
            if self._done[s]:
                self.scheduler.finish(req)

    # ------------------------------------------------------- device work
    def _decode_chunk(self, tok, n, budget, done, tables) -> tuple:
        """``chunk`` decode steps on the device; no host sync.  Returns the
        post-chunk state and the emitted tokens ``[B, chunk]`` (-1 where a
        row emitted nothing)."""
        scfg = self.scfg
        eos = scfg.eos_id
        outs = []
        for _ in range(scfg.chunk):
            emit = ~done
            logits, _ = self._decode(self.params, self._pages, {
                "tokens": tok[:, None], "block_tables": tables,
                "seq_lens": n, "emit": emit})
            nxt = _sample_tokens(logits, scfg.temperature, self._gen)
            nxt = torch.where(emit, nxt, tok)
            live = emit.to(torch.int32)
            n = n + live
            budget = budget - live
            newly_done = emit & (budget <= 0)
            if eos >= 0:
                newly_done = newly_done | (emit & (nxt == eos))
            done = done | newly_done
            outs.append(torch.where(emit, nxt, -1))
            tok = nxt
        return tok, n, budget, done, torch.stack(outs, dim=1)

    def _prefill_into_pages(self, toks: np.ndarray, length: int,
                            bt_row: np.ndarray) -> Tensor:
        """Prefill one right-padded prompt and write its K/V into the pool
        along ``bt_row``, in place; positions >= length land on the
        scratch page.  Returns the logits at position length-1."""
        S, P = toks.shape[0], bt_row.shape[0]
        up = _upload(np.concatenate([toks, [length], bt_row]), self.device)
        tokens, length_t, bt = torch.split(up, [S, 1, P])
        tokens = tokens.view(1, S)
        self._prefill_sigs.add(_signature(tokens, length_t))
        logits, k, v = self._prefill(self.params, {"tokens": tokens,
                                                   "length": length_t})
        ps = self.scfg.page_size
        j = torch.arange(S, device=self.device)
        valid = j < length_t
        pidx = torch.where(valid, bt[torch.clamp(j // ps, max=P - 1)], 0)
        slot = torch.where(valid, j % ps, 0)
        pidx, slot = pidx.to(torch.int64), slot.to(torch.int64)
        self._pages["k"][:, pidx, slot] = k[:, 0]
        self._pages["v"][:, pidx, slot] = v[:, 0]
        return logits
