"""Deterministic, resumable token pipeline.

The port's copy of ``repro.data.pipeline`` (numpy only, no framework): both
packages draw bit-identical batches from one ``DataConfig``.

Two sources:
  * ``SyntheticLM`` — a structured synthetic language (Zipfian unigrams +
    deterministic bigram structure + copy motifs) so that optimizers have a
    real signal to fit (losses drop well below the unigram entropy), used by
    every benchmark in this offline container;
  * ``MemmapCorpus`` — production path: a binary uint16/uint32 token file
    (the standard "packed .bin" layout) read with np.memmap, sharded by
    data-parallel rank.

Both are *stateless* given (step, rank): resume after preemption needs only
the step counter from the checkpoint — no iterator state to persist.

With ``packing=True`` both sources emit **segment-packed** batches instead
of one-document-per-row: ragged documents (length-bucketed draws) are
greedy first-fit packed into fixed ``(B, S)`` rows (:class:`PackedBatch` —
tokens, segment_ids, positions, loss_mask), so ragged corpora stop paying
the padding tax while the batch shape — and therefore the step program —
stays constant.  Packed batches keep the same stateless-given-step
contract: ``packed_batch(step)`` is a pure function of (cfg, step, rank),
so fault recovery rewinds packed streams exactly like padded ones.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # "synthetic" | "memmap"
    path: Optional[str] = None         # for memmap
    dp_rank: int = 0
    dp_size: int = 1
    # Segment-packed ragged batching (DESIGN.md "Packed sequence layout").
    packing: bool = False
    min_doc_len: int = 16              # shortest sampled document (slots)

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.dp_size == 0
        return self.global_batch // self.dp_size


# --------------------------------------------------------------------------
# Segment packing: ragged documents -> fixed-shape (B, S) rows
# --------------------------------------------------------------------------

def bucket_boundaries(max_length: int, min_length: int = 8,
                      length_bucket_step: float = 1.1) -> list[int]:
    """Geometric length-bucket boundaries (tensor2tensor ``data_reader``
    idiom): ``[min_length, ...]`` increasing by ``length_bucket_step`` up
    to (exclusive) ``max_length``."""
    assert length_bucket_step > 1.0
    if min_length >= max_length:
        return [max_length]
    boundaries, x = [], min_length
    while x < max_length:
        boundaries.append(x)
        x = max(x + 1, int(x * length_bucket_step))
    return boundaries


@dataclasses.dataclass
class PackedBatch:
    """The packed-segment layout every layer consumes natively.

    A *document* is a 1-D token array of length ``n+1``; it occupies ``n``
    row slots with inputs ``doc[:-1]`` and labels ``doc[1:]`` (the label
    shift happens per document, *before* packing — so a label can never
    point across a segment boundary).  Per slot:

      ``segment_ids``  1..n_segments within the row, 0 = padding;
      ``positions``    restart at 0 at each segment start (RoPE restarts);
      ``labels``       next token within the segment, -1 where invalid;
      ``loss_mask``    True exactly where labels are real targets.
    """

    tokens: np.ndarray        # (B, S) int32
    labels: np.ndarray        # (B, S) int32, -1 = ignored
    segment_ids: np.ndarray   # (B, S) int32, 0 = padding
    positions: np.ndarray     # (B, S) int32, per-segment
    loss_mask: np.ndarray     # (B, S) bool

    def as_dict(self) -> dict:
        return {"tokens": self.tokens, "labels": self.labels,
                "segment_ids": self.segment_ids,
                "positions": self.positions, "loss_mask": self.loss_mask}

    @property
    def padding_efficiency(self) -> float:
        """Real tokens / slot tokens — the padding-tax metric."""
        return float((self.segment_ids > 0).sum()) / self.segment_ids.size


def pack_documents(docs: Sequence[np.ndarray], n_rows: int, seq_len: int,
                   *, boundaries: Optional[Sequence[int]] = None
                   ) -> tuple[PackedBatch, list[int]]:
    """Greedy first-fit packing of ragged documents into fixed-shape rows.

    Documents are visited longest-bucket-first (first-fit-decreasing at
    bucket granularity, arrival order within a bucket — the fixed-row-shape
    analogue of tensor2tensor's ``bucket_boundaries`` batching scheme) and
    placed into the first row with room; documents that fit nowhere are
    dropped (deterministically).  Returns ``(batch, used)`` where ``used``
    is the sorted list of packed document indices — every used document's
    tokens appear exactly once.
    """
    slots = [len(d) - 1 for d in docs]
    for n in slots:
        if n < 1:
            raise ValueError("documents need >= 2 tokens (input + label)")
        if n > seq_len:
            raise ValueError(f"document with {n} slots exceeds row "
                             f"seq_len={seq_len}; split upstream")
    if boundaries is None:
        boundaries = bucket_boundaries(seq_len)
    bidx = np.searchsorted(np.asarray(boundaries), np.asarray(
        slots, np.int64), side="right") if slots else np.zeros(0, np.int64)
    order = sorted(range(len(docs)), key=lambda i: (-int(bidx[i]), i))

    tokens = np.zeros((n_rows, seq_len), np.int32)
    labels = np.full((n_rows, seq_len), -1, np.int32)
    segment_ids = np.zeros((n_rows, seq_len), np.int32)
    positions = np.zeros((n_rows, seq_len), np.int32)
    fill = [0] * n_rows
    nseg = [0] * n_rows
    used = []
    for i in order:
        n = slots[i]
        for r in range(n_rows):
            if fill[r] + n > seq_len:
                continue
            a = fill[r]
            d = np.asarray(docs[i], np.int32)
            tokens[r, a:a + n] = d[:-1]
            labels[r, a:a + n] = d[1:]
            nseg[r] += 1
            segment_ids[r, a:a + n] = nseg[r]
            positions[r, a:a + n] = np.arange(n, dtype=np.int32)
            fill[r] += n
            used.append(i)
            break
    loss_mask = (labels >= 0) & (segment_ids > 0)
    return (PackedBatch(tokens, labels, segment_ids, positions, loss_mask),
            sorted(used))


def padded_batch_from_docs(docs: Sequence[np.ndarray], n_rows: int,
                           seq_len: int) -> dict:
    """The padded baseline for the same ragged documents: one document per
    row, right-padded — what the packing benchmark compares against."""
    tokens = np.zeros((n_rows, seq_len), np.int32)
    labels = np.full((n_rows, seq_len), -1, np.int32)
    for r, d in enumerate(docs[:n_rows]):
        d = np.asarray(d, np.int32)
        n = min(len(d) - 1, seq_len)
        tokens[r, :n] = d[:n]
        labels[r, :n] = d[1:n + 1]
    return {"tokens": tokens, "labels": labels}


def _sample_doc_lengths(rng, boundaries: Sequence[int], seq_len: int,
                        slot_budget: int) -> list[int]:
    """Length-bucketed ragged draws until the slot budget (+1 row of
    slack for first-fit to drop) is covered; bounded candidate count."""
    lengths, total = [], 0
    cap = 4 * max(slot_budget // max(boundaries[0], 1), 1)
    while total < slot_budget + seq_len and len(lengths) < cap:
        b = int(rng.integers(len(boundaries)))
        lo = boundaries[b]
        hi = boundaries[b + 1] if b + 1 < len(boundaries) else seq_len
        n = min(int(rng.integers(lo, max(hi, lo) + 1)), seq_len)
        lengths.append(n)
        total += n
    return lengths


class SyntheticLM:
    """Zipf unigrams + rotation bigrams + periodic copy spans.

    A next-token predictor can reach substantially below unigram entropy by
    learning (a) the bigram rotation and (b) the copy structure — enough
    signal to separate SGD from adaptive optimizers (paper Fig. 1/4).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        V = cfg.vocab
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.rot = rng.permutation(V)          # deterministic bigram map
        self.copy_period = 64

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.dp_rank)
        B, S = cfg.local_batch, cfg.seq_len
        base = rng.choice(cfg.vocab, size=(B, S + 1), p=self.probs)
        # bigram structure: with p=0.5 the next token is rot[prev]
        use_rot = rng.random((B, S)) < 0.5
        for t in range(1, S + 1):
            sel = use_rot[:, t - 1]
            base[sel, t] = self.rot[base[sel, t - 1]]
        # copy motif: second half of each period repeats the first half
        half = self.copy_period // 2
        for start in range(0, S + 1 - self.copy_period, self.copy_period):
            base[:, start + half:start + self.copy_period] = \
                base[:, start:start + half]
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def _doc(self, rng, n: int) -> np.ndarray:
        """One document of n+1 tokens with the same unigram/bigram/copy
        structure as :meth:`batch`, but ragged."""
        base = rng.choice(self.cfg.vocab, size=n + 1, p=self.probs)
        use_rot = rng.random(n) < 0.5
        for t in range(1, n + 1):
            if use_rot[t - 1]:
                base[t] = self.rot[base[t - 1]]
        half = self.copy_period // 2
        for start in range(0, n + 1 - self.copy_period, self.copy_period):
            base[start + half:start + self.copy_period] = \
                base[start:start + half]
        return base.astype(np.int32)

    def docs(self, step: int) -> list[np.ndarray]:
        """Ragged documents for one packed batch; pure in (cfg, step,
        rank).  A distinct rng stream from :meth:`batch` — enabling
        packing must not perturb the padded stream."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.dp_rank + 0x5E6)
        bounds = bucket_boundaries(cfg.seq_len, min_length=cfg.min_doc_len)
        lengths = _sample_doc_lengths(rng, bounds, cfg.seq_len,
                                      cfg.local_batch * cfg.seq_len)
        return [self._doc(rng, n) for n in lengths]

    def packed_batch(self, step: int) -> dict:
        cfg = self.cfg
        packed, _ = pack_documents(self.docs(step), cfg.local_batch,
                                   cfg.seq_len)
        return packed.as_dict()


class MemmapCorpus:
    """Packed binary token corpus; rank-sharded strided reads."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        assert cfg.path, "memmap source requires path"
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n_seqs = (len(self.data) - 1) // cfg.seq_len

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        B, S = cfg.local_batch, cfg.seq_len
        rng = np.random.default_rng(cfg.seed + step)
        # deterministic shuffled order, strided by dp rank
        order = rng.permutation(self.n_seqs)
        idx = order[(np.arange(B) + step * cfg.global_batch
                     + cfg.dp_rank * B) % self.n_seqs]
        toks = np.stack([self.data[i * S:i * S + S + 1] for i in idx])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def docs(self, step: int) -> list[np.ndarray]:
        """Ragged documents drawn at rank-keyed random offsets; pure in
        (cfg, step, rank), so packed streams rewind like padded ones."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.dp_rank + 0x5E6)
        bounds = bucket_boundaries(cfg.seq_len, min_length=cfg.min_doc_len)
        lengths = _sample_doc_lengths(rng, bounds, cfg.seq_len,
                                      cfg.local_batch * cfg.seq_len)
        n_tok = len(self.data)
        out = []
        for n in lengths:
            n = min(n, n_tok - 1)
            off = int(rng.integers(0, max(n_tok - n - 1, 1)))
            out.append(np.asarray(self.data[off:off + n + 1],
                                  dtype=np.int64).astype(np.int32))
        return out

    def packed_batch(self, step: int) -> dict:
        cfg = self.cfg
        packed, _ = pack_documents(self.docs(step), cfg.local_batch,
                                   cfg.seq_len)
        return packed.as_dict()


def make_source(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticLM(cfg)
    if cfg.source == "memmap":
        return MemmapCorpus(cfg)
    raise ValueError(cfg.source)


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    src = make_source(cfg)
    step = start_step
    while True:
        yield src.packed_batch(step) if cfg.packing else src.batch(step)
        step += 1


def write_corpus(path: str | Path, tokens: np.ndarray):
    """Write a packed binary corpus (production format, used in tests)."""
    tokens = np.asarray(tokens)
    dtype = np.uint16 if tokens.max() < 2 ** 16 else np.uint32
    tokens.astype(dtype).tofile(str(path))
    return dtype
