"""Run-layer data plumbing: arch-aware batch iterators.

Counterpart of ``repro.run.data``.  The token pipeline
(``repro_torch.data.pipeline``) is family-agnostic and yields numpy batches;
the reference's per-batch extras are an encoder-decoder model's ``frames``
(the stubbed audio frontend's frame embeddings), a prefix-LM model's
``prefix_embed`` (the stubbed modality frontend's patch embeddings) and
``prefix_len`` — the embeddings seeded normal draws keyed by the data seed
and the step — and the MTP head's ``labels_mtp`` (the labels shifted once
more, padded with -1).  All are keyed per step, as the reference's are, so
a resumed run and the eval stream reproduce them bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.run.spec import RunSpec


def resolved_data(spec: RunSpec, arch) -> DataConfig:
    """The spec's DataConfig with ``vocab=0`` resolved to the arch vocab."""
    if spec.data is None:
        raise ValueError("spec.data is required to build a batch iterator")
    if spec.data.vocab:
        return spec.data
    return dataclasses.replace(spec.data, vocab=arch.cfg.vocab)


def _with_extras(b: dict, arch, cfg: DataConfig, step: int) -> dict:
    """``b`` with the leaves ``arch.train_batch_specs`` adds to the
    pipeline's: ``frames`` for an encoder-decoder model, ``prefix_embed``
    and ``prefix_len`` for a prefix-LM model (drawn as the reference draws
    them, frames first, from one ``(seed, 0x5eed, step)`` generator) and
    ``labels_mtp`` for an MTP model (token t + 2's label at t)."""
    frames = arch.family == "encdec"
    prefix = getattr(arch.cfg, "prefix_lm", False)
    mtp = getattr(arch.cfg, "mtp", False)
    if not (frames or prefix or mtp):
        return b
    b = dict(b)
    B, d = cfg.local_batch, arch.cfg.d_model
    rng = np.random.default_rng((cfg.seed, 0x5eed, step))
    if frames:
        b["frames"] = rng.standard_normal((B, arch.cfg.n_frames, d),
                                          dtype=np.float32)
    if prefix:
        n = arch.cfg.n_prefix_tokens
        b["prefix_embed"] = rng.standard_normal((B, n, d), dtype=np.float32)
        b["prefix_len"] = np.full((B,), n, np.int32)
    if mtp:
        lab = b["labels"]
        b["labels_mtp"] = np.concatenate(
            [lab[:, 1:], -np.ones((lab.shape[0], 1), np.int32)], 1)
    return b


def make_batch_iter(spec: RunSpec, arch, start_step: int = 0,
                    *, seed_offset: int = 0) -> Iterator[dict]:
    """Deterministic, resumable stream of numpy batches matching
    ``arch.train_batch_specs`` leaf-for-leaf.  ``seed_offset`` derives a
    disjoint stream from the same spec (held-out eval)."""
    cfg = resolved_data(spec, arch)
    if seed_offset:
        cfg = dataclasses.replace(cfg, seed=cfg.seed + seed_offset)
    return (_with_extras(b, arch, cfg, step)
            for step, b in enumerate(batches(cfg, start_step), start_step))


# Seed offset for the default held-out eval stream.
EVAL_SEED_OFFSET = 999
