"""Run-layer data plumbing: arch-aware batch iterators.

Counterpart of ``repro.run.data``.  The token pipeline
(``repro_torch.data.pipeline``) is family-agnostic and yields numpy batches;
the dense transformer family needs no per-batch extras, so the stream is the
pipeline's own, keyed per step so a resume reproduces it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.run.spec import RunSpec


def resolved_data(spec: RunSpec, arch) -> DataConfig:
    """The spec's DataConfig with ``vocab=0`` resolved to the arch vocab."""
    if spec.data is None:
        raise ValueError("spec.data is required to build a batch iterator")
    if spec.data.vocab:
        return spec.data
    return dataclasses.replace(spec.data, vocab=arch.cfg.vocab)


def make_batch_iter(spec: RunSpec, arch, start_step: int = 0,
                    *, seed_offset: int = 0) -> Iterator[dict]:
    """Deterministic, resumable stream of numpy batches matching
    ``arch.train_batch_specs`` leaf-for-leaf.  ``seed_offset`` derives a
    disjoint stream from the same spec (held-out eval)."""
    cfg = resolved_data(spec, arch)
    if seed_offset:
        cfg = dataclasses.replace(cfg, seed=cfg.seed + seed_offset)
    return batches(cfg, start_step)


# Seed offset for the default held-out eval stream.
EVAL_SEED_OFFSET = 999
