"""Run-layer data plumbing: arch-aware batch iterators.

Counterpart of ``repro.run.data``.  The token pipeline
(``repro_torch.data.pipeline``) is family-agnostic and yields numpy batches;
of the reference's per-batch extras the port's architectures need one, the
MTP head's ``labels_mtp`` (the labels shifted once more, padded with -1),
made from each batch's own labels, so a resume reproduces it with the
stream, which is keyed per step.
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


def _with_extras(b: dict, arch) -> dict:
    """``b`` with the leaves ``arch.train_batch_specs`` adds to the
    pipeline's: ``labels_mtp`` for an MTP model (token t + 2's label at t)."""
    if not arch.cfg.mtp:
        return b
    lab = b["labels"]
    return {**b, "labels_mtp": np.concatenate(
        [lab[:, 1:], -np.ones((lab.shape[0], 1), np.int32)], 1)}


def make_batch_iter(spec: RunSpec, arch, start_step: int = 0,
                    *, seed_offset: int = 0) -> Iterator[dict]:
    """Deterministic, resumable stream of numpy batches matching
    ``arch.train_batch_specs`` leaf-for-leaf.  ``seed_offset`` derives a
    disjoint stream from the same spec (held-out eval)."""
    cfg = resolved_data(spec, arch)
    if seed_offset:
        cfg = dataclasses.replace(cfg, seed=cfg.seed + seed_offset)
    return (_with_extras(b, arch) for b in batches(cfg, start_step))


# Seed offset for the default held-out eval stream.
EVAL_SEED_OFFSET = 999
