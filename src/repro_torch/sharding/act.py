"""Activation-sharding policy.  Counterpart of ``repro.sharding.act``.

The reference constrains activations at canonical points so that GSPMD
keeps the residual stream sequence-sharded over the ``model`` axis (FSDP +
sequence parallelism).  Kinds, as the reference's:

  hidden — residual stream [B,S,D]      → P(dp, tp, None)   (seq-sharded)
  ffn    — MLP hidden [B,S,F]           → P(dp, tp, None)
  heads  — q tensor [B,S,H,dh]          → P(dp, tp, None, None)
  kv_full— k/v for attention [B,S,K,dh] → P(dp, None, None, None)
  vocab  — logits [B,S,V] or [B,V]      → P(dp, None, tp) / P(dp, tp)
  experts— MoE buffers [B,E,C,D]        → P(dp, tp, None, None)  (EP)

The port runs every activation as this rank's tile — its rows of the
batch (``pod`` × ``data``) and its sequence tile (``model``) — because the
batch is cut so at the step's entry (``Zero3.rows``).  So :func:`shard_act`
is the identity for the kinds a tile already is (``hidden``, ``ffn``,
``heads``, ``q_tiled``, ``vocab``) and executes the one that moves data:
``kv_full`` gathers K/V over ``model`` along the sequence, its backward the
fixed-order reduce-scatter of dK/dV (a tile's K/V feed every later tile's
queries).  ``experts`` buffers are made by the MoE layer itself
(``models/moe.py``, expert parallelism).  Where a quantity is a sum or a
mean over the whole batch: :func:`batch_sum` sums over every rank (each
holds other tokens), :func:`batch_mean` averages a value that the ``model``
ranks hold alike (the MoE router's statistics over the gathered sequence)
over the ``pod`` × ``data`` ranks.  All are identities with no policy.
"""
from __future__ import annotations

import contextvars
from typing import Optional

import torch

from repro_torch.sharding.rules import P

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)

class ActPolicy:
    def __init__(self, mesh, axes, *, tiles: bool = True):
        """axes: repro_torch.sharding.rules.MeshAxes; ``mesh`` a
        ``launch.mesh.MeshLayout`` or ``ProcessMesh`` (the batch group is
        read from the latter).  ``tiles=False``: the baseline plan's
        policy (``Zero3(optimized=False)``), which shards no activation:
        no sequence tile (the model axis is left out, as if of size 1), so
        every ``model`` rank runs its rows' whole sequence, and the
        batch's sums and means are over the ``pod`` × ``data`` ranks
        alone (the ``model`` ranks hold the same rows)."""
        self.mesh = mesh
        self.axes = axes
        self.tiles = tiles
        self.dp = axes.batch if len(axes.batch) > 1 else (
            axes.batch[0] if axes.batch else None)
        self.tp = axes.tp[0] if axes.tp and tiles else None
        self.dp_size = axes.size(axes.batch)
        self.tp_size = axes.size(axes.tp) if tiles else 1

    def _ok(self, dim: int, size: int) -> bool:
        return size > 1 and dim % size == 0 and dim > 1

    def spec(self, x, kind: str) -> Optional[P]:
        shape = tuple(x.shape)
        nd = len(shape)
        s: list = [None] * nd
        if nd >= 1 and self._ok(shape[0], self.dp_size):
            s[0] = self.dp
        if self.tp is None:
            return P(*s)
        if kind in ("hidden", "ffn", "heads") and nd >= 2:
            if self._ok(shape[1], self.tp_size):
                s[1] = self.tp           # sequence parallelism
        elif kind == "q_tiled" and nd >= 2:
            if shape[1] == self.tp_size:
                s[1] = self.tp           # tile dim == tp axis
        elif kind == "kv_full":
            pass                          # replicated over tp by design
        elif kind == "vocab" and nd >= 2:
            if self._ok(shape[-1], self.tp_size):
                s[-1] = self.tp
        elif kind == "experts" and nd >= 2:
            if self._ok(shape[1], self.tp_size):
                s[1] = self.tp
        return P(*s)

    @property
    def batch_group(self):
        """The ``pod`` × ``data`` ranks (other rows, this sequence tile)."""
        return getattr(self.mesh, "batch_group", None)

    @property
    def world_group(self):
        """Every rank (every rank holds other tokens); without tiles the
        batch ranks (the ``model`` ranks hold the same tokens)."""
        if not self.tiles:
            return self.batch_group
        groups = getattr(self.mesh, "groups", {})
        return groups.get("world", self.batch_group)

    @property
    def model_group(self):
        """The ``model`` ranks (the other sequence tiles of these rows),
        or None with a model axis of 1."""
        if self.tp_size <= 1:
            return None
        return getattr(self.mesh, "groups", {}).get("model")

    @property
    def tile_index(self) -> int:
        return getattr(self.mesh, "tile_index", 0) if self.tiles else 0


def install(policy: Optional[ActPolicy]):
    """Install (or clear with None) the process-wide policy."""
    _POLICY.set(policy)


def current_policy() -> Optional[ActPolicy]:
    return _POLICY.get()


class use_policy:
    def __init__(self, policy: Optional[ActPolicy]):
        self.policy = policy

    def __enter__(self):
        self.tok = _POLICY.set(self.policy)
        return self.policy

    def __exit__(self, *exc):
        _POLICY.reset(self.tok)


def shard_act(x, kind: str):
    """The activation as this rank holds it.  ``kv_full`` is gathered over
    ``model`` along the sequence (dim 1), differentiably; every other kind
    is already this rank's tile (the batch is cut at the step's entry)."""
    pol = _POLICY.get()
    if kind != "kv_full" or pol is None or pol.model_group is None:
        return x
    from repro_torch.sharding import collectives as C
    return C.gather_seq(x, 1, pol.model_group)


def sum_to_tile(x: torch.Tensor) -> torch.Tensor:
    """This rank's tile (dim 1) of the sum over ``model`` of a
    whole-sequence tensor each model rank holds a share of (the gradient
    of an activation gathered by ``kv_full`` outside autograd): the
    fixed-order fp32 reduce-scatter of ``kv_full``'s backward; ``x`` itself
    without a model axis."""
    pol = _POLICY.get()
    if pol is None or pol.model_group is None:
        return x
    from repro_torch.sharding import collectives as C
    return C.reduce_scatter(x, 1, pol.model_group)


def gather_tiles(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence (dim 1) of an integer tile — positions, segment
    ids — gathered over ``model`` with no gradient; ``x`` itself without a
    model axis."""
    pol = _POLICY.get()
    if pol is None or pol.model_group is None:
        return x
    from repro_torch.sharding import collectives as C
    return C.all_gather(x.contiguous(), 1, pol.model_group)


def seq_offset(n_local: int) -> int:
    """The sequence index of this rank's first row: its tile times
    ``n_local``, the tile's length, a modality prefix's rows included (0
    without a model axis)."""
    pol = _POLICY.get()
    if pol is None or pol.model_group is None:
        return 0
    return pol.tile_index * n_local


def model_size() -> int:
    """The number of sequence tiles under the installed policy: its model
    axis' size where the policy's mesh has the model group (1 with none)."""
    pol = _POLICY.get()
    return 1 if pol is None or pol.model_group is None else pol.tp_size


def seq_tiles(seq_len: int) -> int:
    """Sequence tiles of the attention's q-scan, the reference's count: the
    model axis' size when it divides ``seq_len``, else 1.  (The port's
    attention is given this rank's tile of the queries already.)"""
    pol = _POLICY.get()
    if pol is None or pol.tp is None:
        return 1
    return pol.tp_size if seq_len % pol.tp_size == 0 else 1


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every rank (each holds other tokens: its rows
    and its sequence tile), no gradient, in ``x``'s dtype and rank order;
    ``x`` itself with no policy."""
    pol = _POLICY.get()
    g = None if pol is None else pol.world_group
    if g is None:
        return x
    from repro_torch.sharding import collectives as C
    with torch.no_grad():
        return C.all_reduce_exact(x.detach(), g)


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over the ``pod`` × ``data`` ranks.  Backward: this
    rank's share of the gradient, ``grad / (w · tp)``: the gradient's own
    sum over the ``w`` batch ranks completes the mean's, and its sum over
    the ``tp`` model ranks, which hold the same copy, counts the copy once
    and not tp times."""

    @staticmethod
    def forward(ctx, x, group, tp):
        from repro_torch.sharding import collectives as C
        w = C.world_size(group)
        ctx.share = w * tp
        return C.all_reduce(x, group) / w

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.share, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank mean over the batch ranks (``pod`` ×
    ``data``, each holding as many rows), differentiable as above; ``x``
    itself with no policy.  ``x`` must be the same on every ``model`` rank
    (computed from the sequence gathered whole)."""
    pol = _POLICY.get()
    g = None if pol is None else pol.batch_group
    if g is None:
        return x
    return _BatchMean.apply(x, g, model_size())
