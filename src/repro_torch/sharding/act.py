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

The port executes the batch axes only: each rank holds its rows of every
activation, so :func:`shard_act` and :func:`seq_tiles` are identities while
the ``model`` axis is 1, and a policy with a larger one raises
``NotImplementedError`` (slice 6b).  What the batch split does need is
where a quantity is a mean or a sum over the whole batch: the loss's token
count and the MoE router's load-balance statistics.  :func:`batch_sum` and
:func:`batch_mean` give those over the installed policy's batch group
(identities with no policy).
"""
from __future__ import annotations

import contextvars
from typing import Optional

import torch

from repro_torch.sharding.rules import P

_POLICY: contextvars.ContextVar = contextvars.ContextVar(
    "act_sharding_policy", default=None)

SLICE_6B = ("a model axis larger than 1 (tensor, sequence and expert "
            "parallelism) is slice 6b of the port and not ported to "
            "repro_torch yet")


class ActPolicy:
    def __init__(self, mesh, axes):
        """axes: repro_torch.sharding.rules.MeshAxes; ``mesh`` a
        ``launch.mesh.MeshLayout`` or ``ProcessMesh`` (the batch group is
        read from the latter)."""
        self.mesh = mesh
        self.axes = axes
        self.dp = axes.batch if len(axes.batch) > 1 else (
            axes.batch[0] if axes.batch else None)
        self.tp = axes.tp[0] if axes.tp else None
        self.dp_size = axes.size(axes.batch)
        self.tp_size = axes.size(axes.tp)

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
        return getattr(self.mesh, "batch_group", None)


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


def _check_tp(pol: ActPolicy) -> None:
    if pol.tp_size > 1:
        raise NotImplementedError(SLICE_6B)


def shard_act(x, kind: str):
    """The activation as this rank holds it: the identity (the batch split
    is made once, at the step's entry)."""
    pol = _POLICY.get()
    if pol is not None:
        _check_tp(pol)
    return x


def seq_tiles(seq_len: int) -> int:
    """Sequence tiles of the attention's q-scan: 1 without a model axis."""
    pol = _POLICY.get()
    if pol is None or pol.tp is None:
        return 1
    _check_tp(pol)
    return 1


def _group():
    pol = _POLICY.get()
    return None if pol is None else pol.batch_group


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the batch split (no gradient),
    in ``x``'s dtype and rank order; ``x`` itself with no policy."""
    g = _group()
    if g is None:
        return x
    from repro_torch.sharding import collectives as C
    with torch.no_grad():
        return C.all_reduce_exact(x.detach(), g)


class _BatchMean(torch.autograd.Function):
    """Forward: the mean over the batch ranks.  Backward: this rank's share
    of the gradient (``grad / w``), which the gradient's own sum over the
    ranks completes."""

    @staticmethod
    def forward(ctx, x, group):
        from repro_torch.sharding import collectives as C
        import torch.distributed as dist
        w = dist.get_world_size(group)
        ctx.w = w
        return C.all_reduce(x, group) / w

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.w, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank mean over the ranks of the batch split (each
    rank holding as many rows), differentiable as above; ``x`` itself with
    no policy."""
    g = _group()
    if g is None:
        return x
    return _BatchMean.apply(x, g)
