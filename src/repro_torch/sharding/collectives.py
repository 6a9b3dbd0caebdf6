"""The collectives of the sharded step, each over an explicit process group.

The torch form of what GSPMD inserts in the reference: gather a ZeRO-3
shard to the whole tensor, reduce-scatter a gradient back to the shard,
sum small statistics and replicated leaves' gradients over the ranks.

Every sum over the ranks runs in rank order (rank 0's term first), on
every rank: the reduce-scatter is an all-to-all of the gradient's chunks
followed by a local sum of the received chunks in rank order, and the
all-reduce an all-gather followed by the same ordered sum.  So every rank
gets bit-identical sums, a re-run gives the same bits, and a replicated
leaf stays equal on every rank.  (Neither backend's own reduce-scatter or
all-reduce promises an order of summation.)  Tensors travel in their own
dtype (a bf16 gradient as bf16: half the bytes); each term is widened to
fp32 exactly as it is added, the sum taken in fp32 and narrowed once,
after it.

Along the ``model`` axis the sequence-parallel step moves activations:
:func:`gather_seq` (an all-gather along a tensor dim whose backward is the
fixed-order reduce-scatter of the gradient) and :func:`scatter_seq` (a
reduce-scatter whose backward is the all-gather), both autograd-aware.

``gloo`` takes no CUDA tensor for the all-gather and the all-to-all these
use, so with ``gloo`` a CUDA tensor is staged through host memory (two
ranks sharing one card): that staging is counted in :data:`STATS`
(``staged_bytes``).  The kernels and the model still run on the card.

A :class:`DryGroup` stands in for a process group on a dry mesh
(``launch/mesh.py::make_dry_mesh``): one process plays one rank of a
layout of any size, with meta tensors.  Every collective takes it, makes
the output the live call would make (gathered, scattered, or as it was for
the sums) and adds to :data:`STATS` what the live call adds, and calls
nothing in ``torch.distributed``.  Inside :func:`recording` every call,
dry or live, is logged (:data:`LOG`): its kind, operand shape and dtype,
the mesh axes of its group, its operand bytes, its wire bytes under the
reference dry run's factors (all-gather: the result; all-reduce: twice
the result; reduce-scatter: the operand) and the function that called it.
"""
from __future__ import annotations

import contextlib
import sys

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# Collective calls and bytes moved since the last reset (``reset_stats``):
# one count a call of a torch.distributed collective.
STATS = {"calls": 0, "gather_bytes": 0, "scatter_bytes": 0,
         "reduce_bytes": 0, "staged_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class DryGroup:
    """A process group of the ranks ``ranks`` (global ranks, in the
    group's order) in which this process is global rank ``rank``; ``axes``
    are the mesh axes the group spans.  Nothing is communicated: the
    collectives of this module make the outputs a live call would make."""

    def __init__(self, ranks, rank: int, axes: tuple = ()):
        self.ranks = tuple(int(r) for r in ranks)
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not in the group {self.ranks}")
        self.rank = int(rank)
        self.axes = tuple(axes)

    def size(self) -> int:
        return len(self.ranks)

    def index(self) -> int:
        return self.ranks.index(self.rank)


def world_size(group) -> int:
    """The number of ranks in ``group`` (a process group or a
    :class:`DryGroup`)."""
    if isinstance(group, DryGroup):
        return group.size()
    return dist.get_world_size(group)


def rank_in(group) -> int:
    """This process's place in ``group``."""
    if isinstance(group, DryGroup):
        return group.index()
    return dist.get_rank(group)


# the mesh axes of each live group, set by ``launch.mesh.make_mesh``
_AXES: dict = {}


def name_group(group, axes: tuple) -> None:
    """Record the mesh axes ``group`` spans, for :func:`recording`'s log
    (a newer mesh's name for a group replaces an older one's)."""
    if not isinstance(group, DryGroup):
        _AXES[id(group)] = (group, tuple(axes))


def group_axes(group) -> tuple:
    if isinstance(group, DryGroup):
        return group.axes
    return _AXES.get(id(group), (None, ()))[1]


# the calls made inside ``recording()``, oldest first; None outside it
LOG = None


@contextlib.contextmanager
def recording():
    """Log every collective call made inside the block (dry or live) into
    the list this yields (module docstring)."""
    global LOG
    outer, LOG = LOG, []
    try:
        yield LOG
    finally:
        LOG = outer


_WIRE = {"all_gather": lambda op, res: res,
         "all_reduce": lambda op, res: 2 * res,
         "reduce_scatter": lambda op, res: op}


def _caller() -> str:
    """``module:function`` of the nearest frame outside this module and
    autograd's machinery."""
    f = sys._getframe(2)
    while f is not None and (f.f_globals.get("__name__") == __name__
                             or f.f_globals.get("__name__", "").startswith(
                                 "torch.")):
        f = f.f_back
    if f is None:
        return "?"
    return (f"{f.f_globals.get('__name__', '?').rsplit('.', 1)[-1]}:"
            f"{f.f_code.co_name}")


def _log(kind: str, x: Tensor, group, operand: int, result: int) -> None:
    if LOG is None:
        return
    LOG.append({"kind": kind, "shape": list(x.shape),
                "dtype": str(x.dtype).replace("torch.", ""),
                "axes": list(group_axes(group)), "operand_bytes": operand,
                "result_bytes": result,
                "wire_bytes": _WIRE[kind](operand, result),
                "tag": _caller()})


def _staged(x: Tensor, group) -> bool:
    return (x.is_cuda and not isinstance(group, DryGroup)
            and dist.get_backend(group) == "gloo")


def _to_wire(x: Tensor, group) -> Tensor:
    if _staged(x, group):
        STATS["staged_bytes"] += x.numel() * x.element_size()
        return x.to("cpu")
    return x


def _from_wire(y: Tensor, like: Tensor) -> Tensor:
    if y.device != like.device:
        STATS["staged_bytes"] += y.numel() * y.element_size()
        return y.to(like.device)
    return y


def _gather_flat(x: Tensor, group, kind: str = "all_gather") -> Tensor:
    """``[w, *x.shape]``: every rank's ``x``, rank order (``kind``: what
    the call is part of, for the log)."""
    w = world_size(group)
    xs = _to_wire(x.contiguous().reshape(-1), group)
    out = torch.empty(w * xs.numel(), dtype=x.dtype, device=xs.device)
    if not isinstance(group, DryGroup):
        dist.all_gather_into_tensor(out, xs, group=group)
    STATS["calls"] += 1
    nbytes = x.numel() * x.element_size()
    _log(kind, x, group, nbytes, w * nbytes if kind == "all_gather"
         else nbytes)
    return _from_wire(out, x).reshape((w,) + tuple(x.shape))


def _ordered_sum(parts: Tensor, dtype=None) -> Tensor:
    """``parts[0] + parts[1] + ...`` over the leading dim, in index order,
    in ``dtype`` (default ``parts``'): each term widened as it is added."""
    total = parts[0].to(dtype or parts.dtype, copy=True)
    for i in range(1, parts.shape[0]):
        total += parts[i]
    return total


def shard(x: Tensor, dim: int, group) -> Tensor:
    """This rank's slice of ``x`` along ``dim`` (no communication), a
    contiguous tensor of its own: never a view, which would keep the whole
    of ``x`` alive (a slice along the leading dims is contiguous already);
    ``x.shape[dim]`` must divide by the group's size."""
    w, k = world_size(group), rank_in(group)
    if x.shape[dim] % w:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {w} ranks")
    return x.narrow(dim, k * (x.shape[dim] // w),
                    x.shape[dim] // w).clone(
                        memory_format=torch.contiguous_format)


def all_gather(x: Tensor, dim: int, group) -> Tensor:
    """The whole tensor from the shards of ``group`` along ``dim``, in
    ``x``'s dtype (a bf16 shard is gathered as bf16).  A shard split on a
    later dim than 0 gets a layout copy after the gather."""
    parts = _gather_flat(x, group)                   # [w, ...shard]
    STATS["gather_bytes"] += parts.numel() * parts.element_size()
    if dim == 0:
        return parts.reshape((-1,) + tuple(x.shape[1:]))
    full = list(x.shape)
    full[dim] *= parts.shape[0]
    return parts.movedim(0, dim).reshape(full)


def reduce_scatter(g: Tensor, dim: int, group, *, dtype=None) -> Tensor:
    """This rank's shard along ``dim`` of the sum over ``group`` of the
    whole-tensor gradients ``g``: the chunks sent in ``g``'s dtype, each
    widened to fp32 as it is added in rank order, the sum narrowed once to
    ``dtype`` (default ``g``'s)."""
    dtype = dtype or g.dtype
    w = world_size(group)
    if g.shape[dim] % w:
        raise ValueError(f"dim {dim} of {tuple(g.shape)} does not divide "
                         f"over {w} ranks")
    # [w, ...chunk] contiguous: chunk j goes to rank j (a layout copy when
    # dim > 0)
    chunks = g.unflatten(dim, (w, g.shape[dim] // w))
    chunks = chunks.movedim(dim, 0).contiguous()
    send = _to_wire(chunks, group)
    recv = torch.empty_like(send)
    if not isinstance(group, DryGroup):
        dist.all_to_all_single(recv, send, group=group)
    STATS["calls"] += 1
    STATS["scatter_bytes"] += send.numel() * send.element_size()
    nbytes = g.numel() * g.element_size()
    _log("reduce_scatter", g, group, nbytes, nbytes // w)
    return _ordered_sum(_from_wire(recv, g), torch.float32).to(dtype)


def all_reduce(x: Tensor, group, *, dtype=None) -> Tensor:
    """The sum over ``group`` of ``x``, in fp32 and rank order, narrowed
    once to ``dtype`` (default ``x``'s).  Bit-identical on every rank."""
    dtype = dtype or x.dtype
    parts = _gather_flat(x, group, "all_reduce")
    STATS["reduce_bytes"] += parts.numel() * parts.element_size()
    return _ordered_sum(parts, torch.float32).to(dtype)


def all_reduce_exact(x: Tensor, group) -> Tensor:
    """The sum over ``group`` of an integer or fp32 tensor in its own dtype
    (token counts, flags), rank order."""
    parts = _gather_flat(x, group, "all_reduce")
    STATS["reduce_bytes"] += parts.numel() * parts.element_size()
    return _ordered_sum(parts)


def all_reduce_groups(x: Tensor, groups, *, dtype=None) -> Tensor:
    """The sum of ``x`` over each group of ``groups`` in turn (None and
    one-rank groups skipped), in fp32 and rank order, narrowed once to
    ``dtype`` (default ``x``'s) after the last."""
    dtype = dtype or x.dtype
    live = [g for g in groups
            if g is not None and world_size(g) > 1]
    for i, g in enumerate(live):
        x = all_reduce(x, g, dtype=dtype if i == len(live) - 1
                       else torch.float32)
    return x.to(dtype)


class _GatherSeq(torch.autograd.Function):
    """Forward: the whole tensor from the ranks' pieces along ``dim``.
    Backward: each rank's piece of the gradient summed over the ranks
    (every rank's forward output fed another part of the model)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _ScatterSeq(torch.autograd.Function):
    """Forward: this rank's piece along ``dim`` of the sum over the ranks.
    Backward: the gradient's pieces gathered whole (the sum fed every
    rank's output)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad.contiguous(), ctx.dim, ctx.group), None, None


def gather_seq(x: Tensor, dim: int, group) -> Tensor:
    """All-gather along ``dim`` over ``group``, differentiable: the
    gradient goes back as a fixed-order reduce-scatter."""
    return _GatherSeq.apply(x, dim, group)


def scatter_seq(x: Tensor, dim: int, group) -> Tensor:
    """Reduce-scatter along ``dim`` over ``group`` (a fixed-order fp32 sum
    narrowed to ``x``'s dtype), differentiable: the gradient goes back as
    an all-gather."""
    return _ScatterSeq.apply(x, dim, group)
