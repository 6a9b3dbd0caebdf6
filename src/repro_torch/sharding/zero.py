"""ZeRO-3 placement of a model's params and optimizer state over the
``data`` axis of a :class:`~repro_torch.launch.mesh.ProcessMesh`, and the
seams of the sharded fused step.

At rest every param leaf that ``rules.param_pspecs`` shards over ``data``
is held as this rank's contiguous slice along that dim; the other leaves
(norm scales, biases, a shape-guarded head) are whole on every rank.
Params are replicated across pods.  AdaLomo's factored state shards with
the rows and columns it describes: a leaf split by rows keeps its rows' r
and the whole c, one split by columns the whole r and its columns' c; an
unfactored v is split as its param.

The fused step (``core/fused.py``) calls the seams:

  * :meth:`Zero3.gather` / :meth:`Zero3.layer` — the whole tensors of the
    outer leaves (once a step) and of one layer (before its forward and
    before its re-run), gathered in the param dtype;
  * :meth:`Zero3.scatter` — a layer's (or the outer leaves') gradients
    reduce-scattered over ``data`` to the resting shard (then summed over
    ``pod``), a replicated leaf's summed over every rank;
  * :meth:`Zero3.shards` — the :class:`TensorShard` of each leaf, which
    the AdaLomo rule takes to sum its statistics over the ranks.

Nothing here keeps a gathered tensor: a layer's whole weights live while
its forward or its re-run does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.tree import (pytree_leaves, pytree_unflatten,
                                   tree_flatten_with_path, tree_map)
from repro_torch.sharding import collectives as C
from repro_torch.sharding.act import ActPolicy
from repro_torch.sharding.rules import (MeshAxes, data_dim,
                                       make_grad_constraint,
                                       make_param_constraint, param_pspecs)

Tensor = torch.Tensor

_REPLICATED = -1          # a dims list's mark of a leaf held whole


class TensorShard(NamedTuple):
    """One rank's place in a tensor split by rows (``axis=-2``) or columns
    (``axis=-1``) of its matrices: ``n_total`` elements a matrix, and the
    group whose ranks hold the other shards."""

    axis: int
    n_total: int
    group: object

    def sum(self, t: Tensor) -> Tensor:
        """The sum of ``t`` over the ranks holding this tensor's shards."""
        return C.all_reduce(t, self.group)


def _state_dims(dim: Optional[int], ndim: int, state):
    """Dims (``_REPLICATED`` for whole) of a per-tensor state's tensors."""
    if not isinstance(state, tuple):
        return _REPLICATED if dim is None else dim
    fields = getattr(state, "_fields", None)
    out = []
    for i, t in enumerate(state):
        if t is None:
            out.append(None)
            continue
        name = fields[i] if fields else None
        if dim is None:
            d = None
        elif name == "r":         # shape[:-1]: rows' statistics
            d = None if dim == ndim - 1 else dim
        elif name == "c":         # shape[:-2] + shape[-1:]
            d = ndim - 2 if dim == ndim - 1 else (
                None if dim == ndim - 2 else dim)
        else:                     # v, moments: the param's shape
            d = dim
        out.append(_REPLICATED if d is None else d)
    return type(state)(*out) if fields else tuple(out)


def param_dims(params, axes: MeshAxes):
    """The data-axis dim (None: whole) of every param leaf, by the rules."""
    return tree_map(data_dim, param_pspecs(params, axes))


def leaf_dims(dims, shapes, opt_state) -> list:
    """The sharded dim (None: whole) of every tensor of ``(params,
    opt_state)`` in ``pytree_leaves`` order, from the params' ``dims`` and
    full ``shapes``: a state tensor follows its param (a factored r its
    rows, c its columns); ``OptState.step`` is whole."""
    p = [_REPLICATED if d is None else d
         for _, d in tree_flatten_with_path(dims)]
    s = pytree_leaves(tree_map(lambda d, shp, st: _state_dims(d, len(shp),
                                                              st),
                               dims, shapes, opt_state.moments))
    return [None if d == _REPLICATED else d for d in p + [_REPLICATED] + s]


class Zero3:
    """The ZeRO-3 plan of one model on ``mesh``, from its full params'
    paths and shapes (tensors of any device, ``meta`` included)."""

    def __init__(self, mesh, params):
        self.mesh = mesh
        self.axes = MeshAxes(mesh)
        self.dims = param_dims(params, self.axes)
        self.shapes = tree_map(lambda t: tuple(t.shape), params)
        self.data = mesh.group("data")
        self.pod = mesh.groups.get("pod") if mesh.size("pod") > 1 else None
        self.world = mesh.batch_group
        self.policy = ActPolicy(mesh, self.axes)

    # ---------------- placement ----------------
    def leaf_dims(self, opt_state) -> list:
        """The sharded dim (None: whole) of every tensor of ``(params,
        opt_state)``, in checkpoint leaf order (``pytree_leaves``)."""
        return leaf_dims(self.dims, self.shapes, opt_state)

    def tree_dims(self, tree) -> list:
        """:meth:`leaf_dims` of a ``(params, opt_state)`` tree."""
        return self.leaf_dims(tree[1])

    def local(self, full: Tensor, dim: Optional[int]) -> Tensor:
        return full if dim is None else C.shard(full, dim, self.data)

    def shard_tree(self, tree, opt_state) -> tuple:
        """``(params, opt_state)`` of whole tensors -> this rank's resting
        shards (new contiguous tensors for the split leaves)."""
        leaves = pytree_leaves(tree)
        dims = self.leaf_dims(opt_state)
        return pytree_unflatten(tree, [self.local(t, d)
                                       for t, d in zip(leaves, dims)])

    # ---------------- step seams ----------------
    def gather(self, local, dims, *, drop: int = 0):
        """Whole tensors of a subtree (``dims`` its dims tree; ``drop``
        leading dims already indexed away)."""
        return tree_map(
            lambda t, d: t if d is None else C.all_gather(t, d - drop,
                                                          self.data),
            local, dims)

    def layer(self, stacked, dims, i: int):
        """Layer ``i`` of a stacked subtree, whole."""
        return self.gather(tree_map(lambda t: t[i], stacked), dims, drop=1)

    def scatter(self, grads, dims, *, drop: int = 0):
        """Whole-tensor gradients of this rank's rows -> the sum over all
        ranks, as each leaf rests: reduce-scattered over ``data`` (then
        summed over ``pod``) or, for a whole leaf, summed over every rank."""
        def one(g, d):
            if d is None:
                return C.all_reduce(g, self.world)
            if self.pod is None:
                return C.reduce_scatter(g, d - drop, self.data)
            part = C.reduce_scatter(g, d - drop, self.data,
                                    dtype=torch.float32)
            return C.all_reduce(part, self.pod, dtype=g.dtype)
        return tree_map(one, grads, dims)

    def shards(self, dims, shapes, *, drop: int = 0):
        """The :class:`TensorShard` (or None: held whole, or split along an
        independent leading dim) of every leaf of a subtree."""
        def one(d, shp):
            if d is None:
                return None
            shp = shp[drop:]
            d -= drop
            n = len(shp)
            if d < n - 2:
                return None
            return TensorShard(axis=d - n, n_total=shp[-2] * shp[-1],
                               group=self.data)
        return tree_map(one, dims, shapes)

    def seams(self, stack: str) -> dict:
        """The keywords of ``core.fused.stack_backward_update`` for one
        stack: ``layer_fn`` (the gather, ``rules.make_param_constraint``),
        ``grad_fn`` (the reduce-scatter, ``rules.make_grad_constraint``)
        and ``shards``."""
        return dict(layer_fn=make_param_constraint(self)(stack),
                    grad_fn=make_grad_constraint(self)(stack),
                    shards=self.shards(self.dims["stacks"][stack],
                                       self.shapes["stacks"][stack], drop=1))

    def rows(self, x: Tensor) -> Tensor:
        """This rank's rows of a global batch leaf (the leading dim split
        over ``pod`` × ``data`` when it divides, else whole)."""
        w = self.mesh.batch_size
        if x.ndim == 0 or x.shape[0] % w or x.shape[0] <= 1:
            return x
        k = x.shape[0] // w
        return x[self.mesh.batch_index * k:(self.mesh.batch_index + 1) * k]
