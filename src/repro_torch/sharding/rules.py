"""Partition rules: which dims of params, optimizer state, batches and
caches are sharded over which mesh axes.  Counterpart of
``repro.sharding.rules``, as pure functions of (tree path, shape).

Logical axes:
  * ``dp`` — data parallel + ZeRO-3 param sharding.  Resolves to
    ``('data',)`` on the single-pod mesh and ``('pod','data')`` multi-pod
    for the *batch*; parameters are sharded over ``'data'`` only (gathered
    within a pod, replicated across pods).
  * ``tp`` — tensor/expert parallel, resolves to ``('model',)``.

Rules are (regex over the param path, dim-role template) pairs; every rule
is shape-guarded: an axis is applied to a dim only if the dim is divisible
by the mesh axis size (whisper's vocab 51865 stays replicated).  Optimizer
state specs are derived from the param specs by shape-suffix matching, as
the reference derives them.

A spec is a :class:`P`, a tuple of axis names (or tuples of them) and
``None``, one entry a dim — the stand-in for ``jax.sharding.PartitionSpec``.
A mesh is anything with ``axis_names`` and a ``shape`` mapping name ->
size (``launch.mesh.MeshLayout``, ``launch.mesh.ProcessMesh``).

The port executes all three axes (``sharding/zero.py``): a leaf rests
split along its ``data`` dim and its ``model`` dim.
"""
from __future__ import annotations

import math
import re
from typing import Optional

from repro_torch.core.tree import (pytree_leaves, pytree_unflatten,
                                   tree_flatten_with_path, tree_map)


class P(tuple):
    """A partition spec: one entry a dim, an axis name, a tuple of axis
    names, or ``None`` (replicated along that dim)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class MeshAxes:
    """Resolved logical→physical axis names for a given mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.axis_names)
        self.batch = tuple(n for n in ("pod", "data") if n in names)
        self.fsdp = ("data",) if "data" in names else ()
        self.tp = ("model",) if "model" in names else ()

    def size(self, axes: tuple) -> int:
        return math.prod(self.mesh.shape[a] for a in axes) if axes else 1


# Dim-role templates per param-name pattern, as the reference's: 'fsdp' →
# shard over the data axis (ZeRO-3); 'tp' → tensor/expert parallel; None →
# replicated.  Matched against the '/'-joined tree path, first match wins.
_PARAM_RULES: list = [
    # --- MoE expert weights [E, d, f] / [E, f, d]: EP over tp, FSDP inner
    (r"moe/w_(gate|up)$", ("tp", "fsdp", None)),
    (r"moe/w_down$", ("tp", None, "fsdp")),
    (r"moe/router$", ("fsdp", None)),
    (r"moe/shared_mlp/w_(gate|up)$", ("fsdp", "tp")),
    (r"moe/shared_mlp/w_down$", ("tp", "fsdp")),
    # --- attention projections
    (r"attn/w[qkv]$", ("fsdp", "tp")),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"attn/w_dq$", ("fsdp", "tp")),
    (r"attn/w_uq$", ("tp", None)),
    (r"attn/w_dkv$", ("fsdp", None)),
    (r"attn/w_kr$", ("fsdp", None)),
    (r"attn/w_u[kv]$", (None, "tp")),
    (r"(self_attn|cross_attn)/w[qkv]$", ("fsdp", "tp")),
    (r"(self_attn|cross_attn)/wo$", ("tp", "fsdp")),
    # --- dense MLP
    (r"mlp/w_(gate|up)$", ("fsdp", "tp")),
    (r"mlp/w_down$", ("tp", "fsdp")),
    # --- zamba2 shared block + lora
    (r"^shared/w[qkv]$", ("fsdp", "tp")),
    (r"^shared/wo$", ("tp", "fsdp")),
    (r"^shared/w_(gate|up)$", ("fsdp", "tp")),
    (r"^shared/w_down$", ("tp", "fsdp")),
    (r"lora_[qkv]A$", ("fsdp", None)),
    (r"lora_[qkv]B$", (None, "tp")),
    # --- mamba2
    (r"in_proj$", ("fsdp", "tp")),
    (r"out_proj$", ("tp", "fsdp")),
    (r"conv_w$", ("tp", None)),
    (r"conv_b$", ("tp",)),
    # --- embeddings / head
    (r"tok_embed$", ("tp", "fsdp")),
    (r"head$", ("fsdp", "tp")),
    (r"mtp_proj$", ("fsdp", "tp")),
    # --- everything else (norm scales, biases, A_log, D, dt_bias): replicated
]


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def _spec_for_shape(shape: tuple, roles: tuple, axes: MeshAxes) -> P:
    """Apply a role template to a shape, right-aligned (leading dims =
    stack)."""
    n_stack = len(shape) - len(roles)
    spec: list = [None] * len(shape)
    for i, role in enumerate(roles):
        dim = n_stack + i
        if dim < 0 or role is None:
            continue
        ax = {"fsdp": axes.fsdp, "tp": axes.tp}[role]
        if ax and shape[dim] % axes.size(ax) == 0 and shape[dim] > 1:
            spec[dim] = ax if len(ax) > 1 else ax[0]
    return P(*spec)


def leaf_pspec(path: str, shape: tuple, axes: MeshAxes) -> P:
    """The spec of one param leaf from its '/'-joined path and shape."""
    for pat, roles in _PARAM_RULES:
        if re.search(pat, path):
            if len(shape) < len(roles):
                return P()          # e.g. 1-D bias matched by a 2-D rule
            return _spec_for_shape(tuple(shape), roles, axes)
    return P()


def param_pspecs(params, axes: MeshAxes):
    """Spec tree matching ``params`` (a nested dict of anything with a
    ``shape``)."""
    return _map_with_path(
        params, lambda path, leaf: leaf_pspec(path, _shape(leaf), axes))


def _map_with_path(tree, fn, _prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(tree[k], fn, _prefix + (str(k),))
                for k in sorted(tree)}
    return fn("/".join(_prefix), tree)


def opt_pspecs(opt_state, params, param_specs, axes: MeshAxes):
    """Optimizer-state specs from param specs by shape matching, as the
    reference derives them: a state leaf of a param's shape takes its spec,
    ``shape[:-1]`` (a factored r) the spec minus the last dim,
    ``shape[:-2] + shape[-1:]`` (a factored c) minus the second-to-last.
    Shapes are looked up in one table, so two params of one shape share an
    entry (the later one wins), as in the reference.  Returns
    ``opt_state``'s structure with a :class:`P` at every tensor."""
    del axes
    flat_p = {}
    for leaf, spec in zip(pytree_leaves(params),
                          _spec_leaves(param_specs)):
        flat_p[_shape(leaf)] = spec

    def leaf_spec(leaf):
        sh = _shape(leaf)
        if sh == ():
            return P()
        if sh in flat_p:
            return flat_p[sh]
        for psh, spec in flat_p.items():
            parts = list(spec) + [None] * (len(psh) - len(spec))
            if sh == psh[:-1]:
                return P(*parts[:-1]) if len(parts) == len(psh) else P()
            if len(psh) >= 2 and sh == psh[:-2] + psh[-1:]:
                return P(*(parts[:-2] + parts[-1:]))
        return P()

    leaves = pytree_leaves(opt_state)
    return pytree_unflatten(opt_state, [leaf_spec(x) for x in leaves])


def _spec_leaves(specs) -> list:
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def batch_pspecs(batch, axes: MeshAxes):
    """Shard the leading (batch) dim of every input over the dp axes, when
    it divides."""
    ba = axes.batch if len(axes.batch) > 1 else (
        axes.batch[0] if axes.batch else None)

    def leaf_spec(leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return P()
        if shape[0] % axes.size(axes.batch) == 0 and shape[0] > 1:
            return P(ba, *([None] * (len(shape) - 1)))
        return P()

    return tree_map(leaf_spec, batch)


def cache_pspecs(cache, axes: MeshAxes, batch_size: int):
    """KV/state caches: batch over dp when divisible; cache length (axis 2
    of [L,B,W,...] tensors) over tp; the KV-head/state dims stay local."""
    dp_size = axes.size(axes.batch)
    tp_size = axes.size(axes.tp)
    ba = axes.batch if len(axes.batch) > 1 else (
        axes.batch[0] if axes.batch else None)
    tpa = axes.tp[0] if axes.tp else None

    def leaf_spec(leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd <= 1:
            return P()
        spec: list = [None] * nd
        if nd >= 3 and shape[1] == batch_size:
            if batch_size % dp_size == 0 and batch_size > 1:
                spec[1] = ba
            if tpa and shape[2] % tp_size == 0 and shape[2] > 1:
                spec[2] = tpa
        elif shape[0] == batch_size and batch_size % dp_size == 0 \
                and batch_size > 1:
            spec[0] = ba
        return P(*spec)

    return tree_map(leaf_spec, cache)


def _axis_dim(spec: P, name: str) -> Optional[int]:
    for i, ax in enumerate(spec):
        if ax == name or (isinstance(ax, tuple) and name in ax):
            return i
    return None


def data_dim(spec: P) -> Optional[int]:
    """The dim a spec shards over the ``data`` axis (ZeRO-3), or None."""
    return _axis_dim(spec, "data")


def model_dim(spec: P) -> Optional[int]:
    """The dim a spec shards over the ``model`` axis, or None."""
    return _axis_dim(spec, "model")


# Leaves whose ``model`` split is kept at use (expert parallelism): never
# gathered over ``model``, as the reference's make_param_constraint keeps
# their EP axis.
EXPERT_LEAF = re.compile(r"moe/w_(gate|up|down)")


# --------------------------------------------------------------------------
# The reference's constraint makers: the seams of the sharded fused step.
# Where the reference's return GSPMD sharding constraints, these take the
# ZeRO-3 plan (``sharding/zero.py::Zero3``) and return the explicit
# collectives.
# --------------------------------------------------------------------------

def make_param_constraint(zero):
    """Per stack: ``fn(stack_name) -> (stacked, i -> layer i's params)``,
    each leaf gathered whole over ``data`` and ``model`` for the layer's use
    (its resting shard stays as it is), except the MoE expert stacks
    (:data:`EXPERT_LEAF`), which keep their expert split over ``model``."""
    def for_stack(stack_name: str):
        dims = zero.dims["stacks"][stack_name]
        return lambda stacked, i: zero.layer(stacked, dims, i)
    return for_stack


def make_grad_constraint(zero):
    """Per stack: ``fn(stack_name) -> (layer gradients -> the resting
    shards' gradients)``, reduce-scattered over ``data`` then ``model`` (a
    whole leaf's all-reduced over every rank; an expert stack's not summed
    over ``model``, whose ranks hold other experts)."""
    def for_stack(stack_name: str):
        dims = zero.dims["stacks"][stack_name]
        return lambda g: zero.scatter(g, dims, drop=1)
    return for_stack


def make_residual_constraint(zero):
    """Sequence-sharding of saved layer inputs: a saved carry's activations
    are this rank's ``[B/dp, T, d]`` tile, ``T = (P + S) / tp`` with a
    modality prefix of ``P`` rows (``zero.tile``, set where the batch is
    cut, ``Zero3.rows``).  The port's model runs on the tile, so
    nothing moves: the constraint checks each saved tensor of three or more
    dims and raises ``ValueError`` for one that is not the tile."""
    def constrain(x):
        tile = zero.tile
        for t in x:
            if tile is not None and t.ndim >= 3 and tuple(t.shape[:2]) != tile:
                raise ValueError(
                    f"a saved residual {tuple(t.shape)} is not this rank's "
                    f"[B/dp, T] = {list(tile)} tile")
        return x

    return constrain
