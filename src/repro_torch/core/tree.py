"""Nested-dict trees: the port's stand-in for JAX pytrees.

Parameters, gradients, labels and optimizer moments are plain nested dicts.
Anything that is not a dict is a leaf — a tensor, a per-tensor optimizer
state (a tuple), an int label, or ``None``.  Dict keys are visited in sorted
order, as JAX visits them, so leaf order and path strings agree with the
reference leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_flatten_with_path(tree, _prefix: tuple = ()) -> list:
    """``[(path_tuple, leaf), ...]`` in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_flatten_with_path(tree[k], _prefix + (str(k),)))
        return out
    return [(_prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Apply ``fn`` at every leaf of ``tree``; ``rest`` trees are walked
    along it and may hold whole subtrees (tuples, states) at its leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def pytree_leaves(tree) -> list:
    """Leaves in the order of JAX's ``tree_flatten``: dict keys sorted,
    tuples (NamedTuples included) and lists expanded in order, ``None`` no
    leaf at all.  ``tree_leaves`` above stops at tuples, which are whole
    per-tensor states there; a checkpoint needs every tensor, in the order
    the JAX package writes them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in pytree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in pytree_leaves(t)]
    return [tree]


def pytree_unflatten(template, leaves: list):
    """Inverse of :func:`pytree_leaves`: ``template``'s structure (dicts,
    tuples and NamedTuples of their own types, lists, ``None`` in place)
    with ``leaves`` in its leaf positions."""
    want = len(pytree_leaves(template))
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} leaves for a template of {want}")
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            vals = [build(x) for x in t]
            if isinstance(t, list):
                return vals
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return next(it)

    return build(template)
