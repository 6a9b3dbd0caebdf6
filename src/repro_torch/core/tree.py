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
