"""Weights and optimizer state carried between the two packages as numpy.

The JAX package's parameter tree and ``OptState`` reach the port as nested
dicts of numpy arrays (the caller fetches them from JAX; the port never
imports it), and go back the same way, so both packages can compute the same
thing from the same weights.  The layouts agree — ``{"outer", "shared",
"stacks"}``, weights ``[d_in, d_out]`` — so the conversion is a dtype and
device move.  numpy has no bfloat16 of its own: bfloat16 travels as float32
(exact) and is cast on the torch side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.adalomo import FactoredState
from repro_torch.core.api import OptState
from repro_torch.core.tree import tree_map


def _tensor(x, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":       # an extension dtype torch rejects
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    # always a copy: the port updates in place and must own its memory
    t = torch.from_numpy(np.array(arr, order="C", copy=True)).to(device)
    return t.to(dtype) if dtype is not None else t


def params_from_numpy(tree, device, dtype=None) -> dict:
    """Nested dicts of arrays → the port's parameter tree on ``device``.
    ``dtype=None`` keeps each array's dtype (bfloat16 stays bfloat16)."""
    return tree_map(lambda x: _tensor(x, device, dtype), tree)


def _state(s, device):
    if len(s) == 0:                                    # sgd: no state
        return ()
    if len(s) == 3:                                    # (r, c, v)
        return FactoredState(*(None if x is None else _tensor(x, device)
                               for x in s))
    raise ValueError(f"unknown per-tensor state of {len(s)} fields")


def opt_state_from_numpy(step, moments, device) -> OptState:
    """The reference's ``OptState(step, moments)`` — moments a nested dict
    whose leaves are ``(r, c, v)`` tuples of arrays/None, or ``()`` — as the
    port's :class:`OptState` on ``device``."""
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        moments=tree_map(lambda s: _state(s, device), moments))


def to_numpy(tree):
    """Tensors → numpy arrays through dicts, tuples and states; bfloat16
    comes back as float32 (exact)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [to_numpy(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree
