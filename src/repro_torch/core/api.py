"""Opt v2 — one composable, introspectable optimizer API (PyTorch).

Counterpart of ``repro.core.api``; the contract is the reference's:

    opt   = Opt(rule, groups=(GroupSpec(...), ...))
    state = opt.init(params)                         # OptState
    params, state = opt.step(params, grads, state, hparams)

* **Hyperparameters are call-time data.**  ``hparams`` is a plain dict of
  scalars (floats or 0-d tensors) passed on every step; a bare scalar is
  shorthand for ``{"lr": scalar}``; per-group overrides ride under a
  ``"groups"`` key.  A changed value rebuilds nothing.
* **State is data.**  ``OptState(step, moments)`` holds one global step
  scalar (int32, 0-d, on the parameters' device) and a moments tree that
  mirrors ``params`` — the same layout as the reference's, leaf for leaf.
* **Param groups are path labels** (:class:`GroupSpec`).
* **Updates are in place** — the torch form of the reference's donated
  ``(params, opt_state)``: ``step`` writes the new values into the tensors
  it was given and returns the same ``params`` dict.

A top-level ``"stacks"`` key marks layer stacks ``[L, ...]``; where the
reference ``vmap``s a rule over L, the port passes ``batch_dims=1`` so that
factoring and the grouped-RMS axes see the per-layer shape.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Mapping, NamedTuple, Optional, Union

import torch

from repro_torch.core.adalomo import device_scalar
from repro_torch.core.tree import tree_flatten_with_path, tree_map

Tensor = torch.Tensor

# Top-level key marking [L, ...] layer stacks (core/fused.py layout).
STACKS_KEY = "stacks"


# --------------------------------------------------------------------------
# Per-tensor rules: init/update with hyperparameters as data
# --------------------------------------------------------------------------

class UpdateRule(NamedTuple):
    """A per-tensor optimizer rule.

    ``init(param, factored=None, batch_dims=0) -> state`` — per-tensor state.
    ``update(param, grad, state, hp, step, batch_dims=0) -> (param, state)``
    — one step, written **in place** into ``param`` and the state's tensors,
    which are returned; ``hp`` is a fully-resolved dict containing every key
    in ``hparams``; ``step`` is the 1-based global step as float32.
    ``batch_dims`` counts leading dims that index independent tensors.
    ``hparams`` declares the accepted dynamic hyperparameters and defaults.
    """

    name: str
    init: Callable[..., Any]
    update: Callable[..., tuple]
    hparams: dict
    # Analytic per-tensor optimizer-state bytes.
    state_bytes: Callable[[Tensor], int]


def _state_tensors(st) -> list:
    if isinstance(st, Tensor):
        return [st]
    if isinstance(st, (tuple, list)):
        return [t for s in st for t in _state_tensors(s)]
    return []


def make_rule(name: str, init_fn, update_fn, hparams: Mapping[str, Any]
              ) -> UpdateRule:
    """Assemble an :class:`UpdateRule`, deriving ``state_bytes`` from init
    on the meta device (nothing is allocated)."""

    def state_bytes(param: Tensor) -> int:
        st = init_fn(torch.empty(param.shape, dtype=param.dtype,
                                 device="meta"))
        return sum(t.numel() * t.element_size() for t in _state_tensors(st))

    return UpdateRule(name=name, init=init_fn, update=update_fn,
                      hparams=dict(hparams), state_bytes=state_bytes)


class OptState(NamedTuple):
    """Whole-tree optimizer state: ONE step scalar + per-tensor moments."""

    step: Tensor           # 0-d int32, 1-based after first update
    moments: Any           # tree matching params, of per-tensor states


# --------------------------------------------------------------------------
# Path-based param-group labeling
# --------------------------------------------------------------------------

def path_str(key_path) -> str:
    """'outer/embed' / 'stacks/blocks/w_qkv' — the string GroupSpec regexes
    match against."""
    return "/".join(str(k) for k in key_path)


@dataclasses.dataclass(frozen=True)
class LeafInfo:
    """What a group predicate gets to see about one parameter leaf."""

    path: str
    shape: tuple
    stacked: bool    # leading dim is a layer-stack axis ("stacks" subtree)

    @property
    def tensor_shape(self) -> tuple:
        """Shape of the per-tensor unit the rule sees (stack dim stripped)."""
        return self.shape[1:] if self.stacked else self.shape

    @property
    def tensor_ndim(self) -> int:
        return len(self.tensor_shape)


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One param group: match rule + hparam overrides + state masks.

    ``match`` is a regex (``re.search`` on the leaf's path string) or a
    predicate ``f(LeafInfo) -> bool``.  The first matching GroupSpec wins;
    unmatched leaves belong to the default group.  ``factored=False`` forces
    unfactored second-moment state for rules with factored state.
    """

    name: str
    match: Union[str, Callable[[LeafInfo], bool]]
    hparams: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    factored: Optional[bool] = None

    def matches(self, info: LeafInfo) -> bool:
        if callable(self.match):
            return bool(self.match(info))
        return re.search(self.match, info.path) is not None


def no_decay_1d(name: str = "no_decay") -> GroupSpec:
    """No weight decay on 1-D tensors (norm scales, biases) — per-tensor
    ndim, so a [L, d] stacked norm scale counts as 1-D."""
    return GroupSpec(name, match=lambda i: i.tensor_ndim <= 1,
                     hparams={"weight_decay": 0.0})


def _leaf_info(key_path, leaf) -> LeafInfo:
    stacked = (len(key_path) >= 1 and key_path[0] == STACKS_KEY
               and getattr(leaf, "ndim", 0) >= 1)
    return LeafInfo(path=path_str(key_path), shape=tuple(leaf.shape),
                    stacked=stacked)


def _check_hparam_keys(rule: UpdateRule, d: Mapping, what: str) -> None:
    unknown = sorted(set(d) - set(rule.hparams))
    if unknown:
        raise KeyError(
            f"rule {rule.name!r} does not accept {what} {unknown}; "
            f"accepted hyperparameters: {sorted(rule.hparams)}")


def hparams_on_device(hp: tuple, device) -> tuple:
    """Resolved hparam dicts with every value a 0-d float32 tensor on
    ``device`` (see :func:`repro_torch.core.adalomo.device_scalar`)."""
    return tuple({k: device_scalar(v, device) for k, v in d.items()}
                 for d in hp)


# --------------------------------------------------------------------------
# The optimizer object
# --------------------------------------------------------------------------

class Opt:
    """A per-tensor rule + param groups = a whole-tree optimizer.

    One instance drives the unfused path (:meth:`step`), the fused backward
    engine (``core/fused.py``) and — through the rule's backend dispatch —
    the CUDA kernels, all over the same :class:`OptState` layout.
    """

    def __init__(self, rule: UpdateRule, groups: tuple = ()):
        names = [g.name for g in groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate group names: {names}")
        for g in groups:
            _check_hparam_keys(rule, g.hparams, f"group {g.name!r} hparams")
        self.rule = rule
        self.groups = tuple(groups)

    @property
    def name(self) -> str:
        return self.rule.name

    # ---------------- labeling & hparam resolution ----------------
    def _flat_infos(self, params):
        flat = tree_flatten_with_path(params)
        infos = [_leaf_info(kp, leaf) for kp, leaf in flat]
        labels = []
        for info in infos:
            idx = 0
            for i, g in enumerate(self.groups):
                if g.matches(info):
                    idx = i + 1
                    break
            labels.append(idx)
        return flat, infos, labels

    def labels(self, params):
        """Tree of group indices (0 = default, i+1 = groups[i]) matching
        ``params`` — the introspectable label assignment."""
        _, _, labels = self._flat_infos(params)
        it = iter(labels)
        return tree_map(lambda _: next(it), params)

    def resolve(self, hparams=None) -> tuple:
        """Resolved per-group hparam dicts, indexed by label.

        Merge order (later wins): rule defaults < call-time base <
        GroupSpec static overrides < call-time ``hparams["groups"][name]``.
        Unknown keys raise a KeyError naming the accepted set.
        """
        if hparams is None:
            hparams = {}
        if not isinstance(hparams, Mapping):
            hparams = {"lr": hparams}
        user = dict(hparams)
        group_over = dict(user.pop("groups", None) or {})
        _check_hparam_keys(self.rule, user, "hparams")
        known = {g.name for g in self.groups}
        unknown_groups = sorted(set(group_over) - known)
        if unknown_groups:
            raise KeyError(f"unknown group overrides {unknown_groups}; "
                           f"groups: {sorted(known)}")
        base = {**self.rule.hparams, **user}
        out = [base]
        for g in self.groups:
            over = dict(group_over.get(g.name, {}))
            _check_hparam_keys(self.rule, over,
                               f"group {g.name!r} call-time hparams")
            out.append({**base, **g.hparams, **over})
        return tuple(out)

    def _group_of(self, label: int) -> Optional[GroupSpec]:
        return None if label == 0 else self.groups[label - 1]

    # ---------------- init / step ----------------
    def init(self, params) -> OptState:
        """Per-tensor state for every leaf, on the leaf's device; for
        ``stacks`` leaves state[i] == rule.init(param[i])."""
        flat, infos, labels = self._flat_infos(params)
        states = []
        for (_, leaf), info, lab in zip(flat, infos, labels):
            g = self._group_of(lab)
            factored = g.factored if g is not None else None
            states.append(self.rule.init(leaf, factored=factored,
                                         batch_dims=int(info.stacked)))
        it = iter(states)
        device = flat[0][1].device if flat else torch.device("cpu")
        return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                        moments=tree_map(lambda _: next(it), params))

    @torch.no_grad()
    def step(self, params, grads, state: OptState, hparams=None, *,
             shards=None) -> tuple:
        """One unfused optimizer step, **in place**: θ, s ← rule(θ, g, s, hp)
        per tensor, stacks with ``batch_dims=1`` so the math is identical to
        the fused path.  ``shards`` (a tree of ``sharding.zero.TensorShard``
        or None, ``Zero3.tree_shards``) marks the leaves that are one rank's
        ZeRO-3 block of a tensor; the rule gets each as ``shard=``, as the
        fused engine gives it.  Returns ``(params, new_state)``; ``params``
        and the moments are the objects that were passed in."""
        flat, infos, labels = self._flat_infos(params)
        if not flat:
            return params, state
        device = flat[0][1].device
        hp = hparams_on_device(self.resolve(hparams), device)
        g_flat = [g for _, g in tree_flatten_with_path(grads)]
        s_flat = [s for _, s in tree_flatten_with_path(state.moments)]
        sh_flat = ([None] * len(flat) if shards is None
                   else [sh for _, sh in tree_flatten_with_path(shards)])
        new_step = state.step + 1
        stepf = new_step.to(torch.float32)
        for (_, p), g, s, sh, info, lab in zip(flat, g_flat, s_flat, sh_flat,
                                               infos, labels):
            kw = {} if sh is None else {"shard": sh}
            self.rule.update(p, g, s, hp[lab], stepf,
                             batch_dims=int(info.stacked), **kw)
        return params, OptState(step=new_step, moments=state.moments)

    # ---------------- introspection ----------------
    def state_bytes(self, params) -> int:
        """Analytic optimizer-state footprint, honoring group state masks."""
        flat, infos, labels = self._flat_infos(params)
        total = 0
        for (_, leaf), info, lab in zip(flat, infos, labels):
            g = self._group_of(lab)
            st = self.rule.init(
                torch.empty(leaf.shape, dtype=leaf.dtype, device="meta"),
                factored=g.factored if g is not None else None,
                batch_dims=int(info.stacked))
            total += sum(t.numel() * t.element_size()
                         for t in _state_tensors(st))
        return total

    def describe(self, params) -> dict:
        """Per-group accounting: leaf paths, param counts, hparam defaults."""
        _, infos, labels = self._flat_infos(params)
        hp = self.resolve()
        out = {}
        for lab, name in enumerate(
                ["default"] + [g.name for g in self.groups]):
            leaves = [info for info, l_ in zip(infos, labels) if l_ == lab]
            out[name] = {
                "paths": [i.path for i in leaves],
                "n_params": sum(math.prod(i.shape) for i in leaves),
                "hparams": {k: float(v) for k, v in hp[lab].items()},
            }
        return out
