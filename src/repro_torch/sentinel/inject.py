"""Fault injection — the proof harness for the sentinel (PyTorch).

Counterpart of ``repro.sentinel.inject``.  An :class:`Injection` describes
ONE deterministic fault: *what* to poison (``kind``) and *when*
(``at_step``, measured on ``SentinelState.seen``, the executed-step clock).
The guard applies it with ``torch.where`` keyed on the 0-d device bool
``seen == at_step``: nothing is read back to the host, and a re-run is
bitwise the same.

Keying on ``seen`` rather than the data-step index is deliberate: ``seen``
counts every pass through the guard and is never rewound, so after a
rollback the replayed data step has a *different* ``seen`` and the fault
does not re-fire — an injected run always completes.

Kinds:

``nan_grads`` / ``inf_grads``
    poison every float leaf of the updated params and moments — the fused
    path's equivalent of a NaN/Inf gradient (the gradient never
    materializes; its damage to the update does);
``nan_loss``
    poison only the reported loss;
``nan_batch``
    poison the float leaves of the input batch before the step runs (a
    token batch has none);
``spike``
    scale the update ``Δθ`` by ``scale`` (finite, but large enough to trip
    the EMA spike guard).

The port's step updates in place, so the update is poisoned in place too:
:meth:`Injection.poison_update` gets the pre-step snapshot and the live,
already-updated tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import leading_pieces

INJECT_KINDS = ("nan_grads", "inf_grads", "nan_loss", "nan_batch", "spike")


def float_tensors(tree) -> list:
    """The floating-point tensors of a tree of dicts, tuples and lists
    (``None`` and integer tensors skipped), in the reference's leaf
    order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in float_tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in float_tensors(x)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree]
    return []


@dataclasses.dataclass(frozen=True)
class Injection:
    """One deterministic fault.

    kind      one of :data:`INJECT_KINDS`;
    at_step   fires when ``SentinelState.seen == at_step`` (0-based
              executed-step clock, immune to rollback replay);
    scale     update multiplier for ``kind="spike"``.
    """

    kind: str = "nan_grads"
    at_step: int = 0
    scale: float = 100.0

    def __post_init__(self):
        if self.kind not in INJECT_KINDS:
            raise ValueError(
                f"unknown injection kind {self.kind!r}; valid: {INJECT_KINDS}")
        if self.at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {self.at_step}")

    # -- application (called from the guard only) ----------------------

    def _fire(self, seen: torch.Tensor) -> torch.Tensor:
        return seen == self.at_step

    def poison_batch(self, batch: dict, seen: torch.Tensor) -> dict:
        """A new batch dict with NaN in every float leaf when the fault
        fires; integer leaves (tokens, labels) pass through."""
        if self.kind != "nan_batch":
            return batch
        fire = self._fire(seen)
        return {k: torch.where(fire, torch.full_like(v, float("nan")), v)
                if v.is_floating_point() else v for k, v in batch.items()}

    def poison_update(self, snap, params, state, loss: torch.Tensor,
                      seen: torch.Tensor) -> torch.Tensor:
        """Poison the step's result **in place**: ``params`` and ``state``
        (an ``OptState``) are the live, updated trees and ``snap`` the
        pre-step params.  Returns the (possibly poisoned) loss."""
        fire = self._fire(seen)
        if self.kind in ("nan_grads", "inf_grads"):
            bad = float("nan") if self.kind == "nan_grads" else float("inf")
            for t in float_tensors(params) + float_tensors(state.moments):
                t.masked_fill_(fire, bad)
            return loss
        if self.kind == "nan_loss":
            return torch.where(fire, torch.full_like(loss, float("nan")),
                               loss)
        if self.kind == "spike":
            # θ' = θ + scale·(θ' − θ) in the leaf's dtype (one lerp, rounded
            # once; the reference rounds each bf16 op); the where leaves a
            # step that does not fire bitwise as it was; piece by piece, so
            # its temporaries stay small on the largest stacked leaves
            for o, n in zip(float_tensors(snap), float_tensors(params)):
                for oc, nc in zip(leading_pieces(o), leading_pieces(n)):
                    torch.where(fire, torch.lerp(oc, nc, self.scale), nc,
                                out=nc)
        return loss                        # nan_batch: handled upstream
