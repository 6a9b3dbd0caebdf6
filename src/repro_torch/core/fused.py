"""Fused backward-and-update engine (PyTorch): LOMO's mechanism as an
explicit loop.  Counterpart of ``repro.core.fused``.

The paper fuses the optimizer step into the backward pass so that no more
than about one layer's gradients are ever resident.  The reference writes
that as a reverse ``lax.scan``; here it is a reverse Python loop:

  * models are loops over layers with stacked ``[L, ...]`` parameter dicts;
  * the forward pass runs under ``torch.no_grad()`` and saves each layer's
    *input* — nothing else;
  * the backward pass walks the layers in reverse and, for each,
      1. re-runs the layer's forward with autograd on (per-layer remat),
      2. calls ``torch.autograd.grad`` for that layer's parameter gradients
         and the gradient of its input,
      3. hands the gradients straight to the optimizer rule, which updates
         the ``[l]`` slice of the stacked parameter (a contiguous view)
         **in place**,
      4. drops them before the next layer.

No ``.grad`` field is ever set and no whole-model gradient is ever alive.
``(params, opt_state)`` are updated in place — the torch form of the
reference's donated buffers — and the dicts passed in are the ones returned.

``global_grad_norm`` reproduces LOMO's two-pass alternative: pass 1 walks the
whole backward just for the global gradient norm (holding one stack's
gradient at a time, as the reference does), pass 2 applies the clipped update.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.api import Opt, OptState, UpdateRule, hparams_on_device
from repro_torch.core.tree import tree_leaves, tree_map

Tensor = torch.Tensor


# --------------------------------------------------------------------------
# Small tree helpers
# --------------------------------------------------------------------------

def _grad_leaves(tree):
    """A copy of ``tree`` whose tensors are detached leaves that require
    grad (sharing storage with the originals)."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _vjp(outputs: list, grad_outputs: list, *input_trees) -> list:
    """Gradients of ``outputs`` w.r.t. the leaves of each of ``input_trees``,
    as a list of trees; an input the outputs do not depend on gets zeros."""
    leaves = [x for t in input_trees for x in tree_leaves(t)]
    live = [(o, g) for o, g in zip(outputs, grad_outputs) if o.requires_grad]
    if leaves and live:
        grads = torch.autograd.grad([o for o, _ in live], leaves,
                                    [g for _, g in live], allow_unused=True)
    else:
        grads = [None] * len(leaves)
    it = iter(torch.zeros_like(x) if g is None else g
              for x, g in zip(leaves, grads))
    return [tree_map(lambda _: next(it), t) for t in input_trees]


def _carry_tree(x: tuple, *, requires_grad: bool = False) -> dict:
    """A carry (tuple of tensors) as a tree, optionally of fresh leaves."""
    return {str(i): t.detach().requires_grad_(True) if requires_grad else t
            for i, t in enumerate(x)}


def _carry_tuple(tree: dict) -> tuple:
    return tuple(tree[str(i)] for i in range(len(tree)))


def _tree_add(a, b):
    return tree_map(torch.add, a, b)


def _tree_zeros_like(t):
    return tree_map(torch.zeros_like, t)


def _slice_state(state, i: int):
    """Layer ``i`` of a stacked per-tensor state (a tuple of tensors/None);
    the slices are views, so in-place updates land in the stack."""
    return type(state)(*(None if t is None else t[i] for t in state))


def _n_layers(stacked_params) -> int:
    return tree_leaves(stacked_params)[0].shape[0]


# --------------------------------------------------------------------------
# Per-tensor rule application across an arbitrary (layer) tree
# --------------------------------------------------------------------------

@torch.no_grad()
def apply_rule_tree(rule: UpdateRule, params, grads, states, labels, hp,
                    step):
    """Apply ``rule`` leaf-wise, **in place**, with per-group hparams.

    ``states`` has one rule-state per param leaf; ``labels`` is an int tree
    matching ``params`` (from ``Opt.labels``); ``hp`` is the tuple of resolved
    per-group hparam dicts from ``Opt.resolve``.  Returns ``(params,
    states)``, the trees passed in.
    """
    tree_map(lambda p, g, s, lab: rule.update(p, g, s, hp[lab], step),
             params, grads, states, labels)
    return params, states


# --------------------------------------------------------------------------
# Layer-stack forward/backward with inline updates
# --------------------------------------------------------------------------

class StackResiduals(NamedTuple):
    """What the forward loop saves: one input carry per layer."""

    saved_x: list         # L carries (tuples of tensors)
    x_out: Any            # final carry


@torch.no_grad()
def stack_forward(body: Callable, stacked_params, ctx, x) -> StackResiduals:
    """Forward loop over a layer stack, saving layer inputs.

    ``body(layer_params, ctx, x, aux) -> x`` is one layer's forward on the
    carry ``x`` (a tuple of tensors); ``aux`` is the layer index.
    """
    saved = []
    for i in range(_n_layers(stacked_params)):
        saved.append(x)
        x = body(tree_map(lambda t: t[i], stacked_params), ctx, x, i)
    return StackResiduals(saved_x=saved, x_out=x)


def _layer_vjp(body, layer_p, ctx, x_in, dx, aux):
    """Re-run one layer with autograd on; returns (g_layer, g_shared,
    dx_in)."""
    shared, ctx_act = ctx
    p_req = _grad_leaves(layer_p)
    sh_req = _grad_leaves(shared)
    x_req = _carry_tree(x_in, requires_grad=True)
    with torch.enable_grad():
        y = body(p_req, (sh_req, ctx_act), _carry_tuple(x_req), aux)
    g_layer, g_shared, dx_in = _vjp(list(y), list(dx), p_req, sh_req, x_req)
    return g_layer, g_shared, _carry_tuple(dx_in)


def stack_backward_update(body: Callable, rule: UpdateRule, stacked_params,
                          stacked_states, ctx, residuals: StackResiduals,
                          dx_out, *, labels, hp, step):
    """Reverse loop: per-layer VJP + immediate in-place optimizer update.

    Returns ``(dx_in, d_shared, stacked_params, stacked_states)``;
    ``d_shared`` is the gradient of the shared parameters summed over the
    layers.  The stacked trees are the ones passed in, updated.
    """
    shared, _ = ctx
    d_shared = _tree_zeros_like(shared)
    dx = dx_out
    for i in reversed(range(_n_layers(stacked_params))):
        layer_p = tree_map(lambda t: t[i], stacked_params)
        layer_s = tree_map(lambda _, s: _slice_state(s, i), stacked_params,
                           stacked_states)
        g_layer, g_sh, dx = _layer_vjp(body, layer_p, ctx,
                                       residuals.saved_x[i], dx, i)
        # >>> the LOMO moment: this layer's grads are consumed *here* <<<
        apply_rule_tree(rule, layer_p, g_layer, layer_s, labels, hp, step)
        del g_layer
        d_shared = _tree_add(d_shared, g_sh)
    return dx, d_shared, stacked_params, stacked_states


def stack_grads(body: Callable, stacked_params, ctx,
                residuals: StackResiduals, dx_out):
    """Backward loop that only *collects* grads (no update) — used by the
    two-pass global-grad-norm mode and by fused-vs-unfused equivalence
    tests.  Returns ``(dx_in, d_shared, g_stack)``."""
    shared, _ = ctx
    d_shared = _tree_zeros_like(shared)
    dx = dx_out
    per_layer = []
    for i in reversed(range(_n_layers(stacked_params))):
        layer_p = tree_map(lambda t: t[i], stacked_params)
        g_layer, g_sh, dx = _layer_vjp(body, layer_p, ctx,
                                       residuals.saved_x[i], dx, i)
        per_layer.append(g_layer)
        d_shared = _tree_add(d_shared, g_sh)
    per_layer.reverse()
    g_stack = tree_map(lambda *gs: torch.stack(gs), *per_layer)
    return dx, d_shared, g_stack


# --------------------------------------------------------------------------
# Whole-model fused train step for the standard decoder-LM layout.
# --------------------------------------------------------------------------

class FusedSpec(NamedTuple):
    """Loop structure of a model, as consumed by :func:`fused_train_step`.

    params layout: ``{"outer": tree, "shared": tree, "stacks": {name: [L,...]}}``
      * ``outer``  — prologue/epilogue parameters (embeddings, final norm, head)
      * ``shared`` — parameters used by *every* layer; grads accumulate
        across layers, updated once per step
      * ``stacks`` — ordered stacked layer trees

    functions:
      * ``prologue(outer, batch) -> x0`` (the carry: a tuple of tensors)
      * ``bodies[name](layer_params, ctx, x, aux) -> x`` with
        ``ctx = (shared, pro_ctx)``
      * ``epilogue(outer, x, batch) -> (loss, metrics)``
      * ``pro_ctx(outer, batch) -> dict`` (non-learned context; default {})
    """

    prologue: Callable
    bodies: dict
    epilogue: Callable
    pro_ctx: Callable = lambda outer, batch: {}


def _sqsum(tree) -> Tensor:
    return sum(torch.sum(torch.square(g.to(torch.float32)))
               for g in tree_leaves(tree))


def fused_train_step(spec: FusedSpec, opt: Opt, params, opt_state: OptState,
                     batch, *, hparams=None,
                     global_grad_norm: Optional[float] = None):
    """One fused LOMO/AdaLomo training step, **in place**.

    ``opt_state`` is the :class:`OptState` from ``opt.init(params)`` — the
    same layout as the unfused ``Opt.step`` path.  ``hparams`` follows
    ``Opt.resolve`` (dict of scalars, optional per-group overrides, bare
    scalar = lr).  Returns ``(params, new_opt_state, loss, metrics)``:
    ``params`` and the moments are the objects passed in, updated; loss and
    metrics are 0-d tensors on the device (nothing is read back here).
    """
    rule = opt.rule
    outer, shared, stacks = params["outer"], params["shared"], params["stacks"]
    device = tree_leaves(params)[0].device
    hp = hparams_on_device(opt.resolve(hparams), device)
    labels = opt.labels(params)
    step = opt_state.step + 1
    stepf = step.to(torch.float32)
    moments = opt_state.moments

    # ---- forward ----
    with torch.no_grad():
        x = spec.prologue(outer, batch)
        ctx_act = spec.pro_ctx(outer, batch)
        residuals: dict = {}
        for name, stacked in stacks.items():
            res = stack_forward(spec.bodies[name], stacked, (shared, ctx_act),
                                x)
            residuals[name] = res
            x = res.x_out

    # ---- epilogue forward + backward ----
    outer_req = _grad_leaves(outer)
    x_req = _carry_tree(x, requires_grad=True)
    with torch.enable_grad():
        loss, metrics = spec.epilogue(outer_req, _carry_tuple(x_req), batch)
    g_outer_epi, dx_epi = _vjp([loss], [torch.ones_like(loss)], outer_req,
                               x_req)
    dx_epi = _carry_tuple(dx_epi)
    loss = loss.detach()
    metrics = {k: v.detach() for k, v in metrics.items()}
    del outer_req, x_req

    def prologue_grads(dx):
        """Gradient of the prologue w.r.t. ``outer`` (re-run: it is an
        embedding lookup, and ``outer`` is not updated before this)."""
        o_req = _grad_leaves(outer)
        with torch.enable_grad():
            x0 = spec.prologue(o_req, batch)
        return _vjp(list(x0), list(dx), o_req)[0]

    if global_grad_norm is not None:
        # LOMO's two-pass mode (paper §2.1): pass 1 walks the entire backward
        # graph just to obtain the global grad norm.
        sq = torch.zeros((), dtype=torch.float32, device=device)
        dxn = dx_epi
        d_shared_n = _tree_zeros_like(shared)
        for name in reversed(list(stacks.keys())):
            dxn, d_sh, g_stack = stack_grads(
                spec.bodies[name], stacks[name], (shared, ctx_act),
                residuals[name], dxn)
            d_shared_n = _tree_add(d_shared_n, d_sh)
            sq = sq + _sqsum(g_stack)
            del g_stack
        sq = sq + _sqsum(_tree_add(g_outer_epi, prologue_grads(dxn)))
        sq = sq + _sqsum(d_shared_n)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp_max(global_grad_norm / (gnorm + 1e-6), 1.0)
        # Fold the clip into every group's lr — hparams stay data.
        hp = tuple({**d, "lr": d["lr"] * scale} for d in hp)

    # ---- backward + inline update ----
    dx = dx_epi
    d_shared = _tree_zeros_like(shared)
    for name in reversed(list(stacks.keys())):
        dx, d_sh, _, _ = stack_backward_update(
            spec.bodies[name], rule, stacks[name], moments["stacks"][name],
            (shared, ctx_act), residuals[name], dx,
            labels=labels["stacks"][name], hp=hp, step=stepf)
        d_shared = _tree_add(d_shared, d_sh)

    # ``outer`` is updated once, after both gradients are summed.
    g_outer = _tree_add(g_outer_epi, prologue_grads(dx))
    apply_rule_tree(rule, outer, g_outer, moments["outer"], labels["outer"],
                    hp, stepf)
    apply_rule_tree(rule, shared, d_shared, moments["shared"],
                    labels["shared"], hp, stepf)

    return params, OptState(step=step, moments=moments), loss, metrics


def unfused_loss_fn(spec: FusedSpec, params, batch):
    """The same model as one differentiable function — for gradient-based
    baselines and fused-vs-unfused equivalence tests."""
    outer, shared, stacks = params["outer"], params["shared"], params["stacks"]
    x = spec.prologue(outer, batch)
    ctx_act = spec.pro_ctx(outer, batch)
    for name, stacked in stacks.items():
        body = spec.bodies[name]
        for i in range(_n_layers(stacked)):
            x = body(tree_map(lambda t: t[i], stacked), (shared, ctx_act), x,
                     i)
    return spec.epilogue(outer, x, batch)
