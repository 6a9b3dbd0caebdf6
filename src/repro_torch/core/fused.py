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

With ``zero`` (a :class:`~repro_torch.sharding.zero.Zero3`) the step runs
ZeRO-3 sharded over the ``data`` and ``model`` axes, the batch split over
``pod`` × ``data`` and the sequence over ``model`` (FSDP + sequence
parallelism): ``params`` and the moments are this rank's resting blocks,
the batch its rows and sequence tile, and every activation and saved
residual its ``[B/dp, S/tp, ...]`` tile (the residual constraint checks
each saved layer input).  The outer leaves are gathered once a step and
kept from the prologue to the epilogue's gradient; each layer is gathered
before its forward and again before its re-run, and dies after it (MoE
expert stacks stay split over ``model``); each layer's gradients are
reduce-scattered to the resting block (a whole leaf's summed over the
ranks) before the rule updates the block, summing its statistics over the
ranks.  The loss is this rank's share of the global one (the model's
epilogue divides by the global token count), so the gradients' sum over
the ranks is the whole batch's gradient.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.api import Opt, OptState, UpdateRule, hparams_on_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.sharding.rules import make_param_constraint

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
                    step, shards=None):
    """Apply ``rule`` leaf-wise, **in place**, with per-group hparams.

    ``states`` has one rule-state per param leaf; ``labels`` is an int tree
    matching ``params`` (from ``Opt.labels``); ``hp`` is the tuple of resolved
    per-group hparam dicts from ``Opt.resolve``; ``shards`` (a tree of
    ``TensorShard`` or None) marks the leaves that are shards of a tensor.
    Returns ``(params, states)``, the trees passed in.
    """
    if shards is None:
        tree_map(lambda p, g, s, lab: rule.update(p, g, s, hp[lab], step),
                 params, grads, states, labels)
        return params, states

    def one(p, g, s, lab, sh):
        if sh is None:
            return rule.update(p, g, s, hp[lab], step)
        return rule.update(p, g, s, hp[lab], step, shard=sh)

    tree_map(one, params, grads, states, labels, shards)
    return params, states


# --------------------------------------------------------------------------
# Layer-stack forward/backward with inline updates
# --------------------------------------------------------------------------

class StackResiduals(NamedTuple):
    """What the forward loop saves: one input carry per layer."""

    saved_x: list         # L carries (tuples of tensors)
    x_out: Any            # final carry


def _slice_layer(stacked_params, i: int):
    return tree_map(lambda t: t[i], stacked_params)


@torch.no_grad()
def stack_forward(body: Callable, stacked_params, ctx, x, *,
                  layer_fn: Callable = _slice_layer,
                  save_fn: Callable = lambda x: x) -> StackResiduals:
    """Forward loop over a layer stack, saving layer inputs.

    ``body(layer_params, ctx, x, aux) -> x`` is one layer's forward on the
    carry ``x`` (a tuple of tensors); ``aux`` is the layer index.
    ``layer_fn(stacked_params, i)`` gives layer ``i``'s params (ZeRO-3:
    gathered whole, and dropped after the layer); ``save_fn`` is applied to
    each carry saved (ZeRO-3: the residual constraint).
    """
    saved = []
    for i in range(_n_layers(stacked_params)):
        saved.append(save_fn(x))
        x = body(layer_fn(stacked_params, i), ctx, x, i)
    return StackResiduals(saved_x=saved, x_out=x)


def _layer_vjp(body, layer_p, ctx, x_in, dx, aux, act_grad: bool = False):
    """Re-run one layer with autograd on; returns (g_layer, g_shared, dx_in,
    g_act): ``g_act`` is the gradient of the ctx activation tree where
    ``act_grad`` asks for it, else None."""
    shared, ctx_act = ctx
    p_req = _grad_leaves(layer_p)
    sh_req = _grad_leaves(shared)
    act = _grad_leaves(ctx_act) if act_grad else ctx_act
    x_req = _carry_tree(x_in, requires_grad=True)
    with torch.enable_grad():
        y = body(p_req, (sh_req, act), _carry_tuple(x_req), aux)
    wrt = (p_req, sh_req, x_req) + ((act,) if act_grad else ())
    g_layer, g_shared, dx_in, *g_act = _vjp(list(y), list(dx), *wrt)
    return (g_layer, g_shared, _carry_tuple(dx_in),
            g_act[0] if act_grad else None)


def stack_backward_update(body: Callable, rule: UpdateRule, stacked_params,
                          stacked_states, ctx, residuals: StackResiduals,
                          dx_out, *, labels, hp, step,
                          act_grad: bool = False, layer_fn=None,
                          grad_fn=None, shards=None):
    """Reverse loop: per-layer VJP + immediate in-place optimizer update.

    Returns ``(dx_in, d_ctx, stacked_params, stacked_states)``: ``d_ctx`` is
    ``d_shared``, the gradient of the shared parameters summed over the
    layers; with ``act_grad`` it is ``(d_shared, d_act)``, ``d_act`` the
    gradient of the ctx activation tree (an encoder's output that every
    layer cross-attends to), summed over the layers in reverse layer order
    from zeros in the activation's own dtype, as the reference's scan carry
    sums it.  The stacked trees are the ones passed in, updated.

    ZeRO-3 (``layer_fn``, ``grad_fn``, ``shards`` from ``Zero3``): the layer
    is re-run on its gathered params, its gradients go through ``grad_fn``
    to the resting shards, and the rule updates those with ``shards``.
    """
    shared, ctx_act = ctx
    d_shared = _tree_zeros_like(shared)
    d_act = _tree_zeros_like(ctx_act) if act_grad else None
    dx = dx_out
    for i in reversed(range(_n_layers(stacked_params))):
        layer_p = tree_map(lambda t: t[i], stacked_params)
        layer_s = tree_map(lambda _, s: _slice_state(s, i), stacked_params,
                           stacked_states)
        whole = layer_p if layer_fn is None else layer_fn(stacked_params, i)
        g_layer, g_sh, dx, g_act = _layer_vjp(
            body, whole, ctx, residuals.saved_x[i], dx, i, act_grad)
        del whole
        if grad_fn is not None:
            g_layer = grad_fn(g_layer)
        # >>> the LOMO moment: this layer's grads are consumed *here* <<<
        apply_rule_tree(rule, layer_p, g_layer, layer_s, labels, hp, step,
                        shards)
        del g_layer
        d_shared = _tree_add(d_shared, g_sh)
        if act_grad:
            d_act = _tree_add(d_act, g_act)
    d_ctx = (d_shared, d_act) if act_grad else d_shared
    return dx, d_ctx, stacked_params, stacked_states


def stack_grads(body: Callable, stacked_params, ctx,
                residuals: StackResiduals, dx_out, *,
                layer_fn: Callable = _slice_layer, grad_fn=None):
    """Backward loop that only *collects* grads (no update) — used by the
    two-pass global-grad-norm mode and by fused-vs-unfused equivalence
    tests.  Returns ``(dx_in, d_shared, g_stack)``.  ZeRO-3 (``layer_fn``,
    ``grad_fn``): each layer re-run whole, its gradients kept as the resting
    shards' (summed over the ranks)."""
    shared, _ = ctx
    d_shared = _tree_zeros_like(shared)
    dx = dx_out
    per_layer = []
    for i in reversed(range(_n_layers(stacked_params))):
        layer_p = layer_fn(stacked_params, i)
        g_layer, g_sh, dx, _ = _layer_vjp(body, layer_p, ctx,
                                          residuals.saved_x[i], dx, i)
        del layer_p
        if grad_fn is not None:
            g_layer = grad_fn(g_layer)
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
                     global_grad_norm: Optional[float] = None, zero=None):
    """One fused LOMO/AdaLomo training step, **in place**.

    ``opt_state`` is the :class:`OptState` from ``opt.init(params)`` — the
    same layout as the unfused ``Opt.step`` path.  ``hparams`` follows
    ``Opt.resolve`` (dict of scalars, optional per-group overrides, bare
    scalar = lr).  Returns ``(params, new_opt_state, loss, metrics)``:
    ``params`` and the moments are the objects passed in, updated; loss and
    metrics are 0-d tensors on the device (nothing is read back here).
    ``zero``: run ZeRO-3 sharded (module docstring); the loss and metrics
    returned are then the global batch's, and ``global_grad_norm``'s norm is
    of the gradients summed over the ranks.
    """
    if zero is not None:
        from repro_torch.sharding.act import use_policy
        with use_policy(zero.policy):
            return _fused_step(spec, opt, params, opt_state, batch, hparams,
                               global_grad_norm, zero)
    return _fused_step(spec, opt, params, opt_state, batch, hparams,
                       global_grad_norm, None)


def _sharded_sqsum(zero, trees_and_dims) -> Tensor:
    """Σg² over ZeRO-3 gradients (each tree with its places tree), each
    element counted once (``Zero3.sum_once``): the blocks' squares summed
    over the ranks holding other blocks in rank order, whole leaves' once —
    the same bits on every rank."""
    from repro_torch.sharding.zero import tree_sqsums
    return zero.sum_once([t for tree, dims in trees_and_dims
                          for t in tree_sqsums(tree, dims)])


def _fused_step(spec, opt, params, opt_state, batch, hparams,
                global_grad_norm, zero):
    rule = opt.rule
    outer, shared, stacks = params["outer"], params["shared"], params["stacks"]
    device = tree_leaves(params)[0].device
    hp = hparams_on_device(opt.resolve(hparams), device)
    labels = opt.labels(params)
    step = opt_state.step + 1
    stepf = step.to(torch.float32)
    moments = opt_state.moments
    seams = {}
    if zero is not None:
        # the outer and shared leaves whole for the step; each layer whole
        # for its forward and its re-run only
        outer = zero.gather(outer, zero.dims["outer"])
        shared = zero.gather(shared, zero.dims["shared"])
        seams = {name: zero.seams(name) for name in stacks}

    # ---- forward ----
    with torch.no_grad():
        x = spec.prologue(outer, batch)
        ctx_act = spec.pro_ctx(outer, batch)
        residuals: dict = {}
        for name, stacked in stacks.items():
            kw = ({"layer_fn": seams[name]["layer_fn"],
                   "save_fn": zero.residual_fn()} if name in seams else {})
            res = stack_forward(spec.bodies[name], stacked, (shared, ctx_act),
                                x, **kw)
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
    if zero is not None:
        loss = metrics["loss"]         # the global batch's
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
            kw = {} if zero is None else {
                k: seams[name][k] for k in ("layer_fn", "grad_fn")}
            dxn, d_sh, g_stack = stack_grads(
                spec.bodies[name], stacks[name], (shared, ctx_act),
                residuals[name], dxn, **kw)
            d_shared_n = _tree_add(d_shared_n, d_sh)
            sq = sq + (_sqsum(g_stack) if zero is None else _sharded_sqsum(
                zero, [(g_stack, zero.dims["stacks"][name])]))
            del g_stack
        g_outer_n = _tree_add(g_outer_epi, prologue_grads(dxn))
        if zero is None:
            sq = sq + _sqsum(g_outer_n) + _sqsum(d_shared_n)
        else:
            sq = sq + _sharded_sqsum(zero, [
                (zero.scatter(g_outer_n, zero.dims["outer"]),
                 zero.dims["outer"]),
                (zero.scatter(d_shared_n, zero.dims["shared"]),
                 zero.dims["shared"])])
        del g_outer_n
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
            labels=labels["stacks"][name], hp=hp, step=stepf,
            **seams.get(name, {}))
        d_shared = _tree_add(d_shared, d_sh)

    # ``outer`` is updated once, after both gradients are summed.
    g_outer = _tree_add(g_outer_epi, prologue_grads(dx))
    if zero is None:
        apply_rule_tree(rule, outer, g_outer, moments["outer"],
                        labels["outer"], hp, stepf)
        apply_rule_tree(rule, shared, d_shared, moments["shared"],
                        labels["shared"], hp, stepf)
    else:
        del outer, shared, g_outer_epi
        for key, g in (("outer", g_outer), ("shared", d_shared)):
            dims = zero.dims[key]
            g = zero.scatter(g, dims)
            apply_rule_tree(rule, params[key], g, moments[key], labels[key],
                            hp, stepf, zero.shards(dims, zero.shapes[key]))

    return params, OptState(step=step, moments=moments), loss, metrics


def unfused_loss_fn(spec: FusedSpec, params, batch, *, zero=None):
    """The same model as one differentiable function — for gradient-based
    baselines and fused-vs-unfused equivalence tests.  With ``zero``
    (ZeRO-3 shards, evaluation on a mesh): the global ``batch`` is cut to
    this rank's rows, the outer leaves and each layer are gathered for
    their use, and the loss and metrics returned are the global batch's."""
    if zero is not None:
        from repro_torch.sharding.act import use_policy
        with use_policy(zero.policy):
            batch = zero.rows(batch)
            whole = {"outer": zero.gather(params["outer"], zero.dims["outer"]),
                     "shared": zero.gather(params["shared"],
                                           zero.dims["shared"])}
            loss, metrics = _loss(spec, whole["outer"], whole["shared"],
                                  params["stacks"], batch,
                                  make_param_constraint(zero))
            return metrics["loss"], metrics
    return _loss(spec, params["outer"], params["shared"], params["stacks"],
                 batch, lambda name: _slice_layer)


def _loss(spec, outer, shared, stacks, batch, layer_fn_of):
    x = spec.prologue(outer, batch)
    ctx_act = spec.pro_ctx(outer, batch)
    for name, stacked in stacks.items():
        body, layer_fn = spec.bodies[name], layer_fn_of(name)
        for i in range(_n_layers(stacked)):
            x = body(layer_fn(stacked, i), (shared, ctx_act), x, i)
    return spec.epilogue(outer, x, batch)
