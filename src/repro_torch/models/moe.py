"""Fine-grained Mixture-of-Experts FFN (DeepSeek-MoE style), PyTorch.
Counterpart of ``repro.models.moe`` on one device (its ``_moe_ffn_local``).

Tokens are placed into a per-expert capacity buffer ``[B, E, C + 1, d]``
(one ``index_put_`` a top-k slot, never a ``[T, E, C]`` one-hot), the
experts run as batched matrix products over E, and the results are gathered
back and combined with the gate weights.  Capacity-based dropping (GShard)
keeps shapes static: a token past its expert's C slots goes to the waste
slot C, whose output is zero, and falls through on the residual path.  The
switch-style load-balance loss is returned per call; the train body adds it
to the carry's ``aux_loss``.

Everything stays on the device: routing, slot assignment and drops are
tensor ops (no boolean-mask indexing, no ``nonzero``), so a train step keeps
its one host sync.  Kept ``(b, e, slot)`` triples are unique, so no two
kept writes meet and the gathers' backward adds one value a kept slot: the
same inputs give the same bits.

On a batch split over ranks (``sharding.act``) the load-balance loss's
two E-vectors, means over the global batch, are averaged over the ranks
before their product, as the reference's ``pmean`` over the mesh does;
capacity and slots are per row, so the split drops the same tokens.

With a model axis (sequence parallelism) :func:`moe_ffn` runs expert
parallel, as the reference's ``_moe_ffn_shardmap``, where the axis divides
the routed experts: each model rank holds E/tp experts (never gathered
over ``model``), gathers its rows' sequence tiles whole, routes the whole
sequence in fp32 exactly as one device does (so slots, capacity and drops
are the same on every rank), dispatches only the tokens routed to its
experts, runs them, and reduce-scatters the partial outputs back to its
tile.  Where the axis does not divide them, it takes the reference's
fallback (``_moe_ffn_local`` under GSPMD): the expert stacks rest whole on
every model rank (the rules' shape guard), each rank runs every expert on
the whole sequence and keeps its tile's rows.  The shared experts run on
the tile.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding.act import batch_mean, current_policy

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int                 # routed experts (E)
    top_k: int
    d_ff_expert: int              # fine-grained expert width
    n_shared: int = 0             # always-on shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # deepseek-v3 uses sigmoid routing with normalized top-k weights
    router_score: str = "softmax"  # or "sigmoid"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_init(gen, d_model: int, cfg: MoEConfig, *, dtype=torch.float32,
             device, out: Optional[dict] = None) -> dict:
    """The reference's layout and scales: an fp32 router ``[d, E]``, expert
    stacks ``w_gate``/``w_up [E, d, f]`` and ``w_down [E, f, d]`` in
    ``dtype``, and the shared experts as one GLU MLP of width
    ``n_shared * f``; drawn into ``out`` (the same tree) where given."""
    E, f = cfg.n_routed, cfg.d_ff_expert
    o = out or {}
    p = {
        "router": L.linear_init(gen, d_model, E, dtype=torch.float32,
                                device=device, out=o.get("router")),
        "w_gate": L.normal_init(gen, (E, d_model, f), d_model ** -0.5,
                                dtype=dtype, device=device,
                                out=o.get("w_gate")),
        "w_up": L.normal_init(gen, (E, d_model, f), d_model ** -0.5,
                              dtype=dtype, device=device, out=o.get("w_up")),
        "w_down": L.normal_init(gen, (E, f, d_model), f ** -0.5,
                                dtype=dtype, device=device,
                                out=o.get("w_down")),
    }
    if cfg.n_shared:
        fs = cfg.n_shared * f
        sh = o.get("shared_mlp", {})
        p["shared_mlp"] = {
            "w_gate": L.linear_init(gen, d_model, fs, dtype=dtype,
                                    device=device, out=sh.get("w_gate")),
            "w_up": L.linear_init(gen, d_model, fs, dtype=dtype,
                                  device=device, out=sh.get("w_up")),
            "w_down": L.linear_init(gen, fs, d_model, dtype=dtype,
                                    device=device, out=sh.get("w_down")),
        }
    return p


def capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    """Slots per expert and group: the reference's Python float arithmetic
    and rounding (4 x 1024 tokens, top-6 of 64 -> 124; one token -> 4)."""
    c = int(cfg.top_k * tokens_per_group * cfg.capacity_factor
            / cfg.n_routed) + 1
    return _round_up(max(c, 4), 4)


def _one_hot(idx: Tensor, n: int, dtype) -> Tensor:
    # a comparison, not F.one_hot: nothing is checked on the host
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params: dict, x: Tensor, cfg: MoEConfig) -> tuple:
    """Routing of ``x [B, S, d]``: ``(gates [B,S,K] fp32, experts [B,S,K]
    int64, slot [B,S,K] int64, keep [B,S,K] bool, aux)``.  Scores in fp32
    from ``x.float() @ router``; top-k descending; gates renormalised by
    ``max(sum, 1e-9)``; slots in flattened ``(s, k)`` order by a cumulative
    count per expert; a slot at or past C is dropped to the waste slot C."""
    B, S, _ = x.shape
    E, K = cfg.n_routed, cfg.top_k
    C = capacity(S, cfg)
    logits = torch.matmul(x.to(torch.float32), params["router"])  # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    scores = torch.sigmoid(logits) if cfg.router_score == "sigmoid" else probs
    gate_vals, expert_idx = torch.topk(scores, K, dim=-1)         # [B,S,K]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)

    # load-balance aux loss (Switch/GShard): E * sum_e f_e * p_e, with the
    # softmax probabilities for either router score
    probs_mean = batch_mean(torch.mean(probs, dim=(0, 1)))        # [E]
    frac_tokens = batch_mean(torch.mean(
        _one_hot(expert_idx[..., 0], E, torch.float32), dim=(0, 1)))
    aux = cfg.router_aux_weight * E * torch.sum(frac_tokens * probs_mean)

    flat_idx = expert_idx.reshape(B, S * K)
    pos_in_e = torch.cumsum(_one_hot(flat_idx, E, torch.int32), dim=1) - 1
    pos = torch.gather(pos_in_e, 2, flat_idx[..., None])[..., 0]  # [B,SK]
    keep = pos < C
    slot = torch.where(keep, pos, C).reshape(B, S, K).to(torch.int64)
    return gate_vals, expert_idx, slot, keep.reshape(B, S, K), aux


def moe_ffn(params: dict, x: Tensor, cfg: MoEConfig) -> tuple:
    """``x [B, S, d]`` (B token groups of S) -> ``(y [B, S, d], aux)``.

    Under a policy with a model axis (module docstring) ``x`` is this
    rank's sequence tile.  The routing, on the sequence gathered whole, is
    every rank's and one device's, and so is the load-balance loss: its
    E-vectors go through ``batch_mean``, whose backward counts the model
    ranks' identical copies once.

    Expert parallel (``tp`` divides the experts): the stacks hold this
    rank's E/tp experts, and its output sums only their gated outputs, so
    its router gradient through the gates is partial; the router's
    gradient sum over the ranks completes it.

    Indivisible experts: the output is the whole sequence's slice at the
    tile, so its gradient is zero outside the tile, and each rank's expert
    and router gradients are those of its own tile's tokens, partial sums
    that ``Zero3.scatter`` adds over ``model`` as for any leaf the axis
    does not split; the gathered input's gradient goes back through
    ``gather_seq``'s reduce-scatter.  The slice moves nothing, where a
    ``scatter_seq`` of ``y / tp`` would sum tp equal copies, rounded."""
    pol = current_policy()
    if pol is None or pol.model_group is None:
        y, aux = _routed(params, x, cfg, 0, cfg.n_routed)
    else:
        from repro_torch.sharding import collectives as C
        whole = C.gather_seq(x, 1, pol.model_group)
        if cfg.n_routed % pol.tp_size:
            S = x.shape[1]
            y, aux = _routed(params, whole, cfg, 0, cfg.n_routed)
            y = y[:, pol.tile_index * S:(pol.tile_index + 1) * S]
        else:
            n = cfg.n_routed // pol.tp_size
            y, aux = _routed(params, whole, cfg, pol.tile_index * n, n)
            # the experts' partial outputs summed over the ranks, landing
            # on the tile (the backward gathers dy whole)
            y = C.scatter_seq(y, 1, pol.model_group)
    if cfg.n_shared:
        y = y + L.glu_mlp(params["shared_mlp"], x)
    return y, aux


def _routed(params: dict, x: Tensor, cfg: MoEConfig, first: int,
            n: int) -> tuple:
    """The routed experts ``first .. first + n - 1`` (the expert stacks'
    ``n``) on ``x [B, S, d]``: ``(y, aux)``, y the gated sum of those
    experts' outputs (all of them when ``n`` is ``n_routed``)."""
    B, S, d = x.shape
    K = cfg.top_k
    C = capacity(S, cfg)
    gate_vals, idx, slot, keep, aux = route(params, x, cfg)
    if n < cfg.n_routed:
        # another rank's expert: not dispatched here (the waste slot) and
        # not combined
        idx = idx - first
        mine = (idx >= 0) & (idx < n)
        idx = torch.clamp(idx, 0, n - 1)
        slot = torch.where(mine, slot, C)
        keep = keep & mine

    # one write a top-k slot into [B, n, C+1, d]; kept (b, e, slot) triples
    # are unique, dropped tokens all land in the waste slot C (cut off)
    b_ix = torch.arange(B, device=x.device)[:, None].expand(B, S)
    buf = x.new_zeros((B, n, C + 1, d))
    for k in range(K):
        buf.index_put_((b_ix, idx[:, :, k], slot[:, :, k]), x)
    buf = buf[:, :, :C]                                           # [B,n,C,d]

    # the experts, batched over n
    h = (L.ACTS["silu"](torch.einsum("becd,edf->becf", buf,
                                     params["w_gate"]))
         * torch.einsum("becd,edf->becf", buf, params["w_up"]))
    y_buf = torch.einsum("becf,efd->becd", h, params["w_down"])
    y_buf = F.pad(y_buf, (0, 0, 0, 1))                    # waste slot = 0

    # gather back per slot, combined in k order, each gate cast first
    y = torch.zeros_like(x)
    for k in range(K):
        yk = y_buf[b_ix, idx[:, :, k], slot[:, :, k]]             # [B,S,d]
        w = (gate_vals[:, :, k] * keep[:, :, k]).to(yk.dtype)
        y = y + yk * w[..., None]
    return y, aux
