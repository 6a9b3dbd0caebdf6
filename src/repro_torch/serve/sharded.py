"""Per-rank prefill and decode on a mesh for the transformer family.

The reference serves a mesh through GSPMD: its single-device
``make_prefill_step`` / ``make_decode_step`` lowered with the params under
``param_pspecs``, the batch under ``batch_pspecs`` and the ring cache under
``cache_pspecs``, and XLA partitions the step.  Here each rank runs its own
share of the same function, with the collectives explicit:

  * **params** rest as the train plan rests them (``sharding/zero.py::Zero3``)
    and are gathered a layer at a time (``Zero3.layer``), the outer leaves
    once a step (``Zero3.gather``); the expert stacks keep their split over
    ``model`` in the optimized plan.  No whole model is ever held.
  * **the ring cache** rests as ``rules.cache_pspecs`` places it: the rows
    over ``pod`` × ``data``, the slots ``W`` (dim 2 of ``[L, B, W, ...]``)
    over ``model`` where each divides (``Zero3.cache_block``); ``pos`` and
    ``cur`` whole on every rank.
  * **prefill** runs under the plan's activation policy: the rank's rows and
    sequence tile (``Zero3.rows``), K/V (MLA: the latent) gathered over
    ``model`` for attention, from which the rank cuts its block of slots
    (slot ``j`` holds position ``S - W + j``).  The tile holding position
    ``S - 1`` provides the last logits: each rank's last hidden row is
    gathered over ``model`` and every rank computes the same logits.
  * **decode** never tiles (a one-token step cannot be cut over ``model``):
    the ``model`` ranks hold the same rows (``Zero3._batch_rows``).  The
    token's slot ``cur % W`` is written by the rank that owns it, as a
    masked write at a clamped local index (no host read).  Each rank
    attends over its own block of slots — GQA through K4's partial entry
    (``kernels/decode_attention``), MLA by a plain partial softmax over its
    latent slots — to ``(o, lse)``, and :func:`merge_partials` combines the
    ranks' pairs in rank order in fp32, so every ``model`` rank holds the
    same bits.  An MoE layer runs the rank's own experts on the rows and
    sums the outputs over ``model`` in rank order (the train path's gather
    of the sequence over ``model`` would gather one token ``tp`` times).

``optimized=False`` follows ``Zero3(optimized=False)``: prefill has no
tile (every ``model`` rank runs its rows' whole sequence and cuts its block
of slots), expert stacks are gathered whole; decode is otherwise the same.

The decode step gathers every layer's weights for one token: its
collective bytes are about the model's a step, the cost of this layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import _routed
from repro_torch.sharding import collectives as C
from repro_torch.sharding.act import model_size, use_policy
from repro_torch.sharding.zero import Zero3

Tensor = torch.Tensor


def combine_partials(o: Tensor, lse: Tensor) -> Tensor:
    """The attention over the union of R blocks of slots from each block's
    ``o [R, ..., D]`` and ``lse [R, ...]`` (fp32): ``sum_r e^(lse_r - M)
    o_r / sum_r e^(lse_r - M)``, ``M = max_r lse_r``, summed in block order
    in fp32.  A block with ``lse = -inf`` weighs 0; where every block is
    ``-inf`` the result is 0, as K4's is for a row with no valid slot."""
    m = torch.clamp_min(torch.amax(lse, dim=0),
                        torch.finfo(torch.float32).min)
    num = torch.zeros_like(o[0])
    den = torch.zeros_like(lse[0])
    for r in range(o.shape[0]):
        w = torch.exp(lse[r] - m)
        num = num + w[..., None] * o[r]
        den = den + w
    return num / torch.clamp_min(den, 1e-30)[..., None]


def merge_partials(o: Tensor, lse: Tensor, group) -> Tensor:
    """This rank's ``(o [..., D], lse [...])`` merged with those of the
    other ranks of ``group`` (one all-gather of both) by
    :func:`combine_partials`, in fp32: bit-identical on every rank.  ``o``
    itself with no group."""
    if group is None:
        return o
    pack = torch.cat([o, lse[..., None]], dim=-1)[None]
    parts = C.all_gather(pack, 0, group)
    return combine_partials(parts[..., :-1], parts[..., -1])


def _write(cache: Tensor, own: Tensor, idx: Tensor, x: Tensor) -> None:
    """``x [B, 1, ...]`` into slot ``idx`` of ``cache [B, Wl, ...]`` in place
    where ``own`` (a 0-d bool), the slot's own contents back where not."""
    cache.index_copy_(1, idx, torch.where(own, x, cache.index_select(1, idx)))


def _decode_gqa(p: dict, cfg, h: Tensor, kc: Tensor, vc: Tensor,
                slots: dict, rope: tuple, group) -> Tensor:
    """One-token GQA decode of ``h [B,1,d]`` against this rank's block of
    slots ``kc``/``vc [B,Wl,K,dh]`` (K4's partial entry), merged over
    ``group``."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_partial)
    B = h.shape[0]
    q, k, v = T._qkv(p, cfg, h, *rope)
    _write(kc, slots["own"], slots["idx"], k)
    _write(vc, slots["own"], slots["idx"], v)
    o, lse = decode_attention_partial(q, kc, vc, slots["pos"], slots["cur"],
                                      window=cfg.window)
    o = merge_partials(o, lse, group).to(q.dtype)
    return L.dense(o.reshape(B, 1, -1), p["wo"])


def _decode_mla(p: dict, cfg, h: Tensor, ckv_c: Tensor, kr_c: Tensor,
                slots: dict, rope: tuple, group) -> Tensor:
    """``transformer._decode_mla`` over this rank's block of latent slots:
    the same scores (``transformer._mla_decode_scores``), a partial softmax
    in fp32 over the block's valid slots and its log-sum-exp, the
    probabilities cast to the cache dtype (as the reference's) and the
    latent weighted sum kept in fp32, merged over ``group``, cast once to
    the cache dtype and up-projected through ``W_uv``."""
    pos, cur = slots["pos"], slots["cur"]
    valid = (pos >= 0) & (pos <= cur)
    s = T._mla_decode_scores(
        p, cfg, h, ckv_c, kr_c,
        lambda c, x: _write(c, slots["own"], slots["idx"], x), valid, rope)
    mx = torch.amax(s, dim=-1, keepdim=True)
    pr = torch.where(valid, torch.exp(s - mx), 0.0)
    den = torch.sum(pr, dim=-1, keepdim=True)
    probs = (pr / torch.clamp_min(den, 1e-30)).to(ckv_c.dtype)
    o_lat = torch.einsum("bhw,bwr->bhr", probs.float(), ckv_c.float())
    lse = torch.where(den > 0, mx + torch.log(den), -torch.inf)[..., 0]
    o_lat = merge_partials(o_lat, lse, group).to(ckv_c.dtype)
    return T._mla_decode_out(p, cfg, o_lat)


def _ffn_decode(p: dict, cfg, x: Tensor, zero: Zero3) -> Tensor:
    """``x`` plus the block's FFN of one token a row.  An MoE layer whose
    expert stacks keep their split over ``model`` (the optimized plan) runs
    this rank's experts and sums the outputs over ``model`` in rank order;
    else (dense, or every expert gathered here) as on one device."""
    if cfg.moe is None:
        return T._ffn_residual(p, cfg, x)[0]
    moe = cfg.moe
    h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
    place = zero.dims["stacks"]["blocks"]["moe"]["w_gate"]
    if zero.optimized and zero.model is not None and place.model is not None:
        n = moe.n_routed // zero.tp
        y = _routed(p["moe"], h, moe, zero.mesh.tile_index * n, n)[0]
        y = C.all_reduce(y, zero.model)
    else:
        y = _routed(p["moe"], h, moe, 0, moe.n_routed)[0]
    if moe.n_shared:
        y = y + L.glu_mlp(p["moe"]["shared_mlp"], h)
    return x + y


@dataclasses.dataclass
class ShardedServing:
    """One rank's serving steps on a mesh: ``prefill_step(params, batch)
    -> (last logits of this rank's rows, this rank's cache block)`` and
    ``decode_step(params, cache, batch) -> (logits of its rows, cache)``
    (the cache block updated in place, ``cur`` included), ``params`` this
    rank's resting blocks (``zero.place_params``) and ``batch`` the global
    batch (``tokens [B, S]`` and a modality prefix's leaves; ``tokens [B,
    1]`` to decode); ``zero`` the plan, whose ``cache_block`` cuts a whole
    ring cache to this rank's block."""

    zero: Zero3
    prefill_step: Callable
    decode_step: Callable


def make_sharded_prefill_step(arch, zero: Zero3):
    """``prefill_step(params, batch) -> (last logits, cache block)`` of
    this rank of ``zero``'s plan (module docstring)."""
    cfg = arch.cfg
    blocks_dims = zero.dims["stacks"]["blocks"]
    ka, kb = ("ckv", "kr") if cfg.mla is not None else ("k", "v")

    @torch.no_grad()
    def prefill_step(params, batch):
        blocks = params["stacks"]["blocks"]
        with use_policy(zero.policy):
            batch = zero.rows(batch)
            outer = zero.gather(params["outer"], zero.dims["outer"])
            x = T.make_prologue(cfg)(outer, batch)[0]
            ctx = T.make_pro_ctx(cfg)(outer, batch)
            B, n = x.shape[0], x.shape[1] * model_size()     # n = P + S
            W = T.cache_window(cfg, n)
            lo, hi = zero.slot_block(W)
            cache = {k: torch.empty(shape, dtype=cfg.dtype, device=x.device)
                     for k, shape in T._cache_shapes(cfg, B, hi - lo).items()}
            cut = slice(n - W + lo, n - W + hi)
            for i in range(cfg.n_layers):
                p = zero.layer(blocks, blocks_dims, i)
                h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
                a, ca, cb = T._attn_kv(p["attn"], cfg, h, ctx["pos"],
                                       prefix_len=ctx.get("prefix"),
                                       kv_pos=ctx.get("kv_pos"),
                                       whole_kv=True)
                cache[ka][i] = ca[:, cut]
                cache[kb][i] = cb[:, cut]
                x = T._ffn_residual(p, cfg, x + a)[0]
            last = x[:, -1:]
            if zero.policy.model_group is not None:
                # the last tile's last row, on every model rank
                last = C.all_gather(last, 1, zero.policy.model_group)[:, -1:]
            h = L.norm_apply(outer["final_norm"], last, kind=cfg.norm)
            logits = T._logits(outer, cfg, h)[:, 0]
        cache["pos"] = torch.arange(n - W, n, dtype=torch.int32,
                                    device=x.device)
        cache["cur"] = torch.full((), n, dtype=torch.int32, device=x.device)
        return logits, cache

    return prefill_step


def make_sharded_decode_step(arch, zero: Zero3):
    """``decode_step(params, cache, batch) -> (logits, cache)`` of this
    rank of ``zero``'s plan (module docstring), the cache block updated in
    place, ``cur`` included.  Nothing is read back to the host."""
    cfg = arch.cfg
    blocks_dims = zero.dims["stacks"]["blocks"]
    ka, kb = ("ckv", "kr") if cfg.mla is not None else ("k", "v")

    @torch.no_grad()
    def decode_step(params, cache, batch):
        blocks = params["stacks"]["blocks"]
        outer = zero.gather(params["outer"], zero.dims["outer"])
        x = T._embed(outer, cfg, zero._batch_rows(batch["tokens"]))
        cur, pos = cache["cur"], cache["pos"]
        W = pos.shape[0]
        slot = torch.remainder(cur, W).to(torch.int64).reshape(1)
        pos.index_copy_(0, slot, cur.reshape(1))
        lo, hi = zero.slot_block(W)
        group = zero.model if hi - lo < W else None
        local = slot - lo
        slots = {"own": (local >= 0) & (local < hi - lo),
                 "idx": torch.clamp(local, 0, hi - lo - 1),
                 "pos": pos[lo:hi].clone(), "cur": cur}
        rope = T._rope_tables(cfg, cur[None])
        for i in range(cfg.n_layers):
            p = zero.layer(blocks, blocks_dims, i)
            h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
            if cfg.mla is not None:
                a = _decode_mla(p["attn"], cfg, h, cache[ka][i],
                                cache[kb][i], slots, rope, group)
            else:
                a = _decode_gqa(p["attn"], cfg, h, cache[ka][i],
                                cache[kb][i], slots, rope, group)
            x = _ffn_decode(p, cfg, x + a, zero)
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = T._logits(outer, cfg, h)[:, 0]
        cur.add_(1)
        return logits, cache

    return decode_step


def sharded_serving(arch, mesh, *, optimized: bool = True) -> ShardedServing:
    """Rank ``mesh.rank``'s serving steps of ``arch`` (the transformer
    family) on ``mesh`` (a live or a dry ``ProcessMesh``), under the
    optimized plan or (``optimized=False``) the baseline plan (module
    docstring).  Raises ``ValueError`` for another family: mamba2's state, zamba2's
    shared ring and whisper's cross cache split otherwise under
    ``cache_pspecs``."""
    if arch.family != "transformer":
        raise ValueError(f"{arch.arch_id}: sharded serving takes the "
                         f"transformer family, not {arch.family!r}")
    zero = Zero3(mesh, arch.init_params(0, device="meta"),
                 prefix=arch.cfg.n_prefix_tokens, optimized=optimized)
    return ShardedServing(
        zero=zero,
        prefill_step=make_sharded_prefill_step(arch, zero),
        decode_step=make_sharded_decode_step(arch, zero))
