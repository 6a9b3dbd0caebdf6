"""Per-rank prefill and decode on a mesh, for every family.

The reference serves a mesh through GSPMD: its single-device
``make_prefill_step`` / ``make_decode_step`` lowered with the params under
``param_pspecs``, the batch under ``batch_pspecs`` and the cache under
``cache_pspecs``, and XLA partitions the step.  Here each rank runs its own
share of the same function, with the collectives explicit:

  * **params** rest as the train plan rests them (``sharding/zero.py::Zero3``)
    and are gathered a layer at a time (``Zero3.layer``), the outer leaves
    (and zamba2's shared block) once a step (``Zero3.gather``); the expert
    stacks keep their split over ``model`` in the optimized plan.  No whole
    model is ever held.
  * **the cache** rests as ``rules.cache_pspecs`` places it: the rows over
    ``pod`` × ``data`` and dim 2 of every ``[L, B, X, ...]`` leaf over
    ``model`` where each divides (``Zero3.cache_block``,
    ``Zero3.slot_block``): a ring's slots ``W``, mamba's SSM heads (and its
    ``d_conv - 1`` conv taps on a model axis that divides them), whisper's
    frames; ``pos`` and ``cur`` whole on every rank.
  * **prefill** runs under the plan's activation policy on the rank's rows
    and sequence tile (``Zero3.rows``).  Attention gathers K/V (MLA: the
    latent) over ``model``, from which the rank cuts its block of slots
    (the transformer's slot ``j`` holds position ``S - W + j``; the
    hybrid's holds ``j``, its ring padded to ``max_len`` with empty slots
    past ``S``).  A mamba layer gathers its tile's input over ``model``,
    runs the mixer on the whole sequence and keeps the tile's rows, the
    conv tail and the rank's SSM heads of the final state.  The tile
    holding position ``S - 1`` provides the last logits: each rank's last
    hidden row is gathered over ``model`` and every rank computes the same
    logits.  whisper's encoder runs on the rank's tile of the frames where
    the model axis divides them, else on all of them with no policy, as
    training does; every rank gets its rows' output over every frame and
    makes the cross K/V of its block of frames.
  * **decode** never tiles (a one-token step cannot be cut over ``model``):
    the ``model`` ranks hold the same rows (``Zero3._batch_rows``).  The
    token's slot ``cur % W`` is written by the rank that owns it, as a
    masked write at a clamped local index (no host read).  Each rank
    attends over its own block of slots — GQA through K4's partial entry
    (``kernels/decode_attention``), MLA by a plain partial softmax over its
    latent slots — to ``(o, lse)``, and :func:`merge_partials` combines the
    ranks' pairs in rank order in fp32, so every ``model`` rank holds the
    same bits.  whisper's cross-attention does so over the rank's block of
    frames where they are split, else over all of them through
    ``ops.decode_attention``.  An MoE layer runs the rank's own experts on
    the rows and sums the outputs over ``model`` in rank order (the train
    path's gather of the sequence over ``model`` would gather one token
    ``tp`` times).  A mamba layer runs the in-projection and the conv
    whole and the SSM update of its own heads, whose outputs are gathered
    over ``model`` in rank order before the gated norm over all of
    ``d_inner``.

``optimized=False`` follows ``Zero3(optimized=False)``: prefill has no
tile (every ``model`` rank runs its rows' whole sequence and cuts its block
of the cache), expert stacks are gathered whole; decode is otherwise the
same.

The decode step gathers every layer's weights for one token: its
collective bytes are about the model's a step, the cost of this layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec as E
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.models.moe import _routed
from repro_torch.sharding import collectives as C
from repro_torch.sharding.act import (model_size, seq_offset, shard_act,
                                      use_policy)
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
    B = h.shape[0]
    q, k, v = T._qkv(p, cfg, h, *rope)
    _write(kc, slots["own"], slots["idx"], k)
    _write(vc, slots["own"], slots["idx"], v)
    o = _attend_block(q, kc, vc, slots["pos"], slots["cur"], group,
                      window=cfg.window)
    return L.dense(o.reshape(B, 1, -1), p["wo"])


def _attend_block(q: Tensor, kc: Tensor, vc: Tensor, kv_pos: Tensor,
                  q_pos: Tensor, group, *, window=None) -> Tensor:
    """``q [B,1,H,dh]`` over this rank's block ``kc``/``vc [B,Wl,K,dh]``
    at the slot positions ``kv_pos [Wl]`` through K4's partial entry,
    merged over ``group`` (None: the block is the whole ring): ``[B,H,dh]``
    in ``q``'s dtype."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_partial)
    o, lse = decode_attention_partial(q, kc, vc, kv_pos, q_pos,
                                      window=window)
    return merge_partials(o, lse, group).to(q.dtype)


def _ring_slots(zero: Zero3, cache: dict) -> tuple:
    """A decode step's ring bookkeeping: this token's position ``cur``
    marked at slot ``cur % W`` of the whole ``pos`` (in place), and
    ``(slots, group)``: ``slots`` this rank's view of it (``own``: whether
    the slot is in its block, ``idx`` the clamped local index, ``pos`` the
    block's positions, ``cur``) and ``group`` the ranks whose blocks make
    the ring (None where this block is all of it)."""
    cur, pos = cache["cur"], cache["pos"]
    W = pos.shape[0]
    slot = torch.remainder(cur, W).to(torch.int64).reshape(1)
    pos.index_copy_(0, slot, cur.reshape(1))
    lo, hi = zero.slot_block(W)
    local = slot - lo
    slots = {"own": (local >= 0) & (local < hi - lo),
             "idx": torch.clamp(local, 0, hi - lo - 1),
             "pos": pos[lo:hi].clone(), "cur": cur}
    return slots, (zero.model if hi - lo < W else None)


def _last_row(zero: Zero3, x: Tensor) -> Tensor:
    """The hidden row of position ``S - 1`` of this rank's rows, on every
    ``model`` rank: the last tile's last row, gathered over ``model``."""
    last = x[:, -1:]
    if zero.policy.model_group is not None:
        last = C.all_gather(last, 1, zero.policy.model_group)[:, -1:]
    return last


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
    -> (last logits of this rank's rows — an encoder-decoder: its rows'
    encoder output — and this rank's cache block)`` and
    ``decode_step(params, cache, batch) -> (logits of its rows, cache)``
    (the cache block updated in place, ``cur`` included), ``params`` this
    rank's resting blocks (``zero.place_params``) and ``batch`` the global
    batch (``tokens [B, S]`` and a modality prefix's leaves, or
    ``frames``; ``tokens [B, 1]`` to decode); ``zero`` the plan, whose
    ``cache_block`` cuts a whole cache to this rank's block."""

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
            h = L.norm_apply(outer["final_norm"], _last_row(zero, x),
                             kind=cfg.norm)
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
        cur = cache["cur"]
        slots, group = _ring_slots(zero, cache)
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


# --------------------------------------------------------------------------
# mamba2 and the hybrid (zamba2): the state cache, the shared block's ring
# --------------------------------------------------------------------------

def _state_block(mc, zero: Zero3, B: int, device) -> dict:
    """This rank's block of a state cache of ``B`` rows (as
    ``mamba2.init_state_cache``): the conv taps and the SSM heads cut where
    ``rules.cache_pspecs`` splits dim 2 over ``model``; ``cur`` 0."""
    t_lo, t_hi = zero.slot_block(mc.d_conv - 1)
    h_lo, h_hi = zero.slot_block(mc.n_heads)
    return {"conv": torch.empty((mc.n_layers, B, t_hi - t_lo, mc.conv_dim),
                                dtype=mc.dtype, device=device),
            "ssm": torch.empty((mc.n_layers, B, h_hi - h_lo, mc.headdim,
                                mc.d_state), dtype=torch.float32,
                               device=device),
            "cur": torch.zeros((), dtype=torch.int32, device=device)}


def _mix_prefill(p: dict, mc, zero: Zero3, h: Tensor, conv: Tensor,
                 ssm: Tensor) -> Tensor:
    """A mamba layer's mixer over this rank's tile ``h [B,T,d]`` (normed):
    the tile gathered over ``model`` (``kv_full``; none without a tile),
    ``mamba2._mix_seq`` on the whole sequence, the conv tail's and the
    final state's blocks (taps and heads, ``_state_block``) written into
    ``conv`` and ``ssm``, and the tile's rows of the output returned."""
    T_ = h.shape[1]
    off = seq_offset(T_)
    out, tail, state = M2._mix_seq(p, mc, shard_act(h, "kv_full"),
                                   return_state=True)
    lo, hi = zero.slot_block(tail.shape[1])
    conv.copy_(tail[:, lo:hi])
    lo, hi = zero.slot_block(state.shape[1])
    ssm.copy_(state[:, lo:hi])
    return out[:, off:off + T_]


def _mix_block(zero: Zero3, mc) -> dict:
    """``mamba2_mix``'s decode keywords for this rank's cache block: its
    first conv tap and SSM head, and the all-gather over ``model`` that
    joins split blocks in rank order (taps before the conv, the heads'
    outputs before the gated norm over all of ``d_inner``), so every
    ``model`` rank holds the same bits."""
    return {"tap_lo": zero.slot_block(mc.d_conv - 1)[0],
            "head_lo": zero.slot_block(mc.n_heads)[0],
            "gather": lambda t, dim: C.all_gather(t, dim, zero.model)}


def _ssm_parts(arch) -> tuple:
    """``(hybrid, the mamba config, the layers applying the shared
    block)`` of a mamba2 or hybrid arch."""
    if arch.family == "hybrid":
        return True, arch.cfg.mamba_cfg(), HY.attn_layers(arch.cfg)
    return False, arch.cfg, frozenset()


def make_sharded_ssm_prefill_step(arch, zero: Zero3, max_len=None):
    """``prefill_step(params, batch) -> (last logits, cache block)`` of a
    mamba2 or hybrid arch on this rank of ``zero``'s plan: each layer's
    mixer as :func:`_mix_prefill`; the hybrid's shared block on the tile
    (K/V gathered over ``model``), whose ring of ``W = max_len or S``
    slots puts position ``j`` at slot ``j`` and leaves the slots past ``S``
    empty (zeros, position -1), this rank's block of slots cut from that
    padded layout."""
    cfg = arch.cfg
    hybrid, mc, _ = _ssm_parts(arch)
    blocks_dims = zero.dims["stacks"]["blocks"]

    @torch.no_grad()
    def prefill_step(params, batch):
        blocks = params["stacks"]["blocks"]
        S = batch["tokens"].shape[1]
        M2.check_prompt(mc, S)
        with use_policy(zero.policy):
            tokens = zero.rows({"tokens": batch["tokens"]})["tokens"]
            outer = zero.gather(params["outer"], zero.dims["outer"])
            x0 = M2.embed(outer, tokens)
            B, dev = x0.shape[0], x0.device
            cache = _state_block(mc, zero, B, dev)

            def layer(i):
                return zero.layer(blocks, blocks_dims, i)

            def mix(pm, h, i):
                return _mix_prefill(pm, mc, zero, h, cache["conv"][i],
                                    cache["ssm"][i])

            if hybrid:
                shared = zero.gather(params["shared"], zero.dims["shared"])
                ctx = T._seq_ctx(x0.shape[1], dev)
                W = max_len or S
                lo, hi = zero.slot_block(W)
                n = max(min(hi, S) - lo, 0)        # the block's filled slots
                kv = (cfg.n_attn_applications(), B, hi - lo, cfg.n_kv_heads,
                      cfg.head_dim)
                for k in ("attn_k", "attn_v"):
                    cache[k] = torch.zeros(kv, dtype=cfg.dtype, device=dev)

                def keep_kv(a, k, v):
                    cache["attn_k"][a, :, :n] = k[:, lo:lo + n]
                    cache["attn_v"][a, :, :n] = v[:, lo:lo + n]

                x = HY.prefill_layers(cfg, shared, x0, ctx["pos"], layer, mix,
                                      keep_kv, kv_pos=ctx.get("kv_pos"),
                                      whole_kv=True)
            else:
                x = x0
                for i in range(cfg.n_layers):
                    p = layer(i)
                    x = x + mix(p, L.norm_apply(p["ln"], x, kind=cfg.norm), i)
            h = L.norm_apply(outer["final_norm"], _last_row(zero, x),
                             kind=cfg.norm)
            logits = M2.logits(outer, cfg, h)[:, 0]
        if hybrid:
            cache["pos"] = torch.full((W,), -1, dtype=torch.int32,
                                      device=dev)
            cache["pos"][:S] = torch.arange(S, dtype=torch.int32, device=dev)
        cache["cur"].fill_(S)
        return logits, cache

    return prefill_step


def make_sharded_ssm_decode_step(arch, zero: Zero3):
    """``decode_step(params, cache, batch) -> (logits, cache)`` of a mamba2
    or hybrid arch on this rank of ``zero``'s plan, the cache block updated
    in place: each layer's mixer as ``mamba2.decode_mix`` on this rank's
    block (:func:`_mix_block`); the hybrid's shared block (its weights
    gathered once a step) over this rank's block of its ring through K4's
    partial entry, merged over ``model``.  Nothing is read back to the
    host."""
    cfg = arch.cfg
    hybrid, mc, with_attn = _ssm_parts(arch)
    blocks_dims = zero.dims["stacks"]["blocks"]
    block = _mix_block(zero, mc)

    @torch.no_grad()
    def decode_step(params, cache, batch):
        blocks = params["stacks"]["blocks"]
        outer = zero.gather(params["outer"], zero.dims["outer"])
        x0 = M2.embed(outer, zero._batch_rows(batch["tokens"]))
        cur = cache["cur"]
        if hybrid:
            shared = zero.gather(params["shared"], zero.dims["shared"])
            slots, group = _ring_slots(zero, cache)
        x, a = x0, 0
        for i in range(cfg.n_layers):
            p = zero.layer(blocks, blocks_dims, i)
            x = M2.decode_mix(p["mamba"] if hybrid else p, mc, x, cache, i,
                              **block)
            if i in with_attn:
                q, k, v = HY.shared_qkv(shared, p, cfg, x, x0, cur.reshape(1))
                kc, vc = cache["attn_k"][a], cache["attn_v"][a]
                _write(kc, slots["own"], slots["idx"], k)
                _write(vc, slots["own"], slots["idx"], v)
                x = HY.shared_out(shared, cfg, x, _attend_block(
                    q, kc, vc, slots["pos"], cur, group))
                a += 1
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = M2.logits(outer, cfg, h)[:, 0]
        cur.add_(1)
        return logits, cache

    return decode_step


# --------------------------------------------------------------------------
# the encoder-decoder (whisper): the encoder's frames, the cross cache
# --------------------------------------------------------------------------

_CROSS_KV = ("bv", "wk", "wv")


def make_sharded_encdec_prefill_step(arch, zero: Zero3,
                                     max_decode_len: int = 448):
    """``prefill_step(params, batch{'frames'}) -> (enc_out, cache block)``
    of an encoder-decoder on this rank of ``zero``'s plan: the rank's rows
    of the frames encoded (tiled over ``model`` where the axis divides the
    frames, else whole on every rank under no activation policy, as
    training runs them), ``enc_out`` the rows' output over every frame (the
    same bits on every ``model`` rank); the cache block each decoder
    layer's cross K/V over the rank's block of frames (all of them where
    the axis does not divide them) and its block of an empty self ring of
    ``max_decode_len`` slots."""
    cfg = arch.cfg
    K, dh = cfg.n_kv_heads, cfg.head_dim
    enc_body = E.make_enc_body(cfg)
    enc_dims = zero.dims["stacks"]["enc"]
    cross_dims = {k: zero.dims["stacks"]["dec"]["cross_attn"][k]
                  for k in _CROSS_KV}

    @torch.no_grad()
    def prefill_step(params, batch):
        stacks = params["stacks"]
        with use_policy(zero.policy):
            frames = zero.rows({"frames": batch["frames"]})["frames"]
            outer = zero.gather(params["outer"], zero.dims["outer"])
            with E._encoder_scope(cfg, frames):
                x = E._encoder_inputs(cfg, frames)
                for i in range(cfg.n_enc_layers):
                    x, = enc_body(zero.layer(stacks["enc"], enc_dims, i),
                                  ({}, {}), (x,), i)
                enc_out = shard_act(E._encoder_norm(outer, cfg, x),
                                    "kv_full")
        B, dev = enc_out.shape[0], enc_out.device
        flo, fhi = zero.slot_block(cfg.n_frames)
        lo, hi = zero.slot_block(max_decode_len)
        ring = (cfg.n_dec_layers, B, hi - lo, K, dh)
        cross = (cfg.n_dec_layers, B, fhi - flo, K, dh)
        cache = {
            "self_k": torch.zeros(ring, dtype=cfg.dtype, device=dev),
            "self_v": torch.zeros(ring, dtype=cfg.dtype, device=dev),
            "cross_k": torch.empty(cross, dtype=cfg.dtype, device=dev),
            "cross_v": torch.empty(cross, dtype=cfg.dtype, device=dev),
            "pos": torch.full((max_decode_len,), -1, dtype=torch.int32,
                              device=dev),
            "cur": torch.zeros((), dtype=torch.int32, device=dev)}
        block = enc_out[:, flo:fhi]
        cross_attn = stacks["dec"]["cross_attn"]
        for i in range(cfg.n_dec_layers):
            p = zero.layer({k: cross_attn[k] for k in _CROSS_KV},
                           cross_dims, i)
            cache["cross_k"][i] = L.dense(block, p["wk"]).reshape(
                B, -1, K, dh)
            cache["cross_v"][i] = L.dense(block, p["wv"], p["bv"]).reshape(
                B, -1, K, dh)
        return enc_out, cache

    return prefill_step


def make_sharded_encdec_decode_step(arch, zero: Zero3):
    """``decode_step(params, cache, batch) -> (logits, cache)`` of an
    encoder-decoder on this rank of ``zero``'s plan, the cache block
    updated in place: the self-attention over this rank's block of its
    ring through K4's partial entry, merged over ``model``; the
    cross-attention over the rank's block of frames (positions ``lo..hi-1``,
    the query at ``2**30``) the same way where the model axis splits the
    frames, else over all of them through ``ops.decode_attention``, as on
    one device.  Nothing is read back to the host."""
    from repro_torch.kernels.decode_attention import ops
    cfg = arch.cfg
    dec_dims = zero.dims["stacks"]["dec"]
    flo, fhi = zero.slot_block(cfg.n_frames)
    cross_group = zero.model if fhi - flo < cfg.n_frames else None

    @torch.no_grad()
    def decode_step(params, cache, batch):
        dec = params["stacks"]["dec"]
        outer = zero.gather(params["outer"], zero.dims["outer"])
        tokens = zero._batch_rows(batch["tokens"])
        cur = cache["cur"]
        x = E.decoder_token(outer, cfg, tokens, cur)
        slots, group = _ring_slots(zero, cache)
        kv_cross = torch.arange(flo, fhi, dtype=torch.int32, device=x.device)
        q_cross = torch.full((), E._CROSS_Q_POS, dtype=torch.int32,
                             device=x.device)

        def write(ring, kv):
            _write(ring, slots["own"], slots["idx"], kv)

        def attend_self(q, kc, vc):
            return _attend_block(q, kc, vc, slots["pos"], cur, group)

        def attend_cross(q, kc, vc):
            if cross_group is None:
                return ops.decode_attention(q, kc, vc, kv_cross, q_cross)
            return _attend_block(q, kc, vc, kv_cross, q_cross, cross_group)

        for i in range(cfg.n_dec_layers):
            x = E.decoder_layer(zero.layer(dec, dec_dims, i), cfg, x, cache,
                                i, write, attend_self, attend_cross)
        logits = E._logits(outer, cfg, x)[:, 0]
        cur.add_(1)
        return logits, cache

    return decode_step


# each family's (prefill, decode) step makers
_FAMILY_STEPS = {
    "transformer": (make_sharded_prefill_step, make_sharded_decode_step),
    "mamba2": (make_sharded_ssm_prefill_step, make_sharded_ssm_decode_step),
    "hybrid": (make_sharded_ssm_prefill_step, make_sharded_ssm_decode_step),
    "encdec": (make_sharded_encdec_prefill_step,
               make_sharded_encdec_decode_step),
}


def sharded_serving(arch, mesh, *, optimized: bool = True,
                    **prefill_kw) -> ShardedServing:
    """Rank ``mesh.rank``'s serving steps of ``arch`` (any family) on
    ``mesh`` (a live or a dry ``ProcessMesh``), under the optimized plan or
    (``optimized=False``) the baseline plan (module docstring).
    ``prefill_kw`` are the family's ``make_prefill_step`` keywords: the
    hybrid's ``max_len``, the encoder-decoder's ``max_decode_len``."""
    zero = Zero3(mesh, arch.init_params(0, device="meta"),
                 prefix=getattr(arch.cfg, "n_prefix_tokens", 0),
                 optimized=optimized)
    prefill, decode = _FAMILY_STEPS[arch.family]
    return ShardedServing(zero=zero,
                          prefill_step=prefill(arch, zero, **prefill_kw),
                          decode_step=decode(arch, zero))
