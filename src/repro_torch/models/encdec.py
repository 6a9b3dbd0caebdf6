"""Whisper-style encoder-decoder backbone (PyTorch; arXiv:2212.04356).
Counterpart of ``repro.models.encdec``.

The conv audio frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings ``frames [B, n_frames, d_model]``.  Decoder
positions are sinusoidal (whisper's are learned), as in the reference.

On the fused engine (``core/fused.py``) the two stacks run as two layer
loops: the decoder's reverse sweep, which cross-attends to the encoder's
output, sums that output's gradient over its layers (``stack_backward_update``
with ``act_grad``: in the output's own dtype, as the reference's scan carry
does); the gradient then goes back through the final encoder norm and the
encoder's own reverse sweep, each layer updated in place as its gradient is
born.  ``outer`` (the tied embedding and both final norms) is updated once,
from the logits', the decoder embedding's and the encoder norm's gradients
summed in the reference's order.

On a model axis (``sharding/zero.py``) each rank holds a tile of the
frames and a tile of the tokens, each sequence tiled along its own length
(``Zero3.rows``).  Both stacks run on their tiles at the tiles' absolute
positions (the sinusoids included), their self-attention's queries against
K/V gathered over ``model`` (``kv_full``).  The encoder's output is
gathered whole once a step (``kv_full``) and every decoder layer
cross-attends to all of it; its gradient, summed over the decoder's layers
on each rank, holds only that rank's tokens' share, so it is summed over
``model`` and cut to the rank's frame tile (``act.sum_to_tile``: a
fixed-order fp32 reduce-scatter) before the encoder norm's VJP and the
encoder's sweep.  Where the model axis does not divide the frames, every
rank holds them whole and runs the encoder whole, under no activation
policy (:func:`_encoder_scope`): its output needs no gather, and its
gradient, each rank's tokens' share, goes through the encoder's sweep as
it is, the sum over ``model`` made by the scatter of the encoder's
parameter gradients (a sum of the shares' VJPs is the VJP of their sum).

Serving encodes the frames once (``make_prefill_step``), keeps each decoder
layer's cross K/V over every frame and a self-attention ring of
``max_decode_len`` slots, and decodes one token a step; both attentions of a
step go through ``kernels.decode_attention.ops.decode_attention`` (K4 on a
CUDA tensor): the ring with its slot positions and the current position, the
frames with positions ``0..n_frames-1`` and a query position of ``2**30``, so
every frame is visible.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import fused as Fu
from repro_torch.core.api import OptState, hparams_on_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models.transformer import _seq_ctx, cross_entropy
from repro_torch.sharding.act import (batch_sum, current_policy, model_size,
                                      seq_offset, shard_act, sum_to_tile,
                                      use_policy)
from repro_torch.sharding.rules import make_param_constraint

Tensor = torch.Tensor

# the decoder's sinusoid table of the reference has this many rows; a decode
# position past its end takes the last row
_POS_ROWS = 2 ** 16
# the cross-attention's query position: past every frame's, so all are seen
_CROSS_Q_POS = 2 ** 30


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    n_frames: int = 1500
    norm: str = "layernorm"
    act: str = "gelu"
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameters (shapes only; nothing is allocated)."""
        shapes = init_params(0, self, device="meta")
        return sum(math.prod(x.shape) for x in tree_leaves(shapes))

    def active_param_count(self) -> int:
        return self.param_count()


def _sinusoid_at(pos: Tensor, d: int) -> Tensor:
    """fp32 ``[..., d]`` sinusoids (sin half, then cos half) at the fp32
    positions ``pos [..., 1]``, in the reference's arithmetic."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(S: int, d: int, device, start: int = 0) -> Tensor:
    """The fp32 table ``[S, d]`` of positions ``start..start+S-1``."""
    pos = torch.arange(start, start + S, dtype=torch.float32,
                       device=device)[:, None]
    return _sinusoid_at(pos, d)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _attn_init(gen, cfg: EncDecConfig, device, out=None) -> dict:
    """Attention leaves ``wq, bq, wk, wv, bv, wo, bo`` (no key bias, as
    whisper and the reference), the weights drawn in that order."""
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    o = out or {}

    def lin(key, d_in, d_out):
        return L.linear_init(gen, d_in, d_out, dtype=dt, device=device,
                             out=o.get(key))

    def zeros(key, n):
        return L.zeros_init((n,), dtype=dt, device=device, out=o.get(key))

    return {"wq": lin("wq", d, H * dh), "bq": zeros("bq", H * dh),
            "wk": lin("wk", d, K * dh),
            "wv": lin("wv", d, K * dh), "bv": zeros("bv", K * dh),
            "wo": lin("wo", H * dh, d), "bo": zeros("bo", d)}


def _enc_block(gen, cfg: EncDecConfig, device, out=None) -> dict:
    d, o = cfg.d_model, out or {}
    return {"ln1": L.norm_init(d, cfg.norm, device=device, out=o.get("ln1")),
            "attn": _attn_init(gen, cfg, device, o.get("attn")),
            "ln2": L.norm_init(d, cfg.norm, device=device, out=o.get("ln2")),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype=cfg.dtype,
                              device=device, out=o.get("mlp"))}


def _dec_block(gen, cfg: EncDecConfig, device, out=None) -> dict:
    d, o = cfg.d_model, out or {}

    def norm(key):
        return L.norm_init(d, cfg.norm, device=device, out=o.get(key))

    return {"ln1": norm("ln1"),
            "self_attn": _attn_init(gen, cfg, device, o.get("self_attn")),
            "ln_x": norm("ln_x"),
            "cross_attn": _attn_init(gen, cfg, device, o.get("cross_attn")),
            "ln2": norm("ln2"),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype=cfg.dtype,
                              device=device, out=o.get("mlp"))}


def init_params(seed: int, cfg: EncDecConfig, *, device="cuda") -> dict:
    """Params in the fused-engine layout ``{outer, shared, stacks}`` with
    stacks ``enc`` and ``dec``, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``; each stack is allocated once and each layer
    drawn straight into it."""
    dev, gen = L.init_generator(seed, device)
    d = cfg.d_model
    outer = {
        "tok_embed": L.embed_init(gen, cfg.vocab, d, dtype=cfg.dtype,
                                  device=dev),
        "enc_norm": L.norm_init(d, cfg.norm, device=dev),
        "dec_norm": L.norm_init(d, cfg.norm, device=dev),
    }
    enc = L.stacked_blocks(cfg.n_enc_layers, lambda g, dv, out: _enc_block(
        g, cfg, dv, out), gen, dev)
    dec = L.stacked_blocks(cfg.n_dec_layers, lambda g, dv, out: _dec_block(
        g, cfg, dv, out), gen, dev)
    return {"outer": outer, "shared": {}, "stacks": {"enc": enc, "dec": dec}}


# --------------------------------------------------------------------------
# Layer bodies (carries are 1-tuples)
# --------------------------------------------------------------------------

def _mha(p: dict, cfg: EncDecConfig, hq: Tensor, hkv: Tensor, *,
         causal: bool, q_pos: Tensor, kv_pos: Tensor,
         gather: bool = False) -> Tensor:
    """Attention of ``hq [B,Sq,d]`` over ``hkv [B,Skv,d]`` through the
    dispatcher (the direct branch up to 2048 tokens).  ``gather``: a
    self-attention on a sequence tile, whose K/V are gathered over
    ``model`` (``kv_full``), ``kv_pos`` the whole sequence's positions."""
    B, Sq, _ = hq.shape
    Skv = hkv.shape[1]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(hq, p["wq"], p["bq"]).reshape(B, Sq, H, dh)
    k = L.dense(hkv, p["wk"]).reshape(B, Skv, K, dh)
    v = L.dense(hkv, p["wv"], p["bv"]).reshape(B, Skv, K, dh)
    if gather:
        k, v = shard_act(k, "kv_full"), shard_act(v, "kv_full")
    o = L.attention(q, k, v, spec=L.MaskSpec(causal=causal), q_pos=q_pos,
                    kv_pos=kv_pos, q_offset=seq_offset(Sq) if gather else 0)
    return L.dense(o.reshape(B, Sq, H * dh), p["wo"], p["bo"])


def _positions(n: int, device) -> Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _tile_positions(n: int, device) -> tuple:
    """``(pos, kv_pos)``: the absolute positions of this rank's tile of
    ``n`` rows, and of the whole sequence the model axis tiles (both
    ``0..n-1`` without one)."""
    ctx = _seq_ctx(n, device)
    return ctx["pos"], ctx.get("kv_pos", ctx["pos"])


def make_enc_body(cfg: EncDecConfig):
    def body(p, ctx, carry, aux_idx):
        del ctx, aux_idx
        x, = carry
        pos, kv_pos = _tile_positions(x.shape[1], x.device)
        h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
        x = x + _mha(p["attn"], cfg, h, h, causal=False, q_pos=pos,
                     kv_pos=kv_pos, gather=True)
        h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
        return (x + L.mlp(p["mlp"], h, cfg.act),)

    return body


def make_dec_body(cfg: EncDecConfig):
    def body(p, ctx, carry, aux_idx):
        del aux_idx
        _, enc_out = ctx          # every frame (gathered on a model axis)
        x, = carry
        pos, kv_pos = _tile_positions(x.shape[1], x.device)
        epos = _positions(enc_out.shape[1], x.device)
        h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
        x = x + _mha(p["self_attn"], cfg, h, h, causal=True, q_pos=pos,
                     kv_pos=kv_pos, gather=True)
        h = L.norm_apply(p["ln_x"], x, kind=cfg.norm)
        x = x + _mha(p["cross_attn"], cfg, h, enc_out, causal=False,
                     q_pos=pos, kv_pos=epos)
        h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
        return (x + L.mlp(p["mlp"], h, cfg.act),)

    return body


# --------------------------------------------------------------------------
# Fused + unfused train steps
# --------------------------------------------------------------------------

def _encoder_inputs(cfg: EncDecConfig, frames: Tensor) -> Tensor:
    # a model axis' tile at its absolute positions
    n = frames.shape[1]
    x = frames.to(cfg.dtype)
    return x + _sinusoid(n, cfg.d_model, x.device, seq_offset(n)).to(
        cfg.dtype)


def _encoder_scope(cfg: EncDecConfig, frames: Tensor):
    """The activation policy the encoder runs under: the installed one
    where a model axis tiles the frames, none where every rank holds them
    whole (the axis does not divide them, ``Zero3.rows``; module
    docstring)."""
    if model_size() > 1 and frames.shape[1] == cfg.n_frames:
        return use_policy(None)
    return contextlib.nullcontext()


def _encoder_norm(outer: dict, cfg: EncDecConfig, x: Tensor) -> Tensor:
    return L.norm_apply(outer["enc_norm"], x, kind=cfg.norm)


def _decoder_inputs(outer: dict, cfg: EncDecConfig, tokens: Tensor
                    ) -> Tensor:
    # F.embedding: a sorted, fixed-order backward on CUDA (see
    # transformer._embed)
    x = F.embedding(tokens, outer["tok_embed"])
    n = tokens.shape[1]
    return x + _sinusoid(n, cfg.d_model, x.device, seq_offset(n)).to(
        x.dtype)


def _logits(outer: dict, cfg: EncDecConfig, x: Tensor) -> Tensor:
    """fp32 logits of the decoder stream ``x`` through the final norm and
    the tied embedding (an fp32 product of the parameters' values)."""
    h = L.norm_apply(outer["dec_norm"], x, kind=cfg.norm)
    return torch.matmul(h.to(torch.float32),
                        outer["tok_embed"].T.to(torch.float32))


def _loss_from_dec(outer: dict, cfg: EncDecConfig, x: Tensor, batch: dict
                   ) -> tuple:
    """The masked cross entropy over the global token count (on a batch
    split over ranks, ``sharding.act``, each rank's share of it; the
    metrics are the global batch's)."""
    loss_sum, ntok, correct = cross_entropy(_logits(outer, cfg, x),
                                            batch["labels"])
    ntok = batch_sum(ntok)
    denom = torch.clamp_min(ntok, 1).to(torch.float32)
    loss = loss_sum / denom
    report = (batch_sum(loss_sum.detach()) / denom
              if current_policy() is not None else loss)
    metrics = {"loss": report.detach(), "ntokens": ntok.to(torch.float32),
               "accuracy": batch_sum(correct).to(torch.float32) / denom}
    return loss, metrics


def _vjp_of(fn, dy: Tensor, *inputs) -> list:
    """``fn(*inputs)`` re-run with autograd on (each input a tree): the
    inputs' gradients under the cotangent ``dy``."""
    req = [Fu._grad_leaves(t) for t in inputs]
    with torch.enable_grad():
        y = fn(*req)
    return Fu._vjp([y], [dy], *req)


def make_fused_train_step(cfg: EncDecConfig, opt, *, zero=None):
    """``step(params, opt_state, batch, *, hparams)``: one fused step,
    **in place** (``batch``: ``tokens``, ``labels`` ``[B,S]`` and ``frames
    [B, n_frames, d_model]``).  Returns ``(params, opt_state, loss,
    metrics)`` with loss and metrics 0-d tensors on the device.  ``zero``
    (a ``sharding.zero.Zero3``): ZeRO-3 sharded, as ``core.fused``'s step —
    the outer leaves gathered once, each layer of both stacks gathered for
    its forward and its re-run, gradients reduce-scattered before the rule;
    the batch handed in is this rank's rows and its tiles of the frames and
    the tokens (module docstring)."""
    enc_body, dec_body = make_enc_body(cfg), make_dec_body(cfg)

    def train_step(params, opt_state, batch, *, hparams=None):
        if zero is None:
            return one_step(params, opt_state, batch, hparams)
        with use_policy(zero.policy):
            return one_step(params, opt_state, batch, hparams)

    def one_step(params, opt_state, batch, hparams):
        rule = opt.rule
        outer, stacks = params["outer"], params["stacks"]
        seams = {name: {} for name in stacks}
        if zero is not None:
            outer = zero.gather(outer, zero.dims["outer"])
            seams = {name: zero.seams(name) for name in stacks}

        def fwd(name):
            return ({"layer_fn": seams[name]["layer_fn"]} if seams[name]
                    else {})
        hp = hparams_on_device(opt.resolve(hparams),
                               outer["tok_embed"].device)
        labels = opt.labels(params)
        step = opt_state.step + 1
        stepf = step.to(torch.float32)
        m = opt_state.moments
        tokens = batch["tokens"]

        def enc_scope():
            return _encoder_scope(cfg, batch["frames"])

        # ---- forward (layer inputs saved, nothing else) ----
        with torch.no_grad():
            with enc_scope():
                enc_res = Fu.stack_forward(
                    enc_body, stacks["enc"], ({}, {}),
                    (_encoder_inputs(cfg, batch["frames"]),), **fwd("enc"))
                # the frame tile's output, gathered whole once a step
                enc_out = shard_act(
                    _encoder_norm(outer, cfg, enc_res.x_out[0]), "kv_full")
            dec_res = Fu.stack_forward(
                dec_body, stacks["dec"], ({}, enc_out),
                (_decoder_inputs(outer, cfg, tokens),), **fwd("dec"))

        # ---- epilogue forward + backward ----
        o_req = Fu._grad_leaves(outer)
        xd = dec_res.x_out[0].detach().requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = _loss_from_dec(o_req, cfg, xd, batch)
        g_outer_epi, dxd = Fu._vjp([loss], [torch.ones_like(loss)], o_req, xd)
        loss = loss.detach() if zero is None else metrics["loss"]
        del o_req, xd

        # ---- decoder sweep: inline updates; d(enc_out) summed over it ----
        (dxd0,), (_, d_enc_out), _, _ = Fu.stack_backward_update(
            dec_body, rule, stacks["dec"], m["stacks"]["dec"],
            ({}, enc_out), dec_res, (dxd,), labels=labels["stacks"]["dec"],
            hp=hp, step=stepf, act_grad=True, **seams["dec"])
        del dec_res, dxd
        # this rank's tokens' share of every frame's gradient: summed over
        # ``model``, cut to the frame tile
        with enc_scope():
            d_enc_out = sum_to_tile(d_enc_out)
        # ``outer`` is not updated yet: the embedding and the encoder norm
        # are re-run under autograd for their gradients
        g_outer_dpro, = _vjp_of(lambda o: _decoder_inputs(o, cfg, tokens),
                                dxd0, outer)
        g_outer_enorm, dxe = _vjp_of(lambda o, x: _encoder_norm(o, cfg, x),
                                     d_enc_out, outer, enc_res.x_out[0])
        del d_enc_out, dxd0, enc_out

        # ---- encoder sweep (the frames are inputs: nothing upstream) ----
        with enc_scope():
            Fu.stack_backward_update(
                enc_body, rule, stacks["enc"], m["stacks"]["enc"], ({}, {}),
                enc_res, (dxe,), labels=labels["stacks"]["enc"], hp=hp,
                step=stepf, **seams["enc"])
        del enc_res, dxe

        g_outer = Fu._tree_add(Fu._tree_add(g_outer_epi, g_outer_dpro),
                               g_outer_enorm)
        shards = None
        if zero is not None:
            del outer
            g_outer = zero.scatter(g_outer, zero.dims["outer"])
            shards = zero.shards(zero.dims["outer"], zero.shapes["outer"])
        Fu.apply_rule_tree(rule, params["outer"], g_outer, m["outer"],
                           labels["outer"], hp, stepf, shards)
        return params, OptState(step=step, moments=m), loss, metrics

    return train_step


def _run_stack(body, stacked: dict, ctx, x: Tensor, layer_fn=None) -> Tensor:
    """The stack's layers one after another, with autograd as the caller
    has it (layer ``i`` indexed out of the stack, or ``layer_fn(stacked,
    i)``)."""
    for i in range(Fu._n_layers(stacked)):
        p = (tree_map(lambda t: t[i], stacked) if layer_fn is None
             else layer_fn(stacked, i))
        x, = body(p, ctx, (x,), i)
    return x


def _encode(cfg: EncDecConfig, params: dict, frames: Tensor,
            layer_fn=None) -> Tensor:
    """The encoder's output ``enc_out [B, n_frames, d]`` (after its final
    norm)."""
    x = _run_stack(make_enc_body(cfg), params["stacks"]["enc"], ({}, {}),
                   _encoder_inputs(cfg, frames), layer_fn)
    return _encoder_norm(params["outer"], cfg, x)


def _decode_stream(cfg: EncDecConfig, params: dict, enc_out: Tensor,
                   tokens: Tensor, layer_fn=None) -> Tensor:
    """The decoder stack's output over ``tokens`` and ``enc_out``."""
    return _run_stack(make_dec_body(cfg), params["stacks"]["dec"],
                      ({}, enc_out),
                      _decoder_inputs(params["outer"], cfg, tokens), layer_fn)


def decoder_logits(cfg: EncDecConfig, params: dict, enc_out: Tensor,
                   tokens: Tensor) -> Tensor:
    """Teacher-forced fp32 logits ``[B, S, vocab]`` of ``tokens [B, S]``
    over the encoder output ``enc_out``: what ``loss_fn`` scores."""
    return _logits(params["outer"], cfg,
                   _decode_stream(cfg, params, enc_out, tokens))


def _loss(cfg: EncDecConfig, params: dict, batch: dict, layers=None
          ) -> tuple:
    """``(loss, metrics)`` of a batch, differentiable; on a model axis
    (an installed policy, the batch this rank's tiles) the encoder's
    output gathered whole (``kv_full``, its backward the sum over the
    tiles).  ``layers``: ``stack -> layer_fn`` (ZeRO-3's gathers)."""
    with _encoder_scope(cfg, batch["frames"]):
        enc_out = shard_act(_encode(cfg, params, batch["frames"],
                                    layers and layers("enc")), "kv_full")
    x = _decode_stream(cfg, params, enc_out, batch["tokens"],
                       layers and layers("dec"))
    return _loss_from_dec(params["outer"], cfg, x, batch)


def loss_fn(cfg: EncDecConfig, params: dict, batch: dict, *, zero=None
            ) -> tuple:
    """Unfused forward ``(loss, metrics)``, differentiable (the baselines'
    path and the fused step's equivalence tests; the unfused step on a
    mesh calls it under the mesh's policy on this rank's tiles).
    ``zero``: params are ZeRO-3 shards and ``batch`` global (evaluation on
    a mesh; the loss and metrics are the global batch's)."""
    if zero is None:
        return _loss(cfg, params, batch)
    with use_policy(zero.policy):
        batch = zero.rows(batch)
        whole = {"outer": zero.gather(params["outer"], zero.dims["outer"]),
                 "stacks": params["stacks"]}
        _, metrics = _loss(cfg, whole, batch, make_param_constraint(zero))
        return metrics["loss"], metrics


# --------------------------------------------------------------------------
# Serving: encode once, cache cross K/V, decode over a self-attention ring
# --------------------------------------------------------------------------

def init_cache(cfg: EncDecConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Empty cache: ``self_k``/``self_v [L, B, max_len, K, dh]`` (the ring),
    ``cross_k``/``cross_v [L, B, n_frames, K, dh]``, all zeros in the
    model's dtype; ``pos [max_len]`` int32 -1 (empty slot); ``cur`` a 0-d
    int32."""
    dev = resolve_device(device)
    K, dh, Ld = cfg.n_kv_heads, cfg.head_dim, cfg.n_dec_layers

    def zeros(n):
        return torch.zeros((Ld, batch, n, K, dh), dtype=cfg.dtype, device=dev)

    return {"self_k": zeros(max_len), "self_v": zeros(max_len),
            "cross_k": zeros(cfg.n_frames), "cross_v": zeros(cfg.n_frames),
            "pos": torch.full((max_len,), -1, dtype=torch.int32, device=dev),
            "cur": torch.zeros((), dtype=torch.int32, device=dev)}


def make_prefill_step(cfg: EncDecConfig, max_decode_len: int = 448):
    """prefill_step(params, batch{'frames': [B, n_frames, d]}) ->
    (enc_out, cache): the encoder's output and a cache holding each decoder
    layer's cross K/V over it and an empty self-attention ring of
    ``max_decode_len`` slots (``cur`` 0)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        frames = batch["frames"]
        B = frames.shape[0]
        K, dh = cfg.n_kv_heads, cfg.head_dim
        enc_out = _encode(cfg, params, frames)
        cache = init_cache(cfg, B, max_decode_len, device=frames.device)
        dec = params["stacks"]["dec"]
        for i in range(cfg.n_dec_layers):
            p = tree_map(lambda t: t[i], dec["cross_attn"])
            cache["cross_k"][i] = L.dense(enc_out, p["wk"]).reshape(
                B, -1, K, dh)
            cache["cross_v"][i] = L.dense(enc_out, p["wv"], p["bv"]).reshape(
                B, -1, K, dh)
        return enc_out, cache

    return prefill_step


def decoder_token(outer: dict, cfg: EncDecConfig, tokens: Tensor,
                  cur: Tensor) -> Tensor:
    """The decoder's input ``[B,1,d]`` of one token a row at position
    ``cur`` (a 0-d int32): its embedding plus row ``min(cur, 2**16 - 1)``
    of the reference's sinusoid table, computed alone on the device."""
    x = F.embedding(tokens, outer["tok_embed"])           # [B,1,d]
    row = torch.clamp_max(cur, _POS_ROWS - 1).to(torch.float32)
    return x + _sinusoid_at(row.reshape(1, 1), cfg.d_model).to(x.dtype)


def decoder_layer(p: dict, cfg: EncDecConfig, x: Tensor, cache: dict,
                  i: int, write: Callable, attend_self: Callable,
                  attend_cross: Callable) -> Tensor:
    """Decoder layer ``i`` on one token a row ``x [B,1,d]``: its self K
    and V put into ``cache``'s rings by ``write(ring, kv [B,1,K,dh])``,
    the self-attention ``attend_self(q [B,1,H,dh], self_k, self_v)`` and
    the cross-attention ``attend_cross(q, cross_k, cross_v)`` over layer
    ``i``'s blocks of the cache (each ``-> [B,H,dh]``), and the MLP, each
    a residual sum."""
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sa, ca = p["self_attn"], p["cross_attn"]

    def attend(pa, h, fn, kc, vc):
        q = L.dense(h, pa["wq"], pa["bq"]).reshape(B, 1, H, dh)
        o = fn(q, kc[i], vc[i])
        return L.dense(o.reshape(B, 1, H * dh), pa["wo"], pa["bo"])

    h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
    write(cache["self_k"][i], L.dense(h, sa["wk"]).reshape(B, 1, K, dh))
    write(cache["self_v"][i],
          L.dense(h, sa["wv"], sa["bv"]).reshape(B, 1, K, dh))
    x = x + attend(sa, h, attend_self, cache["self_k"], cache["self_v"])
    h = L.norm_apply(p["ln_x"], x, kind=cfg.norm)
    x = x + attend(ca, h, attend_cross, cache["cross_k"], cache["cross_v"])
    h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
    return x + L.mlp(p["mlp"], h, cfg.act)


def make_decode_step(cfg: EncDecConfig, *, use_kernel=None):
    """decode_step(params, cache, batch{'tokens': [B,1]}) -> (logits, cache).

    The cache is **updated in place** and returned: this token's position
    ``cur`` is marked in ``pos`` before attention (so the token sees
    itself), its self K/V go into ring slot ``cur % W`` of every layer, and
    ``cur`` advances.  Its sinusoid is row ``min(cur, 2**16 - 1)`` of the
    reference's table, computed alone on the device.  Both attentions go
    through ``ops.decode_attention`` (``use_kernel``: None = K4 for CUDA
    tensors and the plain version for CPU tensors; False = the plain
    version): the cross one with positions ``0..n_frames-1`` and query
    position ``2**30``, device tensors made once per device.  Nothing is
    read back to the host."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    cross_pos: dict = {}

    def cross_positions(T: int, device) -> tuple:
        key = (T, device)
        if key not in cross_pos:
            cross_pos[key] = (_positions(T, device), torch.full(
                (), _CROSS_Q_POS, dtype=torch.int32, device=device))
        return cross_pos[key]

    @torch.no_grad()
    def decode_step(params, cache, batch):
        outer = params["outer"]
        tokens = batch["tokens"]
        cur = cache["cur"]
        x = decoder_token(outer, cfg, tokens, cur)
        slot = torch.remainder(cur, cache["pos"].shape[0]).to(
            torch.int64).reshape(1)
        cache["pos"].index_copy_(0, slot, cur.reshape(1))
        kv_cross, q_cross = cross_positions(cache["cross_k"].shape[2],
                                            tokens.device)

        def write(ring, kv):
            ring.index_copy_(1, slot, kv)

        def attend_self(q, kc, vc):
            return decode_attention(q, kc, vc, cache["pos"], cur,
                                    use_kernel=use_kernel)

        def attend_cross(q, kc, vc):
            return decode_attention(q, kc, vc, kv_cross, q_cross,
                                    use_kernel=use_kernel)

        dec = params["stacks"]["dec"]
        for i in range(cfg.n_dec_layers):
            x = decoder_layer(tree_map(lambda t: t[i], dec), cfg, x,
                              cache, i, write, attend_self, attend_cross)
        logits = _logits(outer, cfg, x)[:, 0]
        cur.add_(1)
        return logits, cache

    return decode_step
