"""Zamba2-style hybrid (PyTorch): a Mamba2 backbone plus a *shared*
attention block.  Counterpart of ``repro.models.hybrid``.

The shared transformer block (attention + MLP, one set of weights) is
applied every ``attn_every`` layers on ``concat(x, x0)`` (x0 = the
embedding output), with a per-application LoRA delta on the qkv
projections — the Zamba2 parameter-sharing trick (arXiv:2411.15242).

On the fused engine (``core/fused.py``) the shared weights live under
``params["shared"]``: their gradients accumulate over the applications, in
the shared weights' own dtype as the reference's ``zeros_like`` does, and
they are updated once a step; ``x0`` rides in the carry, so its gradient
reaches the embedding.  The reference's ``lax.cond`` on the layer index is
a Python ``if``.  On a model axis every layer runs on this rank's
sequence tile: the mamba mixer on the sequence gathered whole
(``mamba2._mix_tile``), the shared block's queries at the tile's absolute
positions against K/V gathered over ``model``, and ``x0`` the tile's own
embedding.  Serving keeps each layer's conv window and SSM state and,
for each application of the shared block, a K/V ring sized to the prompt;
the decode step's attention over that ring (positions shared by the batch)
is ``kernels.decode_attention.ops.decode_attention``: K4 on a CUDA tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.transformer import _seq_ctx
from repro_torch.sharding.act import seq_offset, shard_act

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk: int = 128
    attn_every: int = 6          # shared block applied at layers 0, 6, 12, …
    lora_rank: int = 128
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def mamba_cfg(self) -> M2.Mamba2Config:
        return M2.Mamba2Config(
            name=self.name + "-mamba", n_layers=self.n_layers,
            d_model=self.d_model, vocab=self.vocab, d_state=self.d_state,
            d_conv=self.d_conv, expand=self.expand, headdim=self.headdim,
            n_groups=self.n_groups, chunk=self.chunk, norm=self.norm,
            dtype=self.dtype)

    def n_attn_applications(self) -> int:
        return len(range(0, self.n_layers, self.attn_every))

    def param_count(self) -> int:
        """Total parameters (shapes only; nothing is allocated)."""
        shapes = init_params(0, self, device="meta")
        return sum(math.prod(x.shape) for x in tree_leaves(shapes))

    def active_param_count(self) -> int:
        return self.param_count()


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _block_init(gen, cfg: HybridConfig, device, out: Optional[dict] = None
                ) -> dict:
    """One layer: its mamba2 block and the LoRA deltas of the shared qkv
    (the B sides zero), drawn into ``out`` where it is given."""
    d, H, K, dh, r = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      cfg.lora_rank)
    dt = cfg.dtype
    o = out or {}

    def lin(key, d_in, d_out):
        return L.linear_init(gen, d_in, d_out, dtype=dt, device=device,
                             out=o.get(key))

    def zeros(key, shape):
        return L.zeros_init(shape, dtype=dt, device=device, out=o.get(key))

    return {
        "mamba": M2._block_init(gen, cfg.mamba_cfg(), device,
                                out=o.get("mamba")),
        "lora_qA": lin("lora_qA", 2 * d, r),
        "lora_qB": zeros("lora_qB", (r, H * dh)),
        "lora_kA": lin("lora_kA", 2 * d, r),
        "lora_kB": zeros("lora_kB", (r, K * dh)),
        "lora_vA": lin("lora_vA", 2 * d, r),
        "lora_vB": zeros("lora_vB", (r, K * dh)),
    }


def init_params(seed: int, cfg: HybridConfig, *, device="cuda") -> dict:
    """Params in the fused-engine layout ``{outer, shared, stacks}``, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``; the
    shared attention block (on ``concat(x, x0)``) under ``shared``."""
    dev, gen = L.init_generator(seed, device)
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype

    def lin(d_in, d_out):
        return L.linear_init(gen, d_in, d_out, dtype=dt, device=dev)

    outer = {
        "tok_embed": L.embed_init(gen, cfg.vocab, d, dtype=dt, device=dev),
        "final_norm": L.norm_init(d, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        outer["head"] = lin(d, cfg.vocab)
    shared = {
        "in_ln": L.norm_init(2 * d, cfg.norm, device=dev),
        "wq": lin(2 * d, H * dh),
        "wk": lin(2 * d, K * dh),
        "wv": lin(2 * d, K * dh),
        "wo": lin(H * dh, d),
        "mlp_ln": L.norm_init(d, cfg.norm, device=dev),
        "w_gate": lin(d, cfg.d_ff),
        "w_up": lin(d, cfg.d_ff),
        "w_down": lin(cfg.d_ff, d),
    }
    blocks = L.stacked_blocks(cfg.n_layers, lambda g, dv, out: _block_init(
        g, cfg, dv, out=out), gen, dev)
    return {"outer": outer, "shared": shared, "stacks": {"blocks": blocks}}


# --------------------------------------------------------------------------
# The shared attention block
# --------------------------------------------------------------------------

def _shared_attn(shared: dict, p: dict, cfg: HybridConfig, x: Tensor,
                 x0: Tensor, pos: Tensor, cache=None, cur=None,
                 use_kernel=None, kv_pos=None, whole_kv: bool = False
                 ) -> tuple:
    """Shared attention block on ``concat(x, x0)`` with this layer's LoRA.

    Train form (``cache`` None): causal attention over the sequence at
    ``pos`` (``(S,)`` int); returns ``(x, (k, v))`` with this application's
    roped k and v ``[B,S,K,dh]`` (what a prefill records).  On a model
    axis ``x`` and ``x0`` are this rank's sequence tile, ``pos`` its
    absolute positions and ``kv_pos`` the whole sequence's: the tile's
    queries attend to K/V gathered over ``model`` (``kv_full``), as the
    transformer family's do; the k and v returned are the tile's
    (``whole_kv``: the whole sequence's, as gathered).

    Decode form: ``cache = (kc, vc, pos_tab)``, the ring ``[B,W,K,dh]``
    and its slot positions ``[W]`` (this token's already marked), ``cur``
    the 0-d int32 position; this token's k and v go into slot ``cur % W``
    in place, and the attention over the ring is ``ops.decode_attention``
    (K4 on a CUDA tensor unless ``use_kernel=False``); returns
    ``(x, None)``."""
    S = x.shape[1]
    q, k, v = shared_qkv(shared, p, cfg, x, x0, pos)
    if cache is None:
        kg, vg = shard_act(k, "kv_full"), shard_act(v, "kv_full")
        o = L.attention(q, kg, vg, spec=L.MaskSpec(causal=True), q_pos=pos,
                        kv_pos=pos if kv_pos is None else kv_pos,
                        q_offset=seq_offset(S))
        kv = (kg, vg) if whole_kv else (k, v)
    else:
        from repro_torch.kernels.decode_attention.ops import decode_attention
        kc, vc, pos_tab = cache
        slot = torch.remainder(cur, kc.shape[1]).to(torch.int64).reshape(1)
        kc.index_copy_(1, slot, k)
        vc.index_copy_(1, slot, v)
        o = decode_attention(q, kc, vc, pos_tab, cur, use_kernel=use_kernel)
        kv = None
    return shared_out(shared, cfg, x, o), kv


def shared_qkv(shared: dict, p: dict, cfg: HybridConfig, x: Tensor,
               x0: Tensor, pos: Tensor) -> tuple:
    """The shared block's roped ``q [B,S,H,dh]``, ``k`` and ``v [B,S,K,dh]``
    of ``concat(x, x0)`` at ``pos``, with this layer's LoRA deltas."""
    B, S, _ = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hN = L.norm_apply(shared["in_ln"], torch.cat([x, x0], dim=-1),
                      kind=cfg.norm)

    def proj(name):
        return (L.dense(hN, shared["w" + name])
                + L.dense(L.dense(hN, p[f"lora_{name}A"]), p[f"lora_{name}B"]))

    q = proj("q").reshape(B, S, H, dh)
    k = proj("k").reshape(B, S, K, dh)
    v = proj("v").reshape(B, S, K, dh)
    sin, cos = L.rope_sincos(pos, dh, cfg.rope_theta)
    return L.apply_rope(q, sin, cos), L.apply_rope(k, sin, cos), v


def shared_out(shared: dict, cfg: HybridConfig, x: Tensor, o: Tensor
               ) -> Tensor:
    """``x`` plus the shared block's output projection of the attention
    ``o [B,S,H,dh]``, then plus its MLP."""
    B, S, _ = x.shape
    x = x + L.dense(o.reshape(B, S, cfg.n_heads * cfg.head_dim),
                    shared["wo"])
    hM = L.norm_apply(shared["mlp_ln"], x, kind=cfg.norm)
    return x + L.glu_mlp({"w_gate": shared["w_gate"], "w_up": shared["w_up"],
                          "w_down": shared["w_down"]}, hM)


def attn_layers(cfg: HybridConfig) -> frozenset:
    """The layers whose body applies the shared block: 0, attn_every, ..."""
    return frozenset(range(0, cfg.n_layers, cfg.attn_every))


# --------------------------------------------------------------------------
# Fused-engine spec (train path)
# --------------------------------------------------------------------------

def make_block_body(cfg: HybridConfig):
    mc = cfg.mamba_cfg()
    with_attn = attn_layers(cfg)

    def body(p, ctx, carry, idx):
        shared, ctx_act = ctx
        x, x0, aux = carry
        h = L.norm_apply(p["mamba"]["ln"], x, kind=cfg.norm)
        x = x + M2.mamba2_mix(p["mamba"], mc, h)
        if idx in with_attn:
            x = _shared_attn(shared, p, cfg, x, x0, ctx_act["pos"],
                             kv_pos=ctx_act.get("kv_pos"))[0]
        return (x, x0, aux)

    return body


def make_fused_spec(cfg: HybridConfig):
    from repro_torch.core.fused import FusedSpec

    def prologue(outer, batch):
        x = M2.embed(outer, batch["tokens"])
        return (x, x, torch.zeros((), dtype=torch.float32, device=x.device))

    def pro_ctx(outer, batch):
        # int positions: the port differentiates the carry and the
        # parameters, never the context; on a model axis the tile's own
        # (absolute) and the whole sequence's (``kv_pos``)
        tokens = batch["tokens"]
        return _seq_ctx(tokens.shape[1], tokens.device)

    return FusedSpec(prologue=prologue,
                     bodies={"blocks": make_block_body(cfg)},
                     epilogue=M2.make_epilogue(cfg), pro_ctx=pro_ctx)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------

def init_cache(cfg: HybridConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Mamba states are O(1); K/V rings ``[n_app, B, max_len, K, dh]`` exist
    only for the applications of the shared block.  ``pos [max_len]`` int32
    -1 (empty slot); ``cur`` a 0-d int32."""
    dev = resolve_device(device)
    n_app = cfg.n_attn_applications()
    kv = (n_app, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = M2.init_state_cache(cfg.mamba_cfg(), batch, device=dev)
    cache.update({
        "attn_k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "attn_v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=dev),
    })
    return cache


def prefill_layers(cfg: HybridConfig, shared: dict, x0: Tensor, pos: Tensor,
                   layer: Callable, mix: Callable, keep_kv: Callable, *,
                   kv_pos=None, whole_kv: bool = False) -> Tensor:
    """The prefill's layers from the embedding ``x0``: layer ``i``'s
    params ``layer(i)``, its mamba mixer ``mix(p["mamba"], h, i)`` on the
    normed ``h`` (which keeps the layer's conv tail and SSM state), and
    after each application ``a`` of the shared block (:func:`_shared_attn`
    at ``pos``, ``kv_pos`` and ``whole_kv``) its K/V handed to
    ``keep_kv(a, k, v)``; returns the last hidden state."""
    with_attn = attn_layers(cfg)
    x, a = x0, 0
    for i in range(cfg.n_layers):
        p = layer(i)
        h = L.norm_apply(p["mamba"]["ln"], x, kind=cfg.norm)
        x = x + mix(p["mamba"], h, i)
        if i in with_attn:
            x, (k, v) = _shared_attn(shared, p, cfg, x, x0, pos,
                                     kv_pos=kv_pos, whole_kv=whole_kv)
            keep_kv(a, k, v)
            a += 1
    return x


def make_prefill_step(cfg: HybridConfig, max_len: Optional[int] = None):
    """prefill_step(params, batch{'tokens': [B,S]}) -> (last_logits, cache):
    the full-sequence forward, a Python loop over the layers keeping each
    layer's conv tail and SSM state and each application's roped K/V in a
    ring of ``W = max_len or S`` slots (slot j holds position j; the tail
    past S is empty, position -1); ``cur`` is S."""
    mc = cfg.mamba_cfg()

    @torch.no_grad()
    def prefill_step(params, batch):
        outer = params["outer"]
        tokens = batch["tokens"]
        B, S = tokens.shape
        M2.check_prompt(cfg, S)
        W = max_len or S
        x0 = M2.embed(outer, tokens)
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
        cache = init_cache(cfg, B, W, device=tokens.device)
        blocks = params["stacks"]["blocks"]

        def mix(pm, h, i):
            y, cache["conv"][i], cache["ssm"][i] = M2._mix_seq(
                pm, mc, h, return_state=True)
            return y

        def keep_kv(a, k, v):
            cache["attn_k"][a, :, :S] = k
            cache["attn_v"][a, :, :S] = v

        x = prefill_layers(cfg, params["shared"], x0, pos,
                           lambda i: tree_map(lambda t: t[i], blocks), mix,
                           keep_kv)
        cache["pos"][:S] = pos
        cache["cur"].fill_(S)
        h = L.norm_apply(outer["final_norm"], x[:, -1:], kind=cfg.norm)
        return M2.logits(outer, cfg, h)[:, 0], cache

    return prefill_step


def make_decode_step(cfg: HybridConfig, *, use_kernel=None):
    """decode_step(params, cache, batch{'tokens': [B,1]}) -> (logits, cache).

    The cache is **updated in place** and returned: this token's position
    is marked in ``pos`` before attention (so the token sees itself), every
    layer's conv window and SSM state advance, each application writes its
    K/V into slot ``cur % W`` of its ring, and ``cur`` advances.
    ``use_kernel`` as in ``kernels.decode_attention.ops``: None = K4 for
    CUDA tensors and the plain version for CPU tensors."""
    mc = cfg.mamba_cfg()
    with_attn = attn_layers(cfg)

    @torch.no_grad()
    def decode_step(params, cache, batch):
        outer = params["outer"]
        x0 = M2.embed(outer, batch["tokens"])                # [B,1,d]
        cur = cache["cur"]
        slot = torch.remainder(cur, cache["pos"].shape[0]).to(
            torch.int64).reshape(1)
        cache["pos"].index_copy_(0, slot, cur.reshape(1))
        pos = cur.reshape(1)
        shared, blocks = params["shared"], params["stacks"]["blocks"]
        x, a = x0, 0
        for i in range(cfg.n_layers):
            p = tree_map(lambda t: t[i], blocks)
            x = M2.decode_mix(p["mamba"], mc, x, cache, i)
            if i in with_attn:
                x, _ = _shared_attn(
                    shared, p, cfg, x, x0, pos,
                    cache=(cache["attn_k"][a], cache["attn_v"][a],
                           cache["pos"]), cur=cur, use_kernel=use_kernel)
                a += 1
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = M2.logits(outer, cfg, h)[:, 0]
        cur.add_(1)
        return logits, cache

    return decode_step
