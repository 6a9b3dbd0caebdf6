"""Decoder-only LM family (PyTorch), dense GQA: the train half and the
paged-serving half.

Counterpart of ``repro.models.transformer``: scan-over-layers layout with
stacked ``[L, ...]`` params so the fused AdaLomo backward (``core/fused.py``)
applies.  Ported: dense GQA blocks with ``qk_norm``, sliding ``window``,
``tie_embeddings`` and ``z_loss``; for serving, ``make_prefill_kv_step``,
``make_paged_decode_step`` and ``init_page_pool`` (the page pool is updated
in place).  MoE, MLA, MTP and prefix-LM configs raise
``NotImplementedError``; the legacy ring-cache serving path
(``make_prefill_step``, ``make_decode_step``, ``init_cache``) is a later
slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as L

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    norm: str = "rmsnorm"
    qk_norm: bool = False
    window: Optional[int] = None          # SWA
    rope_theta: float = 10000.0
    rope_pct: float = 1.0
    act: str = "silu"
    glu: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False             # gemma-style sqrt(d) embed scaling
    # Fields of model families that are not ported yet; a config that sets
    # one raises in check_supported().
    prefix_lm: bool = False
    n_prefix_tokens: int = 0
    moe: Any = None
    mla: Any = None
    mtp: bool = False
    mtp_weight: float = 0.1
    z_loss: float = 0.0
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Total parameters (shapes only; nothing is allocated)."""
        shapes = init_params(0, self, device="meta")
        return sum(math.prod(x.shape) for x in tree_leaves(shapes))


def check_supported(cfg: LMConfig) -> None:
    """Raise for configurations whose code path is not ported yet."""
    for field, what in (("moe", "mixture-of-experts FFN"),
                        ("mla", "multi-head latent attention"),
                        ("mtp", "multi-token prediction"),
                        ("prefix_lm", "prefix-LM masks"),
                        ("n_prefix_tokens", "modality prefix embeddings")):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"LMConfig.{field}: {what} is not ported yet (dense GQA "
                "transformers only)")
    if not cfg.glu:
        raise NotImplementedError("LMConfig.glu=False: the plain 2-layer MLP "
                                  "is not ported yet")


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _attn_init(gen, cfg: LMConfig, device) -> dict:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    p = {
        "wq": L.linear_init(gen, d, H * dh, dtype=dt, device=device),
        "wk": L.linear_init(gen, d, K * dh, dtype=dt, device=device),
        "wv": L.linear_init(gen, d, K * dh, dtype=dt, device=device),
        "wo": L.linear_init(gen, H * dh, d, scale=(2 * cfg.n_layers) ** -0.5,
                            dtype=dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.norm_init(dh, "rmsnorm", device=device)
        p["k_norm"] = L.norm_init(dh, "rmsnorm", device=device)
    return p


def _block_init(gen, cfg: LMConfig, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.dtype
    return {
        "ln1": L.norm_init(d, cfg.norm, device=device),
        "ln2": L.norm_init(d, cfg.norm, device=device),
        "attn": _attn_init(gen, cfg, device),
        "mlp": {
            "w_gate": L.linear_init(gen, d, f, dtype=dt, device=device),
            "w_up": L.linear_init(gen, d, f, dtype=dt, device=device),
            "w_down": L.linear_init(gen, f, d,
                                    scale=(2 * cfg.n_layers) ** -0.5,
                                    dtype=dt, device=device),
        },
    }


def init_params(seed: int, cfg: LMConfig, *, device="cuda") -> dict:
    """Params in the fused-engine layout ``{outer, shared, stacks}``, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``.  The
    layer stack is filled one layer at a time, so no second copy of the
    model is ever alive."""
    check_supported(cfg)
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    outer = {
        "tok_embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                  dtype=cfg.dtype, device=dev),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        outer["head"] = L.linear_init(gen, cfg.d_model, cfg.vocab,
                                      dtype=cfg.dtype, device=dev)
    layer = _block_init(gen, cfg, dev)
    blocks = tree_map(lambda t: t.new_empty((cfg.n_layers,) + t.shape), layer)
    for i in range(cfg.n_layers):
        if i:
            layer = _block_init(gen, cfg, dev)
        if dev.type != "meta":
            tree_map(lambda dst, src: dst[i].copy_(src), blocks, layer)
    return {"outer": outer, "shared": {}, "stacks": {"blocks": blocks}}


# --------------------------------------------------------------------------
# Attention path
# --------------------------------------------------------------------------

def _rope_tables(cfg: LMConfig, pos: Tensor) -> tuple:
    d_rot = int(cfg.head_dim * cfg.rope_pct) // 2 * 2
    return L.rope_sincos(pos, d_rot, cfg.rope_theta)


def _qkv(p: dict, cfg: LMConfig, h: Tensor, sin: Tensor, cos: Tensor
         ) -> tuple:
    """Projections of ``h [B,S,d]`` with RoPE on q and k: q ``[B,S,H,dh]``,
    k and v ``[B,S,K,dh]`` (k and v are what a KV cache holds)."""
    B, S, _ = h.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(h, p["wq"]).reshape(B, S, H, dh)
    k = L.dense(h, p["wk"]).reshape(B, S, K, dh)
    v = L.dense(h, p["wv"]).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"]["scale"])
        k = L.rmsnorm(k, p["k_norm"]["scale"])
    q = L.apply_rope(q, sin, cos, cfg.rope_pct)
    k = L.apply_rope(k, sin, cos, cfg.rope_pct)
    return q, k, v


def _gqa_attn_kv(p: dict, cfg: LMConfig, h: Tensor, pos: Tensor) -> tuple:
    """Causal (SWA) self-attention over the sequence; returns the block's
    attention output and this layer's roped k and v."""
    B, S, _ = h.shape
    sin, cos = _rope_tables(cfg, pos)
    q, k, v = _qkv(p, cfg, h, sin, cos)
    spec = L.MaskSpec(causal=True, window=cfg.window)
    o = L.attention(q, k, v, spec=spec, q_pos=pos, kv_pos=pos)
    return L.dense(o.reshape(B, S, -1), p["wo"]), k, v


def _mlp_residual(p: dict, cfg: LMConfig, x: Tensor) -> Tensor:
    h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
    return x + L.glu_mlp(p["mlp"], h, cfg.act)


# --------------------------------------------------------------------------
# Fused-engine spec (train path)
# --------------------------------------------------------------------------

def make_block_body(cfg: LMConfig):
    def body(p, ctx, carry, aux_idx):
        del aux_idx
        _, ctx_act = ctx
        x, aux_loss = carry
        pos = ctx_act["pos"]        # int positions; never differentiated
        h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
        x = x + _gqa_attn_kv(p["attn"], cfg, h, pos)[0]
        return (_mlp_residual(p, cfg, x), aux_loss)

    return body


def _embed(outer: dict, cfg: LMConfig, tokens: Tensor) -> Tensor:
    # F.embedding and not tok_embed[tokens]: its backward on CUDA sorts the
    # indices and sums each row's contributions in a fixed order, where the
    # backward of advanced indexing scatters with float atomics.
    x = F.embedding(tokens, outer["tok_embed"])
    if cfg.embed_scale:
        x = x * (cfg.d_model ** 0.5)
    return x


def _logits(outer: dict, cfg: LMConfig, h: Tensor) -> Tensor:
    """fp32 logits: fp32 accumulation and fp32 output from the parameters'
    dtype, as the reference's ``preferred_element_type=float32``."""
    w = outer["tok_embed"].T if cfg.tie_embeddings else outer["head"]
    return torch.matmul(h.to(torch.float32), w.to(torch.float32))


def cross_entropy(logits: Tensor, labels: Tensor, z_loss: float = 0.0
                  ) -> tuple:
    """Masked CE. labels < 0 are ignored. Returns (loss, ntok, ncorrect)."""
    mask = labels >= 0
    lab = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    nll = (lse - ll) * mask
    loss = torch.sum(nll)
    if z_loss:
        loss = loss + z_loss * torch.sum(torch.square(lse) * mask)
    ntok = torch.sum(mask)
    correct = torch.sum((torch.argmax(logits, dim=-1) == lab) & mask)
    return loss, ntok, correct


def make_prologue(cfg: LMConfig):
    def prologue(outer, batch):
        x = _embed(outer, cfg, batch["tokens"])
        return (x, torch.zeros((), dtype=torch.float32, device=x.device))

    return prologue


def make_pro_ctx(cfg: LMConfig):
    def pro_ctx(outer, batch):
        # Positions travel as integers: the port differentiates only the
        # carry and the parameters, never the context.
        if "segment_ids" in batch:
            raise NotImplementedError(
                "packed (segment-id) batches are not ported yet")
        tokens = batch["tokens"]
        return {"pos": torch.arange(tokens.shape[1], dtype=torch.int32,
                                    device=tokens.device)}

    return pro_ctx


def make_epilogue(cfg: LMConfig):
    def epilogue(outer, carry, batch):
        x, aux_loss = carry
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = _logits(outer, cfg, h)
        loss_sum, ntok, correct = cross_entropy(logits, batch["labels"],
                                                cfg.z_loss)
        denom = torch.clamp_min(ntok, 1).to(torch.float32)
        loss = loss_sum / denom + aux_loss
        metrics = {
            "loss": loss.detach(),
            "ntokens": ntok.to(torch.float32),
            "accuracy": correct.to(torch.float32) / denom,
        }
        return loss, metrics

    return epilogue


def make_fused_spec(cfg: LMConfig):
    from repro_torch.core.fused import FusedSpec
    check_supported(cfg)
    return FusedSpec(
        prologue=make_prologue(cfg),
        bodies={"blocks": make_block_body(cfg)},
        epilogue=make_epilogue(cfg),
        pro_ctx=make_pro_ctx(cfg),
    )


# --------------------------------------------------------------------------
# Paged serving: prefill emits full per-layer K/V; decode reads/writes a
# shared page pool through per-sequence block tables (serve/paging.py).
# --------------------------------------------------------------------------

def _layer(blocks: dict, i: int) -> dict:
    """Layer ``i`` of the stacked ``[L, ...]`` block params (views)."""
    return tree_map(lambda t: t[i], blocks)


def make_prefill_kv_step(cfg: LMConfig):
    """prefill(params, batch{'tokens': [B,S], 'length': [B]}) ->
    (logits [B,vocab] at position length-1, k [L,B,S,K,dh], v [L,B,S,K,dh]).

    Keeps the *full* per-layer K/V (no ring truncation) so the engine can
    scatter it into KV pages; SWA is enforced by the decode-attention mask.
    Right-padding is harmless: with a causal mask, K/V at positions < length
    never see the pad tail, and logits are gathered at length-1.  Goes
    through the direct attention branch, so S is at most 2048."""
    check_supported(cfg)

    @torch.no_grad()
    def prefill(params, batch):
        outer = params["outer"]
        tokens = batch["tokens"]
        length = batch["length"].to(torch.int64)
        B, S = tokens.shape
        x = _embed(outer, cfg, tokens)
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
        blocks = params["stacks"]["blocks"]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
            a, k, v = _gqa_attn_kv(p["attn"], cfg, h, pos)
            ks.append(k)
            vs.append(v)
            x = _mlp_residual(p, cfg, x + a)
        last = torch.clamp_min(length - 1, 0)[:, None, None].expand(
            B, 1, x.shape[-1])
        h = L.norm_apply(outer["final_norm"], torch.gather(x, 1, last),
                         kind=cfg.norm)
        logits = _logits(outer, cfg, h)[:, 0]
        return logits, torch.stack(ks), torch.stack(vs)

    return prefill


def make_paged_decode_step(cfg: LMConfig, *, use_kernel=None):
    """decode(params, pages, batch) -> (logits [B,vocab], pages).

    pages: {'k','v': [L, N, ps, K, dh]} — the shared page pool, **updated in
    place** (this token's K/V is written into ``pages[l]`` and the attention
    reads that same slice; the pool is never copied).
    batch: tokens [B,1]; block_tables [B,P] int32 (page ids, logical order,
    unallocated tail = scratch page 0); seq_lens [B] int32 tokens already
    cached (== position of the incoming token); emit [B] bool — rows that
    are live this step.  Frozen rows write their K/V to the scratch page and
    their logits are garbage by construction; the engine masks them.
    ``use_kernel`` as in ``kernels.decode_attention.ops``: None = the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    check_supported(cfg)
    from repro_torch.kernels.decode_attention.ops import paged_decode_attention

    @torch.no_grad()
    def decode(params, pages, batch):
        outer = params["outer"]
        tokens = batch["tokens"]
        bt = batch["block_tables"]
        n = batch["seq_lens"].to(torch.int32)              # [B]
        emit = batch["emit"]
        B = tokens.shape[0]
        ps, P = pages["k"].shape[2], bt.shape[1]

        x = _embed(outer, cfg, tokens)                     # [B,1,d]
        # page/slot the incoming token lands in; frozen rows -> scratch 0
        col = torch.clamp(n // ps, max=P - 1).to(torch.int64)[:, None]
        pidx = torch.where(emit, bt.gather(1, col)[:, 0], 0).to(torch.int64)
        slot = torch.where(emit, n % ps, 0).to(torch.int64)
        n_incl = n + 1                                     # incl. this token
        sin, cos = _rope_tables(cfg, n[:, None])           # [B,1,d_rot/2]
        blocks = params["stacks"]["blocks"]
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
            q, k, v = _qkv(p["attn"], cfg, h, sin, cos)
            kp, vp = pages["k"][i], pages["v"][i]
            kp[pidx, slot] = k[:, 0]
            vp[pidx, slot] = v[:, 0]
            o = paged_decode_attention(q, kp, vp, bt, n_incl,
                                       window=cfg.window,
                                       use_kernel=use_kernel)
            a = L.dense(o.reshape(B, 1, -1), p["attn"]["wo"])
            x = _mlp_residual(p, cfg, x + a)
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = _logits(outer, cfg, h)[:, 0]
        return logits, pages

    return decode


def init_page_pool(cfg: LMConfig, num_pages: int, page_size: int, *,
                   device="cuda") -> dict:
    """Zeroed shared KV page pool (page 0 is the engine's scratch page)."""
    check_supported(cfg)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
