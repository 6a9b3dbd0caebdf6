"""Decoder-only LM family (PyTorch): GQA or multi-head latent attention
(MLA) over a dense or a mixture-of-experts FFN, with an optional
multi-token-prediction (MTP) head — the train half and both serving halves.

Counterpart of ``repro.models.transformer``: scan-over-layers layout with
stacked ``[L, ...]`` params so the fused AdaLomo backward (``core/fused.py``)
applies.  Ported: GQA blocks with ``qk_norm``, sliding ``window``, partial
rotary, rmsnorm or layernorm, ``tie_embeddings`` and ``z_loss``; MLA
(DeepSeek-V3: a low-rank query, a shared latent KV plus one RoPE key, q/k
head dim ``d_nope + d_rope`` against v head dim ``d_v``); the MoE FFN
(``models/moe.py``), whose load-balance loss the train body adds to the
carry; and the MTP head, one dense block over ``[h_t ; emb(token_t)]``
scored against ``labels_mtp``.  For paged serving (GQA only, as in the
reference) ``make_prefill_kv_step``, ``make_paged_decode_step`` and
``init_page_pool``; for the legacy engine's ring cache ``cache_window``,
``init_cache``, ``make_prefill_step`` and ``make_decode_step``, whose MLA
cache is the latent ``ckv``/``kr`` and whose MLA decode scores in latent
space (the absorbed matmuls).  Decode steps update the page pool or the
cache in place.  The train half takes packed batches (``segment_ids`` and
per-document ``positions``): RoPE restarts at every document and attention
never crosses one.  Prefix-LM configs (paligemma-3b) prepend the batch's
``prefix_embed`` (a stubbed modality frontend's patch embeddings) to the
token embeddings and open the first ``prefix_len`` positions to every
query; the legacy ring serves them, the paged halves refuse them, as the
reference's do.  ``glu=False`` configs take the plain two-layer MLP with
biases (``layers.mlp``) in place of the GLU.  On a model axis (sequence
parallelism) the train half runs on this rank's sequence tile: GQA gathers
K/V over ``model``, MLA its per-token latent, and the MTP head's block
attends as the main blocks do.  A modality prefix counts in the tiled
sequence: the ``P + S`` rows are tiled evenly, so a tile holds prefix
rows, token rows or both (``sharding/zero.py::Zero3.rows``), attends at its
absolute positions, and scores only its token rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, moe_ffn, moe_init
from repro_torch.sharding.act import (batch_sum, current_policy,
                                      gather_tiles, model_size, seq_offset,
                                      shard_act)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


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
    prefix_lm: bool = False               # prefix-LM mask over the prefix
    n_prefix_tokens: int = 0              # modality prefix (prefix_embed)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mtp: bool = False                     # deepseek-v3 multi-token prediction
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

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k routed only)."""
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        E, K, f, d = (self.moe.n_routed, self.moe.top_k,
                      self.moe.d_ff_expert, self.d_model)
        routed = self.n_layers * E * 3 * d * f
        active_routed = self.n_layers * K * 3 * d * f
        return total - routed + active_routed


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _attn_init(gen, cfg: LMConfig, device, out: Optional[dict] = None
               ) -> dict:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype
    o = out or {}

    def lin(key, d_in, d_out, **kw):
        return L.linear_init(gen, d_in, d_out, dtype=dt, device=device,
                             out=o.get(key), **kw)

    def norm(key, width):
        return L.norm_init(width, "rmsnorm", device=device, out=o.get(key))

    wo_scale = (2 * cfg.n_layers) ** -0.5
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "w_dq": lin("w_dq", d, m.q_lora_rank),
            "q_ln": norm("q_ln", m.q_lora_rank),
            "w_uq": lin("w_uq", m.q_lora_rank, H * (m.d_nope + m.d_rope)),
            "w_dkv": lin("w_dkv", d, m.kv_lora_rank),
            "kv_ln": norm("kv_ln", m.kv_lora_rank),
            "w_kr": lin("w_kr", d, m.d_rope),
            "w_uk": lin("w_uk", m.kv_lora_rank, H * m.d_nope),
            "w_uv": lin("w_uv", m.kv_lora_rank, H * m.d_v),
            "wo": lin("wo", H * m.d_v, d, scale=wo_scale),
        }
    p = {
        "wq": lin("wq", d, H * dh),
        "wk": lin("wk", d, K * dh),
        "wv": lin("wv", d, K * dh),
        "wo": lin("wo", H * dh, d, scale=wo_scale),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm("q_norm", dh)
        p["k_norm"] = norm("k_norm", dh)
    return p


def _block_init(gen, cfg: LMConfig, device, out: Optional[dict] = None
                ) -> dict:
    """One layer's params, drawn into ``out`` (views of one layer of the
    stack) where it is given."""
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.dtype
    o = out or {}
    p = {
        "ln1": L.norm_init(d, cfg.norm, device=device, out=o.get("ln1")),
        "ln2": L.norm_init(d, cfg.norm, device=device, out=o.get("ln2")),
        "attn": _attn_init(gen, cfg, device, out=o.get("attn")),
    }
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, d, cfg.moe, dtype=dt, device=device,
                            out=o.get("moe"))
    elif cfg.glu:
        mlp = o.get("mlp", {})
        p["mlp"] = {
            "w_gate": L.linear_init(gen, d, f, dtype=dt, device=device,
                                    out=mlp.get("w_gate")),
            "w_up": L.linear_init(gen, d, f, dtype=dt, device=device,
                                  out=mlp.get("w_up")),
            "w_down": L.linear_init(gen, f, d,
                                    scale=(2 * cfg.n_layers) ** -0.5,
                                    dtype=dt, device=device,
                                    out=mlp.get("w_down")),
        }
    else:
        p["mlp"] = L.mlp_init(gen, d, f, dtype=dt, device=device,
                              out=o.get("mlp"))
    return p


def _mtp_cfg(cfg: LMConfig) -> LMConfig:
    """The MTP block's config: the model's attention, a dense GLU MLP."""
    return dataclasses.replace(cfg, moe=None, mtp=False)


def init_params(seed: int, cfg: LMConfig, *, device="cuda") -> dict:
    """Params in the fused-engine layout ``{outer, shared, stacks}``, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``.  The
    layer stack is allocated once and each layer drawn straight into it, so
    no copy of a layer is ever made."""
    dev, gen = L.init_generator(seed, device)
    outer = {
        "tok_embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                  dtype=cfg.dtype, device=dev),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        outer["head"] = L.linear_init(gen, cfg.d_model, cfg.vocab,
                                      dtype=cfg.dtype, device=dev)
    if cfg.mtp:
        # the MTP block is dense (the routed experts live in the main stack)
        outer["mtp_proj"] = L.linear_init(gen, 2 * cfg.d_model, cfg.d_model,
                                          dtype=cfg.dtype, device=dev)
        outer["mtp_block"] = _block_init(gen, _mtp_cfg(cfg), dev)
        outer["mtp_norm"] = L.norm_init(cfg.d_model, cfg.norm, device=dev)
    blocks = L.stacked_blocks(cfg.n_layers, lambda g, dv, out: _block_init(
        g, cfg, dv, out=out), gen, dev)
    return {"outer": outer, "shared": {}, "stacks": {"blocks": blocks}}


# --------------------------------------------------------------------------
# Attention path
# --------------------------------------------------------------------------

def _rope_tables(cfg: LMConfig, pos: Tensor) -> tuple:
    """sin/cos at ``pos``: over the rotated part of a GQA head, or over
    MLA's ``d_rope`` wide RoPE part."""
    if cfg.mla is not None:
        d_rot = cfg.mla.d_rope
    else:
        d_rot = int(cfg.head_dim * cfg.rope_pct) // 2 * 2
    return L.rope_sincos(pos, d_rot, cfg.rope_theta)


def _qkv(p: dict, cfg: LMConfig, h: Tensor, sin: Tensor, cos: Tensor
         ) -> tuple:
    """Projections of ``h [B,S,d]`` with RoPE on q and k: q ``[B,S,H,dh]``,
    k and v ``[B,S,K,dh]`` (k and v are what a KV cache holds)."""
    B, S, _ = h.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = shard_act(L.dense(h, p["wq"]).reshape(B, S, H, dh), "heads")
    k = shard_act(L.dense(h, p["wk"]).reshape(B, S, K, dh), "heads")
    v = shard_act(L.dense(h, p["wv"]).reshape(B, S, K, dh), "heads")
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"]["scale"])
        k = L.rmsnorm(k, p["k_norm"]["scale"])
    q = L.apply_rope(q, sin, cos, cfg.rope_pct)
    k = L.apply_rope(k, sin, cos, cfg.rope_pct)
    return q, k, v


def _mask_spec(cfg: LMConfig, seg: Optional[Tensor]) -> L.MaskSpec:
    return L.MaskSpec(causal=True, window=cfg.window,
                      has_prefix=cfg.prefix_lm, segmented=seg is not None)


def _gqa_attn_kv(p: dict, cfg: LMConfig, h: Tensor, pos: Tensor,
                 seg: Optional[Tensor] = None,
                 prefix_len: Optional[Tensor] = None, kv_pos=None,
                 kv_seg=None, whole_kv: bool = False) -> tuple:
    """Causal (SWA) self-attention over the sequence; returns the block's
    attention output and this layer's roped k and v.  ``pos`` is ``(S,)``,
    or ``(B, S)`` for a packed batch, whose ``seg [B, S]`` keeps attention
    inside each document (RoPE phases restart with the positions);
    ``prefix_len [B]`` opens each row's prefix to every query (prefix-LM).

    Sequence parallelism (a model axis): ``h`` is this rank's sequence
    tile, ``pos``/``seg`` its positions and segment ids and
    ``kv_pos``/``kv_seg`` the whole sequence's; the tile's queries attend
    to K/V gathered over ``model`` (``kv_full``).  The k and v returned are
    the tile's, or with ``whole_kv`` the whole sequence's (what a sharded
    prefill cuts its cache block from, ``serve/sharded.py``)."""
    B, S, _ = h.shape
    sin, cos = _rope_tables(cfg, pos)
    q, k, v = _qkv(p, cfg, h, sin, cos)
    k_all, v_all = shard_act(k, "kv_full"), shard_act(v, "kv_full")
    if whole_kv:
        k, v = k_all, v_all
    o = L.attention(q, k_all, v_all,
                    spec=_mask_spec(cfg, seg), q_pos=pos,
                    kv_pos=pos if kv_pos is None else kv_pos,
                    prefix_len=prefix_len, q_seg=seg,
                    kv_seg=seg if kv_seg is None else kv_seg,
                    q_offset=seq_offset(S))
    o = shard_act(o, "heads")
    return shard_act(L.dense(o.reshape(B, S, -1), p["wo"]), "hidden"), k, v


def _mla_query(p: dict, cfg: LMConfig, h: Tensor, sin: Tensor, cos: Tensor
               ) -> tuple:
    """MLA's low-rank query of ``h [B,S,d]``: ``q_nope [B,S,H,d_nope]`` and
    the roped ``q_rope [B,S,H,d_rope]``."""
    m = cfg.mla
    B, S, _ = h.shape
    q = L.dense(L.rmsnorm(L.dense(h, p["w_dq"]), p["q_ln"]["scale"]),
                p["w_uq"]).reshape(B, S, cfg.n_heads, m.d_nope + m.d_rope)
    return q[..., :m.d_nope], L.apply_rope(q[..., m.d_nope:], sin, cos)


def _mla_latent(p: dict, cfg: LMConfig, h: Tensor, sin: Tensor, cos: Tensor
                ) -> tuple:
    """What MLA's cache holds for ``h [B,S,d]``: the normed latent
    ``ckv [B,S,kv_lora_rank]`` and the roped key ``kr [B,S,d_rope]`` that
    every head shares."""
    B, S, _ = h.shape
    d_rope = cfg.mla.d_rope
    ckv = L.rmsnorm(L.dense(h, p["w_dkv"]), p["kv_ln"]["scale"])
    kr = L.dense(h, p["w_kr"]).reshape(B, S, 1, d_rope)
    return ckv, L.apply_rope(kr, sin, cos).reshape(B, S, d_rope)


def _mla_attn_kv(p: dict, cfg: LMConfig, h: Tensor, pos: Tensor,
                 seg: Optional[Tensor] = None,
                 prefix_len: Optional[Tensor] = None, kv_pos=None,
                 kv_seg=None, whole_kv: bool = False) -> tuple:
    """MLA over the sequence (the train and prefill path): the latent KV is
    up-projected per head, k = [k_nope ; kr] with kr broadcast over the
    heads, and the dispatcher runs q/k head dim d_nope + d_rope against v
    head dim d_v at scale (d_nope + d_rope)^-1/2.  Returns the block's
    attention output and this layer's ``ckv`` and ``kr``.

    Sequence parallelism, as in :func:`_gqa_attn_kv`: the query and the
    latent are roped at the tile's positions ``pos``, and the per-token
    latent (``ckv`` and ``kr``, kv_lora_rank + d_rope numbers a token) is
    gathered over ``model`` (``kv_full``), never the up-projected k and v
    (n_heads x (d_nope + d_v) a token); every rank up-projects the whole
    sequence.  The ``ckv`` and ``kr`` returned are the tile's, or with
    ``whole_kv`` the whole sequence's."""
    m = cfg.mla
    B, S, _ = h.shape
    H = cfg.n_heads
    sin, cos = _rope_tables(cfg, pos)
    q_nope, q_rope = _mla_query(p, cfg, h, sin, cos)
    ckv, kr = _mla_latent(p, cfg, h, sin, cos)
    ckv_all, kr_all = shard_act(ckv, "kv_full"), shard_act(kr, "kv_full")
    if whole_kv:
        ckv, kr = ckv_all, kr_all
    T = ckv_all.shape[1]
    k_nope = L.dense(ckv_all, p["w_uk"]).reshape(B, T, H, m.d_nope)
    v = L.dense(ckv_all, p["w_uv"]).reshape(B, T, H, m.d_v)
    k = torch.cat([k_nope, kr_all[:, :, None].expand(B, T, H, m.d_rope)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = L.attention(q, k, v, spec=_mask_spec(cfg, seg), q_pos=pos,
                    kv_pos=pos if kv_pos is None else kv_pos,
                    prefix_len=prefix_len, q_seg=seg,
                    kv_seg=seg if kv_seg is None else kv_seg,
                    scale=(m.d_nope + m.d_rope) ** -0.5,
                    q_offset=seq_offset(S))
    return L.dense(o.reshape(B, S, H * m.d_v), p["wo"]), ckv, kr


def _attn_kv(p: dict, cfg: LMConfig, h: Tensor, pos: Tensor,
             seg: Optional[Tensor] = None,
             prefix_len: Optional[Tensor] = None, kv_pos=None,
             kv_seg=None, whole_kv: bool = False) -> tuple:
    """The block's self-attention and what this layer's cache keeps:
    ``(out, k, v)`` for GQA, ``(out, ckv, kr)`` for MLA (``whole_kv``: of
    the whole sequence on a model axis)."""
    fn = _mla_attn_kv if cfg.mla is not None else _gqa_attn_kv
    return fn(p, cfg, h, pos, seg, prefix_len, kv_pos, kv_seg, whole_kv)


def _ffn_residual(p: dict, cfg: LMConfig, x: Tensor) -> tuple:
    """``x`` plus the block's FFN of ``ln2(x)``, and the FFN's auxiliary
    loss: the MoE load-balance loss, None for a dense MLP (GLU, or the plain
    two-layer MLP with biases where ``glu=False``).  With MoE
    each row of ``x`` is a routing group, its capacity from ``x``'s length
    (a serving prefill's right-padded bucket included: pad tokens come
    after the real ones in slot order and never displace them)."""
    h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
    if cfg.moe is not None:
        y, aux = moe_ffn(p["moe"], h, cfg.moe)
        return x + y, aux
    if cfg.glu:
        return x + L.glu_mlp(p["mlp"], h, cfg.act), None
    return x + L.mlp(p["mlp"], h, cfg.act), None


# --------------------------------------------------------------------------
# Fused-engine spec (train path)
# --------------------------------------------------------------------------

def make_block_body(cfg: LMConfig):
    def body(p, ctx, carry, aux_idx):
        del aux_idx
        _, ctx_act = ctx
        x, aux_loss = carry
        pos = ctx_act["pos"]        # int positions; never differentiated
        seg = ctx_act.get("seg")    # int segment ids of a packed batch
        prefix_len = ctx_act.get("prefix")  # int prefix lengths (prefix-LM)
        h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
        x = x + _attn_kv(p["attn"], cfg, h, pos, seg, prefix_len,
                         ctx_act.get("kv_pos"), ctx_act.get("kv_seg"))[0]
        x, aux = _ffn_residual(p, cfg, x)
        if aux is not None:
            aux_loss = aux_loss + aux
        return (x, aux_loss)

    return body


def _embed(outer: dict, cfg: LMConfig, tokens: Tensor) -> Tensor:
    # F.embedding and not tok_embed[tokens]: its backward on CUDA sorts the
    # indices and sums each row's contributions in a fixed order, where the
    # backward of advanced indexing scatters with float atomics.
    x = F.embedding(tokens, outer["tok_embed"])
    if cfg.embed_scale:
        # the factor in the embedding's dtype, as the reference casts it
        # (sqrt(2048) is 45.25 in bf16)
        # repro-lint: disable=T2 — a CPU tensor made here: no card read
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def _with_prefix(cfg: LMConfig, x: Tensor, batch: dict) -> Tensor:
    """``x`` after the batch's ``prefix_embed [B, n_prefix_tokens, d]``
    (the stubbed modality frontend's patch embeddings, cast to x's dtype and
    not scaled), for a config with a modality prefix.  On a model axis both
    are this rank's tile's rows: its prefix rows, then its token rows."""
    if not cfg.n_prefix_tokens:
        return x
    return torch.cat([batch["prefix_embed"].to(x.dtype), x], dim=1)


def _n_prefix(cfg: LMConfig, batch: dict) -> int:
    """The batch's prefix rows: ``n_prefix_tokens``, or on a model axis
    those of this rank's tile (``Zero3.rows`` cut ``prefix_embed``)."""
    return batch["prefix_embed"].shape[1] if cfg.n_prefix_tokens else 0


def _prefix_ctx(cfg: LMConfig, batch: dict, pos: Tensor) -> dict:
    """The attention context of an unpacked batch: positions, and for a
    prefix-LM config the rows' int32 ``prefix`` lengths."""
    ctx = {"pos": pos}
    if cfg.prefix_lm:
        ctx["prefix"] = batch["prefix_len"].to(torch.int32)
    return ctx


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
        x = _with_prefix(cfg, _embed(outer, cfg, batch["tokens"]), batch)
        return (x, torch.zeros((), dtype=torch.float32, device=x.device))

    return prologue


def _seq_ctx(S: int, device) -> dict:
    """The positions of an unpacked tile of ``S`` rows (a modality prefix's
    included): ``pos`` its own (absolute: the tile's offset on), and with a
    model axis ``kv_pos`` the whole sequence's."""
    tp = model_size()
    off = seq_offset(S)
    ctx = {"pos": torch.arange(off, off + S, dtype=torch.int32,
                               device=device)}
    if tp > 1:
        ctx["kv_pos"] = torch.arange(S * tp, dtype=torch.int32,
                                     device=device)
    return ctx


def make_pro_ctx(cfg: LMConfig):
    def pro_ctx(outer, batch):
        # Positions and segment ids travel as integers: the port
        # differentiates only the carry and the parameters, never the
        # context.  With a model axis the batch is this rank's sequence
        # tile: ``pos``/``seg`` are the tile's (its queries, RoPE) and
        # ``kv_pos``/``kv_seg`` the whole sequence's (the gathered K/V).
        tp = model_size()
        if "segment_ids" in batch:
            if cfg.prefix_lm or cfg.n_prefix_tokens or cfg.mtp:
                raise ValueError(
                    "packed (segment-id) batches are not supported for "
                    "prefix-LM / modality-prefix / MTP architectures")
            ctx = {"pos": batch["positions"].to(torch.int32),
                   "seg": batch["segment_ids"].to(torch.int32)}
            if tp > 1:
                ctx["kv_pos"] = gather_tiles(ctx["pos"])
                ctx["kv_seg"] = gather_tiles(ctx["seg"])
            return ctx
        tokens = batch["tokens"]
        ctx = _seq_ctx(tokens.shape[1] + _n_prefix(cfg, batch), tokens.device)
        return {**_prefix_ctx(cfg, batch, ctx["pos"]), **ctx}

    return pro_ctx


def make_epilogue(cfg: LMConfig):
    def epilogue(outer, carry, batch):
        x, aux_loss = carry
        # the prefix rows score nothing (on a model axis, the tile's own;
        # a tile of prefix rows alone has no label and sums to zero)
        x = x[:, _n_prefix(cfg, batch):]
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = _logits(outer, cfg, h)
        loss_sum, ntok, correct = cross_entropy(logits, batch["labels"],
                                                cfg.z_loss)
        # A batch split over ranks (sharding.act): the loss is a sum over
        # the global batch over the global token count, so each rank's term
        # divides by the global count and the ranks' gradients add up to
        # the whole batch's.  Without a split batch_sum is the identity.
        ntok = batch_sum(ntok)
        denom = torch.clamp_min(ntok, 1).to(torch.float32)
        loss = loss_sum / denom + aux_loss
        mtp = 0.0
        if cfg.mtp:
            mtp_sum, mtp_denom = _mtp_loss(outer, cfg, h, batch)
            mtp = batch_sum(mtp_sum.detach()) / mtp_denom
            loss = loss + cfg.mtp_weight * mtp_sum / mtp_denom
        split = current_policy() is not None
        metrics = {
            "loss": (batch_sum(loss_sum.detach()) / denom + aux_loss
                     + cfg.mtp_weight * mtp).detach() if split
            else loss.detach(),
            "ntokens": ntok.to(torch.float32),
            "accuracy": batch_sum(correct).to(torch.float32) / denom,
        }
        if cfg.moe is not None:
            # the load-balance part of the loss, summed over the layers (a
            # metric the reference does not report)
            metrics["aux_loss"] = aux_loss.detach()
        if cfg.mtp:
            # the MTP head's mean cross entropy (nor does it report this)
            metrics["mtp_loss"] = (mtp if split
                                   else mtp_sum / mtp_denom).detach()
        return loss, metrics

    return epilogue


def _mtp_loss(outer: dict, cfg: LMConfig, h: Tensor, batch: dict) -> tuple:
    """The MTP head's summed cross entropy against ``labels_mtp`` and its
    token count (at least 1, fp32).  The reference's comment reads
    ``[h_t ; emb(token_{t+1})]``, but its code embeds ``batch["tokens"]``
    unshifted, i.e. ``emb(token_t)``: the port takes the code's meaning.
    ``h`` is the final-normed hidden state.  The block attends as the main
    blocks do: at the tile's absolute positions, over the whole sequence's
    latent with a model axis.  ``labels_mtp`` is cut to the tile with the
    batch (``Zero3.rows``) after it was built on the whole sequence, so no
    label crosses a tile edge.  The sum is this rank's tokens' and the
    count every rank's (``batch_sum``), as the main loss's."""
    tokens = batch["tokens"]
    x = L.dense(torch.cat([h, _embed(outer, cfg, tokens)], dim=-1),
                outer["mtp_proj"])
    x, _ = make_block_body(_mtp_cfg(cfg))(
        outer["mtp_block"], ({}, _seq_ctx(tokens.shape[1], tokens.device)),
        (x, torch.zeros((), dtype=torch.float32, device=x.device)), 0)
    x = L.norm_apply(outer["mtp_norm"], x, kind=cfg.norm)
    loss_sum, ntok, _ = cross_entropy(_logits(outer, cfg, x),
                                      batch["labels_mtp"])
    return loss_sum, torch.clamp_min(batch_sum(ntok), 1).to(torch.float32)


def make_fused_spec(cfg: LMConfig):
    from repro_torch.core.fused import FusedSpec
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


def check_paged(cfg: LMConfig) -> None:
    """The paged halves take GQA caches without a prefix only, as the
    reference's do: an MLA model keeps a latent cache and a prefix-LM model
    a prefix, both of which the legacy ``Engine`` serves."""
    if cfg.prefix_lm:
        raise ValueError(f"{cfg.name}: paged serving: prefix-LM not plumbed "
                         "yet (serve it with the legacy Engine)")
    if cfg.mla is not None:
        raise ValueError(f"{cfg.name}: paged serving supports GQA caches "
                         "only (MLA keeps a latent cache; serve it with the "
                         "legacy Engine)")


def make_prefill_kv_step(cfg: LMConfig):
    """prefill(params, batch{'tokens': [B,S], 'length': [B]}) ->
    (logits [B,vocab] at position length-1, k [L,B,S,K,dh], v [L,B,S,K,dh]).

    Keeps the *full* per-layer K/V (no ring truncation) so the engine can
    scatter it into KV pages; SWA is enforced by the decode-attention mask.
    Right-padding is harmless: with a causal mask, K/V at positions < length
    never see the pad tail, and logits are gathered at length-1."""
    check_paged(cfg)

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
            x = _ffn_residual(p, cfg, x + a)[0]
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
    check_paged(cfg)
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
            x = _ffn_residual(p, cfg, x + a)[0]
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = _logits(outer, cfg, h)[:, 0]
        return logits, pages

    return decode


def init_page_pool(cfg: LMConfig, num_pages: int, page_size: int, *,
                   device="cuda") -> dict:
    """Zeroed shared KV page pool (page 0 is the engine's scratch page)."""
    check_paged(cfg)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


# --------------------------------------------------------------------------
# Legacy serving: prefill + single-token decode with a (ring) KV cache
# --------------------------------------------------------------------------

def cache_window(cfg: LMConfig, max_len: int) -> int:
    """SWA archs only ever need a window-sized ring cache."""
    return min(cfg.window, max_len) if cfg.window else max_len


def _cache_shapes(cfg: LMConfig, batch: int, W: int) -> dict:
    """The per-layer ring tensors ``[L, B, W, ...]``: k and v ``[.., K, dh]``
    for GQA; for MLA the latent ``ckv [.., kv_lora_rank]`` and the shared
    RoPE key ``kr [.., d_rope]``."""
    lead = (cfg.n_layers, batch, W)
    if cfg.mla is not None:
        return {"ckv": lead + (cfg.mla.kv_lora_rank,),
                "kr": lead + (cfg.mla.d_rope,)}
    kv = lead + (cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def init_cache(cfg: LMConfig, batch: int, max_len: int, *, device="cuda"
               ) -> dict:
    """Empty ring cache: the per-layer tensors of ``_cache_shapes`` as
    zeros, pos ``[W]`` int32 -1 (empty slot), cur a 0-d int32 (position of
    the next token)."""
    W = cache_window(cfg, max_len)
    dev = resolve_device(device)
    cache = {k: torch.zeros(shape, dtype=cfg.dtype, device=dev)
             for k, shape in _cache_shapes(cfg, batch, W).items()}
    cache["pos"] = torch.full((W,), -1, dtype=torch.int32, device=dev)
    cache["cur"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def _decode_gqa(p: dict, cfg: LMConfig, h: Tensor, kc: Tensor, vc: Tensor,
                pos_tab: Tensor, cur: Tensor, slot: Tensor, rope: tuple,
                use_kernel) -> Tensor:
    """One-token GQA decode of ``h [B,1,d]`` at position ``cur`` (``rope``:
    its sin/cos tables): writes this token's K/V into ring slot ``slot``
    (``[1]`` int64, cur % W) of this layer's cache ``kc``/``vc [B,W,K,dh]``
    in place, then attends over it."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    B = h.shape[0]
    q, k, v = _qkv(p, cfg, h, *rope)
    kc.index_copy_(1, slot, k)
    vc.index_copy_(1, slot, v)
    o = decode_attention(q, kc, vc, pos_tab, cur, window=cfg.window,
                         use_kernel=use_kernel)
    return L.dense(o.reshape(B, 1, -1), p["wo"])


def _mla_decode_scores(p: dict, cfg: LMConfig, h: Tensor, ckv_c: Tensor,
                       kr_c: Tensor, write: Callable, valid: Tensor,
                       rope: tuple) -> Tensor:
    """The absorbed-matmul MLA decode's scores of ``h [B,1,d]`` over the
    latent slots ``ckv_c [B,W,r]`` and ``kr_c [B,W,d_rope]``, after this
    token's latent and RoPE key went in through ``write(cache, x)``:
    ``W_uk`` folded into the query (``q_lat [B,H,r]``), scored in latent
    space plus the RoPE part, scaled in fp32, ``L.NEG_INF`` where the slot
    is not ``valid [W]``.  ``[B,H,W]`` fp32.  Shared by the single-device
    step and a rank's block of slots (``serve/sharded.py``)."""
    m = cfg.mla
    H, r = cfg.n_heads, m.kv_lora_rank
    q_nope, q_rope = _mla_query(p, cfg, h, *rope)
    ckv, kr = _mla_latent(p, cfg, h, *rope)
    write(ckv_c, ckv)
    write(kr_c, kr)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0],
                         p["w_uk"].reshape(r, H, m.d_nope))
    s_nope = torch.einsum("bhr,bwr->bhw", q_lat, ckv_c)
    s_rope = torch.einsum("bhd,bwd->bhw", q_rope[:, 0], kr_c)
    logits = (s_nope + s_rope).to(torch.float32) * (m.d_nope + m.d_rope
                                                     ) ** -0.5
    return torch.where(valid[None, None, :], logits, L.NEG_INF)


def _mla_decode_out(p: dict, cfg: LMConfig, o_lat: Tensor) -> Tensor:
    """The latent attention output ``o_lat [B,H,r]`` up-projected through
    ``W_uv`` and ``wo``: ``[B,1,d]``."""
    m = cfg.mla
    B, H = o_lat.shape[:2]
    o = torch.einsum("bhr,rhv->bhv", o_lat,
                     p["w_uv"].reshape(m.kv_lora_rank, H, m.d_v))
    return L.dense(o.reshape(B, 1, H * m.d_v), p["wo"])


def _decode_mla(p: dict, cfg: LMConfig, h: Tensor, ckv_c: Tensor,
                kr_c: Tensor, pos_tab: Tensor, cur: Tensor, slot: Tensor,
                rope: tuple) -> Tensor:
    """Absorbed-matmul MLA decode of ``h [B,1,d]``: writes this token's
    latent and RoPE key into ring slot ``slot`` of ``ckv_c [B,W,r]`` and
    ``kr_c [B,W,d_rope]`` in place, scores (``_mla_decode_scores``),
    softmaxes in fp32 over the slots with ``0 <= pos <= cur``, casts the
    probabilities to the cache dtype (as the reference does) before the
    latent weighted sum, and up-projects through ``W_uv``.  Plain PyTorch:
    the reference's is ``jnp`` outside any Pallas kernel."""
    logits = _mla_decode_scores(
        p, cfg, h, ckv_c, kr_c, lambda c, x: c.index_copy_(1, slot, x),
        (pos_tab >= 0) & (pos_tab <= cur), rope)
    probs = torch.softmax(logits, dim=-1).to(ckv_c.dtype)
    return _mla_decode_out(p, cfg,
                           torch.einsum("bhw,bwr->bhr", probs, ckv_c))


def make_decode_step(cfg: LMConfig, *, use_kernel=None):
    """decode_step(params, cache, batch{'tokens': [B,1]}) -> (logits, cache).

    The cache is **updated in place** and returned: this token's position
    is marked in ``pos`` before attention (so the token sees itself), its
    K/V (MLA: its latent and RoPE key) go into slot ``cur % W`` of every
    layer, and ``cur`` advances.  Nothing is read back to the host.
    ``use_kernel`` as in ``kernels.decode_attention.ops``: None = the CUDA
    kernel (K4) for CUDA tensors, the plain version for CPU tensors.  MLA
    decodes in plain PyTorch (``_decode_mla``) and never reaches K4."""

    @torch.no_grad()
    def decode_step(params, cache, batch):
        outer = params["outer"]
        x = _embed(outer, cfg, batch["tokens"])            # [B,1,d]
        cur = cache["cur"]
        slot = torch.remainder(cur, cache["pos"].shape[0]).to(
            torch.int64).reshape(1)
        cache["pos"].index_copy_(0, slot, cur.reshape(1))
        rope = _rope_tables(cfg, cur[None])        # shared by the layers
        blocks = params["stacks"]["blocks"]
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
            if cfg.mla is not None:
                a = _decode_mla(p["attn"], cfg, h, cache["ckv"][i],
                                cache["kr"][i], cache["pos"], cur, slot, rope)
            else:
                a = _decode_gqa(p["attn"], cfg, h, cache["k"][i],
                                cache["v"][i], cache["pos"], cur, slot, rope,
                                use_kernel)
            x = _ffn_residual(p, cfg, x + a)[0]
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        logits = _logits(outer, cfg, h)[:, 0]
        cur.add_(1)
        return logits, cache

    return decode_step


def make_prefill_step(cfg: LMConfig):
    """prefill_step(params, batch{'tokens': [B,S]}) -> (last_logits, cache).

    The full-sequence forward (the attention dispatcher picks direct,
    blockwise or sliding-window-gather attention by S), keeping each
    layer's K/V (MLA: latent and RoPE key) of the last
    ``W = cache_window(cfg, S)`` positions: the ring is sized to the prompt,
    slot j holds position S - W + j, and ``cur`` is S.  Logits are those of
    position S - 1.  A modality-prefix config takes ``prefix_embed`` (and,
    prefix-LM, ``prefix_len``) in the batch: S counts the prefix, whose K/V
    the ring then holds."""

    @torch.no_grad()
    def prefill_step(params, batch):
        outer = params["outer"]
        tokens = batch["tokens"]
        dev = tokens.device
        x = _with_prefix(cfg, _embed(outer, cfg, tokens), batch)
        B, S = x.shape[:2]
        ctx = _prefix_ctx(cfg, batch, torch.arange(S, dtype=torch.int32,
                                                    device=dev))
        pos = ctx["pos"]
        W = cache_window(cfg, S)
        shapes = _cache_shapes(cfg, B, W)
        cache = {k: torch.empty(shape, dtype=cfg.dtype, device=dev)
                 for k, shape in shapes.items()}
        ka, kb = shapes             # k, v (GQA) or ckv, kr (MLA)
        blocks = params["stacks"]["blocks"]
        for i in range(cfg.n_layers):
            p = _layer(blocks, i)
            h = L.norm_apply(p["ln1"], x, kind=cfg.norm)
            a, ca, cb = _attn_kv(p["attn"], cfg, h, pos,
                                 prefix_len=ctx.get("prefix"))
            cache[ka][i] = ca[:, S - W:]
            cache[kb][i] = cb[:, S - W:]
            x = _ffn_residual(p, cfg, x + a)[0]
        cache["pos"] = pos[S - W:].clone()
        cache["cur"] = torch.full((), S, dtype=torch.int32, device=dev)
        h = L.norm_apply(outer["final_norm"], x[:, -1:], kind=cfg.norm)
        return _logits(outer, cfg, h)[:, 0], cache

    return prefill_step
