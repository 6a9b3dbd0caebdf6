"""Decoder-only LM family (PyTorch), train half, dense GQA.

Counterpart of ``repro.models.transformer``: scan-over-layers layout with
stacked ``[L, ...]`` params so the fused AdaLomo backward (``core/fused.py``)
applies.  Ported: dense GQA blocks with ``qk_norm``, sliding ``window``,
``tie_embeddings`` and ``z_loss``.  MoE, MLA, MTP and prefix-LM configs raise
``NotImplementedError``; serving is a later slice.
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

def _gqa_attn(p: dict, cfg: LMConfig, h: Tensor, pos: Tensor) -> Tensor:
    B, S, _ = h.shape
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(h, p["wq"]).reshape(B, S, H, dh)
    k = L.dense(h, p["wk"]).reshape(B, S, K, dh)
    v = L.dense(h, p["wv"]).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"]["scale"])
        k = L.rmsnorm(k, p["k_norm"]["scale"])
    d_rot = int(dh * cfg.rope_pct) // 2 * 2
    sin, cos = L.rope_sincos(pos, d_rot, cfg.rope_theta)
    q = L.apply_rope(q, sin, cos, cfg.rope_pct)
    k = L.apply_rope(k, sin, cos, cfg.rope_pct)
    spec = L.MaskSpec(causal=True, window=cfg.window)
    o = L.attention(q, k, v, spec=spec, q_pos=pos, kv_pos=pos)
    return L.dense(o.reshape(B, S, H * dh), p["wo"])


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
        x = x + _gqa_attn(p["attn"], cfg, h, pos)
        h = L.norm_apply(p["ln2"], x, kind=cfg.norm)
        x = x + L.glu_mlp(p["mlp"], h, cfg.act)
        return (x, aux_loss)

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
