"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060), PyTorch.
Counterpart of ``repro.models.mamba2``.

The chunked SSD algorithm: within chunks of length Q the model computes the
quadratic, attention-like form; across chunks a linear recurrence carries
the SSM state (the reference's ``lax.scan`` over chunks is a Python loop
here).  Every einsum of the scan runs in fp32.  Decode is the O(1)
recurrent update of the state ``[B, H, P, N]`` plus a rolling window of the
causal conv's last ``d_conv - 1`` inputs.

One deliberate departure from the reference: ``ssd_chunked`` masks the
upper triangle of the intra-chunk decay *before* the exponential
(``exp(where(mask, diff, -inf))``).  The reference exponentiates the whole
``[Q, Q]`` block and masks after it; in the upper triangle ``diff`` is
positive and grows with the chunk, so past about 88 it overflows fp32 to
inf, and the backward's ``0 * inf`` is NaN (at the published chunk of 128 a
fused step leaves every parameter non-finite).  The forward is bitwise the
reference's; the gradients equal the reference's wherever those are
finite.  A second one: a prefill over fewer than ``d_conv - 1`` tokens
raises ``ValueError`` (the reference returns a conv tail of the wrong
shape, and its next decode step fails on it).

On a model axis (sequence parallelism) the train mixer gathers its tile's
normed input over ``model``, runs the whole sequence on every rank and
keeps the tile's rows (:func:`_mix_tile`): ``model``-fold duplicated work,
safe for parity.  A sequence-split SSD passing chunk states along the ranks
is not ported.
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
from repro_torch.models.transformer import _logits as logits
from repro_torch.models.transformer import cross_entropy
from repro_torch.sharding.act import (batch_sum, current_policy, model_size,
                                      seq_offset, shard_act)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    chunk: int = 256
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    def param_count(self) -> int:
        """Total parameters (shapes only; nothing is allocated)."""
        shapes = init_params(0, self, device="meta")
        return sum(math.prod(x.shape) for x in tree_leaves(shapes))

    def active_param_count(self) -> int:
        return self.param_count()


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _block_init(gen, cfg: Mamba2Config, device, out: Optional[dict] = None
                ) -> dict:
    """One layer's params, drawn into ``out`` (views of one layer of the
    stack) where it is given.  ``A_log = log(linspace(1, 16, H))``;
    ``dt_bias`` the inverse softplus of a log-uniform draw in [1e-3, 1e-1];
    ``conv_w ~ N(0, 1) * 0.2``; ``D`` ones — the reference's draws."""
    d, di, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    dt = cfg.dtype
    o = out or {}
    meta = torch.device(device).type == "meta"
    d_in_proj = 2 * di + 2 * cfg.n_groups * cfg.d_state + H

    def f32(key, shape):
        t = o.get(key)
        return torch.empty(shape, dtype=torch.float32, device=device) \
            if t is None else t

    a_log, dt_bias, D = (f32(k, (H,)) for k in ("A_log", "dt_bias", "D"))
    conv_b = o.get("conv_b")
    if conv_b is None:
        conv_b = torch.empty((cfg.conv_dim,), dtype=dt, device=device)
    p = {
        "ln": L.norm_init(d, cfg.norm, device=device, out=o.get("ln")),
        "in_proj": L.linear_init(gen, d, d_in_proj, dtype=dt, device=device,
                                 out=o.get("in_proj")),
        "conv_w": L.normal_init(gen, (cfg.conv_dim, cfg.d_conv), 0.2,
                                dtype=dt, device=device, out=o.get("conv_w")),
        "conv_b": conv_b,
        "A_log": a_log,
        "dt_bias": dt_bias,
        "D": D,
        "out_norm": L.norm_init(di, "rmsnorm", device=device,
                                out=o.get("out_norm")),
        "out_proj": L.linear_init(gen, di, d, scale=(2 * cfg.n_layers) ** -0.5,
                                  dtype=dt, device=device,
                                  out=o.get("out_proj")),
    }
    if not meta:
        conv_b.zero_()
        a_log.copy_(torch.log(torch.linspace(1.0, 16.0, H, device=device)))
        u = torch.empty((H,), dtype=torch.float32, device=device).uniform_(
            math.log(1e-3), math.log(1e-1), generator=gen)
        dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
        D.fill_(1.0)
    return p


def init_params(seed: int, cfg: Mamba2Config, *, device="cuda") -> dict:
    """Params in the fused-engine layout ``{outer, shared, stacks}``, drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev, gen = L.init_generator(seed, device)
    outer = {
        "tok_embed": L.embed_init(gen, cfg.vocab, cfg.d_model,
                                  dtype=cfg.dtype, device=dev),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        outer["head"] = L.linear_init(gen, cfg.d_model, cfg.vocab,
                                      dtype=cfg.dtype, device=dev)
    blocks = L.stacked_blocks(cfg.n_layers, lambda g, dv, out: _block_init(
        g, cfg, dv, out=out), gen, dev)
    return {"outer": outer, "shared": {}, "stacks": {"blocks": blocks}}


# --------------------------------------------------------------------------
# Causal depthwise conv (kernel k, train form) and SSD chunked scan
# --------------------------------------------------------------------------

def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x: [B,S,C]; w: [C,k] depthwise causal conv along S."""
    k = w.shape[-1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    # sum_j x[t-k+1+j] * w[:, j]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + S, :] * w[:, j]
    return out + b


def _repeat_heads(t: Tensor, rep: int, dim: int) -> Tensor:
    """``jnp.repeat(t, rep, axis=dim)``: each entry along ``dim`` repeated
    ``rep`` times in place (a B/C group's value for each of its heads)."""
    if rep == 1:
        return t
    shape = list(t.shape)
    dim %= t.ndim
    t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return t.flatten(dim, dim + 1)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int,
                init_state: Optional[Tensor] = None,
                return_state: bool = False):
    """Chunked SSD. Shapes:
      x:  [B,S,H,P]  (P = headdim)     dt: [B,S,H]   A: [H] (negative)
      Bm: [B,S,G,N]  Cm: [B,S,G,N]     D: [H]
    Returns y [B,S,H,P] (and the final state [B,H,P,N] fp32 if asked).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // Q
    rep = H // G  # heads per B/C group

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, G, N)
    Cc = Cm.reshape(Bsz, nc, Q, G, N)

    dA = dtc * A                                       # [B,nc,Q,H] (negative)
    cums = torch.cumsum(dA, dim=2)                     # within-chunk cumsum
    seg_end = cums[:, :, -1, :]                        # [B,nc,H]

    # intra-chunk (quadratic) term: attention-like with decay mask
    # L[b,c,h,i,j] = exp(cums_i - cums_j) for i >= j, 0 above the diagonal;
    # masked before the exponential (module docstring)
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # [B,nc,Q,Q,H]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    Ldec = torch.exp(torch.where(mask[:, :, None], diff, -math.inf))
    CB = torch.einsum("bcqgn,bckgn->bcqkg", Cc, Bc)    # [B,nc,Q,Q,G]
    CB = _repeat_heads(CB, rep, -1)                    # → H
    att = CB * Ldec * dtc[:, :, None, :, :]            # scale by dt_j
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, xc)

    # chunk-level states: S_c = sum_j exp(seg_end - cums_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cums)  # [B,nc,Q,H]
    w = decay_to_end * dtc
    Bh = _repeat_heads(Bc, rep, -2)                          # [B,nc,Q,H,N]
    chunk_state = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, Bh, xc)

    # inter-chunk recurrence over nc chunks
    seg_dec = torch.exp(seg_end)                             # [B,nc,H]
    s = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.to(torch.float32))
    s_in = []                                  # the state entering chunk c
    for c in range(nc):
        s_in.append(s)
        s = s * seg_dec[:, c, :, None, None] + chunk_state[:, c].to(
            torch.float32)
    s_in = torch.stack(s_in, dim=1)                          # [B,nc,H,P,N]

    # inter-chunk contribution: y_j += C_j^T exp(cums_j) S_in
    Ch = _repeat_heads(Cc, rep, -2)                          # [B,nc,Q,H,N]
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch,
                           s_in.to(Ch.dtype), torch.exp(cums))
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, P)[:, :S]
    y = y + x.reshape(Bsz, nc * Q, H, P)[:, :S] * D[:, None]
    if return_state:
        return y, s
    return y


def _split_proj(z: Tensor, cfg: Mamba2Config) -> tuple:
    di, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    xBC, gate, dt = torch.split(z, [di + 2 * G * N, di, cfg.n_heads], -1)
    return xBC, gate, dt  # xBC: [.., di+2GN], gate: [.., di], dt: [.., H]


def _dt_and_A(p: dict, dt: Tensor) -> tuple:
    """softplus(dt + dt_bias) in fp32 ``[B,S,H]`` and ``A = -exp(A_log)``."""
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def _out(p: dict, y: Tensor, gate: Tensor) -> Tensor:
    """The gated, normed output projection of the SSD output ``y``
    (already in the hidden dtype, ``[B,S,d_inner]``)."""
    y = L.rmsnorm(y * L.ACTS["silu"](gate), p["out_norm"]["scale"])
    return L.dense(y, p["out_proj"])


def _mix_seq(p: dict, cfg: Mamba2Config, h: Tensor, *, return_state: bool):
    """The full-sequence mixer (train and prefill): returns the output, or
    ``(out, conv_tail, ssm_state)`` with the conv's last ``d_conv - 1``
    inputs (before the activation) and the fp32 final SSM state."""
    B, S, _ = h.shape
    di, G, N, H, P = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.headdim)
    xBC, gate, dt = _split_proj(L.dense(h, p["in_proj"]), cfg)
    dt, A = _dt_and_A(p, dt)
    xBC_c = L.ACTS["silu"](_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x, Bm, Cm = torch.split(xBC_c, [di, G * N, G * N], dim=-1)
    res = ssd_chunked(x.reshape(B, S, H, P).to(torch.float32), dt, A,
                      Bm.reshape(B, S, G, N).to(torch.float32),
                      Cm.reshape(B, S, G, N).to(torch.float32), p["D"],
                      cfg.chunk, return_state=return_state)
    y, s_final = res if return_state else (res, None)
    out = _out(p, y.reshape(B, S, di).to(h.dtype), gate)
    if not return_state:
        return out
    return out, xBC[:, S - (cfg.d_conv - 1):], s_final


def _mix_tile(p: dict, cfg: Mamba2Config, h: Tensor) -> Tensor:
    """The train mixer on a model axis: ``h [B, S/tp, d]`` is this rank's
    sequence tile, and the chunked SSD and the causal conv run along the
    whole sequence, so the tile's normed input is gathered over ``model``
    (``kv_full``: an all-gather forward, a fixed-order reduce-scatter of
    its gradient backward), every rank runs the mixer on the whole
    sequence, and keeps its own rows of the output.  The parameters'
    gradients a rank takes are its tile's rows' share, which the ZeRO-3
    scatter sums over ``model``.  ``h`` is gathered and not ``in_proj``'s
    output, about four times wider."""
    S = h.shape[1]
    off = seq_offset(S)
    out = _mix_seq(p, cfg, shard_act(h, "kv_full"), return_state=False)
    return out[:, off:off + S]


def mamba2_mix(p: dict, cfg: Mamba2Config, h: Tensor,
               conv_state: Optional[Tensor] = None,
               ssm_state: Optional[Tensor] = None,
               decode: bool = False, *, tap_lo: int = 0, head_lo: int = 0,
               gather: Optional[Callable] = None):
    """The mamba2 mixer.  Train/prefill: full-sequence chunked SSD (on a
    model axis, :func:`_mix_tile`).  Decode (S == 1): the recurrent
    update; takes conv_state [B,t,C] (the conv window's taps ``tap_lo`` to
    ``tap_lo + t`` of k-1) and ssm_state [B,h,P,N] (heads ``head_lo`` to
    ``head_lo + h``) and returns (y, new_conv_state, new_ssm_state) of
    those taps and heads.  A block short of its whole dim (a rank's on a
    model axis, ``serve/sharded.py``) is joined with the other ranks'
    blocks in rank order by ``gather(x, dim)``: the taps before the conv,
    the heads' outputs before the gated norm over all of ``d_inner``."""
    if not decode:
        if model_size() > 1:
            return _mix_tile(p, cfg, h)
        return _mix_seq(p, cfg, h, return_state=False)
    B = h.shape[0]
    di, G, N, H, P = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                      cfg.headdim)
    xBC, gate, dt = _split_proj(L.dense(h, p["in_proj"]), cfg)
    dt, A = _dt_and_A(p, dt)
    t = conv_state.shape[1]
    taps = conv_state if t == cfg.d_conv - 1 else gather(conv_state, 1)
    window = torch.cat([taps, xBC[:, :1]], dim=1)           # [B,k,C]
    conv = torch.sum(window * p["conv_w"].T, dim=1) + p["conv_b"]
    x, Bm, Cm = torch.split(L.ACTS["silu"](conv), [di, G * N, G * N], dim=-1)
    hs = slice(head_lo, head_lo + ssm_state.shape[1])
    x = x.reshape(B, H, P).to(torch.float32)[:, hs]
    rep = H // G
    Bh = _repeat_heads(Bm.reshape(B, G, N).to(torch.float32), rep, 1)[:, hs]
    Ch = _repeat_heads(Cm.reshape(B, G, N).to(torch.float32), rep, 1)[:, hs]
    dt0 = dt[:, 0, hs]                                       # [B,h]
    dec = torch.exp(dt0 * A[hs])
    s_new = (ssm_state * dec[:, :, None, None]
             + torch.einsum("bh,bhn,bhp->bhpn", dt0, Bh, x))
    y = torch.einsum("bhn,bhpn->bhp", Ch, s_new) + x * p["D"][hs, None]
    if y.shape[1] < H:
        y = gather(y, 1)
    out = _out(p, y.reshape(B, 1, di).to(h.dtype), gate)
    return out, window[:, 1 + tap_lo:1 + tap_lo + t], s_new


# --------------------------------------------------------------------------
# Fused-engine spec (train path)
# --------------------------------------------------------------------------

def make_block_body(cfg: Mamba2Config):
    def body(p, ctx, carry, aux_idx):
        del ctx, aux_idx
        x, aux = carry
        h = L.norm_apply(p["ln"], x, kind=cfg.norm)
        return (x + mamba2_mix(p, cfg, h), aux)

    return body


def embed(outer: dict, tokens: Tensor) -> Tensor:
    # F.embedding: its CUDA backward sums each row in a fixed order
    return F.embedding(tokens, outer["tok_embed"])


def make_epilogue(cfg):
    """Final norm, fp32 logits and the masked cross entropy of the carry's
    first element; the carry's last element (an fp32 scalar) is added.  On
    a batch split over ranks (``sharding.act``) the cross entropy divides
    by the global token count and the metrics are the global batch's, as
    the transformer family's epilogue."""

    def epilogue(outer, carry, batch):
        x, aux = carry[0], carry[-1]
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        loss_sum, ntok, correct = cross_entropy(logits(outer, cfg, h),
                                                batch["labels"])
        ntok = batch_sum(ntok)
        denom = torch.clamp_min(ntok, 1).to(torch.float32)
        loss = loss_sum / denom + aux
        report = (batch_sum(loss_sum.detach()) / denom + aux
                  if current_policy() is not None else loss).detach()
        return loss, {"loss": report,
                      "ntokens": ntok.to(torch.float32),
                      "accuracy": batch_sum(correct).to(torch.float32)
                      / denom}

    return epilogue


def make_fused_spec(cfg: Mamba2Config):
    from repro_torch.core.fused import FusedSpec

    def prologue(outer, batch):
        x = embed(outer, batch["tokens"])
        return (x, torch.zeros((), dtype=torch.float32, device=x.device))

    return FusedSpec(prologue=prologue,
                     bodies={"blocks": make_block_body(cfg)},
                     epilogue=make_epilogue(cfg))


# --------------------------------------------------------------------------
# Serving: prefill and one-token decode over the state cache
# --------------------------------------------------------------------------

def init_state_cache(cfg: Mamba2Config, batch: int, *, device="cuda"
                     ) -> dict:
    """Decode cache: the conv window and the fp32 SSM state of every layer
    (O(1) in the sequence length), and ``cur`` (a 0-d int32)."""
    dev = resolve_device(device)
    H, P, N = cfg.n_heads, cfg.headdim, cfg.d_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1,
                             cfg.conv_dim), dtype=cfg.dtype, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, H, P, N),
                           dtype=torch.float32, device=dev),
        "cur": torch.zeros((), dtype=torch.int32, device=dev),
    }


def check_prompt(cfg, S: int) -> None:
    """A prefill needs at least ``d_conv - 1`` tokens for the conv tail."""
    if S < cfg.d_conv - 1:
        raise ValueError(
            f"{cfg.name}: a prompt of {S} tokens is shorter than the "
            f"{cfg.d_conv - 1} the conv window's cache holds "
            f"(d_conv - 1); pad it or give more tokens")


def decode_mix(p: dict, cfg: Mamba2Config, x: Tensor, cache: dict,
               i: int, **block) -> Tensor:
    """Layer ``i``'s norm and one-token mixer on ``x [B,1,d]``, its conv
    window and SSM state updated in place in ``cache`` (``block``: where
    they are a rank's block, as :func:`mamba2_mix` takes it); returns the
    residual sum."""
    h = L.norm_apply(p["ln"], x, kind=cfg.norm)
    y, conv_s, ssm_s = mamba2_mix(p, cfg, h, cache["conv"][i],
                                  cache["ssm"][i], decode=True, **block)
    cache["conv"][i].copy_(conv_s)
    cache["ssm"][i].copy_(ssm_s)
    return x + y


def make_decode_step(cfg: Mamba2Config, *, use_kernel=None):
    """decode_step(params, cache, batch{'tokens': [B,1]}) -> (logits,
    cache), the cache updated in place (``cur`` included).  The model has
    no attention: ``use_kernel`` is taken for the registry's signature and
    not read."""
    del use_kernel

    @torch.no_grad()
    def decode_step(params, cache, batch):
        outer = params["outer"]
        x = embed(outer, batch["tokens"])                    # [B,1,d]
        blocks = params["stacks"]["blocks"]
        for i in range(cfg.n_layers):
            x = decode_mix(tree_map(lambda t: t[i], blocks), cfg, x, cache, i)
        h = L.norm_apply(outer["final_norm"], x, kind=cfg.norm)
        cache["cur"].add_(1)
        return logits(outer, cfg, h)[:, 0], cache

    return decode_step


def make_prefill_step(cfg: Mamba2Config):
    """prefill_step(params, batch{'tokens': [B,S]}) -> (last_logits,
    cache): the full-sequence forward, keeping each layer's conv tail
    (before the activation) and final SSM state; ``cur`` is S."""

    @torch.no_grad()
    def prefill_step(params, batch):
        outer = params["outer"]
        tokens = batch["tokens"]
        B, S = tokens.shape
        check_prompt(cfg, S)
        x = embed(outer, tokens)
        blocks = params["stacks"]["blocks"]
        cache = init_state_cache(cfg, B, device=tokens.device)
        for i in range(cfg.n_layers):
            p = tree_map(lambda t: t[i], blocks)
            h = L.norm_apply(p["ln"], x, kind=cfg.norm)
            y, cache["conv"][i], cache["ssm"][i] = _mix_seq(
                p, cfg, h, return_state=True)
            x = x + y
        cache["cur"].fill_(S)
        h = L.norm_apply(outer["final_norm"], x[:, -1:], kind=cfg.norm)
        return logits(outer, cfg, h)[:, 0], cache

    return prefill_step
