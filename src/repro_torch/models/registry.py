"""Architecture registry: ``--arch <id>`` → family functions + input specs.

Counterpart of ``repro.models.registry``, holding the architectures ported so
far: the transformer family's dense GQA configs, its mixture-of-experts
config, deepseek-v3-671b (MLA, MoE with a sigmoid router, MTP),
paligemma-3b (prefix-LM over a stubbed modality prefix), the ``mamba2``
family (mamba2-1.3b, served from a state cache), the ``hybrid`` family
(zamba2-1.2b: a mamba2 backbone and a shared attention block) and the
``encdec`` family (whisper-base: an audio encoder over stubbed frame
embeddings and a text decoder that cross-attends to it).
"""
from __future__ import annotations

import dataclasses
import importlib
from functools import partial
from typing import Any

import torch

from repro_torch.configs.shapes import SHAPES, cells_for

_CONFIG_MODULES = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "whisper-base": "repro_torch.configs.whisper_base",
}

ARCH_IDS = tuple(_CONFIG_MODULES)


@dataclasses.dataclass
class Arch:
    arch_id: str
    family: str
    cfg: Any

    def _family_mod(self):
        from repro_torch.models import encdec, hybrid, mamba2, transformer
        return {"transformer": transformer, "mamba2": mamba2,
                "hybrid": hybrid, "encdec": encdec}[self.family]

    # ---- construction -----------------------------------------------------
    def init_params(self, seed: int = 0, *, device="cuda"):
        """Freshly initialised params on ``device`` (the card unless the
        caller asks for the CPU), from a generator seeded with ``seed``."""
        return self._family_mod().init_params(seed, self.cfg, device=device)

    # ---- train ------------------------------------------------------------
    def make_fused_train_step(self, opt, *, global_grad_norm=None,
                              residual_constraint=None, grad_constraint=None,
                              param_constraint=None):
        """``opt`` is a ``repro_torch.core.api.Opt``; the returned step is
        ``step(params, opt_state, batch, *, hparams)`` and updates ``params``
        and ``opt_state`` in place.  The ``encdec`` family wires its two
        stacks itself and refuses ``global_grad_norm`` with ``ValueError``
        (the reference's drops it unread).

        The reference's constraint keywords: ``param_constraint`` and
        ``grad_constraint`` are one ``sharding.zero.Zero3`` plan, whose
        layer gathers and gradient reduce-scatters the step then runs (the
        params and batch handed to the step are this rank's shards and
        rows); ``residual_constraint`` (``rules.make_residual_constraint``)
        is the identity while the ``model`` axis is 1 and is not applied."""
        from repro_torch.core.fused import fused_train_step
        zero = param_constraint
        if grad_constraint is not zero:
            raise ValueError(
                "param_constraint and grad_constraint must be one Zero3 "
                "plan (the gather and the scatter of the same placement)")
        del residual_constraint
        if self.family == "encdec":
            if global_grad_norm is not None:
                raise ValueError(
                    f"{self.arch_id}: global_grad_norm (LOMO's two-pass "
                    "clip) is not supported by the encoder-decoder fused "
                    "step")
            return self._family_mod().make_fused_train_step(self.cfg, opt,
                                                            zero=zero)
        spec = self._family_mod().make_fused_spec(self.cfg)

        def train_step(params, opt_state, batch, *, hparams=None):
            return fused_train_step(spec, opt, params, opt_state, batch,
                                    hparams=hparams,
                                    global_grad_norm=global_grad_norm,
                                    zero=zero)

        return train_step

    def make_loss_fn(self, *, zero=None):
        """(params, batch) -> (loss, metrics), differentiable.  ``zero``:
        params are ZeRO-3 shards and the batch global (evaluation on a
        mesh; ``core.fused.unfused_loss_fn``)."""
        from repro_torch.core.fused import unfused_loss_fn
        if self.family == "encdec":
            return partial(self._family_mod().loss_fn, self.cfg, zero=zero)
        spec = self._family_mod().make_fused_spec(self.cfg)
        return partial(unfused_loss_fn, spec, zero=zero)

    def supported_cells(self) -> list:
        """The assigned input-shape cells (``configs/shapes.py``) this
        architecture runs."""
        return cells_for(self.arch_id)

    def supports_packing(self) -> bool:
        """Packed-segment batches need the transformer train path with
        plain causal/SWA masks: a prefix-LM mask, a modality prefix or an
        MTP head adds sequence structure that packing would break."""
        cfg = self.cfg
        return self.family == "transformer" and not (
            cfg.prefix_lm or cfg.n_prefix_tokens or cfg.mtp)

    def train_batch_specs(self, batch: int, seq_len: int, *,
                          labels: bool = True, packed: bool = False) -> dict:
        """``{leaf: (shape, dtype)}`` of a train batch for an explicit
        (batch, seq_len) — the contract between the data layer
        (``repro_torch.run.data.make_batch_iter`` yields exactly these leaves)
        and the step program.  ``packed=True`` adds the packed-segment
        leaves: ``segment_ids``, ``positions`` and ``loss_mask``; a
        prefix-LM model's batch adds ``prefix_embed [B, n_prefix_tokens,
        d_model]`` (float32) and ``prefix_len [B]`` (int32); an MTP
        model's labelled batch adds ``labels_mtp``; an encoder-decoder
        model's adds ``frames [B, n_frames, d_model]`` (float32)."""
        B, S = batch, seq_len
        if packed and not self.supports_packing():
            raise ValueError(
                f"packing is not supported for arch {self.arch_id!r} "
                f"(family={self.family}; prefix-LM/modality-prefix/MTP "
                f"batches have extra sequence structure packing would "
                f"break)")
        out = {"tokens": ((B, S), torch.int32)}
        if labels:
            out["labels"] = ((B, S), torch.int32)
        if packed:
            out["segment_ids"] = ((B, S), torch.int32)
            out["positions"] = ((B, S), torch.int32)
            out["loss_mask"] = ((B, S), torch.bool)
            return out
        if self.family == "encdec":
            out["frames"] = ((B, self.cfg.n_frames, self.cfg.d_model),
                             torch.float32)
        if getattr(self.cfg, "prefix_lm", False):
            out["prefix_embed"] = ((B, self.cfg.n_prefix_tokens,
                                    self.cfg.d_model), torch.float32)
            out["prefix_len"] = ((B,), torch.int32)
        if getattr(self.cfg, "mtp", False) and labels:
            out["labels_mtp"] = ((B, S), torch.int32)
        return out

    def input_specs(self, shape_name: str, *, packed: bool = False) -> dict:
        """``{leaf: (shape, dtype)}`` of the batch of an assigned shape
        (``configs/shapes.py``): a train or prefill cell's
        (:meth:`train_batch_specs`, labels for train only, ``packed`` for
        train only), a decode cell's one new token a sequence."""
        sh = SHAPES[shape_name]
        if sh.kind in ("train", "prefill"):
            return self.train_batch_specs(sh.global_batch, sh.seq_len,
                                          labels=sh.kind == "train",
                                          packed=packed and
                                          sh.kind == "train")
        return {"tokens": ((sh.global_batch, 1), torch.int32)}

    def cache_specs(self, shape_name: str):
        """The decode cache of an assigned decode shape, built on the meta
        device (nothing is allocated)."""
        sh = SHAPES[shape_name]
        if sh.kind != "decode":
            raise ValueError(f"{shape_name} is a {sh.kind} cell; a cache "
                             "belongs to a decode cell")
        return self.init_cache(sh.global_batch, sh.seq_len, device="meta")

    # ---- legacy serve (ring-buffer cache) -----------------------------------
    def make_prefill_step(self, **kw):
        """The family's prefill (``encdec``: ``max_decode_len=``, returning
        the encoder's output and the cache)."""
        return self._family_mod().make_prefill_step(self.cfg, **kw)

    def make_decode_step(self, *, use_kernel=None):
        """``use_kernel``: None = the CUDA kernel (K4) for CUDA tensors and
        the plain version for CPU tensors; False = the plain version.  The
        mamba2 family has no attention and does not read it."""
        return self._family_mod().make_decode_step(self.cfg,
                                                   use_kernel=use_kernel)

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        mod = self._family_mod()
        if self.family == "mamba2":
            return mod.init_state_cache(self.cfg, batch, device=device)
        return mod.init_cache(self.cfg, batch, max_len, device=device)

    # ---- paged serving (continuous batching; transformer GQA only) --------
    def supports_paged_serving(self) -> bool:
        try:
            self.paged_family()
        except ValueError:
            return False
        return True

    def paged_family(self):
        """The family module for the paged halves; raises ``ValueError``
        for a config they refuse: every family but the transformer (as the
        reference's ``supports_paged_serving``), and the transformer configs
        ``transformer.check_paged`` refuses."""
        mod = self._family_mod()
        if self.family == "encdec":
            raise ValueError(
                f"{self.arch_id}: paged serving supports the transformer "
                "family only (family 'encdec' decodes over cross K/V of its "
                "encoder; serve it with make_prefill_step and "
                "make_decode_step)")
        if self.family != "transformer":
            raise ValueError(
                f"{self.arch_id}: paged serving supports the transformer "
                f"family only (family {self.family!r} keeps a state cache; "
                "serve it with the legacy Engine)")
        mod.check_paged(self.cfg)
        return mod

    def make_prefill_kv_step(self):
        return self.paged_family().make_prefill_kv_step(self.cfg)

    def make_paged_decode_step(self, *, use_kernel=None):
        """``use_kernel``: None = the CUDA kernel for CUDA tensors and the
        plain version for CPU tensors; False = the plain version."""
        return self.paged_family().make_paged_decode_step(
            self.cfg, use_kernel=use_kernel)

    def init_page_pool(self, num_pages: int, page_size: int, *,
                       device="cuda"):
        return self.paged_family().init_page_pool(
            self.cfg, num_pages, page_size, device=device)


def get_arch(arch_id: str, *, smoke: bool = False) -> Arch:
    if arch_id not in _CONFIG_MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}; have "
                       f"{sorted(_CONFIG_MODULES)}")
    mod = importlib.import_module(_CONFIG_MODULES[arch_id])
    cfg = mod.smoke_config() if smoke else mod.config()
    return Arch(arch_id=arch_id, family=mod.FAMILY, cfg=cfg)


# --------------------------------------------------------------------------
# The paper's own pre-training config (TinyLlama-1.1B, paper §4.3)
# --------------------------------------------------------------------------

def paper_llama_1b() -> Arch:
    """LLaMA-architecture 1.1B used for the from-scratch C4 run (Fig. 4)."""
    from repro_torch.models.transformer import LMConfig
    return Arch(
        arch_id="llama-1.1b-paper", family="transformer",
        cfg=LMConfig(name="llama-1.1b-paper", n_layers=22, d_model=2048,
                     n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000))
