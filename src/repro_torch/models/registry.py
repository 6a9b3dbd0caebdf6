"""Architecture registry: ``--arch <id>`` → family functions + input specs.

Counterpart of ``repro.models.registry``, holding the architectures ported so
far (the dense GQA transformer family).
"""
from __future__ import annotations

import dataclasses
import importlib
from functools import partial
from typing import Any

import torch

_CONFIG_MODULES = {
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
}

ARCH_IDS = tuple(_CONFIG_MODULES)


@dataclasses.dataclass
class Arch:
    arch_id: str
    family: str
    cfg: Any

    def _family_mod(self):
        if self.family != "transformer":
            raise NotImplementedError(
                f"model family {self.family!r} is not ported yet (only "
                "'transformer')")
        from repro_torch.models import transformer
        return transformer

    # ---- construction -----------------------------------------------------
    def init_params(self, seed: int = 0, *, device="cuda"):
        """Freshly initialised params on ``device`` (the card unless the
        caller asks for the CPU), from a generator seeded with ``seed``."""
        return self._family_mod().init_params(seed, self.cfg, device=device)

    # ---- train ------------------------------------------------------------
    def make_fused_train_step(self, opt, *, global_grad_norm=None):
        """``opt`` is a ``repro_torch.core.api.Opt``; the returned step is
        ``step(params, opt_state, batch, *, hparams)`` and updates ``params``
        and ``opt_state`` in place."""
        from repro_torch.core.fused import fused_train_step
        spec = self._family_mod().make_fused_spec(self.cfg)

        def train_step(params, opt_state, batch, *, hparams=None):
            return fused_train_step(spec, opt, params, opt_state, batch,
                                    hparams=hparams,
                                    global_grad_norm=global_grad_norm)

        return train_step

    def make_loss_fn(self):
        """(params, batch) -> (loss, metrics), differentiable."""
        from repro_torch.core.fused import unfused_loss_fn
        spec = self._family_mod().make_fused_spec(self.cfg)
        return partial(unfused_loss_fn, spec)

    def train_batch_specs(self, batch: int, seq_len: int, *,
                          labels: bool = True, packed: bool = False) -> dict:
        """``{leaf: (shape, dtype)}`` of a train batch for an explicit
        (batch, seq_len) — the contract between the data layer
        (``repro_torch.run.data.make_batch_iter`` yields exactly these leaves)
        and the step program."""
        if packed:
            raise NotImplementedError(
                "packed (segment-id) batches are not ported yet")
        out = {"tokens": ((batch, seq_len), torch.int32)}
        if labels:
            out["labels"] = ((batch, seq_len), torch.int32)
        return out

    # ---- legacy serve (ring-buffer cache) -----------------------------------
    def _legacy_serve(self, what: str):
        raise NotImplementedError(
            f"Arch.{what}: the legacy ring-cache serving path (Engine, K4 "
            "decode_attention) is the next slice of the port; serve with "
            "repro_torch.serve.engine.PagedEngine")

    def make_prefill_step(self, **kw):
        self._legacy_serve("make_prefill_step")

    def make_decode_step(self):
        self._legacy_serve("make_decode_step")

    def init_cache(self, batch: int, max_len: int):
        self._legacy_serve("init_cache")

    # ---- paged serving (continuous batching; transformer GQA only) --------
    def supports_paged_serving(self) -> bool:
        return (self.family == "transformer"
                and getattr(self.cfg, "mla", None) is None
                and not getattr(self.cfg, "prefix_lm", False))

    def _paged(self):
        if not self.supports_paged_serving():
            raise ValueError(f"{self.arch_id}: paged serving supports GQA "
                             "transformers only")
        return self._family_mod()

    def make_prefill_kv_step(self):
        return self._paged().make_prefill_kv_step(self.cfg)

    def make_paged_decode_step(self, *, use_kernel=None):
        """``use_kernel``: None = the CUDA kernel for CUDA tensors and the
        plain version for CPU tensors; False = the plain version."""
        return self._paged().make_paged_decode_step(self.cfg,
                                                    use_kernel=use_kernel)

    def init_page_pool(self, num_pages: int, page_size: int, *,
                       device="cuda"):
        return self._paged().init_page_pool(self.cfg, num_pages, page_size,
                                            device=device)


def get_arch(arch_id: str, *, smoke: bool = False) -> Arch:
    if arch_id not in _CONFIG_MODULES:
        raise KeyError(f"architecture {arch_id!r} is not ported yet; have "
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
