"""The fused AdaLomo update of one tensor: K1, a handful of O(L) tensor ops,
K2.  Counterpart of ``repro.kernels.adalomo_update.ops``.

``adalomo_update(param, grad, r, c, lr, step, beta, weight_decay, clip)``
updates ``param``, ``r`` and ``c`` **in place** and returns them.  A CUDA
tensor goes through the CUDA kernels, a CPU tensor through their plain
PyTorch versions — the dispatch is on where the tensor lies, and nothing
falls back.  Leading dims ``[..., m, n]`` are independent slices (the
reference's ``vmap``): a batch axis of the launch grid, statistics per slice.

lr/β/decay/clip/step may be floats or 0-d tensors.  They reach the kernels
through small fp32 device tensors: no value is read back to the host, and a
schedule that changes them rebuilds nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core.adalomo import (DEFAULT_HPARAMS, AdaLomoConfig,
                                      device_scalar as _scalar)
from repro_torch.kernels.adalomo_update import adalomo_update as K

Tensor = torch.Tensor


@torch.no_grad()
def adalomo_update(param: Tensor, grad: Tensor, r: Tensor, c: Tensor, lr,
                   step, beta=DEFAULT_HPARAMS["beta"],
                   weight_decay=DEFAULT_HPARAMS["weight_decay"],
                   clip=DEFAULT_HPARAMS["clip"], *,
                   cfg: AdaLomoConfig = AdaLomoConfig()) -> tuple:
    """Fused AdaLomo step for a tensor ``[..., m, n]``; semantics ==
    ``ref.adalomo_step_ref``: decoupled weight decay scales θ at the final
    write, while the RMS(θ) trust scale is of the un-decayed θ.  Returns
    ``(param, r, c)``, the tensors passed in, updated."""
    dev = param.device
    beta_t = _scalar(beta, dev)
    K.adalomo_stats(grad, r, c, beta_t, eps_stat=cfg.eps_stat)
    denom = torch.clamp_min(r.sum(dim=-1), cfg.eps_stat)          # [...]
    if cfg.bias_correction:
        corr = torch.clamp_min(1.0 - beta_t ** _scalar(step, dev),
                               cfg.eps_stat)
        inv_denom_corr = 1.0 / (denom * corr)
    else:
        inv_denom_corr = 1.0 / denom
    lr_t = _scalar(lr, dev)
    decay = 1.0 - lr_t * _scalar(weight_decay, dev)
    scal = torch.stack(
        [inv_denom_corr, lr_t.expand_as(denom), decay.expand_as(denom),
         _scalar(clip, dev).expand_as(denom)], dim=-1)             # [..., 4]
    K.adalomo_update(param, grad, r, c, scal, eps_div=cfg.eps_div,
                     eps_rms=cfg.eps_rms, literal=cfg.literal_div_v)
    return param, r, c
