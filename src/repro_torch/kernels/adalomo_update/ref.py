"""Oracle for the fused AdaLomo update: the per-tensor update of
``repro_torch.core.adalomo`` with a factored state.  Counterpart of
``repro.kernels.adalomo_update.ref``."""
from __future__ import annotations

from repro_torch.core.adalomo import (DEFAULT_HPARAMS, AdaLomoConfig,
                                      FactoredState, update_tensor)


def adalomo_step_ref(param, grad, r, c, *, lr, step,
                     beta=DEFAULT_HPARAMS["beta"],
                     weight_decay=DEFAULT_HPARAMS["weight_decay"],
                     clip=DEFAULT_HPARAMS["clip"],
                     cfg: AdaLomoConfig = AdaLomoConfig()):
    """param/grad: [..., m, n]; r: [..., m]; c: [..., n].  Returns new
    ``(param, r, c)`` and mutates nothing."""
    new_param, st = update_tensor(
        param, grad, FactoredState(r=r, c=c, v=None), lr=lr, step=step,
        beta=beta, weight_decay=weight_decay, clip=clip, cfg=cfg)
    return new_param, st.r, st.c
