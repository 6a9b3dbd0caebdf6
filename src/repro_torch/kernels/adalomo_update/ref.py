"""Oracle for the fused AdaLomo update: the per-tensor update of
``repro_torch.core.adalomo`` with a factored state.  Counterpart of
``repro.kernels.adalomo_update.ref``."""
from __future__ import annotations

import torch

from repro_torch.core.adalomo import (DEFAULT_HPARAMS, AdaLomoConfig,
                                      FactoredState, update_tensor)
from repro_torch.core.adalomo import device_scalar as _scalar
from repro_torch.kernels.adalomo_update import adalomo_update as K


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


def fixed_order_sum(xs) -> torch.Tensor:
    """``xs[0] + xs[1] + ...`` in index order: the sum over the ranks that
    the collectives make (``sharding.collectives``), emulated in one
    process."""
    total = xs[0].clone()
    for x in xs[1:]:
        total += x
    return total


def adalomo_update_shards(params, grads, rs, cs, *, lr, step,
                          beta=DEFAULT_HPARAMS["beta"],
                          weight_decay=DEFAULT_HPARAMS["weight_decay"],
                          clip=DEFAULT_HPARAMS["clip"], axis: int,
                          cfg: AdaLomoConfig = AdaLomoConfig(),
                          n_total=None, plain: bool = False):
    """The sharded AdaLomo update of one tensor, its w shards (lists, rank
    order) in one process, **in place**: K1's sharded entry on each shard,
    a fixed-order sum of their raw statistics, the fold, K2's partials on
    each shard, a fixed-order sum, K2's apply on each — the steps of
    ``ops.adalomo_update(shard=...)`` with the sums over the ranks written
    out.  ``axis`` -2: row shards (``rs`` each shard's rows, every ``cs[i]``
    the whole c); -1: column shards.  The kernels' wrappers dispatch on the
    device, so CUDA shards run the kernels and CPU shards their plain
    versions; ``plain=True`` runs the plain versions on any device, to
    hold the kernels against them on the card.  ``n_total`` (default: the
    whole tensor's m·n) is the count the RMS values divide by.  Returns
    ``(params, rs, cs)``."""
    stats_partial, stats_fold, update_partials, update_apply = (
        _PLAIN_ENTRIES if plain else
        (K.adalomo_stats_partial, K.adalomo_stats_fold,
         K.adalomo_update_partials, K.adalomo_update_apply))
    dev = params[0].device
    beta_t = _scalar(beta, dev)
    raws = [stats_partial(g, r, c, beta_t, eps_stat=cfg.eps_stat, axis=axis)
            for g, r, c in zip(grads, rs, cs)]
    raw = fixed_order_sum(raws)
    m, n = params[0].shape[-2:]
    w = len(params)
    if n_total is None:
        n_total = m * n * w
    denoms = []
    for r, c in zip(rs, cs):
        if axis == -2:
            stats_fold(c, raw, beta_t)
            denoms.append(torch.clamp_min(raw[..., -1], cfg.eps_stat))
        else:
            stats_fold(r, raw, beta_t)
            denoms.append(torch.clamp_min(r.sum(dim=-1), cfg.eps_stat))
    corr = (torch.clamp_min(1.0 - beta_t ** _scalar(step, dev),
                            cfg.eps_stat)
            if cfg.bias_correction else torch.ones((), device=dev))
    lr_t = _scalar(lr, dev)
    decay = 1.0 - lr_t * _scalar(weight_decay, dev)
    scals = [torch.stack([1.0 / (d * corr), lr_t.expand_as(d),
                          decay.expand_as(d), _scalar(clip, dev).expand_as(d)],
                         dim=-1) for d in denoms]
    kw = dict(eps_div=cfg.eps_div, eps_rms=cfg.eps_rms,
              literal=cfg.literal_div_v)
    sums = fixed_order_sum([update_partials(p, g, r, c, s, **kw)
                            for p, g, r, c, s in zip(params, grads, rs, cs,
                                                     scals)])
    for p, g, r, c, s in zip(params, grads, rs, cs, scals):
        update_apply(p, g, r, c, s, sums, n_total, **kw)
    return params, rs, cs


def adalomo_update_grid(params, grads, rs, cs, *, lr, step,
                        beta=DEFAULT_HPARAMS["beta"],
                        weight_decay=DEFAULT_HPARAMS["weight_decay"],
                        clip=DEFAULT_HPARAMS["clip"],
                        cfg: AdaLomoConfig = AdaLomoConfig(), n_total=None,
                        plain: bool = False):
    """The sharded AdaLomo update of one tensor split into an R × C grid
    of blocks (``params[i][j]``: row block i, column block j; ``rs[i][j]``
    row block i's r, ``cs[i][j]`` column block j's c, each block's own
    copy), in one process, **in place**: the steps of
    ``ops.adalomo_update(shard=...)`` for a block of both (K1's mode 3 on
    each block, the row sums summed over each row's blocks, the fold of r,
    Σr' packed beside the column sums, those summed over each column's
    blocks, the fold of c, K2's partials summed over all the blocks in
    row-major order, K2's apply), the sums over the ranks written out as
    fixed-order sums.  ``plain`` and ``n_total`` as
    :func:`adalomo_update_shards`'s.  Returns ``(params, rs, cs)``."""
    stats_partial, stats_fold, update_partials, update_apply = (
        _PLAIN_ENTRIES if plain else
        (K.adalomo_stats_partial, K.adalomo_stats_fold,
         K.adalomo_update_partials, K.adalomo_update_apply))
    R, Cn = len(params), len(params[0])
    dev = params[0][0].device
    beta_t = _scalar(beta, dev)
    raw = [[stats_partial(grads[i][j], rs[i][j], cs[i][j], beta_t,
                          eps_stat=cfg.eps_stat, axis=K.BOTH)
            for j in range(Cn)] for i in range(R)]
    for i in range(R):
        rows = fixed_order_sum([raw[i][j][0] for j in range(Cn)])
        for j in range(Cn):
            stats_fold(rs[i][j], rows, beta_t)
            raw[i][j][1][..., -1] = rs[i][j].sum(dim=-1)
    denoms = [[None] * Cn for _ in range(R)]
    for j in range(Cn):
        cols = fixed_order_sum([raw[i][j][1] for i in range(R)])
        for i in range(R):
            stats_fold(cs[i][j], cols, beta_t)
            denoms[i][j] = torch.clamp_min(cols[..., -1], cfg.eps_stat)
    if n_total is None:
        n_total = (sum(p.shape[-2] for p in (row[0] for row in params))
                   * sum(p.shape[-1] for p in params[0]))
    corr = (torch.clamp_min(1.0 - beta_t ** _scalar(step, dev),
                            cfg.eps_stat)
            if cfg.bias_correction else torch.ones((), device=dev))
    lr_t = _scalar(lr, dev)
    decay = 1.0 - lr_t * _scalar(weight_decay, dev)
    kw = dict(eps_div=cfg.eps_div, eps_rms=cfg.eps_rms,
              literal=cfg.literal_div_v)
    blocks = [(i, j) for i in range(R) for j in range(Cn)]
    scal = {}
    for i, j in blocks:
        d = denoms[i][j]
        scal[i, j] = torch.stack([1.0 / (d * corr), lr_t.expand_as(d),
                                  decay.expand_as(d),
                                  _scalar(clip, dev).expand_as(d)], dim=-1)
    sums = fixed_order_sum([update_partials(
        params[i][j], grads[i][j], rs[i][j], cs[i][j], scal[i, j], **kw)
        for i, j in blocks])
    for i, j in blocks:
        update_apply(params[i][j], grads[i][j], rs[i][j], cs[i][j],
                     scal[i, j], sums, n_total, **kw)
    return params, rs, cs


def _stats_partial_plain(grad, r, c, beta, *, eps_stat, axis):
    nr, nc, raw = K.adalomo_stats_partial_ref(grad, r, c, beta,
                                              eps_stat=eps_stat, axis=axis)
    r.copy_(nr)
    c.copy_(nc)
    return raw


# the four sharded entries' plain versions, in place as their wrappers are
_PLAIN_ENTRIES = (
    _stats_partial_plain,
    lambda dst, src, beta: dst.copy_(K.adalomo_stats_fold_ref(dst, src,
                                                              beta)),
    K.adalomo_update_partials_ref,
    lambda param, *a, **kw: param.copy_(K.adalomo_update_apply_ref(
        param, *a, **kw)))
