"""Optimizer-health probes (PyTorch) — device reductions run in the step
program.  Counterpart of ``repro.telemetry.probes``.

AdaLomo's correctness hinges on internals the loss curve does not show: the
grouped update normalization (Alg. 1 line 11) and the non-negative
factorization of the second moment (Eq. 5-7).  :func:`instrument_step` wraps
the step program's callable so that every step additionally returns, in the
metrics dict under ``"opt_health"``:

* **per-GroupSpec update/param norm ratios** — ``‖Δθ‖/‖θ‖`` over each Opt-v2
  param group (:func:`group_ratios`);
* **an effective-lr histogram** — the per-unit relative update
  ``RMS(Δθ)/RMS(θ)`` binned into fixed log10 buckets, one unit per layer
  slice of a stacked ``[L, ...]`` leaf (:func:`effective_lr_hist`);
* **the rank-1 transition residual** of the largest factored moments
  (:func:`transition_residual`; see the reference module for the maths), and
  the literal factorization error of any ≥ 2-D unfactored ``v``.

The port's step updates ``(params, opt_state)`` in place, so the pre-step
values the probes compare against come from a :class:`Snapshot` taken before
the step, into buffers kept from one step to the next.

Every reduction accumulates in fp32 over pieces of at most ``_CHUNK``
elements (a layer slice, or a block of rows of a reconstructed moment), in a
fixed order: the fp32 temporaries stay far below a layer's activations on the
largest stacked leaves, and a re-run is bitwise the same.  Nothing is read
back to the host: the probe values ride the runner's one per-step transfer.

On a mesh (``zero``, a ``sharding.zero.Zero3``) each rank holds blocks, so
the sums are reduced over the ranks inside the step and every rank reaches
the same bits: each leaf's per-unit vectors are summed over the ranks
holding its other blocks, each element counted once, in one collective
(:func:`mesh_sums`, ``Zero3.sum_once(per_term=True)``), and the element
counts are the whole leaves' (``zero.shapes``).  The factored residuals
sample tensors by their whole size and sum a block's statistics over its
row, column or block group (the leaf's ``TensorShard``).  A block cuts its
own ``_CHUNK`` pieces, so the sharded sums round differently from the
unsharded ones (fp32 rounding of the order of the sums, ~1e-7 relative); on
a one-rank mesh they are the unsharded values, bit for bit.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import torch

from repro_torch.core.adalomo import FactoredState
from repro_torch.core.api import STACKS_KEY, OptState, path_str
from repro_torch.core.tree import (tree_flatten_with_path, tree_leaves,
                                   tree_map)

_TINY = 1e-30
# Relative updates are measured against max(RMS(θ), _RMS_FLOOR) — the
# Adafactor/AdaLomo eps2 convention — so zero-initialized groups (e.g.
# zero-centered norm scales) report against the floor instead of ∞.
_RMS_FLOOR = 1e-3
# Elements per fp32 temporary of a reduction (128 MiB): a layer slice of
# danube's largest stacked leaf (17.7 M) in one piece, far below the step's
# own transient (≈ 4 GB), in few enough launches that the host keeps up.
_CHUNK = 1 << 25
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ObservabilitySpec:
    """Per-probe cadence + shape knobs for the telemetry layer, on
    :class:`~repro_torch.run.spec.RunSpec` as the ``observe`` field.

    ``optimizer_every=0`` disables the optimizer-health probes entirely
    (the step program is not wrapped).  When enabled, probe values are
    computed every step; the cadences below govern how often the stream
    *records* them:

    ``optimizer_every``  group-ratio + effective-lr records;
    ``factored_every``   reconstruction-residual records (0 = follow
                         ``optimizer_every``);
    ``sample_tensors``   how many of the largest factored (and unfactored
                         >= 2-D) moment tensors get the residual probe;
    ``hist_bins`` / ``hist_range``  fixed log10 bin layout of the
                         effective-lr histogram.
    """

    optimizer_every: int = 0
    factored_every: int = 0
    sample_tensors: int = 2
    hist_bins: int = 16
    hist_range: tuple = (-8.0, 0.0)

    def __post_init__(self):
        if self.optimizer_every < 0 or self.factored_every < 0:
            raise ValueError("probe cadences must be >= 0")
        if self.sample_tensors < 0 or self.hist_bins < 1:
            raise ValueError(
                f"sample_tensors={self.sample_tensors} hist_bins="
                f"{self.hist_bins}")
        lo, hi = self.hist_range
        if not lo < hi:
            raise ValueError(f"hist_range {self.hist_range} must be (lo, hi)")
        # normalize (JSON round-trips lists) so specs compare equal
        object.__setattr__(self, "hist_range",
                           (float(lo), float(hi)))

    @property
    def enabled(self) -> bool:
        return self.optimizer_every > 0

    def resolved_factored_every(self) -> int:
        return self.factored_every or self.optimizer_every


# --------------------------------------------------------------------------
# The pre-step snapshot
# --------------------------------------------------------------------------

def _tensors(tree) -> list:
    """Every tensor of a tree of dicts and (named) tuples, in leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _replace(tree, it):
    """``tree`` with each float tensor replaced by ``next(it)``."""
    if isinstance(tree, dict):
        return {k: _replace(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple):
        vals = [_replace(x, it) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, list):
        return [_replace(x, it) for x in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return next(it)
    return tree


class Snapshot:
    """The pre-step values of an in-place step: a copy of every float leaf
    of ``params`` and every float tensor of the moments.

    The buffers are allocated at the first :meth:`capture` and reused by
    every later one (again only if the trees' shapes change), so a step
    pays one device copy and no allocation.  ``OptState.step`` is replaced
    by a new tensor every step and never written in place, so the old
    object is kept as it is."""

    def __init__(self):
        self._bufs: list = []

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self._bufs)

    def capture(self, params, opt_state: OptState) -> tuple:
        """Copy the live values into the buffers; returns ``(params,
        opt_state)`` as trees over the copies."""
        src = [t for t in _tensors((params, opt_state.moments))
               if t.is_floating_point()]
        sig = [(t.shape, t.dtype, t.device) for t in src]
        if sig != [(b.shape, b.dtype, b.device) for b in self._bufs]:
            self._bufs = []            # free the old set before the new one
            self._bufs = [torch.empty_like(t, memory_format=torch
                                           .contiguous_format) for t in src]
        for b, t in zip(self._bufs, src):
            b.copy_(t)
        it = iter(self._bufs)
        snap_params = _replace(params, it)
        snap_moments = _replace(opt_state.moments, it)
        return snap_params, OptState(step=opt_state.step,
                                     moments=snap_moments)


# --------------------------------------------------------------------------
# Chunked fp32 reductions
# --------------------------------------------------------------------------

def _is_stacked(path: str, leaf) -> bool:
    parts = path.split("/") if path else []
    return bool(parts) and parts[0] == STACKS_KEY and \
        getattr(leaf, "ndim", 0) >= 1


def _units(x: torch.Tensor, stacked: bool) -> torch.Tensor:
    """``[units, elements]`` view: one row per layer slice of a stacked
    leaf, one row for any other leaf."""
    return x.reshape(x.shape[0], -1) if stacked else x.reshape(1, -1)


def _row_blocks(n_rows: int, row_len: int) -> list:
    """``[(r0, r1, c0, c1)]`` blocks of at most ``_CHUNK`` elements over an
    ``[n_rows, row_len]`` matrix, row-major: whole rows grouped when a row
    is small, a long row cut into pieces."""
    if row_len <= _CHUNK:
        per = max(1, _CHUNK // max(row_len, 1))
        return [(r, min(r + per, n_rows), 0, row_len)
                for r in range(0, n_rows, per)]
    return [(r, r + 1, c, min(c + _CHUNK, row_len))
            for r in range(n_rows) for c in range(0, row_len, _CHUNK)]


def _fold(norms: list, units: int) -> torch.Tensor:
    """Per-block norms (in block order) → per-unit sums of squares: a unit
    cut into k pieces contributes k norms, in order."""
    return torch.cat(norms).square_().reshape(units, -1).sum(dim=1)


def _unit_sq_sums(old: torch.Tensor, new: torch.Tensor, stacked: bool,
                  *, par: bool = True) -> tuple:
    """Per unit (layer slice or whole leaf): ``Σ(new − old)²`` and, when
    ``par``, ``Σ old²`` (else None), fp32 ``[units]`` vectors.  The
    difference is taken in fp32 a block at a time and each block reduced by
    one norm; the blocks' norms are folded once at the end."""
    o, n = _units(old, stacked), _units(new, stacked)
    U, E = o.shape
    d_norms, o_norms = [], []
    for r0, r1, c0, c1 in _row_blocks(U, E):
        ob = o[r0:r1, c0:c1]
        d = n[r0:r1, c0:c1].to(_F32, copy=True).sub_(ob)
        d_norms.append(torch.linalg.vector_norm(d, dim=1))
        del d
        if par:
            o_norms.append(torch.linalg.vector_norm(ob, dim=1, dtype=_F32))
    return _fold(d_norms, U), _fold(o_norms, U) if par else None


def leaf_sums(p_old, p_new, *, par: bool = True) -> list:
    """``[(path, stacked, Σ(Δ)² per unit, Σθ² per unit, elements a unit)]``
    over the leaves of ``p_old``, in leaf order — one pass over the two
    trees that the guard's update norm, the trust ratios and the probes all
    read (``Σθ²`` only when ``par``)."""
    out = []
    for (kp, o), n in zip(tree_flatten_with_path(p_old), tree_leaves(p_new)):
        path = path_str(kp)
        stacked = _is_stacked(path, o)
        dsq, osq = _unit_sq_sums(o, n, stacked, par=par)
        out.append((path, stacked, dsq, osq, _units(o, stacked).shape[1]))
    return out


def mesh_sums(sums: list, zero) -> list:
    """:func:`leaf_sums` of the whole model from those of this rank's
    blocks: each leaf's per-unit vectors summed over the ranks holding its
    other blocks, each element once (one collective), and the elements a
    unit of the whole leaf.  A stacked leaf's units are its layers, which
    no block splits.  The same bits on every rank."""
    places = [pl for _, pl in tree_flatten_with_path(zero.dims)]
    shapes = [shp for _, shp in tree_flatten_with_path(zero.shapes)]
    terms = [(pl, dsq if osq is None else torch.cat([dsq, osq]))
             for (_, _, dsq, osq, _), pl in zip(sums, places)]
    out = []
    for (path, st, dsq, osq, _), v, shp in zip(
            sums, zero.sum_once(terms, per_term=True), shapes):
        u = dsq.numel()
        out.append((path, st, v[:u], None if osq is None else v[u:],
                    math.prod(shp) // u))
    return out


def update_norm_of(sums: list) -> torch.Tensor:
    """Global ‖Δθ‖ from :func:`leaf_sums`."""
    return torch.sqrt(torch.cat([dsq for _, _, dsq, _, _ in sums]).sum())


def committed_sums(sums: list, keep: torch.Tensor) -> list:
    """:func:`leaf_sums` of the committed transition, from those of the
    proposed one: the commit keeps the proposed values bitwise (the same
    sums) or restores the old ones (a difference of exactly 0)."""
    return [(p, st, torch.where(keep, dsq, torch.zeros_like(dsq)), osq, e)
            for p, st, dsq, osq, e in sums]


# --------------------------------------------------------------------------
# The probes
# --------------------------------------------------------------------------

def _group_ratios(sums: list, labels: list, opt) -> dict:
    names = ["default"] + [g.name for g in opt.groups]
    dev = sums[0][2].device if sums else torch.device("cpu")
    upd = [torch.zeros((), dtype=_F32, device=dev) for _ in names]
    par = [torch.zeros((), dtype=_F32, device=dev) for _ in names]
    cnt = [0 for _ in names]
    for (_, _, dsq, osq, e), lab in zip(sums, labels):
        upd[lab] = upd[lab] + dsq.sum()
        par[lab] = par[lab] + osq.sum()
        cnt[lab] += dsq.numel() * e
    return {name: torch.sqrt(u) / torch.clamp_min(
                torch.sqrt(p), _RMS_FLOOR * max(c, 1) ** 0.5)
            for name, u, p, c in zip(names, upd, par, cnt)}


def group_ratios(p_old, p_new, opt) -> dict:
    """``‖Δθ‖ / max(‖θ‖, eps2·√n)`` per Opt-v2 param group (fp32 0-d
    tensors, one per group name, group 'default' first).  The denominator
    floor is the group-norm equivalent of ``RMS(θ) >= _RMS_FLOOR``."""
    return _group_ratios(leaf_sums(p_old, p_new),
                         tree_leaves(opt.labels(p_old)), opt)


def hist_edges(ospec: ObservabilitySpec, device="cpu") -> torch.Tensor:
    """The histogram's ``hist_bins + 1`` fp32 edges, by ``jnp.linspace``'s
    formula: ``lo·(1 − i/bins) + hi·(i/bins)``, the last edge ``hi``; made
    on ``device`` (a fill, no copy from the host)."""
    lo, hi = ospec.hist_range
    b = ospec.hist_bins
    full = lambda x: torch.full((), x, dtype=_F32, device=device)  # noqa: E731
    frac = torch.arange(b, dtype=_F32, device=device) / full(float(b))
    lo_t, hi_t = full(lo), full(hi)
    return torch.cat([lo_t * (1 - frac) + hi_t * frac, hi_t.reshape(1)])


def _histogram(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(x, bins=edges)[0]``: bin ``i`` holds
    ``edges[i] <= x < edges[i+1]``, the last edge inclusive, values outside
    (and NaN) dropped; fp32 counts.  ``bucketize`` and a one-hot sum, both
    deterministic on the card."""
    nb = edges.numel() - 1
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], nb, idx)
    idx = torch.where(torch.isnan(x), nb + 1, idx)
    bins = torch.arange(1, nb + 1, device=x.device)
    return (idx[:, None] == bins[None, :]).to(_F32).sum(dim=0)


def _eff_lr(sums: list, ospec: ObservabilitySpec) -> dict:
    rels = [torch.sqrt(dsq / e) / torch.clamp_min(torch.sqrt(osq / e),
                                                   _RMS_FLOOR)
            for _, _, dsq, osq, e in sums]
    rel = torch.cat(rels)
    lo, hi = ospec.hist_range
    edges = hist_edges(ospec, rel.device)
    counts = _histogram(torch.log10(torch.clamp_min(rel, _TINY)), edges)
    return {"counts": counts, "lo": lo, "hi": hi,
            "n_units": int(rel.shape[0]),
            "rel_update_mean": torch.mean(rel),
            "rel_update_max": torch.max(rel)}


def effective_lr_hist(p_old, p_new, ospec: ObservabilitySpec) -> dict:
    """Fixed-shape histogram of per-unit relative updates
    ``log10(RMS(Δθ)/RMS(θ))``, plus mean/max of the raw ratio."""
    return _eff_lr(leaf_sums(p_old, p_new), ospec)


def _lead_row_blocks(lead: int, m: int, n: int) -> list:
    """``[(l0, l1, i0, i1)]`` over ``[lead, m, n]``, at most ``_CHUNK``
    elements a block: whole matrices grouped when they are small, else
    blocks of rows of one matrix."""
    if m * n <= _CHUNK:
        per = max(1, _CHUNK // max(m * n, 1))
        return [(l, min(l + per, lead), 0, m) for l in range(0, lead, per)]
    rows = max(1, _CHUNK // max(n, 1))
    return [(l, l + 1, i, min(i + rows, m))
            for l in range(lead) for i in range(0, m, rows)]


def _reducers(shard) -> tuple:
    """(sum over the row group, over the column group, over the block
    group) of a mesh block's ``TensorShard``; identities off a mesh."""
    if shard is None:
        same = lambda t: t                                      # noqa: E731
        return same, same, same
    return shard.over_rows, shard.over_cols, shard.sum


def _unit_mean(x: torch.Tensor, units, n_units: int) -> torch.Tensor:
    """The mean of per-unit values ``x`` over the whole leaf's units
    (``units``: the group holding its other units, or None)."""
    if units is None:
        return torch.mean(x)
    from repro_torch.sharding import collectives as C
    return C.all_reduce(torch.sum(x), units) / n_units


def transition_residual(r_old, c_old, r_new, c_new, beta, *, shard=None,
                        units=None, n_units=None):
    """Rank-1 transition residual of the factored EMA:
    ‖v̂ₜ − (β v̂ₜ₋₁ + (1−β) v̂(R,C))‖_F / ‖v̂ₜ‖_F, mean over leading dims,
    with the implied statistics ``R = max(rₜ − β rₜ₋₁, 0)/(1−β)`` (C
    likewise).

    The difference is three rank-1 terms ``r_k c_kᵀ`` with the weights and
    each ``1/Σr_k`` folded into the column vectors; it is built a block of
    rows at a time (one product, two fused multiply-adds) and reduced by a
    norm, so no ``[m, n]`` matrix exists whole.  ``‖v̂ₜ‖_F = ‖rₜ‖‖cₜ‖/Σrₜ``
    exactly, a product of two vector norms.

    On a mesh ``r`` and ``c`` are this rank's blocks of a matrix whose
    ``shard`` (a ``TensorShard``) names the groups holding the others: the
    Σr and ‖r‖² are summed over the row group, ‖c‖² over the column group
    and the squared residual of each block over the block group; ``units``
    is the group holding the leaf's other leading slices (an expert stack
    split over ``model``), of ``n_units`` in all."""
    rows, cols, blocks = _reducers(shard)
    dev = r_new.device
    b = beta.to(device=dev, dtype=_F32) if isinstance(beta, torch.Tensor) \
        else torch.full((), beta, dtype=_F32, device=dev)
    one_m_b = torch.clamp_min(1.0 - b, _TINY)
    r_imp = torch.clamp_min(r_new - b * r_old, 0.0) / one_m_b
    c_imp = torch.clamp_min(c_new - b * c_old, 0.0) / one_m_b
    m, n = r_new.shape[-1], c_new.shape[-1]
    lead = math.prod(r_new.shape[:-1])
    rs = [x.reshape(lead, m) for x in (r_new, r_old, r_imp)]
    r_sums = rows(torch.stack(
        [torch.sum(r, dim=-1) for r in rs]
        + [torch.linalg.vector_norm(rs[0], dim=-1).square()], dim=-1))
    dens = [torch.clamp_min(r_sums[:, k], _TINY) for k in range(3)]
    weights = (1.0, -b, -(1.0 - b))
    cs = [x.reshape(lead, n) * (w / d)[:, None] for x, w, d in
          zip((c_new, c_old, c_imp), weights, dens)]
    vn = (torch.sqrt(r_sums[:, 3])
          * torch.sqrt(cols(torch.linalg.vector_norm(cs[0], dim=-1)
                            .square())))
    norms = []
    for l0, l1, i0, i1 in _lead_row_blocks(lead, m, n):
        x = rs[0][l0:l1, i0:i1, None] * cs[0][l0:l1, None, :]
        for k in (1, 2):
            x.addcmul_(rs[k][l0:l1, i0:i1, None], cs[k][l0:l1, None, :])
        norms.append(torch.linalg.vector_norm(x, dim=(-2, -1)))
        del x
    res = torch.sqrt(blocks(_fold(norms, lead)))
    return _unit_mean(res / torch.clamp_min(vn, _TINY), units, n_units)


def factorization_error(v, *, shard=None, units=None, n_units=None):
    """Literal ‖v − v_r v_cᵀ/Σv_r‖_F / ‖v‖_F for a materialized v (>= 2-D)
    — the error a rank-1 factorization of this tensor WOULD incur now;
    reduced a block of rows at a time.  On a mesh (``shard``, ``units`` as
    :func:`transition_residual`'s) v is this rank's block: the row sums
    are summed over the column group, the column sums and Σv_r over the
    row group, the squared norms over the block group."""
    rows, cols, blocks = _reducers(shard)
    m, n = v.shape[-2], v.shape[-1]
    lead = math.prod(v.shape[:-2])
    v3 = v.reshape(lead, m, n)
    r = cols(torch.sum(v3, dim=-1))
    c_sums = rows(torch.cat([torch.sum(v3, dim=-2),
                             torch.sum(r, dim=-1, keepdim=True)], dim=-1))
    c = c_sums[:, :-1] / torch.clamp_min(c_sums[:, -1:], _TINY)
    res, vn = [], []
    for l0, l1, i0, i1 in _lead_row_blocks(lead, m, n):
        vb = v3[l0:l1, i0:i1].to(_F32)
        d = vb - r[l0:l1, i0:i1, None] * c[l0:l1, None, :]
        res.append(torch.linalg.vector_norm(d, dim=(-2, -1)))
        vn.append(torch.linalg.vector_norm(vb, dim=(-2, -1)))
        del vb, d
    return _unit_mean(torch.sqrt(blocks(_fold(res, lead))) / torch.clamp_min(
        torch.sqrt(blocks(_fold(vn, lead))), _TINY), units, n_units)


def _moment_leaves(moments) -> list:
    """[(path, FactoredState)] — per-tensor moment states with paths."""
    return [(path_str(kp), st) for kp, st in tree_flatten_with_path(moments)
            if isinstance(st, FactoredState)]


def _sample(pairs, k):
    """Deterministic sample: the k largest by reconstructed-tensor size,
    ties broken by path."""
    return sorted(pairs, key=lambda ps: (-ps[1], ps[0]))[:k]


def _recon_size(st: FactoredState) -> int:
    """Element count of the tensor v̂(r, c) reconstructs (incl. stacks)."""
    lead = 1
    for d in st.r.shape[:-1]:
        lead *= int(d)
    return lead * int(st.r.shape[-1]) * int(st.c.shape[-1])


def _mesh_kw(zero) -> dict:
    """``{path: keywords}`` of the residual probes for each leaf of a
    mesh's params: its ``TensorShard`` and, for an expert stack split over
    ``model``, the group holding its other experts and its slice count."""
    shards = dict((path_str(kp), sh) for kp, sh in
                  tree_flatten_with_path(zero.tree_shards()))
    out = {}
    for (kp, pl), (_, shp) in zip(tree_flatten_with_path(zero.dims),
                                  tree_flatten_with_path(zero.shapes)):
        path = path_str(kp)
        ep = pl.ep and zero.model is not None
        out[path] = {"shard": shards[path],
                     "units": zero.model if ep else None,
                     "n_units": math.prod(shp[:-2]) if ep else None}
    return out


def factored_health(s_old, s_new, beta, ospec: ObservabilitySpec,
                    zero=None) -> dict:
    """Reconstruction-error probes over sampled moment tensors.  Returns
    ``{"recon/<path>": residual}`` (+ ``"fact_err/<path>"`` for tensors
    carrying an explicit v).  Empty when the rule's state is not the
    AdaLomo factored layout or ``beta`` is unavailable.  On a mesh
    (``zero``) the tensors are sampled by their whole size and each
    rank's blocks reduced with the others (module docstring)."""
    out: dict = {}
    if beta is None:
        return out
    old = dict(_moment_leaves(s_old))
    new = dict(_moment_leaves(s_new))
    if zero is None:
        size = lambda p, st: (_recon_size(st) if st.v is None    # noqa: E731
                              else int(st.v.numel()))
        kw = collections.defaultdict(dict)
    else:
        whole = {path_str(kp): math.prod(shp)
                 for kp, shp in tree_flatten_with_path(zero.shapes)}
        size = lambda p, st: whole[p]                           # noqa: E731
        kw = _mesh_kw(zero)
    fact = [(p, size(p, st)) for p, st in new.items()
            if st.r is not None and st.c is not None and p in old]
    for p, _sz in _sample(fact, ospec.sample_tensors):
        so, sn = old[p], new[p]
        out[f"recon/{p}"] = transition_residual(so.r, so.c, sn.r, sn.c,
                                                beta, **kw[p])
    dense = [(p, size(p, st)) for p, st in new.items()
             if st.v is not None and st.v.ndim >= 2]
    for p, _sz in _sample(dense, ospec.sample_tensors):
        out[f"fact_err/{p}"] = factorization_error(new[p].v, **kw[p])
    return out


def optimizer_health(p_old, p_new, s_old, s_new, hp, *, opt,
                     ospec: ObservabilitySpec, sums=None, zero=None) -> dict:
    """The full per-step health dict (fp32 0-d device tensors, one
    ``[hist_bins]`` histogram, and the histogram's host constants).  One
    pass over ``(p_old, p_new)`` (or the caller's :func:`leaf_sums` of
    them) feeds both the group ratios and the histogram.  Its structure
    depends only on (params, opt, ospec).  On a mesh (``zero``) the values
    are the whole model's, the same bits on every rank; ``sums`` are then
    :func:`mesh_sums`' when given."""
    beta = opt.resolve(hp)[0].get("beta")
    if sums is None:
        sums = leaf_sums(p_old, p_new)
        if zero is not None:
            sums = mesh_sums(sums, zero)
    return {
        "group_ratio": _group_ratios(sums, group_labels(opt, p_old, zero),
                                     opt),
        "eff_lr": _eff_lr(sums, ospec),
        "factored": factored_health(s_old.moments, s_new.moments, beta,
                                    ospec, zero),
    }


def group_labels(opt, params, zero=None) -> list:
    """The group index of each leaf, in leaf order; on a mesh labelled by
    the whole leaves' shapes (``zero.shapes``), as the unsharded run's."""
    if zero is not None:
        params = tree_map(lambda shp: torch.empty(shp, device="meta"),
                          zero.shapes)
    return tree_leaves(opt.labels(params))


def instrument_step(inner, *, opt, ospec: ObservabilitySpec, zero=None):
    """Wrap an in-place step callable ``(params, opt_state, batch, hp) ->
    (params', opt_state', loss, metrics)`` so metrics additionally carries
    ``"opt_health"``: the pre-step values are captured into a
    :class:`Snapshot` (the wrapper's ``.snapshot``, kept across steps)
    before ``inner`` runs.  ``zero``: the step is ZeRO-3 sharded, and the
    probes are reduced over the ranks (module docstring)."""
    snapshot = Snapshot()

    def instrumented(params, opt_state, batch, hp):
        p_old, s_old = snapshot.capture(params, opt_state)
        p2, s2, loss, metrics = inner(params, opt_state, batch, hp)
        health = optimizer_health(p_old, p2, s_old, s2, hp, opt=opt,
                                  ospec=ospec, zero=zero)
        return p2, s2, loss, {**metrics, "opt_health": health}

    instrumented.snapshot = snapshot
    return instrumented
