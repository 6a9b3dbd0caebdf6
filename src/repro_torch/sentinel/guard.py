"""In-step anomaly guard (PyTorch) — detection + skip/backoff commit folded
into the step program.  Counterpart of ``repro.sentinel.guard``.

:func:`guard_step` wraps the step program's callable (the slot
:func:`repro_torch.telemetry.probes.instrument_step` occupies) so that every
step additionally threads a :class:`SentinelState` and returns a verdict in
the metrics dict under ``"sentinel"``:

* **non-finite guard** — any NaN/Inf in the loss, the updated params, or the
  updated optimizer moments;
* **spike guard** — global update norm ``‖Δθ‖`` against a bias-corrected EMA
  carried in ``SentinelState`` (armed after ``warmup`` clean steps; the
  fused path never materializes gradients, so the post-normalization update
  norm is the spike signal);
* **trust guard** — per-GroupSpec trust ratios (the probes' group ratios)
  against ``SentinelSpec.trust_max`` (0 disables).

One pass over (snapshot, proposed params) gives per-unit sums of squares
that the update norm, the trust ratios and — masked by the verdict, since
the commit keeps the proposal bitwise or restores the snapshot — the probes
of the committed transition all read.

The reference's step is functional and commits with a ``jnp.where`` between
the old and the new trees.  The port's step updates ``(params, opt_state)``
in place, so by the time a verdict exists the old values are gone.  The
guard therefore **snapshots before the step** (into buffers kept from step
to step, :class:`~repro_torch.telemetry.probes.Snapshot`), runs the in-place
step, poisons it (the injector), detects, and **commits in place** with
``torch.where(keep, new, snap, out=new)`` over params and every moment
tensor; ``OptState.step`` is a new tensor each step, so the old object is
the old value.  A skipped step is then a true no-op on the optimizer,
counter included.  ``keep`` is a 0-d device bool: nothing is read back to
the host, and the verdict rides the runner's one per-step transfer.  The
EMA absorbs only clean steps, so one anomaly cannot drag the reference
level toward the anomaly.

On a mesh (``zero``, a ``sharding.zero.Zero3``) each rank holds shards, so
the verdict is reduced over the ranks on the device before the commit: a
non-finite value on any rank makes the step non-finite on every rank, and
the per-unit sums of squares that the update norm, the trust ratios and the
probes read are summed over the ``data`` × ``model`` ranks in rank order,
each element once (``telemetry.probes.mesh_sums``), the trust ratios
counting the whole leaves' elements.  Every rank then reaches the same
verdict and the same probe values from the same bits, inside the step's
one host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.api import OptState
from repro_torch.sentinel.inject import float_tensors
from repro_torch.sentinel.spec import SentinelSpec
from repro_torch.telemetry.probes import (Snapshot, _group_ratios,
                                          committed_sums, group_labels,
                                          leaf_sums, mesh_sums,
                                          optimizer_health, update_norm_of)

_TINY = 1e-30
_F32 = torch.float32
_I32 = torch.int32

#: Metrics keys that snapshot the post-step device state exactly.  Every
#: value is a 0-d f32 whose payload survives the device→host→checkpoint
#: →device round trip bitwise (int32 and f32 are exact in binary64).
SNAPSHOT_KEYS = ("seen", "clean", "ema", "backoff", "skipped")


class SentinelState(NamedTuple):
    """Cross-step sentinel memory — five 0-d device tensors.

    seen     executed-step counter (counts every pass through the guard,
             including skipped and replayed steps — the injection clock);
    clean    count of clean (committed) steps — the EMA's sample count;
    ema      EMA of the update norm over clean steps (spike reference);
    backoff  remaining clean steps of an active lr-backoff window;
    skipped  lifetime count of discarded updates.
    """

    seen: torch.Tensor
    clean: torch.Tensor
    ema: torch.Tensor
    backoff: torch.Tensor
    skipped: torch.Tensor


def init_sentinel_state(device="cpu") -> SentinelState:
    z = lambda dt: torch.zeros((), dtype=dt, device=device)  # noqa: E731
    return SentinelState(seen=z(_I32), clean=z(_I32), ema=z(_F32),
                         backoff=z(_I32), skipped=z(_I32))


def state_from_snapshot(snap: dict, device="cpu") -> SentinelState:
    """Rebuild the device state from a host snapshot (the ``SNAPSHOT_KEYS``
    slice of a ``metrics["sentinel"]`` verdict, or checkpoint extra)."""
    i = lambda k: torch.full((), int(snap[k]), dtype=_I32,   # noqa: E731
                             device=device)
    return SentinelState(seen=i("seen"), clean=i("clean"),
                         ema=torch.full((), float(snap["ema"]), dtype=_F32,
                                        device=device),
                         backoff=i("backoff"), skipped=i("skipped"))


def _all_finite(*trees) -> torch.Tensor:
    """0-d device bool: every element of every float leaf is finite.  One
    ``aminmax`` a leaf (NaN propagates into both, ±inf into one; a
    reduction, no temporary of the leaf's size), then one ``isfinite`` over
    the collected extremes."""
    ext = [torch.stack(torch.aminmax(leaf)).to(_F32)
           for t in trees for leaf in float_tensors(t)]
    if not ext:
        return torch.ones((), dtype=torch.bool)
    return torch.isfinite(torch.cat(ext)).all()


def _f32_scalar(x: float) -> float:
    """``x`` rounded to fp32, as a host float (the reference computes
    its constants in f32)."""
    return float(torch.tensor(x, dtype=_F32))


def _any_rank(zero, flag) -> torch.Tensor:
    """0-d bool: ``flag`` is set on any rank (the same on every rank)."""
    from repro_torch.sharding import collectives as C
    return C.all_reduce_exact(flag.to(_F32).reshape(1), zero.world)[0] > 0


def guard_step(inner, *, opt, sspec: SentinelSpec, ospec=None, inject=None,
               zero=None):
    """Wrap an in-place step ``(params, opt_state, batch, hp) -> (params',
    opt_state', loss, metrics)`` into the 5-arg guarded form ``(params,
    opt_state, batch, hp, sent) -> (params', opt_state', loss, metrics,
    sent')``.

    ``ospec`` (an enabled ObservabilitySpec) folds the optimizer-health
    probes in on the **committed** transition — probes describe what
    actually landed, so a skipped step reports zero update norms.
    ``inject`` (an :class:`~repro_torch.sentinel.inject.Injection`) poisons
    the batch/update keyed on ``sent.seen``.  The wrapper's ``.snapshot``
    is the :class:`~repro_torch.telemetry.probes.Snapshot` whose buffers
    hold the pre-step values.  ``zero``: the step is ZeRO-3 sharded (module
    docstring).
    """
    snapshot = Snapshot()
    decay = _f32_scalar(sspec.ema_decay)
    one_m_decay = float(1.0 - torch.tensor(decay, dtype=_F32))
    spike_factor = _f32_scalar(sspec.spike_factor)
    trust_max = _f32_scalar(sspec.trust_max)
    use_trust = sspec.trust_max > 0.0 and opt is not None
    use_backoff = "backoff" in sspec.ladder

    def guarded(params, opt_state, batch, hp, sent):
        dev = sent.seen.device
        # --- backoff: transient lr scale-down, call-time data -------------
        if use_backoff:
            lr_scale = torch.where(
                sent.backoff > 0,
                torch.full((), sspec.backoff_scale, dtype=_F32, device=dev),
                torch.ones((), dtype=_F32, device=dev))
        else:
            lr_scale = torch.ones((), dtype=_F32, device=dev)
        hp_eff = dict(hp)
        hp_eff["lr"] = hp["lr"] * lr_scale

        p_old, s_old = snapshot.capture(params, opt_state)
        if inject is not None:
            batch = inject.poison_batch(batch, sent.seen)
        p2, s2, loss, metrics = inner(params, opt_state, batch, hp_eff)
        if inject is not None:
            loss = inject.poison_update(p_old, p2, s2, loss, sent.seen)

        # --- detection (0-d verdict tensors) -------------------------------
        nonfinite = ~(_all_finite(p2, s2.moments)
                      & torch.isfinite(loss).all())
        # one pass over (snapshot, proposed params): the update norm, the
        # trust ratios and (committed) the probes all read these sums
        sums = leaf_sums(p_old, p2, par=use_trust or ospec is not None)
        if zero is not None:
            nonfinite = _any_rank(zero, nonfinite)
            sums = mesh_sums(sums, zero)
        unorm = update_norm_of(sums)

        n = sent.clean.to(_F32)
        ema_ref = sent.ema / torch.clamp_min(
            1.0 - torch.pow(torch.full((), decay, dtype=_F32, device=dev),
                            n), _TINY)
        armed = sent.clean >= sspec.warmup
        # NaN unorm fails this comparison (NaN > x is False) — the
        # non-finite guard owns that case.
        spike = armed & (unorm > spike_factor * ema_ref)

        trust_worst = torch.zeros((), dtype=_F32, device=dev)
        trust = torch.zeros((), dtype=torch.bool, device=dev)
        if use_trust:
            ratios = _group_ratios(sums, group_labels(opt, p_old, zero),
                                   opt)
            trust_worst = torch.max(torch.stack(list(ratios.values())))
            trust = trust_worst > trust_max

        anomaly = nonfinite | spike | trust
        keep = ~anomaly

        # --- commit: skip is a true no-op on params AND OptState ----------
        for new, old in zip(float_tensors(p2) + float_tensors(s2.moments),
                            float_tensors(p_old)
                            + float_tensors(s_old.moments)):
            torch.where(keep, new, old, out=new)
        s_out = OptState(step=torch.where(keep, s2.step, s_old.step),
                         moments=s2.moments)

        sent_out = SentinelState(
            seen=sent.seen + 1,
            clean=sent.clean + keep.to(_I32),
            # the EMA absorbs only clean steps — an anomaly must not drag
            # the reference toward itself
            ema=torch.where(keep, decay * sent.ema + one_m_decay * unorm,
                            sent.ema),
            backoff=(torch.where(
                anomaly,
                torch.full((), sspec.backoff_window, dtype=_I32, device=dev),
                torch.clamp_min(sent.backoff - 1, 0))
                if use_backoff else sent.backoff),
            skipped=sent.skipped + anomaly.to(_I32))

        f32 = lambda x: x.to(_F32)                           # noqa: E731
        verdict = {
            "anomaly": f32(anomaly), "nonfinite": f32(nonfinite),
            "spike": f32(spike), "trust": f32(trust),
            "update_norm": unorm, "ema_ref": ema_ref,
            "trust_worst": trust_worst, "lr_scale": lr_scale,
            # post-step state snapshot: lets the host rebuild the device
            # state exactly (checkpoint extra → state_from_snapshot)
            "seen": f32(sent_out.seen), "clean": f32(sent_out.clean),
            "ema": sent_out.ema, "backoff": f32(sent_out.backoff),
            "skipped": f32(sent_out.skipped),
        }
        metrics = {**metrics, "sentinel": verdict}

        if ospec is not None:
            metrics["opt_health"] = optimizer_health(
                p_old, p2, s_old, s_out, hp_eff, opt=opt, ospec=ospec,
                sums=committed_sums(sums, keep), zero=zero)

        return p2, s_out, loss, metrics, sent_out

    guarded.snapshot = snapshot
    return guarded
