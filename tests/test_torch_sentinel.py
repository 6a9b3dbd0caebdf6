"""PyTorch port vs the JAX reference: the training sentinel
(``repro_torch.sentinel``) — a skipped step is a bitwise no-op on params and
the whole OptState in the fused and unfused engines, the injectors, the
spike guard and backoff, the trust guard, the host policy (budget, streak,
rollback, quarantine), injected runs that are bitwise reproducible across
re-runs and chaos kills, and the same verdicts and anomaly records as the
reference for the same spec, weights and injection."""

import numpy as np
import pytest
import torch

from repro.run import hooks as ref_hooks
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro.sentinel import AnomalyBudgetExceeded as RefBudgetExceeded
from repro.sentinel import Injection as RefInjection
from repro_torch.core.tree import pytree_leaves, pytree_unflatten
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import get_arch
from repro_torch.run import (CheckpointSpec, Hook, ModelSpec,
                             ObservabilitySpec, OptSpec, RunSpec,
                             SentinelSpec, StepSpec, build_step_program, run)
from repro_torch.run.data import make_batch_iter
from repro_torch.run.runner import batch_to_device, to_host
from repro_torch.sentinel import (INJECT_KINDS, QUARANTINE_SEED_OFFSET,
                                  AnomalyBudgetExceeded, Injection,
                                  SentinelMonitor, quarantined_batch_iter,
                                  state_from_snapshot)
from repro_torch.telemetry.schema import read_stream
from repro_torch.train.fault import RETRIABLE
from torch_parity import ARCH_ID, ref_params_and_copy, smoke_archs

CPU = torch.device("cpu")
QUIET = dict(log_fn=lambda s: None, device="cpu")
TOTAL = 8
K = 3          # fault step, on the executed-step (seen) clock


def _spec(total=TOTAL, sentinel=None, opt="adalomo", microbatches=1, **kw):
    base = dict(
        model=ModelSpec(arch=ARCH_ID, smoke=True),
        data=DataConfig(vocab=0, seq_len=32, global_batch=4),
        opt=OptSpec(name=opt, lr=1e-3, schedule="constant"),
        steps=StepSpec(total=total, microbatches=microbatches),
        sentinel=sentinel or SentinelSpec(enabled=True),
        log_every=0)
    base.update(kw)
    return RunSpec(**base)


def _clone(tree):
    return pytree_unflatten(tree, [t.clone() for t in pytree_leaves(tree)])


def _bitwise(a, b) -> bool:
    la, lb = pytree_leaves(a), pytree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _drive(program, spec, n):
    """n guarded steps; returns [(params, opt_state, loss, verdict, sent)]
    with copies of the in-place trees and host verdicts."""
    params, opt_state = program.init(spec.seed)
    sent = program.init_sentinel()
    it = make_batch_iter(spec, program.arch)
    out = []
    for step in range(n):
        hp = program.hparams_fn(step + 1)
        params, opt_state, loss, metrics, sent = program.step(
            params, opt_state, batch_to_device(next(it), CPU), hp, sent)
        loss_h, metrics_h = to_host(loss, metrics)
        out.append((_clone(params), _clone(opt_state), loss_h,
                    metrics_h["sentinel"], sent))
    return out


# ------------------------------------------------------------ the guard

@pytest.mark.parametrize("opt,mb", [("adalomo", 1), ("adalomo", 2),
                                    ("adamw", 1), ("sgd_momentum", 1)])
def test_skip_is_bitwise_noop_on_params_and_optstate(opt, mb):
    """A NaN'd update is discarded: params, every moment (AdaLomo's r/c,
    AdamW's m/v, momentum's m) AND the step counter are bitwise what they
    were before the poisoned step — fused, fused over microbatches, and
    unfused."""
    spec = _spec(opt=opt, microbatches=mb)
    program = build_step_program(
        spec, device="cpu", inject=Injection(kind="nan_grads", at_step=1))
    assert program.fused == (opt == "adalomo")
    (p0, s0, _, v0, _), (p1, s1, _, v1, sent1) = _drive(program, spec, 2)
    assert v0["anomaly"] == 0.0
    assert v1["anomaly"] == 1.0 and v1["nonfinite"] == 1.0
    assert _bitwise((p0, s0), (p1, s1))
    assert int(s1.step) == mb             # the skipped step never counted
    assert int(sent1.seen) == 2 and int(sent1.clean) == 1
    assert int(sent1.skipped) == 1


@pytest.mark.parametrize("kind", ["nan_loss", "inf_grads", "nan_grads"])
def test_nonfinite_injections_trip_the_guard(kind):
    spec = _spec()
    program = build_step_program(spec, device="cpu",
                                 inject=Injection(kind=kind, at_step=0))
    (_, s, loss, v, sent), = _drive(program, spec, 1)
    assert v["nonfinite"] == 1.0 and v["anomaly"] == 1.0, kind
    assert int(sent.skipped) == 1 and int(s.step) == 0, kind
    assert all(bool(torch.isfinite(t).all()) for t in pytree_leaves(s))


def test_nan_batch_injector_poisons_float_leaves_only():
    """A token batch has no float leaf, so ``nan_batch`` leaves it (and the
    step) alone; on a float leaf it fires only at its step."""
    inj = Injection(kind="nan_batch", at_step=2)
    batch = {"x": torch.ones(3), "tok": torch.ones(3, dtype=torch.int32)}
    hit = inj.poison_batch(batch, torch.tensor(2, dtype=torch.int32))
    assert torch.isnan(hit["x"]).all() and torch.equal(hit["tok"],
                                                       batch["tok"])
    miss = inj.poison_batch(batch, torch.tensor(1, dtype=torch.int32))
    assert torch.equal(miss["x"], batch["x"])
    spec = _spec()
    program = build_step_program(spec, device="cpu",
                                 inject=Injection(kind="nan_batch",
                                                  at_step=0))
    (_, _, _, v, _), = _drive(program, spec, 1)
    assert v["anomaly"] == 0.0


def test_all_finite_sees_one_bad_element_anywhere():
    """One NaN, +inf or -inf anywhere makes the verdict non-finite; the
    reference's whole-tree ``isfinite`` agrees."""
    import jax.numpy as jnp
    from repro.sentinel.guard import _all_finite as ref_all_finite
    from repro_torch.sentinel import guard
    rng = np.random.default_rng(0)
    base = {"a": rng.standard_normal((5, 9)).astype(np.float32),
            "b": rng.standard_normal(11).astype(np.float32)}
    tree = {k: torch.from_numpy(v) for k, v in base.items()}
    tree["i"] = torch.arange(4)                  # integer leaves are skipped
    assert bool(guard._all_finite(tree))
    for bad in (float("nan"), float("inf"), -float("inf")):
        for leaf, idx in (("a", (4, 8)), ("a", (0, 0)), ("b", 10)):
            t = {k: v.clone() for k, v in tree.items()}
            t[leaf][idx] = bad
            want = ref_all_finite({k: jnp.asarray(v.numpy()) for k, v in
                                   t.items() if k != "i"})
            assert bool(guard._all_finite(t)) is bool(want) is False


def test_spike_guard_arms_after_warmup_and_backoff_scales_lr():
    sspec = SentinelSpec(enabled=True, ladder=("skip", "backoff"),
                         warmup=2, ema_decay=0.5, spike_factor=4.0,
                         backoff_scale=0.25, backoff_window=2)
    spec = _spec(sentinel=sspec)
    program = build_step_program(
        spec, device="cpu",
        inject=Injection(kind="spike", at_step=3, scale=1000.0))
    traj = _drive(program, spec, 6)
    verdicts = [v for _, _, _, v, _ in traj]
    assert [v["anomaly"] for v in verdicts] == [0, 0, 0, 1, 0, 0]
    assert verdicts[3]["spike"] == 1.0 and verdicts[3]["nonfinite"] == 0.0
    # the two steps after the anomaly run at the scaled lr, then the window
    # closes
    assert [v["lr_scale"] for v in verdicts] == [1, 1, 1, 1, 0.25, 0.25]
    assert int(traj[-1][4].backoff) == 0
    # the EMA absorbed only clean steps, and the spiked step is a no-op
    assert float(traj[3][4].ema) == float(traj[2][4].ema)
    assert _bitwise(traj[2][:2], traj[3][:2])


def test_trust_guard_blocks_every_update_when_bound_is_tiny():
    spec = _spec(sentinel=SentinelSpec(enabled=True, trust_max=1e-12))
    program = build_step_program(spec, device="cpu")
    traj = _drive(program, spec, 2)
    for _, _, _, v, _ in traj:
        assert v["trust"] == 1.0 and v["anomaly"] == 1.0
        assert v["trust_worst"] > 1e-12
    sent = traj[-1][4]
    assert int(sent.clean) == 0 and int(sent.skipped) == 2


def test_guard_with_probes_reports_the_committed_transition():
    """With ``observe`` on, the probes see what landed: a skipped step's
    group ratios are 0."""
    spec = _spec(observe=ObservabilitySpec(optimizer_every=1))
    program = build_step_program(spec, device="cpu",
                                 inject=Injection("nan_loss", at_step=1))
    params, opt_state = program.init(0)
    sent = program.init_sentinel()
    it = make_batch_iter(spec, program.arch)
    ratios = []
    for step in range(3):
        params, opt_state, loss, metrics, sent = program.step(
            params, opt_state, batch_to_device(next(it), CPU),
            program.hparams_fn(step + 1), sent)
        ratios.append(to_host(loss, metrics)[1]["opt_health"]["group_ratio"])
    assert [r["default"] > 0 for r in ratios] == [True, False, True]
    assert ratios[1] == {"default": 0.0, "no_decay": 0.0}


def test_injection_is_validated_and_needs_the_sentinel():
    with pytest.raises(ValueError, match="kind"):
        Injection(kind="bogus")
    with pytest.raises(ValueError, match="at_step"):
        Injection(at_step=-1)
    assert INJECT_KINDS == ("nan_grads", "inf_grads", "nan_loss",
                            "nan_batch", "spike")
    spec = _spec(sentinel=SentinelSpec(enabled=False))
    with pytest.raises(ValueError, match="sentinel"):
        build_step_program(spec, device="cpu",
                           inject=Injection(kind="nan_grads"))
    with pytest.raises(ValueError, match="inject requires"):
        run(_spec(), program=build_step_program(_spec(), device="cpu"),
            inject=Injection(), **QUIET)


# ------------------------------------------------------------ the policy

def _verdict(anomaly=0.0, nonfinite=0.0, spike=0.0, trust=0.0, seen=1,
             clean=1, ema=0.5, backoff=0, skipped=0):
    return {"anomaly": anomaly, "nonfinite": nonfinite, "spike": spike,
            "trust": trust, "seen": float(seen), "clean": float(clean),
            "ema": ema, "backoff": float(backoff),
            "skipped": float(skipped)}


def test_monitor_budget_streak_escalation_and_classify():
    m = SentinelMonitor(SentinelSpec(enabled=True,
                                     ladder=("skip", "rollback"),
                                     rollback_after=2, budget=3))
    assert not m.observe(0, _verdict())
    assert m.observe(1, _verdict(anomaly=1.0, nonfinite=1.0))
    assert m.streak == 1 and not m.wants_rollback()
    assert m.observe(2, _verdict(anomaly=1.0, spike=1.0))
    assert m.wants_rollback()
    m.quarantine(1, 3)
    assert m.streak == 0 and m.rollbacks == 1
    assert m.is_quarantined(1) and m.is_quarantined(2)
    assert not m.is_quarantined(3)
    assert not m.exhausted()
    m.observe(3, _verdict(anomaly=1.0, trust=1.0))
    m.observe(4, _verdict(anomaly=1.0, trust=1.0))
    assert m.anomalies == 4 and m.exhausted()
    assert SentinelMonitor.classify(
        _verdict(anomaly=1, nonfinite=1, spike=1)) == "nonfinite"
    assert SentinelMonitor.classify(
        _verdict(anomaly=1, spike=1, trust=1)) == "spike"
    assert SentinelMonitor.classify(_verdict(anomaly=1, trust=1)) == "trust"
    assert SentinelMonitor.classify(_verdict(anomaly=1)) == "unknown"
    # exhausting the budget aborts: never one of the retried errors
    assert not issubclass(AnomalyBudgetExceeded, RETRIABLE)
    assert issubclass(AnomalyBudgetExceeded, RuntimeError)


def test_extra_round_trip_rebuilds_device_state():
    m = SentinelMonitor(SentinelSpec(enabled=True))
    m.observe(5, _verdict(anomaly=1.0, nonfinite=1.0, seen=6, clean=4,
                          ema=0.25, backoff=2, skipped=2))
    m.quarantine(4, 6)
    extra = m.to_extra()
    m2 = SentinelMonitor(SentinelSpec(enabled=True))
    m2.load_extra(extra)
    assert m2.to_extra() == extra and m2.is_quarantined(5)
    sent = state_from_snapshot(extra["state"])
    assert [t.dtype for t in sent] == [torch.int32, torch.int32,
                                       torch.float32, torch.int32,
                                       torch.int32]
    assert int(sent.seen) == 6 and int(sent.clean) == 4
    assert float(sent.ema) == 0.25
    assert int(sent.backoff) == 2 and int(sent.skipped) == 2


@pytest.mark.parametrize("start", [0, 3])
def test_quarantined_iter_substitutes_only_the_range(start):
    """Outside a quarantined range the stream is bitwise the primary
    stream; inside, bitwise the QUARANTINE_SEED_OFFSET stream — from a
    rewound start too."""
    spec = _spec()
    arch = get_arch(ARCH_ID, smoke=True)
    m = SentinelMonitor(SentinelSpec(enabled=True))
    m.quarantine(3, 4)
    q = quarantined_batch_iter(spec, arch, start, m)
    primary = make_batch_iter(spec, arch, start)
    alt = next(make_batch_iter(spec, arch, 3,
                               seed_offset=QUARANTINE_SEED_OFFSET))
    for step in range(start, 6):
        got, ref = next(q), next(primary)
        want = alt if step == 3 else ref
        assert all(np.array_equal(got[k], want[k]) for k in want)
        if step == 3:
            assert not all(np.array_equal(got[k], ref[k]) for k in ref)


# ------------------------------------------------------------ injected runs

def test_injected_nan_run_completes_skips_and_stays_close(tmp_path):
    mp = str(tmp_path / "m.jsonl")
    clean = run(_spec(), **QUIET)
    res = run(_spec(metrics_path=mp),
              inject=Injection(kind="nan_grads", at_step=K), **QUIET)
    assert res.history["step"] == list(range(TOTAL))
    assert int(res.opt_state.step) == TOTAL - 1
    assert int(clean.opt_state.step) == TOTAL
    # the skip kept the pre-fault params bitwise: the forward passes agree
    # through the fault step, then stay close
    assert res.history["loss"][:K + 1] == clean.history["loss"][:K + 1]
    assert np.isfinite(res.history["loss"]).all()
    np.testing.assert_allclose(res.history["loss"][K + 1:],
                               clean.history["loss"][K + 1:], rtol=0.1)
    s = read_stream(mp)
    anoms = s.anomalies()
    assert [(a["anomaly"], a["step"], a["action"], a["count"])
            for a in anoms] == [("nonfinite", K, "skip", 1)]
    assert s.anomalies("nonfinite") == anoms
    assert [r["step"] for r in s.steps()] == list(range(TOTAL))


def test_injected_run_is_bitwise_reproducible(tmp_path):
    def go(i):
        mp = str(tmp_path / f"m{i}.jsonl")
        r = run(_spec(metrics_path=mp),
                inject=Injection(kind="nan_grads", at_step=K), **QUIET)
        return r, read_stream(mp)

    (r1, s1), (r2, s2) = go(1), go(2)
    assert r1.history["loss"] == r2.history["loss"]
    assert _bitwise((r1.params, r1.opt_state), (r2.params, r2.opt_state))
    key = lambda a: (a["anomaly"], a["step"], a["action"], a["count"])  # noqa
    assert [key(a) for a in s1.anomalies()] == \
        [key(a) for a in s2.anomalies()]


def test_injected_chaos_kill_resumes_bitwise(tmp_path):
    """Kill the injected run after the fault and resume from checkpoint:
    the sentinel's state rides the checkpoint extra, so the seen-clock
    keeps the fault from re-firing and the final state is bitwise the
    uninterrupted injected run's."""
    from repro_torch.fleet import chaos_run
    inj = Injection(kind="nan_grads", at_step=K)

    def mk(d):
        return _spec(checkpoint=CheckpointSpec(dir=str(d), every=2))

    rep = chaos_run(mk(tmp_path / "a"), kill_at=[5], inject=inj,
                    device="cpu")
    straight = run(mk(tmp_path / "b"), inject=inj, **QUIET)
    assert rep.kills == [(5, 4)]
    assert _bitwise((rep.result.params, rep.result.opt_state),
                    (straight.params, straight.opt_state))
    assert int(rep.result.opt_state.step) == TOTAL - 1


def test_rollback_restores_quarantines_and_completes(tmp_path):
    mp = str(tmp_path / "m.jsonl")
    sspec = SentinelSpec(enabled=True, ladder=("skip", "rollback"),
                         rollback_after=1, budget=8)
    spec = _spec(sentinel=sspec, metrics_path=mp,
                 checkpoint=CheckpointSpec(dir=str(tmp_path / "ck"),
                                           every=2))
    logs, params = [], get_arch(ARCH_ID, smoke=True).init_params(0,
                                                                 device="cpu")
    res = run(spec, params=params,
              inject=Injection(kind="nan_grads", at_step=4),
              device="cpu", log_fn=logs.append)
    assert any("rolled back to step 4" in m for m in logs)
    assert res.params is params                    # restored in place
    assert res.history["step"] == list(range(TOTAL))
    assert np.isfinite(res.history["loss"]).all()
    a, = read_stream(mp).anomalies()
    assert a["anomaly"] == "nonfinite" and a["action"] == "rollback"
    assert a["step"] == 4 and a["anomaly_step"] == 4
    assert a["quarantine"] == [4, 5]


def test_budget_exhaustion_fails_loudly_and_is_recorded(tmp_path):
    """A tiny trust bound flags every step: budget 1 allows one anomaly, the
    second aborts — NOT through restore cycles — with its record first."""
    mp = str(tmp_path / "m.jsonl")
    spec = _spec(sentinel=SentinelSpec(enabled=True, trust_max=1e-12,
                                       budget=1), metrics_path=mp)
    with pytest.raises(AnomalyBudgetExceeded, match="budget"):
        run(spec, **QUIET)
    anoms = read_stream(mp).anomalies()
    assert [(a["action"], a["count"]) for a in anoms] == [("skip", 1),
                                                          ("abort", 2)]


# ------------------------------------------------------------ vs the reference

def _verdict_hook(base):
    class Verdicts(base):
        def __init__(self):
            self.v = []

        def on_step_end(self, ctx, ev):
            self.v.append({k: float(ev.metrics["sentinel"][k]) for k in (
                "anomaly", "nonfinite", "spike", "trust", "lr_scale",
                "seen", "clean", "backoff", "skipped")})
    return Verdicts()


CASES = {
    "nan_grads-skip": dict(inject=("nan_grads", 3, 100.0)),
    "spike-backoff": dict(
        inject=("spike", 4, 1000.0),
        sentinel=dict(ladder=("skip", "backoff"), warmup=2, ema_decay=0.5,
                      spike_factor=4.0, backoff_window=2)),
    "nan_loss-rollback": dict(
        inject=("nan_loss", 4, 100.0), ckpt=True,
        sentinel=dict(ladder=("skip", "rollback"), rollback_after=1)),
    "adamw-unfused": dict(opt="adamw", inject=("nan_grads", 2, 100.0)),
    "sgd_momentum-unfused": dict(opt="sgd_momentum",
                                 inject=("inf_grads", 1, 100.0)),
    "trust-abort": dict(sentinel=dict(trust_max=1e-12, budget=2),
                        raises=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_verdicts_and_records_match_reference(tmp_path, case):
    """The same spec, weights and injection in both packages: the same
    per-step verdict flags, lr scales and sentinel counters, the same
    ``(anomaly, step, action, count)`` records, losses within 1e-4."""
    c = CASES[case]
    sspec = SentinelSpec(enabled=True, **c.get("sentinel", {}))
    out = {}
    ref_arch, _ = smoke_archs()
    ref_params, port_params = ref_params_and_copy(ref_arch)
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        spec = _spec(total=7, sentinel=sspec, opt=c.get("opt", "adalomo"),
                     metrics_path=str(d / "m.jsonl"),
                     checkpoint=(CheckpointSpec(dir=str(d / "ck"), every=2)
                                 if c.get("ckpt") else CheckpointSpec()))
        hook = _verdict_hook(ref_hooks.Hook if pkg == "ref" else Hook)
        inj = c.get("inject")
        if pkg == "ref":
            go = lambda: ref_run(                          # noqa: E731
                ref_spec_mod.RunSpec.from_json(spec.to_json()),
                params=ref_params, hooks=[hook], log_fn=lambda s: None,
                inject=RefInjection(*inj) if inj else None)
            exc = RefBudgetExceeded
        else:
            go = lambda: run(spec, params=port_params,     # noqa: E731
                             hooks=[hook],
                             inject=Injection(*inj) if inj else None,
                             **QUIET)
            exc = AnomalyBudgetExceeded
        res = None
        if c.get("raises"):
            with pytest.raises(exc):
                go()
        else:
            res = go()
        out[pkg] = (hook.v, read_stream(spec.metrics_path), res)
    (rv, rs, rres), (pv, ps, pres) = out["ref"], out["port"]
    assert pv == rv
    key = lambda a: (a["anomaly"], a["step"], a["action"],  # noqa: E731
                     a["count"], a.get("quarantine"))
    assert [key(a) for a in ps.anomalies()] == \
        [key(a) for a in rs.anomalies()]
    assert ps.anomalies()                     # the case did trip the guard
    if rres is not None:
        np.testing.assert_allclose(pres.history["loss"],
                                   rres.history["loss"], atol=1e-4, rtol=0)
        assert pres.history["step"] == rres.history["step"]
        assert int(pres.opt_state.step) == int(rres.opt_state.step)
