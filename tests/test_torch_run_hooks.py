"""PyTorch port vs the JAX reference: the hook pipeline — event protocol,
default pipeline, liveness annotations, the metrics stream (read by both
packages' readers and summarized equally), the profiler window, and the
Trainer shim."""
import json
import time
import types

import numpy as np
import pytest
import torch

from repro.run import hooks as ref_hooks
from repro.run import runner as ref_runner
from repro.run import spec as ref_spec_mod
from repro.telemetry import report as ref_report
from repro.telemetry import schema as ref_schema
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.run import (CheckpointSpec, EvalSpec, FaultSpec,
                             HeartbeatHook, HistoryHook, Hook, MetricsHook,
                             ModelSpec, OptSpec, ProfileSpec, ProfilerHook,
                             RunSpec, StepEvent, StepSpec, StragglerHook,
                             find_metrics_hook, run)
from repro_torch.run import runner as port_runner
from repro_torch.telemetry import report
from repro_torch.telemetry.schema import iter_data_records, read_stream
from torch_parity import ARCH_ID, smoke_archs

QUIET = dict(log_fn=lambda s: None, device="cpu")


def _spec(total=3, **kw):
    base = dict(
        model=ModelSpec(arch=ARCH_ID, smoke=True),
        data=DataConfig(vocab=0, seq_len=32, global_batch=4),
        opt=OptSpec(name="adalomo", lr=1e-3, schedule="constant"),
        steps=StepSpec(total=total),
        log_every=0)
    base.update(kw)
    return RunSpec(**base)


def _ref(spec):
    """The same spec in the JAX package (specs are byte-equal JSON)."""
    return ref_spec_mod.RunSpec.from_json(spec.to_json())


class Recorder(Hook):
    def __init__(self):
        self.events = []

    def on_run_start(self, ctx):
        self.events.append(("run_start", ctx.start_step))

    def on_step_end(self, ctx, ev):
        self.events.append(("step_end", ev.step))

    def on_eval(self, ctx, step, metrics):
        self.events.append(("eval", step))

    def on_exit(self, ctx):
        self.events.append(("exit", None))


# --------------------------------------------------------- event protocol

def test_event_sequence_and_eval_broadcast():
    rec = Recorder()
    res = run(_spec(total=4, eval=EvalSpec(every=2, n_batches=1)),
              hooks=(rec,), **QUIET)
    # user hooks run after EvalHook, so a step's eval reaches them first
    assert rec.events == [("run_start", 0), ("step_end", 0), ("eval", 1),
                          ("step_end", 1), ("step_end", 2), ("eval", 3),
                          ("step_end", 3), ("exit", None)]
    assert res.history["step"] == [0, 1, 2, 3]
    assert res.history["eval_step"] == [1, 3]
    assert all(isinstance(x, float) for x in res.history["eval_loss"])
    assert res.history["lr"] == [pytest.approx(1e-3)] * 4


def test_on_exit_runs_when_a_step_or_a_hook_raises():
    rec = Recorder()

    def bad_iter():
        yield {"tokens": np.zeros((4, 32), np.int32),
               "labels": np.zeros((4, 32), np.int32)}
        raise RuntimeError("data source died")

    with pytest.raises(RuntimeError, match="data source died"):
        run(_spec(total=3, fault=FaultSpec(retries=0)),
            batch_iter=bad_iter(), hooks=(rec,), **QUIET)
    assert rec.events[-1] == ("exit", None) and ("step_end", 0) in rec.events

    rec = Recorder()

    class Bomb(Hook):
        def on_run_start(self, ctx):
            raise RuntimeError("bad hook")

    with pytest.raises(RuntimeError, match="bad hook"):
        run(_spec(total=2), hooks=(rec, Bomb()), **QUIET)
    assert rec.events == [("run_start", 0), ("exit", None)]


# --------------------------------------------------------- default pipeline

@pytest.mark.parametrize("case", ["all", "no_ckpt", "no_preempt", "user"])
def test_default_pipeline_matches_reference(tmp_path, case):
    """The same spec assembles the same hook classes in the same order in
    both packages; a user hook of a default's class replaces it."""
    spec = _spec(total=1, log_every=5, metrics_path=str(tmp_path / "m"),
                 eval=EvalSpec(every=2), profile=ProfileSpec(dir="p"),
                 fault=FaultSpec(heartbeat_timeout_s=60.0,
                                 preempt=case != "no_preempt"))
    with_ckpt = case != "no_ckpt"
    port_user = (StragglerHook(),) if case == "user" else ()
    ref_user = (ref_hooks.StragglerHook(),) if case == "user" else ()
    factory = lambda start: iter(())                       # noqa: E731
    port = port_runner._default_hooks(
        spec, eval_iter=None, eval_factory=factory,
        ckpt_manager=CheckpointManager(tmp_path / "pc") if with_ckpt
        else None, log_fn=print, user_hooks=port_user)
    from repro.checkpoint.manager import CheckpointManager as RefManager
    ref = ref_runner._default_hooks(
        _ref(spec), eval_iter=None, eval_factory=factory,
        ckpt_manager=RefManager(tmp_path / "rc") if with_ckpt else None,
        log_fn=print, user_hooks=ref_user)
    names = [type(h).__name__ for h in port]
    assert names == [type(h).__name__ for h in ref]
    assert ("PreemptionHook" in names) == (case in ("all", "user"))
    if case == "user":
        assert names[-1] == "StragglerHook" and port[-1] is port_user[0]


def test_full_pipeline_run(tmp_path):
    """The default hooks in one run: history, logging, checkpoints,
    heartbeat, straggler monitor, metrics, eval, preemption; ``params``
    updated in place."""
    spec = _spec(total=4, checkpoint=CheckpointSpec(dir=str(tmp_path / "c"),
                                                    every=2),
                 eval=EvalSpec(every=2, n_batches=1),
                 fault=FaultSpec(heartbeat_timeout_s=60.0),
                 metrics_path=str(tmp_path / "m.jsonl"), log_every=1)
    _, arch = smoke_archs()
    params = arch.init_params(0, device="cpu")
    lines = []
    res = run(spec, params=params, device="cpu", log_fn=lines.append)
    assert res.params is params
    assert res.history is res.find_hook(HistoryHook).history
    assert [type(h).__name__ for h in res.hooks] == [
        "StragglerHook", "HeartbeatHook", "HistoryHook", "LoggingHook",
        "MetricsHook", "EvalHook", "CheckpointHook", "PreemptionHook"]
    hb = res.find_hook(HeartbeatHook)
    assert hb.heartbeat is not None and not hb.heartbeat.stalled
    assert CheckpointManager(tmp_path / "c").latest_step() == 4
    assert sum("eval loss" in s for s in lines) == 2
    s = read_stream(tmp_path / "m.jsonl")
    assert [r["step"] for r in s.steps()] == [0, 1, 2, 3]


@pytest.mark.parametrize("ends", ["finished", "raised"])
def test_a_dropped_run_frees_its_params_without_the_cyclic_gc(tmp_path,
                                                              ends):
    """Once the caller drops the result (or the exception), nothing of the
    pipeline keeps the run's params alive: on the card a model is GBs."""
    import gc
    import weakref
    spec = _spec(total=2, checkpoint=CheckpointSpec(dir=str(tmp_path / "c"),
                                                    every=1),
                 eval=EvalSpec(every=1, n_batches=1),
                 fault=FaultSpec(heartbeat_timeout_s=60.0),
                 metrics_path=str(tmp_path / "m.jsonl"), log_every=1,
                 profile=ProfileSpec(dir=str(tmp_path / "p"), start=0,
                                     steps=1))

    class Fail(Hook):
        def on_step_end(self, ctx, ev):
            raise ValueError("stop")

    # torch's first profiler start in a process leaves its caller's frames
    # in a reference cycle, once: take it here, outside the run
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    prof.stop()
    _, arch = smoke_archs()
    params = arch.init_params(0, device="cpu")
    ref = weakref.ref(params["outer"]["tok_embed"])
    gc.collect()
    gc.disable()
    try:
        if ends == "finished":
            res = run(spec, params=params, **QUIET)
            del res
        else:
            with pytest.raises(ValueError):
                run(spec, params=params, hooks=(Fail(),), **QUIET)
        del params
        assert ref() is None
    finally:
        gc.enable()


# --------------------------------------------------------- liveness events

def _ctx(metrics, extra_hooks=(), start_step=0):
    return types.SimpleNamespace(
        spec=types.SimpleNamespace(data=None), start_step=start_step,
        log=lambda s: None, hooks=(metrics,) + tuple(extra_hooks))


def _ev(step, dt=0.1, loss=1.0):
    return StepEvent(step=step, loss=loss, metrics={}, hparams={"lr": 1e-3},
                     dt=dt)


def _records(path):
    return [r for r in (json.loads(line) for line in open(path)
                        if line.strip()) if "schema" not in r]


def test_find_metrics_hook_and_annotate(tmp_path):
    m = MetricsHook(tmp_path / "m.jsonl")
    assert find_metrics_hook((object(), m)) is m
    assert find_metrics_hook(()) is None
    ctx = _ctx(m)
    m.on_run_start(ctx)
    m.on_step_end(ctx, _ev(0))
    m.annotate("custom", 0, detail="x")
    m.on_step_end(ctx, _ev(1))
    m.on_exit(ctx)
    recs = _records(tmp_path / "m.jsonl")
    assert [r.get("event") for r in recs] == [None, "custom", None]
    assert recs[1] == {"event": "custom", "step": 0, "detail": "x"}


def test_straggler_step_annotates_metrics(tmp_path):
    m, s = MetricsHook(tmp_path / "m.jsonl"), StragglerHook()
    ctx = _ctx(m, (s,))
    m.on_run_start(ctx)
    for step, dt in enumerate([0.1, 0.1, 0.1, 10.0]):   # the last > 3x EMA
        m.on_step_end(ctx, _ev(step, dt))
        s.on_step_end(ctx, _ev(step, dt))
    m.on_exit(ctx)
    events = [r for r in _records(tmp_path / "m.jsonl") if "event" in r]
    assert len(events) == 1
    e = events[0]
    assert e["event"] == "straggler" and e["step"] == 3
    assert e["dt_s"] == 10.0 and e["ema_s"] > 0


def test_heartbeat_stall_annotates_metrics(tmp_path):
    m, h = MetricsHook(tmp_path / "m.jsonl"), HeartbeatHook(timeout_s=0.05)
    ctx = _ctx(m, (h,))
    m.on_run_start(ctx)
    h.on_run_start(ctx)
    m.on_step_end(ctx, _ev(0, dt=0.01))
    h.on_step_end(ctx, _ev(0, dt=0.01))
    try:
        deadline = time.time() + 5.0
        while time.time() < deadline:     # the watchdog fires off-thread
            with m._lock:
                if any("event" in r for r in m.records):
                    break
            time.sleep(0.01)
    finally:
        h.on_exit(ctx)
        m.on_exit(ctx)
    assert h.heartbeat.stalled
    events = [r for r in _records(tmp_path / "m.jsonl") if "event" in r]
    assert events and events[0] == {"event": "heartbeat_stall", "step": 0,
                                    "timeout_s": 0.05}


# --------------------------------------------------------- metrics stream

def test_metrics_rewind_and_fast_forward(tmp_path):
    """on_recover drops step records at/after the restored step but keeps
    events; a resumed process keeps the records before its start step,
    under one header; a legacy headerless file upgrades to v1."""
    p = tmp_path / "m.jsonl"
    m = MetricsHook(p)
    ctx = _ctx(m)
    m.on_run_start(ctx)
    for step in range(4):
        m.on_step_end(ctx, _ev(step, loss=float(step)))
    m.annotate("recover", 2, attempt=1)
    m.on_recover(ctx, 2)
    assert [r.get("step") for r in m.records] == [0, 1, 2]
    m.on_step_end(ctx, _ev(2, loss=20.0))
    m.on_exit(ctx)

    m2 = MetricsHook(p)
    ctx2 = _ctx(m2, start_step=2)
    m2.on_run_start(ctx2)                    # keeps records with step < 2
    m2.on_step_end(ctx2, _ev(2, loss=2.5))
    m2.on_step_end(ctx2, _ev(3, loss=3.5))
    m2.on_exit(ctx2)
    lines = [json.loads(line) for line in p.open()]
    assert sum(1 for r in lines if "schema" in r) == 1
    s = read_stream(p)
    assert [r["step"] for r in s.steps()] == [0, 1, 2, 3]
    assert [r["loss"] for r in s.steps()] == [0.0, 1.0, 2.5, 3.5]

    p.write_text('{"step": 0, "loss": 2.0}\n{"step": 1, "loss": 1.9}\n'
                 '{"step": 2, "loss": 1.8}\n')
    m3 = MetricsHook(p)
    ctx3 = _ctx(m3, start_step=2)
    m3.on_run_start(ctx3)
    m3.on_step_end(ctx3, _ev(2, loss=1.7))
    m3.on_exit(ctx3)
    s = read_stream(p)
    assert s.schema == 1 and [r["loss"] for r in s.steps()] == [2.0, 1.9, 1.7]
    assert len(list(iter_data_records(p.read_text().splitlines()))) == 3


def test_metrics_stream_is_read_and_summarized_alike(tmp_path, capsys):
    """A port run's stream validates with the reference's reader, and the
    reference's report summarizes it exactly as the port's does (text,
    JSON and Chrome trace)."""
    path = tmp_path / "m.jsonl"
    spec = _spec(total=4, metrics_path=str(path),
                 checkpoint=CheckpointSpec(dir=str(tmp_path / "c"), every=2),
                 eval=EvalSpec(every=2, n_batches=1))
    res = run(spec, **QUIET)
    with open(path, "a") as f:
        f.write(json.dumps({"event": "straggler", "step": 3, "dt_s": 1.0,
                            "ema_s": 0.1}) + "\n")
    ref = ref_schema.read_stream(path)
    mine = read_stream(path)
    assert ref.schema == mine.schema == 1
    assert ref.records == mine.records
    assert [r["loss"] for r in mine.steps()] == res.history["loss"]
    summary = report.summarize([mine])
    assert summary == ref_report.summarize([ref])
    assert summary["train"]["final_loss"] == res.history["loss"][-1]
    assert summary["train"]["events"] == {"straggler": 1}
    assert report.render_text(summary) == ref_report.render_text(summary)
    assert report.main([str(path), "--json", "--chrome-trace",
                        str(tmp_path / "t.json")]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(summary))
    from repro.telemetry.trace import chrome_trace as ref_chrome_trace
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        json.dumps(ref_chrome_trace(ref)))


# --------------------------------------------------------- profiler

def test_profiler_traces_window_and_stamps_spec(tmp_path):
    prof = tmp_path / "prof"
    spec = _spec(total=3, profile=ProfileSpec(dir=str(prof), start=1,
                                              steps=1))
    res = run(spec, **QUIET)
    hook = res.find_hook(ProfilerHook)
    kinds = [type(h).__name__ for h in res.hooks]
    assert kinds.index("ProfilerHook") < kinds.index("HistoryHook")
    assert hook.done and not hook.active
    # the sidecar is byte-equal to the one the reference writes
    ref_dir = tmp_path / "ref_prof"
    ref_hook = ref_hooks.ProfilerHook(ref_dir, start=1, steps=1)
    ref_hook.on_run_start(types.SimpleNamespace(
        spec=_ref(spec), start_step=5, log=lambda s: None))
    assert (prof / "profile.runspec.json").read_bytes() == \
        (ref_dir / "profile.runspec.json").read_bytes()
    assert RunSpec.from_dict(json.loads(
        (prof / "profile.runspec.json").read_text())) == spec
    trace = json.loads(open(hook.trace_path).read())
    assert trace["traceEvents"], "an empty trace"


def test_profiler_skips_window_already_executed(tmp_path):
    hook = ProfilerHook(tmp_path / "prof", start=1, steps=2)
    ctx = types.SimpleNamespace(spec=_spec(), start_step=3,
                                log=lambda s: None)
    hook.on_run_start(ctx)
    assert hook.done and not hook.active
    hook.on_step_end(ctx, types.SimpleNamespace(step=3))
    assert not hook.active and hook.trace_path is None


def test_profiler_stops_on_recover_and_user_instance_replaces(tmp_path):
    spec = _spec(total=2, profile=ProfileSpec(dir=str(tmp_path / "d")))
    mine = ProfilerHook(tmp_path / "mine", start=0, steps=5)
    ctx = types.SimpleNamespace(spec=spec, start_step=0, log=lambda s: None,
                                program=types.SimpleNamespace(
                                    device=torch.device("cpu")))
    mine.on_run_start(ctx)
    assert mine.active
    mine.on_recover(ctx, 0)                  # keeps what was captured
    assert mine.done and not mine.active and mine.trace_path
    mine = ProfilerHook(tmp_path / "mine", start=1, steps=1)
    res = run(spec, hooks=(mine,), **QUIET)
    assert [h for h in res.hooks if isinstance(h, ProfilerHook)] == [mine]
    assert not (tmp_path / "d").exists()
    res = run(_spec(total=1), **QUIET)
    assert res.find_hook(ProfilerHook) is None


# --------------------------------------------------------- Trainer shim

def test_history_matches_trainer_shim():
    """The Trainer shim and bare run() produce identical curves."""
    from repro_torch.train.loop import TrainConfig, Trainer
    _, arch = smoke_archs()
    res = run(_spec(total=3), params=arch.init_params(0, device="cpu"),
              **QUIET)
    tcfg = TrainConfig(optimizer="adalomo", lr=1e-3, total_steps=3,
                       schedule="constant", log_every=0)
    tr = Trainer(arch, tcfg, device="cpu", log_fn=lambda s: None)
    params, state = tr.init(0)
    dcfg = DataConfig(vocab=arch.cfg.vocab, seq_len=32, global_batch=4)
    out = tr.fit(params, state, batches(dcfg))
    assert out["history"]["loss"] == res.history["loss"]
    assert out["params"] is params
    ev = tr.evaluate(params, batches(dcfg), n_batches=2)
    assert set(ev) == {"loss", "ppl", "accuracy"}
    assert ev["ppl"] == pytest.approx(np.exp(ev["loss"]))
    assert tr.spec.to_json() == _ref(tr.spec).to_json()


def test_hooks_see_host_values_only():
    """Hooks receive Python floats: the step's one transfer, and eval's."""
    seen = []

    class Probe(Hook):
        def on_step_end(self, ctx, ev):
            seen.append((ev.loss, *ev.metrics.values(), *ev.hparams.values()))

        def on_eval(self, ctx, step, metrics):
            seen.append(tuple(metrics.values()))

    run(_spec(total=2, eval=EvalSpec(every=1, n_batches=1)),
        hooks=(Probe(),), **QUIET)
    assert len(seen) == 4
    assert all(isinstance(v, float) for row in seen for v in row)
