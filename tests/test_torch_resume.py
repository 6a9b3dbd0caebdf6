"""PyTorch port vs the JAX reference: resume and fault recovery through
``run(spec)`` — a resume crosses between the packages in both directions,
a resume within the port is bitwise, a transient device error restores the
last checkpoint and finishes bitwise equal to the uninterrupted run, with
the reference's backoff and retry bounds; the eval curve matches the
reference's."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.tree import pytree_leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.run import (CheckpointSpec, EvalSpec, FaultSpec, ModelSpec,
                             OptSpec, RunSpec, StepSpec, build_step_program,
                             run)
from repro_torch.telemetry.schema import read_stream
from torch_parity import (ARCH_ID, assert_trees_close, ref_params_and_copy,
                          smoke_archs)

QUIET = dict(log_fn=lambda s: None, device="cpu")


def _spec(total=4, **kw):
    base = dict(
        model=ModelSpec(arch=ARCH_ID, smoke=True),
        data=DataConfig(vocab=0, seq_len=32, global_batch=4, seed=3),
        # constant: a run cut short follows the same schedule as the whole
        opt=OptSpec(name="adalomo", lr=1e-3, schedule="constant"),
        steps=StepSpec(total=total), seed=3, log_every=0)
    base.update(kw)
    return RunSpec(**base)


def _ckpt(d, every=2, resume=False):
    return CheckpointSpec(dir=str(d), every=every, resume=resume)


def _ref(spec):
    return ref_spec_mod.RunSpec.from_json(spec.to_json())


def _port_params():
    _, arch = smoke_archs()
    return arch.init_params(7, device="cpu")


def _assert_bitwise(a, b):
    la, lb = pytree_leaves(a), pytree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------ across the two packages

def test_resume_crosses_between_the_packages(tmp_path):
    """A reference run's checkpoint resumes in the port, and a port run's
    in the reference; either tail tracks the reference's uninterrupted run
    within the run-parity bounds (loss 1e-4, fused-step params)."""
    ref_arch, _ = smoke_archs()
    clean = ref_run(_ref(_spec(total=6)),
                    params=ref_params_and_copy(ref_arch)[0],
                    log_fn=lambda s: None)

    # reference → port
    ref_run(_ref(_spec(checkpoint=_ckpt(tmp_path / "r"))),
            params=ref_params_and_copy(ref_arch)[0], log_fn=lambda s: None)
    port = run(_spec(total=6, checkpoint=_ckpt(tmp_path / "r", resume=True)),
               params=_port_params(), **QUIET)
    assert port.start_step == 4 and port.history["step"] == [4, 5]
    np.testing.assert_allclose(port.history["loss"], clean.history["loss"][4:],
                               atol=1e-4, rtol=0)
    assert int(port.opt_state.step) == int(clean.opt_state.step) == 6
    assert_trees_close(port.params, clean.params, rtol=1e-4, atol=1e-5)

    # port → reference
    run(_spec(checkpoint=_ckpt(tmp_path / "p")),
        params=ref_params_and_copy(ref_arch)[1], **QUIET)
    back = ref_run(_ref(_spec(total=6,
                              checkpoint=_ckpt(tmp_path / "p", resume=True))),
                   params=ref_params_and_copy(ref_arch, seed=9)[0],
                   log_fn=lambda s: None)
    assert back.start_step == 4 and back.history["step"] == [4, 5]
    np.testing.assert_allclose(back.history["loss"], clean.history["loss"][4:],
                               atol=1e-4, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(back.params),
                    jax.tree_util.tree_leaves(clean.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_eval_losses_match_reference():
    """The default held-out stream and the eval loss, in both packages from
    the same weights: eval steps equal, losses within 1e-4."""
    ref_arch, _ = smoke_archs()
    ref_params, params = ref_params_and_copy(ref_arch)
    spec = _spec(total=4, eval=EvalSpec(every=2, n_batches=2))
    rres = ref_run(_ref(spec), params=ref_params, log_fn=lambda s: None)
    pres = run(spec, params=params, **QUIET)
    assert pres.history["eval_step"] == rres.history["eval_step"] == [1, 3]
    np.testing.assert_allclose(pres.history["eval_loss"],
                               rres.history["eval_loss"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(pres.history["loss"], rres.history["loss"],
                               atol=1e-4, rtol=0)


# ------------------------------------------------ within the port

def test_resume_within_the_port_is_bitwise(tmp_path):
    """Stop at step 4, resume to 6: the same params, OptState, losses and
    eval curve as 6 uninterrupted steps, bit for bit; one metrics file
    holds each step once; the caller's params are the run's."""
    ev = EvalSpec(every=2, n_batches=2)
    clean = run(_spec(total=6, eval=ev), params=_port_params(), **QUIET)
    metrics = str(tmp_path / "m.jsonl")
    run(_spec(total=4, eval=ev, checkpoint=_ckpt(tmp_path / "c", every=4),
              metrics_path=metrics), params=_port_params(), **QUIET)
    params = _port_params()
    res = run(_spec(total=6, eval=ev, metrics_path=metrics,
                    checkpoint=_ckpt(tmp_path / "c", every=4, resume=True)),
              params=params, **QUIET)
    assert res.start_step == 4 and res.params is params
    assert res.history["step"] == [4, 5]
    assert res.history["loss"] == clean.history["loss"][4:]
    assert res.history["eval_step"] == [5]
    assert res.history["eval_loss"] == clean.history["eval_loss"][2:]
    _assert_bitwise((res.params, res.opt_state),
                    (clean.params, clean.opt_state))
    s = read_stream(metrics)
    assert [r["step"] for r in s.steps()] == list(range(6))
    assert [r["loss"] for r in s.steps()] == clean.history["loss"]


# ------------------------------------------------ transient failures

def _flaky_program(spec, fail_on_calls, exc=None):
    """A StepProgram whose step raises a transient device error on each
    call number in ``fail_on_calls`` — after the real in-place update
    already ran, like a real late failure."""
    prog = build_step_program(spec, device="cpu")
    real = prog.step
    calls = {"n": 0}

    def step(params, opt_state, batch, hp):
        out = real(params, opt_state, batch, hp)
        calls["n"] += 1
        if calls["n"] in fail_on_calls:
            raise (exc or torch.AcceleratorError("injected"))
        return out

    prog.step = step
    return prog


def test_transient_failure_recovers_bitwise(tmp_path):
    """Call 6 = step 5 fails, two steps past the step-3 checkpoint: the run
    restores step 3 into its live tensors, replays 3 and 4, and finishes
    with the uninterrupted run's state, history and eval curve."""
    ev = EvalSpec(every=2, n_batches=1)
    spec = _spec(total=7, eval=ev, checkpoint=_ckpt(tmp_path / "c", every=3),
                 metrics_path=str(tmp_path / "m.jsonl"))
    logs, params = [], _port_params()
    res = run(spec, program=_flaky_program(spec, {6}), params=params,
              device="cpu", log_fn=logs.append)
    assert any("restored step 3" in m for m in logs)
    assert res.params is params and int(res.opt_state.step) == 7
    clean = run(_spec(total=7, eval=ev), params=_port_params(), **QUIET)
    _assert_bitwise((res.params, res.opt_state),
                    (clean.params, clean.opt_state))
    assert res.history["step"] == clean.history["step"] == list(range(7))
    assert res.history["loss"] == clean.history["loss"]
    assert res.history["eval_step"] == clean.history["eval_step"]
    assert res.history["eval_loss"] == clean.history["eval_loss"]
    s = read_stream(spec.metrics_path)
    assert [r["step"] for r in s.steps()] == list(range(7))
    assert [(r["step"], r["failed_step"]) for r in s.events("recover")] == \
        [(3, 5)]


@pytest.fixture
def sleeps(monkeypatch):
    """Capture every runner backoff sleep instead of actually waiting."""
    import repro_torch.run.runner as runner_mod
    rec = []
    monkeypatch.setattr(runner_mod.time, "sleep", rec.append)
    return rec


def _retry_spec(tmp_path, fault):
    return _spec(total=7, checkpoint=_ckpt(tmp_path / "ck"),
                 metrics_path=str(tmp_path / "m.jsonl"), fault=fault)


def _recovers(path):
    return [r for r in (json.loads(line) for line in open(path))
            if r.get("event") == "recover"]


def test_backoff_doubles_and_caps(tmp_path, sleeps):
    """Call 4 = step 3 and call 5 = the replayed step 2 fail: attempt 1
    waits the base, attempt 2 doubles into the cap."""
    spec = _retry_spec(tmp_path, FaultSpec(retries=3, retry_backoff_s=0.05,
                                           retry_backoff_max_s=0.08))
    res = run(spec, program=_flaky_program(spec, {4, 5}), **QUIET)
    assert sleeps == [0.05, 0.08]
    assert res.history["step"] == list(range(7))
    rec = _recovers(spec.metrics_path)
    assert [(r["attempt"], r["failed_step"], r["step"]) for r in rec] == \
        [(1, 3, 2), (2, 2, 2)]
    assert [r["backoff_s"] for r in rec] == [0.05, 0.08]


def test_default_backoff_never_sleeps(tmp_path, sleeps):
    spec = _retry_spec(tmp_path, FaultSpec())
    run(spec, program=_flaky_program(spec, {4}), **QUIET)
    assert sleeps == []
    assert [(r["attempt"], r["backoff_s"])
            for r in _recovers(spec.metrics_path)] == [(1, 0.0)]


def test_retries_are_bounded(tmp_path, sleeps):
    spec = _retry_spec(tmp_path, FaultSpec(retries=2, retry_backoff_s=0.01))
    with pytest.raises(torch.AcceleratorError, match="injected"):
        run(spec, program=_flaky_program(spec, {4, 5, 6}), **QUIET)
    assert sleeps == [0.01, 0.02]   # the exhausted attempt never waits


@pytest.mark.parametrize("exc", [
    RuntimeError("a programming error"),
    torch.cuda.OutOfMemoryError("out of memory")])
def test_non_transient_errors_are_not_retried(tmp_path, sleeps, exc):
    spec = _retry_spec(tmp_path, FaultSpec(retries=3))
    with pytest.raises(type(exc)):
        run(spec, program=_flaky_program(spec, {4}, exc), **QUIET)
    assert _recovers(spec.metrics_path) == []


def test_transient_failure_without_checkpoint_raises():
    spec = _spec(total=3)
    prog = build_step_program(spec, device="cpu")

    def step(params, opt_state, batch, hp):
        raise torch.AcceleratorError("no checkpoint to recover from")

    prog.step = step
    with pytest.raises(torch.AcceleratorError):
        run(spec, program=prog, **QUIET)


def test_injected_iterator_is_not_rewound(tmp_path):
    """A caller's batch iterator cannot be rewound, so the error propagates
    even with a checkpoint to restore."""
    spec = _retry_spec(tmp_path, FaultSpec(retries=3))
    from repro_torch.run.data import make_batch_iter
    _, arch = smoke_archs()
    with pytest.raises(torch.AcceleratorError):
        run(spec, program=_flaky_program(spec, {4}),
            batch_iter=make_batch_iter(spec, arch), **QUIET)
    assert CheckpointManager(tmp_path / "ck").latest_step() == 2
