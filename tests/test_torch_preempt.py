"""PyTorch port: preemption safety — SIGTERM/SIGINT → boundary checkpoint →
resumable marker → ``Preempted`` → bitwise resume, as
``tests/fleet/test_preempt.py`` holds the JAX package to; the CLI's exit code
75 in a real process; the marker format the reference reads."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.fleet import preempt as ref_preempt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.tree import pytree_leaves
from repro_torch.data.pipeline import DataConfig
from repro_torch.fleet import PREEMPTED_EXIT_CODE, Preempted, PreemptionHook
from repro_torch.run import (CheckpointSpec, FaultSpec, Hook, ModelSpec,
                             OptSpec, RunSpec, StepSpec, run)
from torch_parity import ARCH_ID, smoke_archs

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")
QUIET = dict(log_fn=lambda s: None, device="cpu")


def fleet_spec(ckpt_dir=None, *, total=6, every=3, metrics_path=None, **kw):
    base = dict(
        model=ModelSpec(arch=ARCH_ID, smoke=True),
        data=DataConfig(vocab=0, seq_len=32, global_batch=8),
        opt=OptSpec(name="adalomo", lr=1e-3, schedule="constant"),
        steps=StepSpec(total=total),
        metrics_path=metrics_path,
        log_every=0)
    if ckpt_dir is not None:
        base["checkpoint"] = CheckpointSpec(dir=str(ckpt_dir), every=every,
                                            resume=True)
    base.update(kw)
    return RunSpec(**base)


def _params():
    return smoke_archs()[1].init_params(0, device="cpu")


class SendSignal(Hook):
    """Raise a real signal against our own pid at a step boundary."""

    def __init__(self, at_step, signum=signal.SIGTERM):
        self.at_step, self.signum = at_step, signum

    def on_step_end(self, ctx, ev):
        if ev.step + 1 == self.at_step:
            os.kill(os.getpid(), self.signum)


def test_sigterm_checkpoints_at_boundary_and_resumes_bitwise(tmp_path):
    # every=5 > the kill step: the preemption save is OFF the schedule
    clean = run(fleet_spec(tmp_path / "clean", every=5), params=_params(),
                **QUIET)
    spec = fleet_spec(tmp_path / "p", every=5,
                      metrics_path=str(tmp_path / "m.jsonl"))
    # user hooks run after the default pipeline, so a signal at boundary k
    # is observed by PreemptionHook at boundary k+1
    with pytest.raises(Preempted) as ei:
        run(spec, hooks=[SendSignal(2)], params=_params(), **QUIET)
    assert ei.value.step == 3 and ei.value.signum == signal.SIGTERM

    mgr = CheckpointManager(tmp_path / "p")
    assert mgr.latest_step() == 3          # off-schedule boundary save
    want = {"step": 3, "resumable": True, "signum": int(signal.SIGTERM)}
    assert mgr.read_preempt_marker() == want
    assert RefManager(tmp_path / "p").read_preempt_marker() == want
    records = [json.loads(line) for line in (tmp_path / "m.jsonl").open()]
    assert {"event": "preempted", "step": 3,
            "signum": int(signal.SIGTERM)} in records

    orig = signal.getsignal(signal.SIGTERM)
    res = run(spec, params=_params(), **QUIET)
    assert res.start_step == 3
    assert mgr.read_preempt_marker() is None   # marker consumed
    assert res.history["loss"] == clean.history["loss"][3:]
    for a, b in zip(pytree_leaves((res.params, res.opt_state)),
                    pytree_leaves((clean.params, clean.opt_state))):
        assert torch.equal(a, b)
    assert signal.getsignal(signal.SIGTERM) == orig


def test_second_signal_escalates(tmp_path):
    hook = PreemptionHook(CheckpointManager(tmp_path))
    orig = signal.getsignal(signal.SIGINT)
    for sig in (signal.SIGTERM, signal.SIGINT):
        hook._originals[sig] = signal.signal(sig, hook._handler)
    try:
        os.kill(os.getpid(), signal.SIGTERM)   # first: sets the flag
        assert hook.requested == signal.SIGTERM
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)  # second: escalates
    finally:
        hook._restore()
    assert signal.getsignal(signal.SIGINT) == orig


def test_preempt_opt_out_and_no_ckpt(tmp_path):
    res = run(fleet_spec(total=1), **QUIET)
    assert not any(isinstance(h, PreemptionHook) for h in res.hooks)
    res = run(fleet_spec(tmp_path, total=1, fault=FaultSpec(preempt=False)),
              **QUIET)
    assert not any(isinstance(h, PreemptionHook) for h in res.hooks)
    assert PREEMPTED_EXIT_CODE == ref_preempt.PREEMPTED_EXIT_CODE == 75


def test_cli_preempted_exits_75_and_resumes(tmp_path):
    """SIGTERM a real ``repro_torch.launch.train`` process mid-run: exit
    75 with a resumable marker; ``--resume`` finishes the run; a second
    ``--resume`` has nothing to do."""
    ck, metrics = tmp_path / "ck", tmp_path / "m.jsonl"

    def argv(steps, every):
        return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                ARCH_ID, "--smoke", "--steps", str(steps), "--batch", "2",
                "--seq", "16", "--device", "cpu", "--ckpt-dir", str(ck),
                "--ckpt-every", str(every), "--metrics-path", str(metrics)]

    env = dict(os.environ, PYTHONPATH=SRC)
    child = subprocess.Popen(argv(400, 1000), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and child.poll() is None:
            try:
                if len(metrics.read_text().splitlines()) >= 3:  # 2 steps
                    break
            except OSError:
                pass
            time.sleep(0.05)
        assert child.poll() is None, child.stdout.read()[-3000:]
        child.send_signal(signal.SIGTERM)
        out, _ = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == PREEMPTED_EXIT_CODE, out[-3000:]
    marker = CheckpointManager(ck).read_preempt_marker()
    assert marker["resumable"] and marker["signum"] == signal.SIGTERM
    at = marker["step"]
    assert CheckpointManager(ck).latest_step() == at < 400
    assert f"checkpointed at step {at}" in out

    for expect in ("final loss", "nothing to do: resumed at step"):
        proc = subprocess.run(argv(at + 2, 1) + ["--resume"], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert expect in proc.stdout
    assert CheckpointManager(ck).read_preempt_marker() is None
    steps = [json.loads(line).get("step") for line in metrics.open()
             if '"loss"' in line]
    assert steps == list(range(at + 2))
