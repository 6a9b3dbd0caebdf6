"""PyTorch port vs the JAX reference: the run layer as a whole —
``run(spec)`` from the same converted initial weights, the spec's JSON, the
CLI, the schedules, and the port's contracts (no ``jax``/``repro`` import,
the card by default, the CPU only on request)."""
import dataclasses
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import batches as ref_batches
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro.train import schedules as ref_sched
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.run import (HistoryHook, LoggingHook, RunSpec, StepSpec,
                             TimingHook, build_step_program, run)
from repro_torch.run import spec as spec_mod
from repro_torch.train import schedules as sched
from torch_parity import (ARCH_ID, assert_trees_close, ref_params_and_copy,
                          smoke_archs)

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _specs(**steps_kw):
    kw = dict(seed=3, log_every=0)
    mk = lambda m: m.RunSpec(                               # noqa: E731
        model=m.ModelSpec(ARCH_ID, smoke=True),
        data=(DataConfig if m is spec_mod else RefDataConfig)(
            vocab=0, seq_len=32, global_batch=4, seed=3),
        opt=m.OptSpec(name="adalomo", lr=1e-3),
        steps=m.StepSpec(total=4, **steps_kw), **kw)
    return mk(ref_spec_mod), mk(spec_mod)


@pytest.mark.parametrize("steps_kw", [{}, {"microbatches": 2},
                                      {"fused": False}])
def test_run_matches_reference_run(steps_kw):
    """4 steps of ``run(spec)`` in both packages from the same weights:
    identical batches, loss history within 1e-4, final params within the
    fused-step bounds."""
    rspec, pspec = _specs(**steps_kw)
    ref_arch, _ = smoke_archs()
    ref_params, port_params = ref_params_and_copy(ref_arch)
    rres = ref_run(rspec, params=ref_params, log_fn=lambda s: None)
    pres = run(pspec, params=port_params, device="cpu",
               log_fn=lambda s: None)
    assert pres.history["step"] == rres.history["step"] == [0, 1, 2, 3]
    np.testing.assert_allclose(pres.history["loss"], rres.history["loss"],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(pres.history["lr"], rres.history["lr"],
                               rtol=1e-6)
    np.testing.assert_allclose(pres.history["accuracy"],
                               rres.history["accuracy"], atol=1e-6)
    assert pres.params is port_params                         # in place
    assert int(pres.opt_state.step) == int(rres.opt_state.step)
    assert_trees_close(pres.params, rres.params, rtol=1e-4, atol=1e-5)
    assert all(isinstance(v, float) for v in pres.history["loss"])


def test_batches_are_bit_identical():
    rcfg = RefDataConfig(vocab=128, seq_len=32, global_batch=4, seed=7)
    pcfg = DataConfig(vocab=128, seq_len=32, global_batch=4, seed=7)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    rit, pit = ref_batches(rcfg, 2), batches(pcfg, 2)
    for _ in range(3):
        rb, pb = next(rit), next(pit)
        assert sorted(rb) == sorted(pb)
        for k in rb:
            assert rb[k].dtype == pb[k].dtype
            assert np.array_equal(rb[k], pb[k])


def test_runspec_json_is_byte_equal_across_packages():
    rspec, pspec = _specs(microbatches=2)
    assert pspec.to_json() == rspec.to_json()
    assert pspec.to_json(indent=1, sort_keys=True) == \
        rspec.to_json(indent=1, sort_keys=True)
    assert RunSpec.from_json(rspec.to_json()) == pspec
    assert ref_spec_mod.RunSpec.from_json(pspec.to_json()) == rspec
    argv = ["--arch", ARCH_ID, "--smoke", "--steps", "7", "--batch", "4",
            "--seq", "16", "--weight-decay", "0.1", "--lr", "2e-3"]
    assert RunSpec.from_cli(argv).to_json() == \
        ref_spec_mod.RunSpec.from_cli(argv).to_json()
    assert spec_mod.DEFAULT_LRS == ref_spec_mod.DEFAULT_LRS


@pytest.mark.parametrize("total", [4, 100])
def test_schedules_match_reference(total):
    r, p = ref_sched.warmup_cosine(1e-3, total), sched.warmup_cosine(1e-3,
                                                                     total)
    for step in range(1, total + 1, max(total // 10, 1)):
        assert isinstance(p(step), float)
        np.testing.assert_allclose(p(step), float(r(step)), rtol=1e-5)
    assert sched.constant(0.5)(3) == float(ref_sched.constant(0.5)(3)) == 0.5


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "hist.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH_ID,
         "--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
         "--optimizer", "adalomo", "--device", "cpu", "--history-out",
         str(out)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stdout
    hist = json.loads(out.read_text())
    assert hist["step"] == [0, 1, 2] and np.isfinite(hist["loss"]).all()
    # the same spec through --spec gives the same curve
    spec = tmp_path / "spec.json"
    spec.write_text(RunSpec.from_cli(
        ["--arch", ARCH_ID, "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "16"]).to_json())
    out2 = tmp_path / "hist2.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--spec",
         str(spec), "--device", "cpu", "--history-out", str(out2)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(out2.read_text())["loss"] == hist["loss"]


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, imported in a fresh interpreter: neither
    ``jax`` nor anything of ``repro`` gets loaded."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.kernels.adalomo_update.ops" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, pspec = _specs()
    _, port_arch = smoke_archs()
    for call in (lambda: run(pspec, log_fn=lambda s: None),
                 lambda: build_step_program(pspec),
                 lambda: port_arch.init_params(0),
                 lambda: repro_torch.resolve_device()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert build_step_program(pspec, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("change", [
    {"sentinel": spec_mod.SentinelSpec(enabled=True)},
    {"observe": spec_mod.ObservabilitySpec(optimizer_every=1)},
    {"mesh": spec_mod.MeshSpec(kind="multi", shape=(2,))},
    {"data": DataConfig(vocab=0, seq_len=32, global_batch=4, packing=True)}])
def test_unported_spec_fields_raise(change):
    _, pspec = _specs()
    bad = dataclasses.replace(pspec, **change)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_step_program(bad, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        run(bad, device="cpu")


def test_hooks_pipeline_and_step_event():
    _, pspec = _specs()
    pspec = dataclasses.replace(pspec, log_every=2)
    lines, timing = [], TimingHook()
    mine = HistoryHook()
    res = run(pspec, device="cpu", hooks=[timing, mine], log_fn=lines.append)
    assert res.find_hook(HistoryHook) is mine       # replaces the default
    assert isinstance(res.find_hook(LoggingHook), LoggingHook)
    assert len(lines) == 3                          # steps 0, 2 and the last
    assert timing.n_steps == 4 and len(timing.step_s) == 4
    assert timing.wall_s > 0 and timing.us_per_step > 0
    assert res.history is mine.history and len(res.history["loss"]) == 4
    with pytest.raises(ValueError, match="not divisible"):
        run(dataclasses.replace(pspec, steps=StepSpec(total=1,
                                                      microbatches=3)),
            device="cpu")
