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


def test_cli_sentinel_and_probes_on_cpu(tmp_path):
    """``--sentinel --observe-every 2`` run on the CPU: the stream holds
    probe records every 2 steps and no anomaly on a clean run; the spec the
    flags make is the reference CLI's."""
    metrics = tmp_path / "m.jsonl"
    argv = ["--arch", ARCH_ID, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--sentinel", "--sentinel-ladder",
            "skip,backoff", "--observe-every", "2", "--metrics-path",
            str(metrics)]
    assert RunSpec.from_cli(argv).to_json() == \
        ref_spec_mod.RunSpec.from_cli(argv).to_json()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stdout and "sentinel" not in proc.stdout
    from repro_torch.telemetry.schema import read_stream
    s = read_stream(str(metrics))
    assert [(r["probe"], r["step"]) for r in s.probes()] == [
        ("opt_health", 0), ("factored", 0), ("opt_health", 2),
        ("factored", 2)]
    assert s.anomalies() == [] and len(s.steps()) == 4


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


@pytest.mark.parametrize("arch_id,shape", [
    ("deepseek-v3-671b", (1, 2)),
    ("paligemma-3b", (2, 2)),
    ("whisper-base", (1, 2)),
    ("zamba2-1.2b", (1, 2, 2)),
    ("mamba2-1.3b", (1, 2)),
    ("deepseek-moe-16b", (1, 3)),
    ("h2o-danube-1.8b", (2, 2)),
    ("deepseek-moe-16b", (1, 2)),
    ("deepseek-v3-671b", (1, 3))])
def test_zero3_plan_tiles_every_family_on_a_model_axis(arch_id, shape):
    """Every family's ZeRO-3 plan on a model axis, built on the meta device
    with no world (``torch_parity.plan_mesh``), as ``run(spec)`` builds it
    for a spec of that mesh: each rank's rows and tiles of a global batch
    of 8 rows (every value its own index) put back together, the model
    ranks' along the sequence and the batch ranks' along the rows, are the
    global batch; a modality prefix's rows come ahead of the tokens' and an
    encoder's frames are a sequence of their own; ``tile`` and
    ``frame_tile`` are each rank's."""
    from repro_torch.models.registry import get_arch
    from repro_torch.sharding.zero import Zero3
    from torch_parity import plan_mesh
    arch = get_arch(arch_id, smoke=True)
    meta = arch.init_params(0, device="meta")
    P = getattr(arch.cfg, "n_prefix_tokens", 0)
    tp, dp = shape[-1], int(np.prod(shape[:-1]))
    B, S = 8, 24 if tp == 3 else 16
    batch = {k: torch.arange(int(np.prod(shp)), dtype=torch.float64)
             .reshape(shp)
             for k, (shp, _) in arch.train_batch_specs(B, S).items()}
    assert ("frames" in batch) == (arch.family == "encdec")
    got = {}
    for rank in range(int(np.prod(shape))):
        mesh = plan_mesh(shape, rank)
        zero = Zero3(mesh, meta, prefix=P)
        got[mesh.batch_index, mesh.tile_index] = zero.rows(batch)
        assert zero.tile == (B // dp, (P + S) // tp)
        assert zero.frame_tile == (None if "frames" not in batch else
                                   (B // dp, batch["frames"].shape[1] // tp))
    for k in batch:
        whole = torch.cat([
            torch.cat([got[i, j][k] for j in range(tp)], dim=1)
            if batch[k].ndim >= 2 else got[i, 0][k] for i in range(dp)])
        assert torch.equal(whole, batch[k]), k
        if batch[k].ndim < 2:
            assert all(torch.equal(got[i, j][k], got[i, 0][k])
                       for i in range(dp) for j in range(tp)), k


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
