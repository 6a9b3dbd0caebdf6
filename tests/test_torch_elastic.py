"""Scale-out of the port: ZeRO-3 sharded fused AdaLomo over ``gloo`` worlds
of 2 and 4 ranks on the host, held against the JAX package's
single-device run of the same spec from the same weights.

Two worlds are spawned (``_torch_elastic_worker.run_world``), each running
its cases in order, so process start-up is paid twice.  The reference runs
in this process.  Tolerances are the reference's own for its sharded run
(``tests/fleet/_elastic_script.py``): loss rtol 1e-5, atol 1e-5; params
rtol 5e-4, atol 1e-5."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.tree import tree_flatten_with_path, tree_map
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import get_arch
from repro_torch.run import run
from torch_parity import assert_trees_close, ref_params_and_copy, smoke_archs
from _torch_elastic_worker import make_spec, run_world

DANUBE, MOE = "h2o-danube-1.8b", "deepseek-moe-16b"
FAMILIES = {"mamba2": "mamba2-1.3b", "zamba2": "zamba2-1.2b",
            "whisper": "whisper-base"}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _ref_spec(arch, **kw):
    return make_spec(arch, spec_mod=ref_spec_mod, data_cls=RefDataConfig,
                     **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device runs and both worlds' results."""
    d = tmp_path_factory.mktemp("elastic")
    out = {"dir": d, "ref": {}, "init": {}}
    for name, arch, packing in (("danube", DANUBE, False),
                                ("moe", MOE, False),
                                ("packed", DANUBE, True)):
        ref_arch, _ = smoke_archs(arch)
        ref_params, port_params = ref_params_and_copy(ref_arch)
        init = str(d / f"init_{name}.pt")
        torch.save(port_params, init)
        out["init"][name] = (init, port_params)
        out["ref"][name] = ref_run(_ref_spec(arch, packing=packing),
                                   params=ref_params, log_fn=lambda s: None)
    for name, arch in FAMILIES.items():
        # the other families against the port's single-device run (held to
        # the reference's in tests/test_torch_{mamba2,hybrid,encdec}.py)
        params = get_arch(arch, smoke=True).init_params(0, device="cpu")
        init = str(d / f"init_{name}.pt")
        torch.save(params, init)
        out["init"][name] = (init, params)
    a = str(d / "A")
    w2 = [
        dict(kind="run", arch=DANUBE, shape=[2], total=6, ckpt=a,
             init=out["init"]["danube"][0], out=str(d / "A.json")),
        dict(kind="run", arch=MOE, shape=[2], total=6, eval_every=3,
             init=out["init"]["moe"][0], out=str(d / "moe.json")),
        dict(kind="run", arch=DANUBE, shape=[2], total=6, packing=True,
             init=out["init"]["packed"][0], out=str(d / "packed.json")),
        dict(kind="copy_step", src=f"{a}/step_000000003", dst=str(d / "S"),
             out=""),
        dict(kind="run", arch=DANUBE, shape=[2], total=6, ckpt=str(d / "S"),
             out=str(d / "S.json")),
        dict(kind="mesh_error", shape=[4], out=str(d / "mesh_error.json")),
        dict(kind="run", arch=DANUBE, shape=[2], total=6, ckpt=str(d / "G"),
             init=out["init"]["danube"][0], inject=["nan_grads", 3],
             out=str(d / "G.json")),
        dict(kind="ggn", arch=DANUBE, shape=[2], ckpt=str(d / "L"),
             init=out["init"]["danube"][0], out=str(d / "L.json")),
    ] + [dict(kind="run", arch=arch, shape=[2], total=4, every=2,
              ckpt=str(d / name), init=out["init"][name][0],
              out=str(d / f"{name}.json")) for name, arch in FAMILIES.items()]
    run_world(2, str(d / "store2"), w2)
    w4 = [
        dict(kind="run", arch=DANUBE, shape=[2, 2, 1], total=6,
             ckpt=str(d / "P"), init=out["init"]["danube"][0],
             out=str(d / "P.json")),
        dict(kind="copy_step", src=f"{a}/step_000000003", dst=str(d / "R"),
             out=""),
        dict(kind="run", arch=DANUBE, shape=[4], total=6, ckpt=str(d / "R"),
             out=str(d / "R.json")),
        dict(kind="roundtrip", arch=DANUBE, shape=[4], total=6, step=3,
             src=a, dst=str(d / "T"), out=""),
    ]
    run_world(4, str(d / "store4"), w4)
    return out


def _hist(runs, name):
    return json.loads((runs["dir"] / f"{name}.json").read_text())


def _ckpt_params(path, step, port_params):
    """The params of a checkpoint written by a sharded run (whole arrays)."""
    from repro_torch.core.optimizers import get_opt
    opt_state = get_opt("adalomo").init(port_params)
    _, tree, _ = CheckpointManager(path).restore(
        step, template=(port_params, opt_state))
    return tree[0]


@pytest.mark.parametrize("case,shape", [("A", (2,)), ("P", (2, 2, 1))])
def test_sharded_run_matches_reference(runs, case, shape):
    """danube on a data mesh of 2 and on pod x data = 2 x 2: losses and
    final params against the reference's single-device run."""
    ref = runs["ref"]["danube"]
    h = _hist(runs, case)
    assert h["step"] == [0, 1, 2, 3, 4, 5]
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    params = _ckpt_params(runs["dir"] / case, 6, runs["init"]["danube"][1])
    assert_trees_close(params, ref.params, what=str(shape), **PARAM_TOL)


def test_replicated_leaves_bitwise_equal_across_ranks(runs):
    """Whole (replicated) leaves — norm scales — are the same bits on every
    rank; split leaves differ (each rank its shard)."""
    full = runs["init"]["danube"][1]
    for case, world in (("A", 2), ("P", 4)):
        ranks = [torch.load(runs["dir"] / f"{case}.json.rank{r}.pt")
                 for r in range(world)]
        flat = [dict(tree_flatten_with_path(t)) for t in ranks]
        n_whole = 0
        for kp, ref in tree_flatten_with_path(full):
            if flat[0][kp].shape != ref.shape:
                continue
            n_whole += 1
            for f in flat[1:]:
                assert torch.equal(f[kp], flat[0][kp]), (case, kp)
        assert 0 < n_whole < len(flat[0])


def test_moe_loss_and_aux_match(runs):
    """deepseek-moe-16b on (2,): the loss against the reference's
    single-device run, and the router's load-balance loss (averaged over
    the ranks before its product) and the held-out eval loss (every 3
    steps, each rank its rows of the eval batches) against the port's
    single-device run."""
    h = _hist(runs, "moe")
    np.testing.assert_allclose(h["loss"], runs["ref"]["moe"].history["loss"],
                               **LOSS_TOL)
    from repro_torch.run.hooks import Hook

    class Aux(Hook):
        aux = []

        def on_step_end(self, ctx, ev):
            self.aux.append(ev.metrics["aux_loss"])

    params = tree_map(torch.clone, runs["init"]["moe"][1])
    single = run(make_spec(MOE, eval_every=3), params=params, device="cpu",
                 hooks=[Aux()], log_fn=lambda s: None)
    assert len(h["eval_loss"]) == len(single.history["eval_loss"]) == 2
    np.testing.assert_allclose(h["eval_loss"], single.history["eval_loss"],
                               **LOSS_TOL)
    assert all(a > 0 for a in h["aux"])
    np.testing.assert_allclose(h["aux"], Aux.aux, **LOSS_TOL)


def test_packed_loss_is_global_token_mean(runs):
    """Packed batches on (2,): each rank's rows hold another number of
    tokens, and the loss is the global batch's sum over its global token
    count, as the reference's single-device run."""
    h = _hist(runs, "packed")
    np.testing.assert_allclose(h["loss"],
                               runs["ref"]["packed"].history["loss"],
                               **LOSS_TOL)


def _files(step_dir):
    return sorted(p for p in os.listdir(step_dir) if p.endswith(".npy"))


def test_resume_across_world_sizes(runs):
    """Written on (2,) at step 3: restored onto (4,) and saved again, every
    leaf is the saved one bitwise; resumed on (4,) and on no mesh, the
    continued losses match the uninterrupted run's."""
    d = runs["dir"]
    src, dst = d / "A" / "step_000000003", d / "T" / "step_000000003"
    assert _files(src) == _files(dst) and _files(src)
    for name in _files(src):
        a, b = np.load(src / name), np.load(dst / name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    whole = _hist(runs, "A")["loss"]
    four = _hist(runs, "R")
    assert four["step"] == [3, 4, 5]
    np.testing.assert_allclose(four["loss"], whole[3:], **LOSS_TOL)
    # onto no mesh: the unsharded run restores the whole arrays
    ck = d / "N"
    ck.mkdir()
    shutil.copytree(src, ck / "step_000000003")
    _, port = smoke_archs(DANUBE)
    params = port.init_params(0, device="cpu")
    res = run(make_spec(DANUBE, ckpt=str(ck)), params=params, device="cpu",
              log_fn=lambda s: None)
    assert res.history["step"] == [3, 4, 5]
    np.testing.assert_allclose(res.history["loss"], whole[3:], **LOSS_TOL)
    assert_trees_close(params, runs["ref"]["danube"].params, **PARAM_TOL)


def test_same_world_resume_is_bitwise(runs):
    """Resumed on (2,) from the (2,) run's step 3: the same losses and the
    same step-6 checkpoint, bit for bit."""
    d = runs["dir"]
    assert _hist(runs, "S")["loss"] == _hist(runs, "A")["loss"][3:]
    a, s = d / "A" / "step_000000006", d / "S" / "step_000000006"
    for name in _files(a):
        assert np.array_equal(np.load(a / name), np.load(s / name)), name


def test_make_mesh_wrong_world_size_names_virtual_devices(runs):
    """A mesh that is not the world's size raises, naming the flag that
    makes a world of the right size: inside a world of 2, and with no
    world at all."""
    err = json.loads((runs["dir"] / "mesh_error.json").read_text())["error"]
    assert "--virtual-devices 4" in err and "world has 2" in err
    with pytest.raises(ValueError, match="--virtual-devices 2"):
        make_mesh((2,), "cpu")


def test_launcher_virtual_devices_then_elastic_from(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --mesh-shape 2
    --virtual-devices 2`` trains on two gloo ranks; ``--elastic-from`` its
    checkpoints continues it on one."""
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            DANUBE, "--smoke", "--batch", "4", "--seq", "16", "--device",
            "cpu", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    a = subprocess.run(base + ["--steps", "2", "--mesh-shape", "2",
                               "--virtual-devices", "2"],
                       capture_output=True, text=True, env=env, timeout=240)
    assert a.returncode == 0, a.stderr[-2000:]
    assert "elastic mesh {'data': 2}" in a.stdout
    assert a.stdout.count("final loss") == 1          # rank 0 alone prints
    assert (tmp_path / "ck" / "step_000000002" / "_COMPLETE").exists()
    b = subprocess.run(base + ["--steps", "4", "--elastic-from",
                               str(tmp_path / "ck"), "--virtual-devices",
                               "1"],
                       capture_output=True, text=True, env=env, timeout=240)
    assert b.returncode == 0, b.stderr[-2000:]
    assert "resumed from step 2" in b.stdout
    assert "elastic mesh {'data': 1}" in b.stdout
    assert (tmp_path / "ck" / "step_000000004" / "_COMPLETE").exists()


def test_sentinel_skips_the_same_step_on_every_rank(runs):
    """The sentinel on (2,): a NaN'd update at step 3 on every rank's shards
    is one verdict, reduced over the ranks inside the step — the step is
    skipped on both, and the run matches the single-device guarded run with
    the same injection."""
    from repro_torch.sentinel.inject import Injection
    h = _hist(runs, "G")
    assert h["anomaly"] == [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    ck = runs["dir"] / "G1"
    params = tree_map(torch.clone, runs["init"]["danube"][1])
    single = run(make_spec(DANUBE, sentinel=True, ckpt=str(ck)),
                 params=params, inject=Injection("nan_grads", at_step=3),
                 device="cpu", log_fn=lambda s: None)
    np.testing.assert_allclose(h["loss"], single.history["loss"], **LOSS_TOL)
    sharded = _ckpt_params(runs["dir"] / "G", 6, runs["init"]["danube"][1])
    for (kp, a), (_, b) in zip(tree_flatten_with_path(sharded),
                               tree_flatten_with_path(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(kp),
                                   **PARAM_TOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_other_families_sharded(runs, name):
    """mamba2-1.3b, zamba2-1.2b (its shared attention block's gradients
    summed over its applications, then over the ranks) and whisper-base
    (two stacks, the decoder's cross-attention gradient fed to the
    encoder's sweep) on (2,): losses and params against the port's
    single-device run of the same weights."""
    arch = FAMILIES[name]
    params = tree_map(torch.clone, runs["init"][name][1])
    single = run(make_spec(arch, total=4), params=params, device="cpu",
                 log_fn=lambda s: None)
    h = _hist(runs, name)
    np.testing.assert_allclose(h["loss"], single.history["loss"], **LOSS_TOL)
    from repro_torch.core.optimizers import get_opt
    _, tree, _ = CheckpointManager(runs["dir"] / name).restore(
        4, template=(params, get_opt("adalomo").init(params)))
    for (kp, a), (_, b) in zip(tree_flatten_with_path(tree[0]),
                               tree_flatten_with_path(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(kp),
                                   **PARAM_TOL)


def test_lomo_global_grad_norm_sharded(runs):
    """LOMO's two-pass clip on (2,): pass 1 reduce-scatters each layer's
    gradient and sums the shards' squares over the ranks, so the norm, the
    clip and the run are the single-device run's."""
    import dataclasses

    from repro_torch.run.spec import OptSpec
    from _torch_elastic_worker import lomo_steps
    spec = dataclasses.replace(
        make_spec(DANUBE), opt=OptSpec(name="lomo", lr=1e-2,
                                       schedule="constant"))
    params = tree_map(torch.clone, runs["init"]["danube"][1])
    losses, program, (params, _) = lomo_steps(spec, params)
    assert program.fused
    np.testing.assert_allclose(_hist(runs, "L")["loss"], losses, **LOSS_TOL)
    _, tree, _ = CheckpointManager(runs["dir"] / "L").restore(
        3, template=(params, program.opt.init(params)))
    moved = False
    for (kp, a), (_, b), (_, c) in zip(
            tree_flatten_with_path(tree[0]), tree_flatten_with_path(params),
            tree_flatten_with_path(runs["init"]["danube"][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(kp),
                                   **PARAM_TOL)
        moved |= not torch.equal(b, c)
    assert moved

