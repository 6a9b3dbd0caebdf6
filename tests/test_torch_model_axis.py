"""The model axis of the port: sequence-parallel fused AdaLomo on
(data, model) meshes over ``gloo`` worlds on the host — 2-D ZeRO-3 blocks,
each rank its rows and sequence tile, K/V gathered over ``model``, the MoE
experts expert-parallel — held against the JAX package's single-device
run of the same spec from the same weights.

Two worlds are spawned (``_torch_elastic_worker.run_world``): four ranks
on (2, 2) and (1, 2, 2), then two on (1, 2) and (2,).  The reference runs
in this process.  Tolerances are the reference's own for its sharded run
(``tests/distribution/_dist_script.py``): loss rtol 1e-5, atol 1e-5;
params rtol 5e-4, atol 1e-5."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import tree_flatten_with_path, tree_map
from repro_torch.run import run
from repro_torch.run.hooks import Hook
from torch_parity import assert_trees_close, ref_params_and_copy, smoke_archs
from _torch_elastic_worker import aux_arch, lomo_steps, make_spec, run_world

DANUBE, MOE = "h2o-danube-1.8b", "deepseek-moe-16b"
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
# a load-balance weight 1000x the config's: a gradient of the aux loss
# counted once a model rank (twice on (2, 2)) moves the run far outside
# the tolerance
AUX_HEAVY = 1.0


def _ref_spec(arch, **kw):
    return make_spec(arch, spec_mod=ref_spec_mod, data_cls=RefDataConfig,
                     **kw)


def _ref_moe_heavy():
    ref, _ = smoke_archs(MOE)
    moe = dataclasses.replace(ref.cfg.moe, router_aux_weight=AUX_HEAVY)
    return dataclasses.replace(ref, cfg=dataclasses.replace(ref.cfg,
                                                            moe=moe))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device runs and both worlds' results."""
    d = tmp_path_factory.mktemp("model_axis")
    out = {"dir": d, "ref": {}, "init": {}}
    for name, ref_arch, packing, total in (
            ("danube", smoke_archs(DANUBE)[0], False, 6),
            ("packed", smoke_archs(DANUBE)[0], True, 4),
            ("moe", smoke_archs(MOE)[0], False, 3),
            ("moe_heavy", _ref_moe_heavy(), False, 3)):
        ref_params, port_params = ref_params_and_copy(ref_arch)
        init = str(d / f"init_{name}.pt")
        torch.save(port_params, init)
        out["init"][name] = (init, port_params)
        arch_id = MOE if name.startswith("moe") else DANUBE
        out["ref"][name] = ref_run(_ref_spec(arch_id, packing=packing,
                                             total=total),
                                   arch=ref_arch, params=ref_params,
                                   log_fn=lambda s: None)
    rng = np.random.default_rng(0)
    np.save(d / "x.npy", rng.standard_normal((2, 8, 3, 4)).astype(np.float32))
    np.save(d / "w.npy", rng.standard_normal((4, 2, 8, 3, 4)).astype(
        np.float32))
    a = str(d / "A")
    init = out["init"]
    w4 = [
        dict(kind="run", arch=DANUBE, shape=[2, 2], total=6, ckpt=a,
             init=init["danube"][0], out=str(d / "A.json")),
        dict(kind="run", arch=DANUBE, shape=[2, 2], total=4, packing=True,
             init=init["packed"][0], out=str(d / "packed.json")),
        dict(kind="run", arch=MOE, shape=[2, 2], total=3, ckpt=str(d / "M"),
             init=init["moe"][0], out=str(d / "moe.json")),
        dict(kind="run", arch=MOE, shape=[2, 2], total=3, ckpt=str(d / "H"),
             aux_weight=AUX_HEAVY, init=init["moe_heavy"][0],
             out=str(d / "moe_heavy.json")),
        dict(kind="run", arch=MOE, shape=[1, 2, 2], total=3,
             ckpt=str(d / "MP"), init=init["moe"][0],
             out=str(d / "moe_1x2x2.json")),
        dict(kind="run", arch=DANUBE, shape=[2, 2], total=6, ckpt=str(d / "G"),
             init=init["danube"][0], inject=["nan_grads", 3],
             out=str(d / "G.json")),
        dict(kind="ggn", arch=DANUBE, shape=[2, 2], ckpt=str(d / "L"),
             init=init["danube"][0], out=str(d / "L.json")),
        dict(kind="copy_step", src=f"{a}/step_000000003", dst=str(d / "S"),
             out=""),
        dict(kind="run", arch=DANUBE, shape=[2, 2], total=6,
             ckpt=str(d / "S"), out=str(d / "S.json")),
        dict(kind="copy_step", src=f"{a}/step_000000003", dst=str(d / "F"),
             out=""),
        dict(kind="run", arch=DANUBE, shape=[4], total=6, ckpt=str(d / "F"),
             out=str(d / "F.json")),
        dict(kind="run", arch=DANUBE, shape=[1, 2, 2], total=6, every=6,
             ckpt=str(d / "P"), init=init["danube"][0],
             out=str(d / "P.json")),
        dict(kind="tiles", arch=DANUBE, shape=[2, 2],
             out=str(d / "tiles_danube.json")),
        dict(kind="tiles", arch=MOE, shape=[2, 2],
             out=str(d / "tiles_moe.json")),
        dict(kind="shard_act", shape=[2, 2], x=str(d / "x.npy"),
             w=str(d / "w.npy"), out=str(d / "act")),
    ]
    run_world(4, str(d / "store4"), w4)
    w2 = [
        dict(kind="run", arch=DANUBE, shape=[1, 2], total=6, every=6,
             ckpt=str(d / "D"), init=init["danube"][0],
             out=str(d / "D.json")),
        dict(kind="run", arch=MOE, shape=[1, 2], total=3, ckpt=str(d / "M12"),
             init=init["moe"][0], out=str(d / "moe_1x2.json")),
        dict(kind="copy_step", src=f"{a}/step_000000003", dst=str(d / "R"),
             out=""),
        dict(kind="run", arch=DANUBE, shape=[2], total=6, ckpt=str(d / "R"),
             out=str(d / "R.json")),
    ]
    run_world(2, str(d / "store2"), w2)
    return out


def _hist(runs, name):
    return json.loads((runs["dir"] / f"{name}.json").read_text())


def _ckpt_params(path, step, port_params, opt="adalomo"):
    """The params of a checkpoint written by a sharded run (whole arrays)."""
    _, tree, _ = CheckpointManager(path).restore(
        step, template=(port_params, get_opt(opt).init(port_params)))
    return tree[0]


@pytest.mark.parametrize("case,shape", [("A", (2, 2)), ("P", (1, 2, 2)),
                                        ("D", (1, 2))])
def test_model_axis_run_matches_reference(runs, case, shape):
    """danube on (2, 2), (1, 2, 2) and (1, 2): losses and final params
    against the reference's single-device run."""
    ref = runs["ref"]["danube"]
    h = _hist(runs, case)
    assert h["step"] == [0, 1, 2, 3, 4, 5]
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    params = _ckpt_params(runs["dir"] / case, 6, runs["init"]["danube"][1])
    assert_trees_close(params, ref.params, what=str(shape), **PARAM_TOL)


def test_packed_batch_on_2x2(runs):
    """A packed batch on (2, 2): each rank's rows and tile hold another
    number of tokens and other documents; the q tile's segment ids meet the
    gathered ones, and the loss is the global token mean."""
    np.testing.assert_allclose(_hist(runs, "packed")["loss"],
                               runs["ref"]["packed"].history["loss"],
                               **LOSS_TOL)


@pytest.mark.parametrize("case,name,ckpt", [
    ("moe", "moe", "M"), ("moe_heavy", "moe_heavy", "H"),
    ("moe_1x2x2", "moe", "MP"), ("moe_1x2", "moe", "M12")])
def test_moe_expert_parallel_matches_reference(runs, case, name, ckpt):
    """deepseek-moe-16b on (2, 2), (1, 2, 2) and (1, 2), expert parallel
    over ``model``: loss and params after 3 steps against the reference's
    single-device run, and the load-balance loss (a metric the reference
    does not report) against the port's.  ``moe_heavy`` weighs the aux
    loss 1000x: its gradient entering once a model rank would fail it.
    The expert stacks are never gathered over ``model`` (over ``data``
    where it is larger than 1)."""
    ref = runs["ref"][name]
    h = _hist(runs, case)
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    params = _ckpt_params(runs["dir"] / ckpt, 3, runs["init"][name][1])
    assert_trees_close(params, ref.params, what=name, **PARAM_TOL)
    aux = []

    class Aux(Hook):
        def on_step_end(self, ctx, ev):
            aux.append(ev.metrics["aux_loss"])

    single = run(make_spec(MOE, total=3),
                 arch=aux_arch(MOE, AUX_HEAVY) if name == "moe_heavy"
                 else None,
                 params=tree_map(torch.clone, runs["init"][name][1]),
                 hooks=[Aux()], device="cpu", log_fn=lambda s: None)
    assert all(a > 0 for a in h["aux"])
    np.testing.assert_allclose(h["aux"], aux, **LOSS_TOL)
    gathers = {(a, k): n for a, k, n in h["gathers"]}
    assert gathers.get(("model", "expert"), 0) == 0
    assert gathers[("model", "dense")] > 0
    assert (gathers.get(("data", "expert"), 0) > 0) == (case != "moe_1x2")
    np.testing.assert_allclose(h["loss"], single.history["loss"], **LOSS_TOL)


def test_lomo_global_grad_norm_on_2x2(runs):
    """Fused LOMO with the two-pass global-norm clip (active: the clip is
    below the norm) on (2, 2): each element's square counted once over
    data x model, so the clip and the run are the single-device run's."""
    from repro_torch.run.spec import OptSpec
    spec = dataclasses.replace(
        make_spec(DANUBE), opt=OptSpec(name="lomo", lr=1e-2,
                                       schedule="constant"))
    params = tree_map(torch.clone, runs["init"]["danube"][1])
    losses, program, (params, _) = lomo_steps(spec, params)
    np.testing.assert_allclose(_hist(runs, "L")["loss"], losses, **LOSS_TOL)
    got = _ckpt_params(runs["dir"] / "L", 3, runs["init"]["danube"][1],
                       opt="lomo")
    for (kp, a), (_, b) in zip(tree_flatten_with_path(got),
                               tree_flatten_with_path(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(kp),
                                   **PARAM_TOL)


def test_sentinel_skips_the_same_step_on_a_2x2_mesh(runs):
    """The sentinel on (2, 2): a NaN'd update at step 3 on every rank's
    blocks is one verdict (the non-finite flag summed over every rank, the
    update norm over data x model each element once), so all four ranks
    skip it, and the run matches the single-device guarded run."""
    from repro_torch.sentinel.inject import Injection
    h = _hist(runs, "G")
    assert h["anomaly"] == [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]
    params = tree_map(torch.clone, runs["init"]["danube"][1])
    single = run(make_spec(DANUBE, sentinel=True,
                           ckpt=str(runs["dir"] / "G1")),
                 params=params, inject=Injection("nan_grads", at_step=3),
                 device="cpu", log_fn=lambda s: None)
    np.testing.assert_allclose(h["loss"], single.history["loss"], **LOSS_TOL)
    got = _ckpt_params(runs["dir"] / "G", 6, runs["init"]["danube"][1])
    for (kp, a), (_, b) in zip(tree_flatten_with_path(got),
                               tree_flatten_with_path(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=str(kp),
                                   **PARAM_TOL)


def test_whole_leaves_bitwise_across_four_ranks(runs):
    """Leaves held whole (norm scales) are the same bits on all four ranks
    of (2, 2); the split leaves are each rank's block, a quarter or a half
    of the whole."""
    full = runs["init"]["danube"][1]
    ranks = [dict(tree_flatten_with_path(torch.load(
        runs["dir"] / f"A.json.rank{r}.pt"))) for r in range(4)]
    n_whole = n_quarter = 0
    for kp, ref in tree_flatten_with_path(full):
        if ranks[0][kp].shape == ref.shape:
            n_whole += 1
            for f in ranks[1:]:
                assert torch.equal(f[kp], ranks[0][kp]), kp
        elif ranks[0][kp].numel() * 4 == ref.numel():
            n_quarter += 1
    assert n_whole > 0 and n_quarter > 0


def test_same_mesh_resume_is_bitwise(runs):
    """Resumed on (2, 2) from the (2, 2) run's step 3: the same losses and
    the same step-6 checkpoint, bit for bit."""
    d = runs["dir"]
    assert _hist(runs, "S")["loss"] == _hist(runs, "A")["loss"][3:]
    a, s = d / "A" / "step_000000006", d / "S" / "step_000000006"
    names = sorted(p for p in os.listdir(a) if p.endswith(".npy"))
    assert names
    for name in names:
        assert np.array_equal(np.load(a / name), np.load(s / name)), name


def test_2x2_checkpoint_resumes_on_2_4_and_on_no_mesh(runs):
    """The (2, 2) run's step-3 checkpoint (2-D blocks gathered to whole
    arrays) continued on (2,), on (4,) and on no mesh: the losses of the
    uninterrupted run, and the no-mesh run's params the reference's."""
    d = runs["dir"]
    whole = _hist(runs, "A")["loss"]
    for name in ("R", "F"):
        h = _hist(runs, name)
        assert h["step"] == [3, 4, 5]
        np.testing.assert_allclose(h["loss"], whole[3:], **LOSS_TOL)
    ck = d / "N"
    ck.mkdir()
    shutil.copytree(d / "A" / "step_000000003", ck / "step_000000003")
    params = tree_map(torch.zeros_like, runs["init"]["danube"][1])
    res = run(make_spec(DANUBE, ckpt=str(ck)), params=params, device="cpu",
              log_fn=lambda s: None)
    assert res.history["step"] == [3, 4, 5]
    np.testing.assert_allclose(res.history["loss"], whole[3:], **LOSS_TOL)
    assert_trees_close(params, runs["ref"]["danube"].params, **PARAM_TOL)


@pytest.mark.parametrize("arch", ["danube", "moe"])
def test_saved_residuals_are_the_rank_tile(runs, arch):
    """Every saved layer input on a (2, 2) rank is its [B/2, S/2, d] tile
    of the global [B, S] batch (the residual constraint's input), and the
    expert stacks are never gathered over ``model``."""
    h = json.loads((runs["dir"] / f"tiles_{arch}.json").read_text())
    B, S = h["global"]
    assert h["tile"] == [B // 2, S // 2]
    assert len(h["saved"]) == 2                    # one a layer
    for shapes in h["saved"]:
        assert shapes and all(s[:2] == [B // 2, S // 2] for s in shapes)
    gathers = {(a, k): n for a, k, n in h["gathers"]}
    assert gathers.get(("model", "expert"), 0) == 0


def test_shard_act_kinds_on_a_model_axis(runs):
    """``shard_act`` on each (2, 2) rank's tile: every kind but ``kv_full``
    is the tile itself, ``kv_full`` the whole sequence (the reference's
    ``shard_act`` is the identity on the whole activation); its backward
    sums every model rank's upstream gradient at the tile; ``seq_tiles`` is
    the reference's count and ``seq_offset`` the tile's start."""
    from repro.sharding import act as ref_act
    x = np.load(runs["dir"] / "x.npy")
    w = np.load(runs["dir"] / "w.npy")
    S, n = x.shape[1], x.shape[1] // 2
    for rank in range(4):
        got = np.load(runs["dir"] / f"act.rank{rank}.npz")
        k = rank % 2                                # the model index
        tile = x[:, k * n:(k + 1) * n]
        for kind in ("hidden", "ffn", "heads", "q_tiled", "vocab",
                     "experts"):
            np.testing.assert_array_equal(got[kind], np.asarray(
                ref_act.shard_act(x, kind))[:, k * n:(k + 1) * n])
        np.testing.assert_array_equal(got["kv_full"],
                                      np.asarray(ref_act.shard_act(
                                          x, "kv_full")))
        d = rank - k                                # the model group's base
        want = (w[d] + w[d + 1])[:, k * n:(k + 1) * n]
        np.testing.assert_allclose(got["kv_full_grad"], want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["seq_tiles"], 2)
        np.testing.assert_array_equal(got["offset"], k * n)
        assert got["kv_full"].shape == x.shape and tile.shape[1] == n


def test_launcher_virtual_devices_on_a_2x2_mesh(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --virtual-devices 4
    --mesh-shape 2x2`` trains on a (data, model) world of four gloo ranks
    and checkpoints the whole arrays."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           DANUBE, "--smoke", "--batch", "4", "--seq", "16", "--device",
           "cpu", "--steps", "2", "--mesh-shape", "2x2",
           "--virtual-devices", "4", "--ckpt-dir", str(tmp_path / "ck"),
           "--ckpt-every", "2"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "elastic mesh {'data': 2, 'model': 2}" in out.stdout
    assert out.stdout.count("final loss") == 1
    assert (tmp_path / "ck" / "step_000000002" / "_COMPLETE").exists()
