"""The optimizer side of a mesh: the unfused rules (AdamW, Adafactor and
the SGD ablations) ZeRO-3 sharded, and the optimizer-health probes and the
sentinel's trust guard reduced over the ranks, held against the JAX
package's single-device run of the same spec from the same weights.

One world of four ``gloo`` ranks runs the ``(2, 2)`` and ``(2, 2, 1)``
cases, one of two the ``(1, 2)`` and ``(2,)`` ones, and one of one the
one-rank mesh (``_torch_elastic_worker.start_world``); the reference runs
in this process meanwhile.  Tolerances are the reference's own for its
sharded run: loss rtol 1e-5, atol 1e-5; params rtol 5e-4, atol 1e-5.

The probes on a mesh sum each leaf's per-unit squares over the ranks in
another order than one device does: their values are held at rtol 1e-4,
atol 1e-5 (the records' tolerance of ``test_torch_probes.py``), the
histogram counts exactly (lr 3e-4 keeps the relative updates clear of the
bin edges), and they are the same bits on every rank."""
import json
import os

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.run import spec as ref_spec_mod
from repro.run.hooks import Hook as RefHook
from repro.run.runner import run as ref_run
from repro.sentinel import spec as ref_guard_mod
from repro.telemetry import probes as ref_probes_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import tree_map
from repro_torch.run import run
from torch_parity import (params_close, port_flat, ref_params_and_copy,
                          smoke_archs)
from _torch_elastic_worker import make_spec, probe_values, start_world

DANUBE, MOE = "h2o-danube-1.8b", "deepseek-moe-16b"
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
PROBE_TOL = dict(rtol=1e-4, atol=1e-5)
RULES = ("adamw", "adafactor", "sgd_momentum", "sgd_variance")
# (2, 2) runs: name -> make_spec keywords (6 steps where a checkpoint at
# step 3 is resumed on other meshes)
RUNS = {
    "adamw": dict(opt="adamw", total=6),
    "adafactor": dict(opt="adafactor", total=6),
    "sgd_momentum": dict(opt="sgd_momentum", total=3),
    "sgd_variance": dict(opt="sgd_variance", total=3),
    "adafactor_mb2": dict(opt="adafactor", total=3, microbatches=2),
    # the guard with the trust ratios and every probe, fused AdaLomo
    "guarded": dict(opt="adalomo", total=3, lr=3e-4, trust_max=1.0,
                    observe=1, factored_every=1),
    # the probes alone (no sentinel) around the unfused step
    "probed": dict(opt="adafactor", total=3, lr=3e-4, observe=1),
    # a trust ceiling below every ratio: every step skipped
    "trust_trip": dict(opt="adamw", total=2, trust_max=1e-6),
}


def _ref(arch, **kw):
    return make_spec(arch, spec_mod=ref_spec_mod, data_cls=RefDataConfig,
                     guard_mod=ref_guard_mod, probes_mod=ref_probes_mod,
                     **kw)


class _RefProbes(RefHook):
    def __init__(self):
        self.values = []

    def on_step_end(self, ctx, ev):
        self.values.append(probe_values(ev.metrics))


def _ref_run(arch_id, ref_arch, ref_params, **kw):
    import jax
    hook = _RefProbes()
    res = ref_run(_ref(arch_id, **kw), arch=ref_arch,
                  params=jax.tree.map(lambda x: x.copy(), ref_params),
                  hooks=[hook], log_fn=lambda s: None)
    return res, hook.values


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three worlds' results and the reference's single-device runs."""
    d = tmp_path_factory.mktemp("mesh_opt")
    out = {"dir": d, "ref": {}, "init": {}, "probes": {}}
    archs = {}
    for name, arch_id in (("danube", DANUBE), ("moe", MOE)):
        ref_arch, _ = smoke_archs(arch_id)
        ref_params, port_params = ref_params_and_copy(ref_arch)
        init = str(d / f"init_{name}.pt")
        torch.save(port_params, init)
        out["init"][name] = (init, port_params)
        archs[name] = (arch_id, ref_arch, ref_params)
    init = out["init"]["danube"][0]
    w4 = [dict(kind="run", arch=DANUBE, shape=[2, 2], ckpt=str(d / name),
               init=init, out=str(d / f"{name}.json"),
               **{"every": 3, **kw}) for name, kw in RUNS.items()]
    w4.append(dict(kind="run", arch=DANUBE, shape=[2, 2, 1], init=init,
                   out=str(d / "guarded_pod.json"), **RUNS["guarded"]))
    for rule in ("adafactor", "adamw"):
        src = f"{d / rule}/step_000000003"
        w4 += [dict(kind="copy_step", src=src, dst=str(d / f"{rule}_{to}"),
                    out="") for to in ("2", "none")]
    wait4 = start_world(4, str(d / "store4"), w4)
    w2 = [dict(kind="run", arch=MOE, shape=[1, 2], total=3,
               ckpt=str(d / "moe"), init=out["init"]["moe"][0], opt="adamw",
               out=str(d / "moe.json"))]
    w1 = [dict(kind="one_rank_probes", arch=DANUBE, init=init,
               out=str(d / "one_rank.json"),
               runs={k: RUNS[k] for k in ("guarded", "probed")})]
    wait1 = start_world(1, str(d / "store1"), w1)
    for name, kw in RUNS.items():
        out["ref"][name], out["probes"][name] = _ref_run(
            DANUBE, *archs["danube"][1:], **kw)
    out["ref"]["moe"], _ = _ref_run(MOE, *archs["moe"][1:], opt="adamw",
                                    total=3)
    wait4()
    # the (2, 2) step-3 checkpoints resumed on (2,) (after the world of
    # four: two worlds share the host's cores)
    w2 += [dict(kind="run", arch=DANUBE, shape=[2], every=3,
                ckpt=str(d / f"{rule}_2"), out=str(d / f"{rule}_2.json"),
                **RUNS[rule]) for rule in ("adafactor", "adamw")]
    wait2 = start_world(2, str(d / "store2"), w2)
    wait1()
    wait2()
    return out


def _hist(runs, name):
    return json.loads((runs["dir"] / f"{name}.json").read_text())


def _rank_probes(runs, name, world):
    return [json.loads((runs["dir"] / f"{name}.json.rank{r}.probes.json")
                       .read_text()) for r in range(world)]


def _ckpt_params(runs, ckpt, step, opt, name="danube"):
    like = runs["init"][name][1]
    _, tree, _ = CheckpointManager(str(runs["dir"] / ckpt)).restore(
        step, template=(like, get_opt(opt).init(like)))
    return tree[0]


def _params_close(got, want, what, *, opt=None):
    """Leaf by leaf at the reference's sharded tolerance, under the
    near-zero-gradient rule for the rules that divide by √v̂
    (``torch_parity.params_close``)."""
    params_close(got, want, what, opt=opt, **PARAM_TOL)


@pytest.mark.parametrize("name", list(RULES) + ["adafactor_mb2"])
def test_unfused_rules_on_2x2_match_reference(runs, name):
    """AdamW, Adafactor (also with 2 microbatches, the shards accumulated)
    and the SGD ablations, unfused on (2, 2): each rank its rows and
    sequence tile and its 2-D blocks of params and state; losses and final
    params against the reference's single-device run."""
    ref = runs["ref"][name]
    kw = RUNS[name]
    h = _hist(runs, name)
    assert h["step"] == list(range(kw["total"]))
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    got = _ckpt_params(runs, name, kw["total"], kw["opt"])
    _params_close(got, ref.params, name, opt=kw["opt"])


def test_moe_unfused_adamw_on_1x2_keeps_experts_split(runs):
    """deepseek-moe-16b, unfused AdamW on (1, 2): the expert stacks run
    expert-parallel, never gathered over ``model``, and the run matches
    the reference's single-device run."""
    ref = runs["ref"]["moe"]
    h = _hist(runs, "moe")
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    got = _ckpt_params(runs, "moe", 3, "adamw", name="moe")
    _params_close(got, ref.params, "moe", opt="adamw")
    gathers = {(a, k): n for a, k, n in h["gathers"]}
    assert gathers.get(("model", "expert"), 0) == 0
    assert gathers[("model", "dense")] > 0


def _assert_probes_close(got: list, want: list, what: str):
    assert len(got) == len(want), what
    for step, (a, b) in enumerate(zip(got, want)):
        assert sorted(a) == sorted(b), (what, step)
        for k in a:
            if k.endswith("counts"):
                assert a[k] == b[k], (what, step, k)
            else:
                np.testing.assert_allclose(
                    a[k], b[k], err_msg=f"{what} step {step} {k}",
                    **PROBE_TOL)


@pytest.mark.parametrize("name,shape", [("guarded", (2, 2)),
                                        ("guarded_pod", (2, 2, 1)),
                                        ("probed", (2, 2))])
def test_probes_and_trust_ratios_same_on_every_rank(runs, name, shape):
    """The probes (group and trust ratios, the effective-lr histogram, the
    factored residuals) on a mesh: the same bits on every rank, and within
    the probe tolerance of the reference's single-device run; the guarded
    run's losses are the reference's."""
    ranks = _rank_probes(runs, name, 4)
    assert ranks[0] and all(r == ranks[0] for r in ranks[1:]), shape
    base = "guarded" if name == "guarded_pod" else name
    want = runs["probes"][base]
    _assert_probes_close(ranks[0], want, name)
    keys = set(ranks[0][0])
    assert any(k.startswith("group_ratio/") for k in keys)
    if base == "guarded":
        assert "trust_worst" in keys
        assert any(k.startswith("factored/recon/") for k in keys)
    np.testing.assert_allclose(_hist(runs, name)["loss"],
                               runs["ref"][base].history["loss"], **LOSS_TOL)


def test_trust_guard_skips_every_step_on_every_rank(runs):
    """A trust ceiling below every group ratio: each step's verdict, from
    the ratios summed over the ranks, skips it on all four ranks, as the
    reference's guard does; the params stay the initial ones."""
    h = _hist(runs, "trust_trip")
    ref = runs["ref"]["trust_trip"]
    assert h["anomaly"] == [1.0, 1.0]
    ranks = _rank_probes(runs, "trust_trip", 4)
    assert all(r == ranks[0] for r in ranks[1:])
    want = [v["trust_worst"] for v in runs["probes"]["trust_trip"]]
    np.testing.assert_allclose([v["trust_worst"] for v in ranks[0]], want,
                               **PROBE_TOL)
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    init = runs["init"]["danube"][1]
    params = torch.load(runs["dir"] / "trust_trip.json.rank0.pt")
    whole = [(p, t) for (p, t), (_, s) in zip(port_flat(params),
                                              port_flat(init))
             if t.shape == s.shape]
    assert whole and all(np.array_equal(t, dict(port_flat(init))[p])
                         for p, t in whole)


def test_one_rank_mesh_probes_are_the_unsharded_bits(runs):
    """On a one-rank mesh every probe value and ``trust_worst`` is the
    unsharded run's, bit for bit (the guard around fused AdaLomo, and the
    probes around the unfused Adafactor step)."""
    got = json.loads((runs["dir"] / "one_rank.json").read_text())
    for name in ("guarded", "probed"):
        assert got[name]["steps"] == RUNS[name]["total"]
        assert got[name]["equal"], name


@pytest.mark.parametrize("rule", ["adafactor", "adamw"])
def test_2x2_checkpoint_resumes_on_2_and_on_no_mesh(runs, rule):
    """The (2, 2) run's step-3 checkpoint of an unfused rule's state
    (Adafactor's factored r and c in 2-D blocks, AdamW's m and v) resumed
    on (2,) and on no mesh: the uninterrupted run's losses, and the
    no-mesh run's params the reference's."""
    whole = _hist(runs, rule)["loss"]
    h = _hist(runs, f"{rule}_2")
    assert h["step"] == [3, 4, 5]
    np.testing.assert_allclose(h["loss"], whole[3:], **LOSS_TOL)
    d = runs["dir"] / f"{rule}_none"
    params = tree_map(torch.zeros_like, runs["init"]["danube"][1])
    res = run(make_spec(DANUBE, ckpt=str(d), every=3, **RUNS[rule]),
              params=params, device="cpu", log_fn=lambda s: None)
    assert res.history["step"] == [3, 4, 5]
    np.testing.assert_allclose(res.history["loss"], whole[3:], **LOSS_TOL)
    _params_close(params, runs["ref"][rule].params, f"{rule} resumed",
                  opt=rule)


def test_launcher_runs_unfused_rules_on_meshes(tmp_path):
    """``python -m repro_torch.launch.train --optimizer adamw --mesh-shape
    2 --virtual-devices 2`` and ``--optimizer adafactor --mesh-shape 2,2
    --virtual-devices 4`` (both at once) train on the CPU and checkpoint."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    procs = []
    for opt, shape, n in (("adamw", "2", 2), ("adafactor", "2,2", 4)):
        ck = tmp_path / opt
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               DANUBE, "--smoke", "--batch", "4", "--seq", "16", "--device",
               "cpu", "--steps", "2", "--optimizer", opt, "--mesh-shape",
               shape, "--virtual-devices", str(n), "--ckpt-dir", str(ck),
               "--ckpt-every", "2"]
        procs.append((ck, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=src))))
    for ck, proc in procs:
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, stderr[-2000:]
        assert stdout.count("final loss") == 1
        assert (ck / "step_000000002" / "_COMPLETE").exists()
