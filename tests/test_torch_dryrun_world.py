"""The dry run against a live run of the same spec, and the baseline
sharding (``MeshSpec.optimized=False``) against the reference: one world
of two ``gloo`` ranks (``_torch_elastic_worker.start_world``).

First each rank runs one fused AdaLomo step of danube's smoke config on
(2,) and then on (1, 2), under the optimized plan and under the baseline
plan, and traces its own rank of the same spec on the meta device
(``launch/dryrun.py::trace_train``).  On each rank the dry plan equals the
live run: the collectives call for call (kind, operand shape, dtype, mesh
axes), their ``STATS`` (``staged_bytes`` apart: gloo stages nothing of a
CPU tensor), the K1/K2 launches (the live run's plain updates counted as
the kernel entries the card's path takes for them) and the resting bytes
(the rank's real shards).

Then the same world trains danube on both meshes under both plans, and
deepseek-moe-16b on (1, 2) under the baseline, 4 steps each from the
reference's weights, while this process runs the reference's
single-device run of the same specs.  The baseline holds the reference
and the optimized plan at the reference's sharded tolerance
(``tests/distribution/_dist_script.py``): loss rtol 1e-5; params rtol
5e-4, atol 1e-5."""
import json

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import tree_flatten_with_path
from torch_parity import assert_trees_close, ref_params_and_copy, smoke_archs
from _torch_elastic_worker import make_spec, start_world

DANUBE, MOE = "h2o-danube-1.8b", "deepseek-moe-16b"
# name: (mesh, optimized)
MESHES = {"2": ((2,), True), "1x2": ((1, 2), True),
          "2-baseline": ((2,), False), "1x2-baseline": ((1, 2), False)}
# the trained runs: name: (arch, mesh, optimized)
RUNS = {"danube-2-baseline": (DANUBE, (2,), False),
        "danube-1x2-baseline": (DANUBE, (1, 2), False),
        "danube-2": (DANUBE, (2,), True),
        "danube-1x2": (DANUBE, (1, 2), True),
        "moe-1x2-baseline": (MOE, (1, 2), False)}
STEPS = 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dry_world")
    init, ref = {}, {}
    for arch in (DANUBE, MOE):
        ref_params, port_params = ref_params_and_copy(smoke_archs(arch)[0])
        init[arch] = (str(d / f"init_{arch}.pt"), port_params, ref_params)
        torch.save(port_params, init[arch][0])
    cases = [{"kind": "dry_vs_live", "arch": DANUBE, "shape": list(shape),
              "optimized": optimized, "out": str(d / name)}
             for name, (shape, optimized) in MESHES.items()]
    cases += [{"kind": "run", "arch": arch, "shape": list(shape),
               "optimized": optimized, "total": STEPS, "every": STEPS,
               "ckpt": str(d / name), "init": init[arch][0],
               "out": str(d / f"{name}.json")}
              for name, (arch, shape, optimized) in RUNS.items()]
    wait = start_world(2, str(d / "store"), cases)
    # the reference's single-device runs while the ranks run
    for arch in (DANUBE, MOE):
        ref[arch] = ref_run(make_spec(arch, total=STEPS,
                                      spec_mod=ref_spec_mod,
                                      data_cls=RefDataConfig),
                            params=init[arch][2], log_fn=lambda s: None)
    wait()
    out = {(name, r): json.loads(open(d / f"{name}.rank{r}.json").read())
           for name in MESHES for r in range(2)}
    out["dir"], out["init"], out["ref"] = d, init, ref
    return out


def _calls(log):
    return [(c["kind"], c["shape"], c["dtype"], c["axes"]) for c in log]


CASES = [(m, r) for m in MESHES for r in range(2)]


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_collectives_equal_live_call_for_call(world, mesh, rank):
    got = world[mesh, rank]
    assert got["live"]["log"]
    assert _calls(got["dry"]["log"]) == _calls(got["live"]["log"])
    assert [c["wire_bytes"] for c in got["dry"]["log"]] == \
        [c["wire_bytes"] for c in got["live"]["log"]]


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_stats_equal_live(world, mesh, rank):
    got = world[mesh, rank]
    live, dry = dict(got["live"]["stats"]), dict(got["dry"]["stats"])
    live.pop("staged_bytes")
    assert dry.pop("staged_bytes") == 0
    assert dry == live and live["calls"] > 0


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_launches_equal_live(world, mesh, rank):
    got = world[mesh, rank]
    assert got["dry"]["launches"] == got["live"]["launches"]
    assert got["live"]["launches"].get("adalomo_stats_partial", 0) > 0


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_resting_equals_real_shards(world, mesh, rank):
    got = world[mesh, rank]
    assert got["dry"]["resting"] == got["live"]["resting"] > 0


@pytest.mark.parametrize("mesh,rank", [(m, r) for m in ("2", "1x2")
                                       for r in range(2)])
def test_baseline_rests_and_launches_as_the_optimized_plan(world, mesh,
                                                           rank):
    """The baseline plan's params and state rest where the optimized
    plan's do, and its update takes the same K1/K2 entries; what differs
    is its collectives: no K/V gathered over ``model``, and each whole
    gradient all-reduced where the optimized plan reduce-scatters."""
    opt, base = world[mesh, rank], world[f"{mesh}-baseline", rank]
    assert base["live"]["resting"] == opt["live"]["resting"]
    assert base["live"]["launches"] == opt["live"]["launches"]
    assert "reduce_scatter" not in {c["kind"] for c in base["live"]["log"]}
    assert base["live"]["stats"]["scatter_bytes"] == 0
    if mesh == "1x2":
        # the params alone are gathered over model: no K/V tile
        assert base["live"]["stats"]["gather_bytes"] < \
            opt["live"]["stats"]["gather_bytes"]


def _hist(world, name):
    return json.loads((world["dir"] / f"{name}.json").read_text())


def _ckpt_params(world, name, arch):
    """The whole params a run's final checkpoint holds."""
    like = world["init"][arch][1]
    _, tree, _ = CheckpointManager(world["dir"] / name).restore(
        STEPS, template=(like, get_opt("adalomo").init(like)))
    return tree[0]


@pytest.mark.parametrize("mesh", ["2", "1x2"])
def test_baseline_matches_reference(world, mesh):
    """danube under the baseline plan on (2,) and on (1, 2): losses and
    final params against the reference's single-device run."""
    name = f"danube-{mesh}-baseline"
    ref = world["ref"][DANUBE]
    h = _hist(world, name)
    assert h["step"] == list(range(STEPS)) and h["tile"] is None
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    assert_trees_close(_ckpt_params(world, name, DANUBE), ref.params,
                       what=name, **PARAM_TOL)


@pytest.mark.parametrize("mesh", ["2", "1x2"])
def test_baseline_matches_optimized_plan(world, mesh):
    """The baseline against the port's optimized plan on the same mesh:
    losses and final params within the sharded tolerance."""
    base, opt = f"danube-{mesh}-baseline", f"danube-{mesh}"
    assert _hist(world, opt)["tile"] == ([8, 16] if mesh == "1x2"
                                         else None)
    np.testing.assert_allclose(_hist(world, base)["loss"],
                               _hist(world, opt)["loss"], **LOSS_TOL)
    a = _ckpt_params(world, base, DANUBE)
    b = _ckpt_params(world, opt, DANUBE)
    if mesh == "2":
        # no model axis: each gradient element is the same fp32 sum over
        # the two ranks in rank order, all-reduced or reduce-scattered
        assert _hist(world, base)["loss"] == _hist(world, opt)["loss"]
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
            tree_flatten_with_path(a), tree_flatten_with_path(b)))
    for (path, x), (_, y) in zip(tree_flatten_with_path(a),
                                 tree_flatten_with_path(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=str(path),
                                   **PARAM_TOL)


def test_moe_baseline_counts_the_router_once(world):
    """deepseek-moe-16b under the baseline on (1, 2): both model ranks
    run every expert on the same rows, the load-balance loss is the
    batch's mean (its backward divides by the batch ranks alone), and
    losses and params hold the reference's single-device run; every
    expert stack is gathered whole over ``model``."""
    name = "moe-1x2-baseline"
    ref = world["ref"][MOE]
    h = _hist(world, name)
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    assert all(a > 0 for a in h["aux"])
    gathers = {(a, k): n for a, k, n in h["gathers"]}
    assert gathers.get(("model", "expert"), 0) > 0
    assert_trees_close(_ckpt_params(world, name, MOE), ref.params,
                       what=name, **PARAM_TOL)
