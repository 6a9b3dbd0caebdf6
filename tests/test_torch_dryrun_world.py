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
5e-4, atol 1e-5.

Last, the same world serves (``serve/sharded.py``): danube,
deepseek-moe-16b, deepseek-v3-671b (MLA) and paligemma-3b (a modality
prefix) on (1, 2), danube on (2,) and danube on (1, 2) under the baseline
plan, a prefill and greedy decode steps enough for the slot writes to
cross every block boundary of the ring, against the reference's
single-device ``make_prefill_step`` / ``make_decode_step`` from the same
weights (``tests/test_torch_legacy_serve.py``'s tolerance: rtol = atol =
1e-5): each rank's rows' logits, the greedy tokens, each rank's cache
block against its slice of the reference's cache, both ``model`` ranks'
logits bitwise equal; and each rank's dry trace of the same steps
against the live run."""
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
MLA, PREFIX = "deepseek-v3-671b", "paligemma-3b"
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
# the served cases: name: (arch, mesh, optimized, prompt tokens); each
# prompt's ring has W slots (danube's window 8, else the prompt, a modality
# prefix's 8 rows included), and W + 2 decode steps cross every block
# boundary of it and its wrap
SERVE = {"danube-1x2": (DANUBE, (1, 2), True, 12),
         "moe-1x2": (MOE, (1, 2), True, 8),
         "mla-1x2": (MLA, (1, 2), True, 8),
         "prefix-1x2": (PREFIX, (1, 2), True, 4),
         "danube-2": (DANUBE, (2,), True, 12),
         "danube-1x2-baseline": (DANUBE, (1, 2), False, 12)}
SERVE_B = 2
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dry_world")
    init, ref = {}, {}
    for arch in (DANUBE, MOE, MLA, PREFIX):
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
    prompts = {}
    for name, (arch, shape, optimized, S) in SERVE.items():
        prompts[name] = _prompt(arch, S)
        np.savez(d / f"prompt_{name}.npz", **prompts[name])
        cases.append({"kind": "serve", "arch": arch, "shape": list(shape),
                      "optimized": optimized, "init": init[arch][0],
                      "prompt": str(d / f"prompt_{name}.npz"),
                      "steps": _ring(arch, S) + 2,
                      "out": str(d / f"serve_{name}")})
    wait = start_world(2, str(d / "store"), cases)
    # the reference's single-device runs while the ranks run (the served
    # ones first: a run consumes its params)
    served = {}
    for name, (arch, _, _, S) in SERVE.items():
        served[name] = _ref_serve(arch, init[arch][2], prompts[name],
                                  _ring(arch, S) + 2)
    for arch in (DANUBE, MOE):
        ref[arch] = ref_run(make_spec(arch, total=STEPS,
                                      spec_mod=ref_spec_mod,
                                      data_cls=RefDataConfig),
                            params=init[arch][2], log_fn=lambda s: None)
    wait()
    out = {(name, r): json.loads(open(d / f"{name}.rank{r}.json").read())
           for name in MESHES for r in range(2)}
    out["dir"], out["init"], out["ref"] = d, init, ref
    for name in SERVE:
        for r in range(2):
            base = f"serve_{name}.rank{r}"
            out["serve", name, r] = (
                json.loads((d / f"{base}.json").read_text()),
                dict(np.load(d / f"{base}.npz")))
    out["served"] = served
    return out


def _ring(arch_id, S) -> int:
    """The slots of the ring a prompt of ``S`` tokens fills."""
    cfg = smoke_archs(arch_id)[1].cfg
    n = S + cfg.n_prefix_tokens
    return min(cfg.window, n) if cfg.window else n


def _prompt(arch_id, S) -> dict:
    """A global batch of ``SERVE_B`` prompts of ``S`` tokens (and a
    modality prefix's leaves), made with numpy from a seed."""
    cfg = smoke_archs(arch_id)[1].cfg
    rng = np.random.default_rng(S + len(arch_id))
    out = {"tokens": rng.integers(1, cfg.vocab, (SERVE_B, S)).astype(
        np.int32)}
    if cfg.n_prefix_tokens:
        out["prefix_embed"] = rng.standard_normal(
            (SERVE_B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        out["prefix_len"] = np.full((SERVE_B,), cfg.n_prefix_tokens,
                                    np.int32)
    return out


def _ref_serve(arch_id, params, prompt, steps) -> dict:
    """The reference's single-device prefill and ``steps`` greedy decode
    steps: each step's logits, the greedy tokens, and the cache after the
    prefill and after the last step (numpy)."""
    import jax
    import jax.numpy as jnp
    ref = smoke_archs(arch_id)[0]
    logits, cache = jax.jit(ref.make_prefill_step())(
        params, {k: jnp.asarray(v) for k, v in prompt.items()})
    host = lambda c: {k: np.asarray(v, np.float32)  # noqa: E731
                      for k, v in c.items()}
    out = {"logits": [np.asarray(logits)], "tokens": [],
           "first": host(cache)}
    decode = jax.jit(ref.make_decode_step())
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        out["tokens"].append(tok)
        logits, cache = decode(params, cache,
                               {"tokens": jnp.asarray(tok[:, None])})
        out["logits"].append(np.asarray(logits))
    out["last"] = host(cache)
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


# ---------------------------------------------------------------------
# sharded serving against the reference's single-device steps
# ---------------------------------------------------------------------

SERVE_RANKS = [(name, r) for name in SERVE for r in range(2)]


@pytest.mark.parametrize("name,rank", SERVE_RANKS)
def test_serve_logits_match_reference(world, name, rank):
    """Each rank's rows' last logits after the prefill and after every
    decode step."""
    meta, got = world["serve", name, rank]
    want = np.stack(world["served"][name]["logits"])
    lo, hi = meta["rows"]
    assert got["logits"].shape == want[:, lo:hi].shape
    np.testing.assert_allclose(got["logits"], want[:, lo:hi], **SERVE_TOL)


@pytest.mark.parametrize("name", SERVE)
def test_serve_greedy_tokens_equal_reference(world, name):
    want = np.stack(world["served"][name]["tokens"])
    for r in range(2):
        np.testing.assert_array_equal(world["serve", name, r][1]["tokens"],
                                      want)


@pytest.mark.parametrize("name", [n for n in SERVE if len(SERVE[n][1]) == 2])
def test_serve_model_ranks_bitwise_equal(world, name):
    """The ``model`` ranks hold the same rows: their logits are the same
    bits every step (the decode merge is one fixed-order sum on each)."""
    a, b = (world["serve", name, r][1]["logits"] for r in range(2))
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,rank", SERVE_RANKS)
def test_serve_cache_block_matches_reference(world, name, rank):
    """Each rank's block of the ring (rows over the batch axes, slots over
    ``model``) after the prefill and after the last decode step, against
    its slice of the reference's cache; ``pos`` and ``cur`` whole."""
    meta, got = world["serve", name, rank]
    (r0, r1), (s0, s1) = meta["rows"], meta["slots"]
    W = world["served"][name]["first"]["pos"].shape[0]
    if SERVE[name][1] == (1, 2):
        assert (s0, s1) == (rank * W // 2, (rank + 1) * W // 2)
    for when in ("first", "last"):
        want = world["served"][name][when]
        for k, v in want.items():
            g = got[f"{when}_{k}"]
            if v.ndim >= 3:
                np.testing.assert_allclose(g, v[:, r0:r1, s0:s1],
                                           **SERVE_TOL, err_msg=f"{when} {k}")
            else:
                np.testing.assert_array_equal(g, v, err_msg=f"{when} {k}")


@pytest.mark.parametrize("name,rank", SERVE_RANKS)
def test_serve_dry_equals_live(world, name, rank):
    """The dry trace of a rank's serving steps against its live run: the
    collectives call for call, each step's ``STATS`` and K4 partial
    launches (GQA: one a layer a decode step; MLA's partial softmax is
    plain), the resting param blocks and the cache block's bytes."""
    meta, _ = world["serve", name, rank]
    live, dry = meta["live"], meta["dry"]
    assert _calls(dry["log"]) == _calls(live["log"]) and live["log"]
    assert [c["wire_bytes"] for c in dry["log"]] == \
        [c["wire_bytes"] for c in live["log"]]
    for d, lv in zip(dry["steps"], live["steps"], strict=True):
        d = dict(d, stats={k: v for k, v in d["stats"].items()
                           if k != "staged_bytes"})
        lv = dict(lv, stats={k: v for k, v in lv["stats"].items()
                             if k != "staged_bytes"})
        assert d == lv
    layers = smoke_archs(SERVE[name][0])[1].cfg.n_layers
    want = 0 if name.startswith("mla") else layers
    assert [s["launches"].get("decode_attention_partial", 0)
            for s in live["steps"]] == [0] + [want] * (len(live["steps"]) - 1)
    assert dry["resting"] == live["resting"] > 0
    assert dry["cache"] == live["cache"] > 0
