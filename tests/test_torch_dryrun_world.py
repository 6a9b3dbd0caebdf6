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
plan; mamba2-1.3b on (1, 2) (its SSM heads split over ``model``) and on
(2,); zamba2-1.2b on (1, 2) into a ring wider than its prompt (the
padded layout, written across the block boundary and wrapped), on (2,)
and on (1, 2) under the baseline plan; whisper-base on (1, 2) with its 24
smoke frames split over ``model`` and with 25 (the cross cache whole on
every rank).  Each is a prefill and greedy decode steps enough for the
slot writes to cross every block boundary of the ring, against the
reference's single-device ``make_prefill_step`` / ``make_decode_step``
from the same weights (``tests/test_torch_legacy_serve.py``'s and
``tests/test_torch_{mamba2,hybrid,encdec}.py``'s tolerance: rtol = atol
= 1e-5): each rank's rows' logits (and whisper's encoder output), the
greedy tokens, each rank's cache block against its slice of the
reference's cache, both ``model`` ranks' logits bitwise equal; and each
rank's dry trace of the same steps against the live run."""
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
MAMBA, ZAMBA, WHISPER = "mamba2-1.3b", "zamba2-1.2b", "whisper-base"
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
# the served cases: name: (arch, mesh, optimized, prompt tokens, extra);
# extra's ``prefill`` are the prefill's keywords and ``cfg`` overrides of
# the smoke config (both in both packages), its ``steps`` the decode steps.
# Each prompt's ring has W slots (danube's window 8, zamba2's ``max_len``,
# whisper's ``max_decode_len``, else the prompt, a modality prefix's 8 rows
# included), and W + 2 decode steps cross every block boundary of it and
# its wrap; mamba2 has no ring and takes 4, and zamba2's cases whose ring
# is whole (2,) or is cut as in zamba2-1x2 (the baseline) take 3, enough
# to wrap.  whisper's prompt is its frames and one first token a row.
SERVE = {"danube-1x2": (DANUBE, (1, 2), True, 12, {}),
         "moe-1x2": (MOE, (1, 2), True, 8, {}),
         "mla-1x2": (MLA, (1, 2), True, 8, {}),
         "prefix-1x2": (PREFIX, (1, 2), True, 4, {}),
         "danube-2": (DANUBE, (2,), True, 12, {}),
         "danube-1x2-baseline": (DANUBE, (1, 2), False, 12, {}),
         "mamba2-1x2": (MAMBA, (1, 2), True, 8, {}),
         "mamba2-2": (MAMBA, (2,), True, 8, {}),
         # slots 6-11 rank 1's: the prompt fills 6 and 7, decode 8-11,
         # then wraps into rank 0's 0-5 and back
         "zamba2-1x2": (ZAMBA, (1, 2), True, 8,
                        {"prefill": {"max_len": 12}}),
         "zamba2-2": (ZAMBA, (2,), True, 8, {"steps": 3}),
         "zamba2-1x2-baseline": (ZAMBA, (1, 2), False, 8, {"steps": 3}),
         # 24 frames, 12 a rank; rank 1's half of the ring empty until
         # step 4
         "whisper-1x2": (WHISPER, (1, 2), True, 1,
                         {"prefill": {"max_decode_len": 8}}),
         # 25 frames: the model axis does not divide them
         "whisper-1x2-whole": (WHISPER, (1, 2), True, 1,
                               {"prefill": {"max_decode_len": 8},
                                "cfg": {"n_frames": 25}})}
SERVE_B = 2
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dry_world")
    init, ref = {}, {}
    for arch in (DANUBE, MOE, MLA, PREFIX, MAMBA, ZAMBA, WHISPER):
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
    for name, (arch, shape, optimized, S, extra) in SERVE.items():
        prompts[name] = _prompt(name)
        np.savez(d / f"prompt_{name}.npz", **prompts[name])
        cases.append({"kind": "serve", "arch": arch, "shape": list(shape),
                      "optimized": optimized, "init": init[arch][0],
                      "prompt": str(d / f"prompt_{name}.npz"),
                      "steps": _steps(name), **extra,
                      "out": str(d / f"serve_{name}")})
    wait = start_world(2, str(d / "store"), cases)
    # the reference's single-device runs while the ranks run (the served
    # ones first: a run consumes its params)
    served, refs = {}, {}
    for name, (arch, _, _, S, extra) in SERVE.items():
        # cases of one arch, prompt and keywords share one reference
        key = (arch, S, json.dumps(extra, sort_keys=True))
        if key not in refs:
            refs[key] = _ref_serve(name, init[arch][2], prompts[name])
        served[name] = refs[key]
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


def _cfg(name):
    """The port's smoke config of a served case, with its overrides."""
    arch, *_, extra = SERVE[name]
    return smoke_archs(arch, **extra.get("cfg", {}))[1].cfg


def _steps(name) -> int:
    """A served case's decode steps: its ``steps``, else W + 2 over a ring
    of W slots (its prefill's ``max_len`` or ``max_decode_len``, a window,
    or the prompt with its modality prefix), 4 with no ring."""
    arch, _, _, S, extra = SERVE[name]
    cfg, kw = _cfg(name), extra.get("prefill", {})
    if "steps" in extra:
        return extra["steps"]
    if arch == MAMBA:
        return 4
    W = kw.get("max_len") or kw.get("max_decode_len")
    if W is None:
        n = S + getattr(cfg, "n_prefix_tokens", 0)
        W = min(cfg.window, n) if getattr(cfg, "window", None) else n
    return W + 2


def _prompt(name) -> dict:
    """A served case's global batch of ``SERVE_B`` prompts of ``S`` tokens
    (and a modality prefix's leaves; an encoder-decoder's frames and ``S``
    first tokens), made with numpy from a seed."""
    arch_id, _, _, S, _ = SERVE[name]
    cfg = _cfg(name)
    rng = np.random.default_rng(S + len(arch_id))
    out = {"tokens": rng.integers(1, cfg.vocab, (SERVE_B, S)).astype(
        np.int32)}
    if getattr(cfg, "n_prefix_tokens", 0):
        out["prefix_embed"] = rng.standard_normal(
            (SERVE_B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        out["prefix_len"] = np.full((SERVE_B,), cfg.n_prefix_tokens,
                                    np.int32)
    if hasattr(cfg, "n_frames"):
        out["frames"] = rng.standard_normal(
            (SERVE_B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _ref_serve(name, params, prompt) -> dict:
    """The reference's single-device prefill and the case's greedy decode
    steps: each step's logits (an encoder-decoder's prefill output apart,
    its first tokens the prompt's), the greedy tokens, and the cache after
    the prefill and after the last step (numpy)."""
    import jax
    import jax.numpy as jnp
    arch_id, *_, extra = SERVE[name]
    ref = smoke_archs(arch_id, **extra.get("cfg", {}))[0]
    prefill = jax.jit(ref.make_prefill_step(**extra.get("prefill", {})))
    batch = {k: jnp.asarray(v) for k, v in prompt.items()}
    host = lambda c: {k: np.asarray(v, np.float32)  # noqa: E731
                      for k, v in c.items()}
    out = {"logits": [], "tokens": []}
    if ref.family == "encdec":
        enc, cache = prefill(params, {"frames": batch["frames"]})
        out["enc_out"] = np.asarray(enc)
        tok = prompt["tokens"][:, 0]
    else:
        logits, cache = prefill(params, batch)
        out["logits"].append(np.asarray(logits))
    out["first"] = host(cache)
    decode = jax.jit(ref.make_decode_step())
    for i in range(_steps(name)):
        if out["logits"]:
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
    decode step (an encoder-decoder's after every decode step)."""
    meta, got = world["serve", name, rank]
    want = np.stack(world["served"][name]["logits"])
    lo, hi = meta["rows"]
    assert got["logits"].shape == want[:, lo:hi].shape
    np.testing.assert_allclose(got["logits"], want[:, lo:hi], **SERVE_TOL)


@pytest.mark.parametrize("name,rank", [(n, r) for n, r in SERVE_RANKS
                                       if SERVE[n][0] == WHISPER])
def test_serve_encoder_output_matches_reference(world, name, rank):
    """whisper's prefill: each rank's rows of the encoder's output over
    every frame (encoded on a tile of the frames, or whole where the model
    axis does not divide them)."""
    meta, got = world["serve", name, rank]
    lo, hi = meta["rows"]
    want = world["served"][name]["enc_out"][lo:hi]
    assert got["enc_out"].shape == want.shape
    np.testing.assert_allclose(got["enc_out"], want, **SERVE_TOL)


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


def _dim2_block(n: int, shape: tuple, rank: int) -> tuple:
    """``rules.cache_pspecs``' block of a cache leaf's dim 2 of ``n`` on
    this rank: split over ``model`` where the axis divides it."""
    tp = shape[-1] if len(shape) > 1 else 1
    if tp > 1 and n % tp == 0 and n > 1:
        k = n // tp
        return (rank % tp) * k, (rank % tp + 1) * k
    return 0, n


@pytest.mark.parametrize("name,rank", SERVE_RANKS)
def test_serve_cache_block_matches_reference(world, name, rank):
    """Each rank's block of the cache (rows over the batch axes; dim 2 —
    a ring's slots, mamba's SSM heads, whisper's frames — over ``model``
    where the axis divides it) after the prefill and after the last decode
    step, against its slice of the reference's cache; ``pos`` and ``cur``
    whole."""
    meta, got = world["serve", name, rank]
    (r0, r1), shape = meta["rows"], SERVE[name][1]
    first = world["served"][name]["first"]
    if "pos" in first:
        W = first["pos"].shape[0]
        s0, s1 = meta["slots"]
        assert (s0, s1) == _dim2_block(W, shape, rank)
        if shape == (1, 2):
            assert (s0, s1) == (rank * W // 2, (rank + 1) * W // 2)
    for when in ("first", "last"):
        want = world["served"][name][when]
        for k, v in want.items():
            g = got[f"{when}_{k}"]
            if v.ndim >= 3:
                b0, b1 = _dim2_block(v.shape[2], shape, rank)
                np.testing.assert_allclose(g, v[:, r0:r1, b0:b1],
                                           **SERVE_TOL, err_msg=f"{when} {k}")
            else:
                np.testing.assert_array_equal(g, v, err_msg=f"{when} {k}")


def _decode_launches(name) -> dict:
    """The K4 launches of one decode step of a served case on a rank: the
    partial entry once a GQA layer (none for MLA's plain partial softmax,
    none for mamba2), once an application of zamba2's shared block, twice
    a whisper decoder layer where the model axis splits the frames (the
    self ring and the cross cache), else once and the whole-ring entry
    once (the cross cache whole)."""
    arch, shape = SERVE[name][:2]
    cfg = _cfg(name)
    if arch == MAMBA or arch == MLA:
        return {}
    if arch == ZAMBA:
        return {"decode_attention_partial": cfg.n_attn_applications()}
    if arch == WHISPER:
        n = cfg.n_dec_layers
        if _dim2_block(cfg.n_frames, shape, 0)[1] < cfg.n_frames:
            return {"decode_attention_partial": 2 * n}
        return {"decode_attention_partial": n, "decode_attention": n}
    return {"decode_attention_partial": cfg.n_layers}


@pytest.mark.parametrize("name,rank", SERVE_RANKS)
def test_serve_dry_equals_live(world, name, rank):
    """The dry trace of a rank's serving steps against its live run: the
    collectives call for call, each step's ``STATS`` and K4 launches
    (:func:`_decode_launches`; none in a prefill), the resting param blocks
    and the cache block's bytes."""
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
    assert [s["launches"] for s in live["steps"]] == \
        [{}] + [_decode_launches(name)] * (len(live["steps"]) - 1)
    assert dry["resting"] == live["resting"] > 0
    assert dry["cache"] == live["cache"] > 0
