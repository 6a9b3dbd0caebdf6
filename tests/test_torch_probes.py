"""PyTorch port vs the JAX reference: the optimizer-health probes
(``repro_torch.telemetry.probes``) — each reduction on the same numpy-made
inputs within 1e-5 relative, the histogram's binning at and around its
edges, the pieces the port reduces over, the pre-step snapshot, and a smoke
h2o-danube run with ``observe`` on whose probe records equal the
reference's key by key, JSON types included."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as ref_opt_lib
from repro.core.api import GroupSpec as RefGroupSpec
from repro.core.api import Opt as RefOpt
from repro.core.api import no_decay_1d as ref_no_decay_1d
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro.telemetry import probes as RP
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.api import GroupSpec, Opt, no_decay_1d
from repro_torch.core.tree import tree_map
from repro_torch.data.pipeline import DataConfig
from repro_torch.run import ObservabilitySpec, run
from repro_torch.run import spec as spec_mod
from repro_torch.telemetry import probes as PP
from torch_parity import ARCH_ID, ref_params_and_copy, smoke_archs

RTOL = 1e-5


def _np_tree(seed: int) -> dict:
    """A params tree with a stack, a matrix, a 1-D leaf and a zero-init
    1-D leaf (numpy fp32)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"outer": {"emb": f(40, 24), "bias": np.zeros(24, np.float32)},
            "stacks": {"blocks": {"w": f(3, 24, 20), "scale": 1.0 + f(3, 20)
                                  * 0.1}}}


def _moved(tree: dict, seed: int) -> dict:
    """``tree`` with each unit (layer slice, or whole leaf) moved by a
    relative amount log-uniform in [1e-6, 1e-1], so the effective-lr values
    fall in several bins."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        stacked = path.startswith("stacks")
        units = x.shape[0] if stacked else 1
        rel = 10.0 ** rng.uniform(-6, -1, units).astype(np.float32)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        shape = (units,) + (1,) * (x.ndim - 1) if stacked else ()
        base = np.maximum(np.abs(x), 1e-3)
        return (x + rel.reshape(shape) * noise * base).astype(np.float32)

    def walk(t, prefix=""):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else move(prefix + k, v) for k, v in t.items()}
    return walk(tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _opts(groups: str):
    """An AdaLomo Opt in both packages with the same groups."""
    if groups == "no_decay":
        return (RefOpt(ref_opt_lib.get_rule("adalomo"),
                       groups=(ref_no_decay_1d(),)),
                Opt(opt_lib.get_rule("adalomo"), groups=(no_decay_1d(),)))
    # a regex group, a predicate group, and the default group
    return (RefOpt(ref_opt_lib.get_rule("adalomo"), groups=(
                RefGroupSpec("emb", match="emb"),
                RefGroupSpec("zero", match=lambda i: "bias" in i.path))),
            Opt(opt_lib.get_rule("adalomo"), groups=(
                GroupSpec("emb", match="emb"),
                GroupSpec("zero", match=lambda i: "bias" in i.path))))


@pytest.mark.parametrize("groups", ["no_decay", "three"])
def test_group_ratios_match_reference(groups):
    """Per-group ``‖Δθ‖/max(‖θ‖, eps2·√n)``, 'default' first; the
    zero-initialised bias group reports against the floor."""
    old = _np_tree(0)
    new = _moved(old, 1)
    ref_opt, opt = _opts(groups)
    want = RP.group_ratios(_jax(old), _jax(new), ref_opt)
    got = PP.group_ratios(_torch(old), _torch(new), opt)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    if groups == "three":
        # the zero group: ‖Δ‖ / (1e-3·√24), not ‖Δ‖ / 0
        d = np.linalg.norm(new["outer"]["bias"])
        np.testing.assert_allclose(float(got["zero"]),
                                   d / (1e-3 * 24 ** 0.5), rtol=RTOL)


def _edge_distance(rel: np.ndarray, edges: np.ndarray) -> float:
    v = np.log10(np.maximum(rel, 1e-30))
    return float(np.min(np.abs(v[:, None] - edges[None, :])))


@pytest.mark.parametrize("seed", [1, 2])
def test_effective_lr_hist_matches_reference(seed):
    """Counts equal (units of a stack counted one per layer), mean and max
    within 1e-5; no value lies within 1e-6 of an edge, so the equality
    does not hang on the last bit of an edge."""
    ospec = ObservabilitySpec(optimizer_every=1)
    old = _np_tree(0)
    new = _moved(old, seed)
    want = RP.effective_lr_hist(_jax(old), _jax(new),
                                RP.ObservabilitySpec(optimizer_every=1))
    got = PP.effective_lr_hist(_torch(old), _torch(new), ospec)
    # stacks contribute 3 units each, the other leaves one each
    assert got["n_units"] == int(want["n_units"]) == 2 + 3 + 3
    rel = np.concatenate([
        np.sqrt(np.mean((n - o).reshape(u, -1) ** 2, 1)) / np.maximum(
            np.sqrt(np.mean(o.reshape(u, -1) ** 2, 1)), 1e-3)
        for o, n, u in ((old["outer"]["bias"], new["outer"]["bias"], 1),
                        (old["outer"]["emb"], new["outer"]["emb"], 1),
                        (old["stacks"]["blocks"]["scale"],
                         new["stacks"]["blocks"]["scale"], 3),
                        (old["stacks"]["blocks"]["w"],
                         new["stacks"]["blocks"]["w"], 3))])
    assert _edge_distance(rel, np.asarray(jnp.linspace(-8, 0, 17))) > 1e-6
    assert got["counts"].dtype == torch.float32
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    assert float(got["counts"].sum()) == got["n_units"]
    assert (got["lo"], got["hi"]) == (want["lo"], want["hi"]) == (-8.0, 0.0)
    for k in ("rel_update_mean", "rel_update_max"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL)


def test_histogram_bins_like_jnp_histogram():
    """The edges of the default layout are jnp.linspace's bit for bit, and
    values on an edge, on the last edge, outside the range and NaN land
    where ``jnp.histogram`` puts them."""
    ospec = ObservabilitySpec(optimizer_every=1)
    edges = PP.hist_edges(ospec)
    want_edges = np.asarray(jnp.linspace(-8.0, 0.0, 17))
    np.testing.assert_array_equal(edges.numpy(), want_edges)
    x = np.array([-9.0, -8.0, -7.5, -7.25, -3.0, -2.9999, 0.0, 0.5, -0.5,
                  np.nan, -8.0001, -4.0, -4.0], np.float32)
    got = PP._histogram(torch.from_numpy(x), edges)
    want, _ = jnp.histogram(jnp.asarray(x), bins=jnp.asarray(want_edges))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rc(seed: int, lead: tuple, m: int, n: int):
    rng = np.random.default_rng(seed)
    r_old = rng.uniform(0.5, 2.0, lead + (m,)).astype(np.float32)
    c_old = rng.uniform(0.5, 2.0, lead + (n,)).astype(np.float32)
    # a non-rank-1 g²: its row/col marginals folded in by β
    g2 = rng.uniform(0.0, 3.0, lead + (m, n)).astype(np.float32) ** 3
    b = np.float32(0.9)
    r_new = (b * r_old + (1 - b) * g2.sum(-1)).astype(np.float32)
    c_new = (b * c_old + (1 - b) * g2.sum(-2)).astype(np.float32)
    return r_old, c_old, r_new, c_new


@pytest.mark.parametrize("lead,beta_kind", [((), "float"), ((3,), "float"),
                                            ((3,), "tensor")])
def test_transition_residual_matches_reference(monkeypatch, lead,
                                               beta_kind):
    """In blocks of rows (the piece size shrunk so a 20x24 matrix takes
    several), against the reference's whole-matrix residual."""
    monkeypatch.setattr(PP, "_CHUNK", 64)
    r_old, c_old, r_new, c_new = _rc(3, lead, 20, 24)
    want = RP.transition_residual(*map(jnp.asarray,
                                       (r_old, c_old, r_new, c_new)), 0.9)
    beta = torch.tensor(0.9) if beta_kind == "tensor" else 0.9
    got = PP.transition_residual(*map(torch.from_numpy,
                                      (r_old, c_old, r_new, c_new)), beta)
    assert float(want) > 1e-3           # a real residual, not noise
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_factorization_error_matches_reference(monkeypatch, lead):
    monkeypatch.setattr(PP, "_CHUNK", 50)
    rng = np.random.default_rng(4)
    v = rng.uniform(0.0, 2.0, lead + (18, 30)).astype(np.float32) ** 2
    want = RP.factorization_error(jnp.asarray(v))
    got = PP.factorization_error(torch.from_numpy(v))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_factored_health_samples_the_same_tensors(monkeypatch):
    """AdaLomo moments of a tree with stacked and plain matrices and a
    group forced unfactored: the same sampled keys (the largest by
    reconstructed size, ties by path), values within 1e-5."""
    monkeypatch.setattr(PP, "_CHUNK", 256)
    rng = np.random.default_rng(5)
    f = lambda *s: rng.uniform(0.1, 1.0, s).astype(np.float32)  # noqa: E731
    params = {"outer": {"emb": f(40, 24), "head": f(24, 40),
                        "dense": f(20, 20)},
              "stacks": {"blocks": {"w": f(3, 24, 20), "u": f(3, 20, 24)}}}
    groups = lambda G: (G("dense", match="dense", factored=False),)  # noqa
    ref_opt = RefOpt(ref_opt_lib.get_rule("adalomo"),
                     groups=groups(RefGroupSpec))
    opt = Opt(opt_lib.get_rule("adalomo"), groups=groups(GroupSpec))
    grads = _moved(params, 6)
    ospec = ObservabilitySpec(optimizer_every=1, sample_tensors=2)
    r_params, r_state = _jax(params), ref_opt.init(_jax(params))
    r_p2, r_s2 = ref_opt.step(r_params, _jax(grads), r_state, 1e-3)
    want = RP.factored_health(r_state.moments, r_s2.moments, 0.999,
                              RP.ObservabilitySpec(optimizer_every=1))
    p = _torch(params)
    s_old = opt.init(p)
    _, s_snap = PP.Snapshot().capture(p, s_old)
    _, s_new = opt.step(p, _torch(grads), s_old, 1e-3)
    got = PP.factored_health(s_snap.moments, s_new.moments, 0.999, ospec)
    assert sorted(got) == sorted(want)
    assert "fact_err/outer/dense" in got
    assert {k for k in got if k.startswith("recon/")} == {
        "recon/stacks/blocks/u", "recon/stacks/blocks/w"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)


def test_pieces_do_not_change_the_unit_sums(monkeypatch):
    """Per-unit sums over pieces of 7 elements (rows cut, rows grouped)
    equal the whole-unit sums within fp32 rounding, and float64 sums of
    the same values; a re-run is bitwise."""
    old = _np_tree(7)
    new = _moved(old, 8)
    o, n = (torch.from_numpy(t["stacks"]["blocks"]["w"]) for t in (old, new))
    whole = PP._unit_sq_sums(o, n, True)
    monkeypatch.setattr(PP, "_CHUNK", 7)
    cut = PP._unit_sq_sums(o, n, True)
    for a, b in zip(cut, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in
               zip(cut, PP._unit_sq_sums(o, n, True)))
    w = old["stacks"]["blocks"]["w"].reshape(3, -1).astype(np.float64)
    dw = new["stacks"]["blocks"]["w"].reshape(3, -1) - w
    np.testing.assert_allclose(whole[1].numpy(), (w ** 2).sum(1), rtol=1e-6)
    np.testing.assert_allclose(whole[0].numpy(), (dw ** 2).sum(1), rtol=1e-5)


def test_snapshot_reuses_its_buffers():
    """One allocation: a second capture copies into the same storage; the
    snapshot holds the values of the capture, not the live tensors'."""
    opt = opt_lib.get_opt("adalomo")
    params = _torch(_np_tree(9))
    state = opt.init(params)
    snap = PP.Snapshot()
    p1, s1 = snap.capture(params, state)
    ptrs = [b.data_ptr() for b in snap._bufs]
    assert snap.nbytes == sum(
        t.numel() * t.element_size() for t in
        PP._tensors((params, state.moments)) if t.is_floating_point())
    before = p1["outer"]["emb"].clone()
    params["outer"]["emb"].add_(1.0)
    assert torch.equal(p1["outer"]["emb"], before)
    assert s1.step is state.step
    p2, _ = snap.capture(params, state)
    assert [b.data_ptr() for b in snap._bufs] == ptrs
    assert torch.equal(p2["outer"]["emb"], params["outer"]["emb"])


# ------------------------------------------------------------- end to end

def _run_specs(total: int = 4):
    def mk(m, dc):
        return m.RunSpec(
            model=m.ModelSpec(ARCH_ID, smoke=True),
            data=dc(vocab=0, seq_len=32, global_batch=4, seed=3),
            # lr 3e-4: AdaLomo's clipped relative update sits at about
            # log10(3e-4) = -3.52, clear of the half-decade edges
            opt=m.OptSpec(name="adalomo", lr=3e-4, schedule="constant"),
            steps=m.StepSpec(total=total), seed=3, log_every=0,
            observe=m.ObservabilitySpec(optimizer_every=1,
                                        factored_every=2))
    from repro.data.pipeline import DataConfig as RefDataConfig
    return mk(ref_spec_mod, RefDataConfig), mk(spec_mod, DataConfig)


def _records(path) -> list:
    return [json.loads(line) for line in open(path)][1:]


def assert_records_match(port_recs, ref_recs, *, rtol=1e-4, atol=1e-5):
    """Record for record: the same keys, the same JSON types, numbers
    within the run tolerance (counts exactly)."""
    assert len(port_recs) == len(ref_recs)

    def same(a, b, where):
        assert type(a) is type(b), (where, a, b)
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif isinstance(a, float) and where.split("/")[-1] not in (
                "dt_s", "tokens_per_s", "lr"):
            if "counts" in where:
                assert a == b, where
            else:
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                           err_msg=where)
        elif not isinstance(a, float):
            assert a == b, where

    for i, (a, b) in enumerate(zip(port_recs, ref_recs)):
        same(a, b, f"record {i}")


def test_probe_records_match_reference_run(tmp_path):
    """A smoke h2o-danube run with ``observe`` on (no sentinel) in both
    packages from one set of weights: probe records at every step, the
    factored ones every 2, equal key by key with the same JSON types."""
    rspec, pspec = _run_specs()
    rm, pm = str(tmp_path / "r.jsonl"), str(tmp_path / "p.jsonl")
    ref_arch, _ = smoke_archs()
    ref_params, port_params = ref_params_and_copy(ref_arch)
    ref_run(dataclasses.replace(rspec, metrics_path=rm), params=ref_params,
            log_fn=lambda s: None)
    res = run(dataclasses.replace(pspec, metrics_path=pm),
              params=port_params, device="cpu", log_fn=lambda s: None)
    pr = [r for r in _records(pm) if "probe" in r]
    rr = [r for r in _records(rm) if "probe" in r]
    assert [(r["probe"], r["step"]) for r in pr] == [
        ("opt_health", 0), ("factored", 0), ("opt_health", 1),
        ("opt_health", 2), ("factored", 2), ("opt_health", 3)]
    assert_records_match(pr, rr)
    health = pr[0]
    assert sum(health["eff_lr"]["counts"]) == health["eff_lr"]["n_units"]
    assert all(np.isfinite(v) and v >= 0 for r in pr
               if r["probe"] == "factored"
               for k, v in r.items() if k.startswith("recon/"))
    assert res.program.snapshot is not None and res.program.snapshot.nbytes
