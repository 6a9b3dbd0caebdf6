"""PyTorch port vs the JAX reference: the baseline optimizer rules of
``core/optimizers.py`` — SGD with momentum (paper Eq. 3), SGD with variance
(Eq. 4), AdamW and Adafactor — beside AdaLomo, LOMO and SGD.

Every rule of the registry goes through ``Opt.step`` on the danube smoke
tree (stacked ``[L, ...]`` and unstacked leaves) for 1 and 3 steps against
``repro.core.optimizers``; the fused step equals the unfused one within the
port and the reference's fused step; the grouped no-decay hparams, the
Table-1 state-byte ordering, the registry's errors and bf16 parameters are
held as the reference's own tests hold them."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import optimizers as ref_opt
from repro_torch.convert import opt_state_from_numpy, to_numpy
from repro_torch.core import api, optimizers as opt_lib, tree as tree_lib
from repro_torch.core.tree import tree_flatten_with_path, tree_map
from torch_parity import (CPU, assert_trees_close, convert_opt_state,
                          jax_batch, make_batch, np_f32, ref_params_and_copy,
                          smoke_archs, torch_batch)

RULES = sorted(ref_opt.REGISTRY)
NEW_RULES = ["adafactor", "adamw", "sgd_momentum", "sgd_variance"]

# fp32 unfused steps: the tolerances of test_torch_opt_api's unfused test.
UNFUSED_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=3e-5, atol=1e-7)
# tests/core/test_fused.py::_assert_trees_close (fused vs unfused).
FUSED_TOL = dict(rtol=5e-4, atol=5e-6)
# one bf16 rounding at the write (the reference's bf16 kernel tolerance)
BF16_TOL = 5e-3


def _hp(name: str, **over) -> dict:
    """Call-time hparams that move every rule's dynamic knobs off their
    defaults where the rule has them."""
    hp = {"lr": 1e-3}
    extra = {"adalomo": {"beta": 0.99, "weight_decay": 0.1},
             "adamw": {"beta1": 0.8, "beta2": 0.99, "weight_decay": 0.1},
             "adafactor": {"decay_rate": 0.7, "weight_decay": 0.1,
                           "clip": 0.5},
             "sgd_momentum": {"beta1": 0.8},
             "sgd_variance": {"beta2": 0.99, "eps": 1e-6}}
    return {**hp, **extra.get(name, {}), **over}


def _grads(rng, ref_params, scale=0.1):
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * scale).astype(np.float32),
        jax.device_get(ref_params))


def _assert_states_close(port_state, ref_state, tol=STATE_TOL):
    conv = convert_opt_state(ref_state)
    assert int(port_state.step) == int(conv.step)
    for (kp, a), (_, b) in zip(tree_flatten_with_path(port_state.moments),
                               tree_flatten_with_path(conv.moments)):
        assert type(a) is type(b), "/".join(kp)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(np_f32(x), np_f32(y),
                                           err_msg="/".join(kp), **tol)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("name", RULES)
def test_unfused_step_matches_reference(name, n_steps):
    """``Opt.step`` over the smoke tree — ``stacks`` leaves with
    ``batch_dims=1`` where the reference vmaps — on numpy-made gradients,
    fp32: params to rtol 1e-5 / atol 1e-6, state to rtol 3e-5."""
    ref_arch, _ = smoke_archs()
    ref_params, port_params = ref_params_and_copy(ref_arch)
    ropt, popt = ref_opt.get_opt(name), opt_lib.get_opt(name)
    rstate, pstate = ropt.init(ref_params), popt.init(port_params)
    hp = _hp(name)
    rng = np.random.default_rng(7)
    rp = ref_params
    for _ in range(n_steps):
        g = _grads(rng, ref_params)
        rp, rstate = ropt.step(rp, jax.tree.map(jnp.asarray, g), rstate, hp)
        out, pstate = popt.step(port_params, jax.tree.map(torch.from_numpy, g),
                                pstate, hp)
        assert out is port_params                              # in place
    assert int(pstate.step) == n_steps
    assert_trees_close(port_params, rp, what=name, **UNFUSED_TOL)
    _assert_states_close(pstate, rstate)


@pytest.mark.parametrize("name", NEW_RULES)
def test_state_layout_matches_reference(name):
    """Same paths, the same NamedTuple per leaf (the reference's field
    names), the same shapes, fp32; and the state-byte count."""
    ref_arch, _ = smoke_archs()
    ref_params, port_params = ref_params_and_copy(ref_arch)
    ropt, popt = ref_opt.get_opt(name), opt_lib.get_opt(name)
    rstate, pstate = ropt.init(ref_params), popt.init(port_params)
    conv = convert_opt_state(rstate)
    pflat = tree_flatten_with_path(pstate.moments)
    for (pk, ps), (_, cs) in zip(pflat, tree_flatten_with_path(conv.moments)):
        assert type(ps) is type(cs) and ps._fields == cs._fields
        for a, b in zip(ps, cs):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.shape == b.shape and a.dtype == torch.float32
    assert popt.state_bytes(port_params) == ropt.state_bytes(ref_params)
    if name == "adafactor":                       # per-layer [L, m] / [L, d]
        m = pstate.moments["stacks"]["blocks"]
        assert m["attn"]["wq"].r.shape == (2, 64)
        assert m["ln1"]["scale"].v.shape == (2, 64)


def test_adafactor_statistics_rms_and_factoring_are_per_layer_slice():
    """A stacked ``[L, d]`` leaf with L ≥ 16 is L 1-D tensors (unfactored v,
    RMS over d), never one L × d matrix; a stacked ``[L, m, n]`` leaf is
    factored per slice with per-slice RMS.  Held against the reference's
    ``jax.vmap`` of the rule over L, 3 steps."""
    rng = np.random.default_rng(3)
    rref, rport = ref_opt.adafactor(), opt_lib.adafactor()
    hp = _hp("adafactor")
    for shape in [(20, 32), (3, 24, 40)]:
        p = rng.standard_normal(shape).astype(np.float32)
        p[0] *= 30.0               # slices of very different scale
        ps = rport.init(torch.from_numpy(p), batch_dims=1)
        rs = jax.vmap(rref.init)(jnp.asarray(p))
        if len(shape) == 2:
            assert ps.v is not None and ps.v.shape == shape
            assert rport.init(torch.from_numpy(p)).v is None   # as a matrix
        else:
            assert ps.r.shape == shape[:2] and ps.c.shape == (3, 40)
        pt, rp = torch.from_numpy(p.copy()), jnp.asarray(p)
        for step in (1.0, 2.0, 3.0):
            g = rng.standard_normal(shape).astype(np.float32)
            stepf = jnp.float32(step)
            rp, rs = jax.vmap(lambda pi, gi, si: rref.update(
                pi, gi, si, hp, stepf))(rp, jnp.asarray(g), rs)
            rport.update(pt, torch.from_numpy(g), ps,
                         api.hparams_on_device((hp,), CPU)[0],
                         torch.tensor(step), batch_dims=1)
        np.testing.assert_allclose(np_f32(pt), np_f32(rp), **UNFUSED_TOL)
        for a, b in zip(ps, rs):
            if a is not None:
                np.testing.assert_allclose(np_f32(a), np_f32(b), **STATE_TOL)


def _fused_vs_unfused(name, groups_mod=None, hp=None):
    """One port fused step, one port unfused step and one reference fused
    step from the same weights and batch."""
    ref_arch, port_arch = smoke_archs()
    ref_params, p_fused = ref_params_and_copy(ref_arch)
    _, p_unfused = ref_params_and_copy(ref_arch)
    batch = make_batch(ref_arch.cfg.vocab, 2, 16, seed=1)
    hp = hp or {"lr": 1e-3}

    def groups(mod):
        if groups_mod is None:
            return ()
        return (mod.no_decay_1d(),
                mod.GroupSpec("embed", match="outer/", hparams={"lr": 1e-4}))

    ropt = ref_opt.get_opt(name, groups=groups(ref_api))
    popt = opt_lib.get_opt(name, groups=groups(api))
    rp, rs, rloss, _ = jax.jit(lambda p, s, b: ref_arch.make_fused_train_step(
        ropt)(p, s, b, hparams=hp))(ref_params, ropt.init(ref_params),
                                    jax_batch(batch))
    fs = popt.init(p_fused)
    _, fs, floss, _ = port_arch.make_fused_train_step(popt)(
        p_fused, fs, torch_batch(batch), hparams=hp)
    loss_fn = port_arch.make_loss_fn()
    p_req = tree_map(lambda t: t.detach().requires_grad_(True), p_unfused)
    uloss, _ = loss_fn(p_req, torch_batch(batch))
    leaves = [t for _, t in tree_flatten_with_path(p_req)]
    it = iter(torch.autograd.grad(uloss, leaves))
    grads = tree_map(lambda _: next(it), p_req)
    _, us = popt.step(p_unfused, grads, popt.init(p_unfused), hp)
    uloss = uloss.detach()
    np.testing.assert_allclose(float(floss), float(uloss), rtol=1e-5)
    np.testing.assert_allclose(float(floss), float(rloss), rtol=1e-5)
    assert int(fs.step) == int(us.step) == 1
    assert_trees_close(p_fused, rp, what=f"{name} fused vs ref", **FUSED_TOL)
    for (kp, a), (_, b) in zip(tree_flatten_with_path(p_fused),
                               tree_flatten_with_path(p_unfused)):
        np.testing.assert_allclose(np_f32(a), np_f32(b), err_msg="/".join(kp),
                                   **FUSED_TOL)
    _assert_states_close(fs, rs, FUSED_TOL)


@pytest.mark.parametrize("name", RULES)
def test_fused_equals_unfused_and_reference(name):
    """tests/core/test_fused.py::test_fused_equals_unfused_updates for the
    port: fused == unfused, and the fused step == the reference's, at
    rtol 5e-4 / atol 5e-6."""
    _fused_vs_unfused(name)


@pytest.mark.parametrize("name", ["adalomo", "adamw"])
def test_fused_equals_unfused_grouped_hparams(name):
    """No decay on 1-D leaves (``no_decay_1d``: a stacked ``[L, d]`` norm
    scale counts as 1-D) and a per-group lr, with weight decay 0.1: the
    same per-tensor updates fused, unfused and in the reference."""
    _fused_vs_unfused(name, groups_mod=True,
                      hp={"lr": 1e-3, "weight_decay": 0.1})


@pytest.mark.parametrize("name", ["adalomo", "adamw"])
def test_no_decay_group_exempts_1d_leaves(name):
    """With lr 0-ish updates cancelled out (zero gradients), only the decay
    moves θ: the 1-D leaves stay bitwise, the matrices shrink."""
    _, port_arch = smoke_archs()
    params = port_arch.init_params(0, device="cpu")
    before = tree_map(torch.clone, params)
    opt = opt_lib.get_opt(name, groups=(api.no_decay_1d(),))
    state = opt.init(params)
    zeros = tree_map(torch.zeros_like, params)
    opt.step(params, zeros, state, {"lr": 0.1, "weight_decay": 0.5})
    for (kp, a), (_, b) in zip(tree_flatten_with_path(params),
                               tree_flatten_with_path(before)):
        per_tensor_ndim = a.ndim - (kp[0] == "stacks")
        if per_tensor_ndim <= 1:
            assert torch.equal(a, b), "/".join(kp)
        else:
            assert not torch.equal(a, b), "/".join(kp)


def test_table1_state_byte_ordering():
    """tests/core/test_optimizers.py::test_table1_state_byte_ordering:
    AdamW state ≫ Adafactor = AdaLomo state ≫ LOMO's (none)."""
    p = torch.zeros((1024, 1024), dtype=torch.bfloat16)
    adamw_b = opt_lib.adamw().state_bytes(p)
    adaf_b = opt_lib.adafactor().state_bytes(p)
    adal_b = opt_lib.adalomo().state_bytes(p)
    assert adamw_b == 2 * 1024 * 1024 * 4
    assert adal_b == adaf_b == (1024 + 1024) * 4
    assert opt_lib.sgd().state_bytes(p) == 0
    assert opt_lib.sgd_momentum().state_bytes(p) == 1024 * 1024 * 4
    assert opt_lib.sgd_variance().state_bytes(p) == 1024 * 1024 * 4
    assert adal_b < adamw_b / 500
    for name in RULES:
        rule_p = opt_lib.get_rule(name)
        rule_r = ref_opt.get_rule(name)
        assert rule_p.state_bytes(p) == rule_r.state_bytes(
            jnp.zeros((1024, 1024), jnp.bfloat16)), name


def test_registry_and_get_rule_errors():
    assert sorted(opt_lib.REGISTRY) == sorted(ref_opt.REGISTRY)
    assert len(opt_lib.REGISTRY) == 7
    with pytest.raises(KeyError, match="unknown optimizer") as ei:
        opt_lib.get_rule("madgrad")
    assert all(n in str(ei.value) for n in NEW_RULES)
    with pytest.raises(KeyError) as ei:
        opt_lib.get_rule("lomo", weight_decay=0.1)
    msg = str(ei.value)
    assert "weight_decay" in msg and "accepted" in msg and "lr" in msg
    assert opt_lib.get_rule("adamw", weight_decay=0.1).hparams[
        "weight_decay"] == 0.1
    for name in RULES:
        assert (opt_lib.get_rule(name).hparams
                == ref_opt.get_rule(name).hparams), name
    with pytest.raises(KeyError, match="accepted hyperparameters"):
        opt_lib.get_opt("adamw").resolve({"lr": 0.1, "momentum": 0.9})


def test_adamw_matches_manual_step():
    """tests/core/test_optimizers.py::test_adamw_matches_manual_step."""
    p = torch.tensor([[1.0, -2.0]])
    g = torch.tensor([[0.5, 0.25]])
    rule = opt_lib.adamw(beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1)
    s = rule.init(p)
    expect = (p * (1 - 0.1 * 0.1)
              - 0.1 * (0.1 * g / 0.1) / (torch.sqrt(0.01 * g ** 2 / 0.01)
                                         + 1e-8))
    rule.update(p, g, s, {**rule.hparams, "lr": 0.1}, torch.tensor(1.0))
    np.testing.assert_allclose(p.numpy(), expect.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", NEW_RULES)
def test_bf16_params_within_5e3(name):
    """bf16 θ at ``(16, 4096)`` against the reference's bf16 θ, 3 steps:
    fp32 arithmetic and one cast at the write keep them within 5e-3 (an
    intermediate cast exceeds it first at this shape)."""
    rng = np.random.default_rng(11)
    shape = (16, 4096)
    p = rng.standard_normal(shape).astype(np.float32)
    rrule, prule = ref_opt.get_rule(name), opt_lib.get_rule(name)
    rp = jnp.asarray(p, jnp.bfloat16)
    pt = torch.from_numpy(p).to(torch.bfloat16)
    rs, ps = rrule.init(rp), prule.init(pt)
    hp = {**rrule.hparams, **_hp(name)}
    for step in (1.0, 2.0, 3.0):
        g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        rp, rs = rrule.update(rp, jnp.asarray(g, jnp.bfloat16), rs, hp,
                              jnp.float32(step))
        prule.update(pt, torch.from_numpy(g).to(torch.bfloat16), ps,
                     api.hparams_on_device((hp,), CPU)[0],
                     torch.tensor(step))
    assert pt.dtype == torch.bfloat16
    np.testing.assert_allclose(np_f32(pt), np_f32(rp), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("name", NEW_RULES)
def test_state_round_trips_through_numpy(name):
    """``to_numpy`` → ``opt_state_from_numpy`` keeps each state's type and
    values, and the reference's state converts to the same types — the
    names of the fields, not their count, decide (``MomentumState(m)`` and
    ``VarianceState(v)`` both have one)."""
    ref_arch, _ = smoke_archs()
    ref_params, port_params = ref_params_and_copy(ref_arch)
    popt = opt_lib.get_opt(name)
    st = popt.init(port_params)
    rng = np.random.default_rng(5)
    g = tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)), port_params)
    _, st = popt.step(port_params, g, st, _hp(name))
    back = opt_state_from_numpy(st.step.numpy(), to_numpy(st.moments), CPU)
    assert int(back.step) == 1
    for (kp, a), (_, b) in zip(tree_flatten_with_path(st.moments),
                               tree_flatten_with_path(back.moments)):
        assert type(a) is type(b), "/".join(kp)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    conv = convert_opt_state(ref_opt.get_opt(name).init(ref_params))
    types = {type(s).__name__ for _, s in tree_flatten_with_path(conv.moments)}
    want = {"adamw": {"AdamState"}, "sgd_momentum": {"MomentumState"},
            "sgd_variance": {"VarianceState"},
            "adafactor": {"FactoredState"}}[name]
    assert types == want


def test_unknown_state_fields_raise():
    from collections import namedtuple
    Bad = namedtuple("Bad", ["q"])
    with pytest.raises(ValueError, match="unknown per-tensor state"):
        opt_state_from_numpy(0, {"w": Bad(np.zeros(2))}, CPU)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_launcher_trains_a_baseline_on_the_cpu(name, tmp_path, capsys):
    """``python -m repro_torch.launch.train ... --optimizer adamw`` (and
    adafactor) through the launcher's ``main``: the unfused step, four
    finite losses."""
    import json

    from repro_torch.launch.train import main
    hist = tmp_path / "h.json"
    main(["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "4", "--batch",
          "2", "--seq", "32", "--device", "cpu", "--optimizer", name,
          "--history-out", str(hist)])
    assert "final loss" in capsys.readouterr().out
    losses = json.loads(hist.read_text())["loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    with pytest.raises(KeyError, match="unknown optimizer"):
        main(["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "1",
              "--device", "cpu", "--optimizer", "madgrad"])


@pytest.mark.parametrize("shape,dtype,transposed", [
    ((3, 70, 40), torch.bfloat16, False),
    ((130, 64), torch.float32, True),
    ((2, 3, 50, 20), torch.bfloat16, True)])
def test_lomo_updates_in_pieces_bitwise_as_the_whole_leaf(shape, dtype,
                                                          transposed,
                                                          monkeypatch):
    """The SGD (LOMO) rule updates a leaf larger than one piece piece by
    piece, in place, and gives the whole-leaf update's bits: fp32
    arithmetic, one cast at each piece's write.  Pieces are views along
    the leading axes (cut further where one index is larger than a piece)
    that cover the leaf once; a non-contiguous gradient is cut the same
    way.  The piece is shrunk to 1000 elements so a small leaf spans
    several."""
    monkeypatch.setattr(tree_lib, "PIECE", 1000)
    rng = np.random.default_rng(len(shape))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         ).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape[:-2] + shape[:-3:-1])
                         .astype(np.float32)).to(dtype).transpose(-1, -2) \
        if transposed else torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    assert g.is_contiguous() != transposed
    lr = torch.tensor(0.05)
    want = (p.to(torch.float32) - lr * g.to(torch.float32)).to(dtype)
    pieces = tree_lib.leading_pieces(p)
    assert len(pieces) > 1 and max(x.numel() for x in pieces) <= 1000
    assert sum(x.numel() for x in pieces) == p.numel()
    assert all(x.untyped_storage().data_ptr() ==
               p.untyped_storage().data_ptr() for x in pieces)
    before = p.data_ptr()
    rule = opt_lib.get_rule("sgd")
    out, state = rule.update(p, g, rule.init(p), {"lr": lr},
                             torch.tensor(1.0))
    assert out is p and p.data_ptr() == before and state == ()
    assert torch.equal(p, want)


# --------------------------------------------------------------------------
# Adafactor on ZeRO-3 blocks: an R x C grid of blocks of [L, m, n], each
# updated with the sums over the other row and column blocks, emulated in
# one process (a thread a block)
# --------------------------------------------------------------------------

class _Group:
    """Threads whose ``all_reduce`` is the collectives': the members'
    tensors widened to fp32 and added in member order, narrowed once."""

    def __init__(self, n):
        self.bar = threading.Barrier(n)
        self.buf = [None] * n

    def all_reduce(self, idx, t):
        self.buf[idx] = t
        self.bar.wait()
        out = self.buf[0].to(torch.float32, copy=True)
        for x in self.buf[1:]:
            out += x
        self.bar.wait()
        return out.to(t.dtype)


class _BlockShard:
    """``sharding.zero.TensorShard``'s interface for block (i, j) of an
    R x C grid."""

    def __init__(self, rows, cols, both, i, j, R, C, n_total):
        self.rows, self.cols, self.both = rows, cols, both
        self.i, self.j, self.R, self.C = i, j, R, C
        self.n_total = n_total

    def sum(self, t):
        return self.both.all_reduce(self.i * self.C + self.j, t)

    def over_rows(self, t):
        return t if self.rows is None else self.rows.all_reduce(self.i, t)

    def over_cols(self, t):
        return t if self.cols is None else self.cols.all_reduce(self.j, t)

    def whole_mn(self, m, n):
        return m * self.R, n * self.C


def _adafactor_on_grid(p, g_steps, R, C, hp):
    """Port Adafactor on each block of an R x C grid of the stacked
    ``[L, m, n]`` tensor ``p`` (torch), a thread a block, for each gradient
    of ``g_steps``; the blocks' params and state put back together."""
    rule = opt_lib.adafactor()
    m, n = p.shape[-2:]
    blocks = [[b.contiguous() for b in row.chunk(C, -1)]
              for row in p.chunk(R, -2)]
    whole = rule.init(p, batch_dims=1)
    if whole.v is None:
        states = [[type(whole)(r=whole.r.chunk(R, -1)[i].clone(),
                               c=whole.c.chunk(C, -1)[j].clone(), v=None)
                   for j in range(C)] for i in range(R)]
    else:
        states = [[type(whole)(r=None, c=None, v=blocks[i][j].new_zeros(
            blocks[i][j].shape, dtype=torch.float32)) for j in range(C)]
            for i in range(R)]
    hp_dev = api.hparams_on_device((hp,), CPU)[0]
    for k, g in enumerate(g_steps):
        gb = [[b.contiguous() for b in row.chunk(C, -1)]
              for row in g.chunk(R, -2)]
        cols = [_Group(C) for _ in range(R)] if C > 1 else [None] * R
        rows = [_Group(R) for _ in range(C)] if R > 1 else [None] * C
        both = _Group(R * C)

        def one(i, j):
            shard = _BlockShard(rows[j], cols[i], both, i, j, R, C, m * n)
            rule.update(blocks[i][j], gb[i][j], states[i][j], hp_dev,
                        torch.tensor(float(k + 1)), batch_dims=1,
                        shard=shard)

        threads = [threading.Thread(target=one, args=(i, j))
                   for i in range(R) for j in range(C)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    out = torch.cat([torch.cat(row, -1) for row in blocks], -2)
    if whole.v is not None:
        return out, (None, None, torch.cat(
            [torch.cat([s.v for s in row], -1) for row in states], -2))
    for i in range(R):              # every block of a row folds the same r
        for j in range(1, C):
            assert torch.equal(states[i][j].r, states[i][0].r)
    return out, (torch.cat([row[0].r for row in states], -1),
                 torch.cat([s.c for s in states[0]], -1), None)


@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (2, 2)],
                         ids=["rows", "cols", "both"])
@pytest.mark.parametrize("shape", [(3, 64, 96), (3, 34, 38), (3, 12, 40)],
                         ids=["even", "ragged", "unfactored"])
@pytest.mark.parametrize("pdt", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_adafactor_on_blocks_matches_whole_tensor_reference(grid, shape,
                                                            pdt):
    """Adafactor on the blocks of a matrix split by rows, by columns or
    both (a ZeRO-3 shard on ``(2,)``, ``(1, 2)``, ``(2, 2)``): the row and
    column means summed over the other blocks over the whole n and m, Σr
    over the row blocks, the RMS of u and θ over every block; 3 steps
    against the reference's whole-tensor ``adafactor`` (vmapped over L) on
    the joined blocks, at the tolerances of the port's own Adafactor tests
    (fp32: the unfused step's; bf16: one rounding at the write).  The
    ragged shape splits into 17 x 19 blocks; the unfactored one (12 < 16)
    keeps a dense v split as θ."""
    rng = np.random.default_rng(sum(shape) + grid[0] * 3 + grid[1])
    p = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    gs = [(rng.standard_normal(shape) * 0.3).astype(np.float32)
          for _ in range(3)]
    hp = {**ref_opt.adafactor().hparams, **_hp("adafactor")}
    rrule = ref_opt.adafactor()
    rp = jnp.asarray(p).astype(pdt)
    rs = jax.vmap(rrule.init)(rp)
    for k, g in enumerate(gs):
        rp, rs = jax.vmap(lambda pi, gi, si: rrule.update(
            pi, gi, si, hp, jnp.float32(k + 1)))(
                rp, jnp.asarray(g).astype(pdt), rs)
    tdt = torch.float32 if pdt == jnp.float32 else torch.bfloat16
    got, state = _adafactor_on_grid(
        torch.from_numpy(p).to(tdt),
        [torch.from_numpy(g).to(tdt) for g in gs], *grid, hp)
    assert got.dtype == tdt
    if pdt == jnp.float32:
        np.testing.assert_allclose(np_f32(got), np_f32(rp), **UNFUSED_TOL)
    else:
        np.testing.assert_allclose(np_f32(got), np_f32(rp), rtol=BF16_TOL,
                                   atol=BF16_TOL)
    for a, b in zip(state, rs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(np_f32(a), np_f32(b), **STATE_TOL)
