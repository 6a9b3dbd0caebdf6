"""PyTorch port vs the JAX reference: the Opt v2 API (``core/api.py``) and
the rule registry (``core/optimizers.py``) — labels, hparam resolution, state
layout leaf for leaf, the unfused step, describe."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import optimizers as ref_opt
from repro_torch.core import api, optimizers as opt_lib
from repro_torch.core.adalomo import FactoredState
from repro_torch.core.tree import tree_flatten_with_path, tree_leaves
from torch_parity import (CPU, assert_trees_close, convert_opt_state, np_f32,
                          ref_params_and_copy, smoke_archs)


@pytest.fixture(scope="module")
def trees():
    ref_arch, _ = smoke_archs()
    return ref_params_and_copy(ref_arch)


def _groups(mod):
    return (mod.no_decay_1d(),
            mod.GroupSpec("embed", r"tok_embed", hparams={"lr": 1e-4}),
            mod.GroupSpec("mlp_unfactored", r"mlp/w_down", factored=False))


def _both(name="adalomo", **kw):
    return (ref_opt.get_opt(name, groups=_groups(ref_api), **kw)
            if name == "adalomo" else ref_opt.get_opt(name, **kw),
            opt_lib.get_opt(name, groups=_groups(api), **kw)
            if name == "adalomo" else opt_lib.get_opt(name, **kw))


def test_labels_match_reference(trees):
    ref_params, port_params = trees
    ropt, popt = _both()
    rl = jax.tree_util.tree_flatten_with_path(ropt.labels(ref_params))[0]
    pl = tree_flatten_with_path(popt.labels(port_params))
    assert [lab for _, lab in pl] == [lab for _, lab in rl]
    assert ["/".join(kp) for kp, _ in pl] == [ref_api.path_str(kp)
                                              for kp, _ in rl]
    assert set(lab for _, lab in pl) == {0, 1, 2, 3}


@pytest.mark.parametrize("hparams", [
    None, 3e-4, {"lr": 2e-3, "beta": 0.99},
    {"lr": 1e-3, "weight_decay": 0.1,
     "groups": {"embed": {"lr": 5e-5}, "no_decay": {"clip": 2.0}}}])
def test_resolve_matches_reference(hparams):
    ropt, popt = _both()
    assert popt.resolve(hparams) == ropt.resolve(hparams)


def test_unknown_keys_raise():
    _, popt = _both()
    with pytest.raises(KeyError, match="accepted hyperparameters"):
        popt.resolve({"momentum": 0.9})
    with pytest.raises(KeyError, match="unknown group overrides"):
        popt.resolve({"groups": {"nope": {"lr": 1.0}}})
    with pytest.raises(KeyError, match="call-time hparams"):
        popt.resolve({"groups": {"embed": {"momentum": 0.9}}})
    with pytest.raises(KeyError, match="does not accept"):
        api.Opt(opt_lib.sgd(), groups=(api.no_decay_1d(),))
    with pytest.raises(ValueError, match="duplicate"):
        api.Opt(opt_lib.adalomo(), groups=(api.no_decay_1d("a"),
                                           api.no_decay_1d("a")))
    with pytest.raises(KeyError, match="accepted kwargs"):
        opt_lib.get_rule("adalomo", momentum=0.9)
    with pytest.raises(KeyError, match="unknown optimizer"):
        opt_lib.get_rule("adamw")
    assert sorted(opt_lib.REGISTRY) == ["adalomo", "lomo", "sgd"]


def test_no_decay_1d_sees_per_tensor_ndim():
    g = api.no_decay_1d()
    assert g.matches(api.LeafInfo("stacks/blocks/ln1/scale", (2, 64), True))
    assert not g.matches(api.LeafInfo("outer/head", (64, 128), False))
    assert g.hparams == {"weight_decay": 0.0}
    info = api.LeafInfo("stacks/blocks/attn/wq", (2, 64, 64), True)
    assert info.tensor_shape == (64, 64) and info.tensor_ndim == 2


@pytest.mark.parametrize("name", ["adalomo", "sgd"])
def test_init_state_layout_matches_reference(trees, name):
    """Same paths, same (r, c, v) / () leaves, same shapes and dtypes; a
    converted reference state is laid out like a fresh one."""
    ref_params, port_params = trees
    ropt, popt = _both(name)
    rstate, pstate = ropt.init(ref_params), popt.init(port_params)
    assert pstate.step.dtype == torch.int32 and pstate.step.ndim == 0
    assert int(pstate.step) == int(rstate.step) == 0
    rflat = jax.tree_util.tree_flatten_with_path(
        rstate.moments, is_leaf=lambda x: isinstance(x, tuple))[0]
    pflat = tree_flatten_with_path(pstate.moments)
    assert len(pflat) == len(rflat) == len(tree_leaves(port_params))
    conv = tree_flatten_with_path(convert_opt_state(rstate).moments)
    for (pk, ps), (rk, rs), (_, cs) in zip(pflat, rflat, conv):
        assert "/".join(pk) == ref_api.path_str(rk)
        assert type(ps) is type(cs)
        assert len(ps) == len(rs)
        for a, b, c in zip(ps, rs, cs):
            assert (a is None) == (b is None) == (c is None)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape)
                assert a.dtype == c.dtype == torch.float32
    if name == "adalomo":
        m = pstate.moments["stacks"]["blocks"]
        assert isinstance(m["attn"]["wq"], FactoredState)
        assert m["attn"]["wq"].r.shape == (2, 64)          # per layer [L, m]
        assert m["ln1"]["scale"].v.shape == (2, 64)        # L 1-D tensors
        assert m["mlp"]["w_down"].v is not None            # factored=False
    assert popt.state_bytes(port_params) == ropt.state_bytes(ref_params)
    assert (popt.rule.state_bytes(torch.zeros(64, 128))
            == ropt.rule.state_bytes(jnp.zeros((64, 128))))


@pytest.mark.parametrize("name", ["adalomo", "sgd"])
def test_unfused_step_matches_reference(trees, name):
    """Two ``Opt.step`` calls on numpy-made gradients, in place; fp32, so
    params to rtol 1e-5 / atol 1e-6."""
    ref_params, _ = trees
    _, port_params = ref_params_and_copy(smoke_archs()[0])  # fresh copy
    ropt, popt = _both(name)
    rstate, pstate = ropt.init(ref_params), popt.init(port_params)
    hp = {"lr": 1e-3} if name == "sgd" else {
        "lr": 1e-3, "weight_decay": 0.1, "groups": {"embed": {"lr": 1e-4}}}
    rng = np.random.default_rng(0)
    rp = ref_params
    for _ in range(2):
        g_np = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.1,
            jax.device_get(ref_params))
        rp, rstate = ropt.step(rp, jax.tree.map(jnp.asarray, g_np), rstate,
                               hp)
        out, pstate = popt.step(
            port_params, jax.tree.map(torch.from_numpy, g_np), pstate, hp)
        assert out is port_params                            # in place
    assert int(pstate.step) == int(rstate.step) == 2
    assert_trees_close(port_params, rp, rtol=1e-5, atol=1e-6, what="params")
    conv = convert_opt_state(rstate)
    for (kp, a), (_, b) in zip(tree_flatten_with_path(pstate.moments),
                               tree_flatten_with_path(conv.moments)):
        for x, y in zip(a, b):
            if x is not None:
                np.testing.assert_allclose(np_f32(x), np_f32(y), rtol=3e-5,
                                           atol=1e-7, err_msg="/".join(kp))


def test_describe_matches_reference(trees):
    ref_params, port_params = trees
    ropt, popt = _both()
    rd, pd = ropt.describe(ref_params), popt.describe(port_params)
    assert list(pd) == list(rd)
    for k in rd:
        assert pd[k]["paths"] == rd[k]["paths"]
        assert pd[k]["n_params"] == rd[k]["n_params"]
        assert pd[k]["hparams"] == pytest.approx(rd[k]["hparams"])
    assert popt.name == "adalomo"


def test_hparams_on_device_makes_fp32_scalars():
    hp = api.hparams_on_device(
        ({"lr": 1e-3, "beta": torch.tensor(0.9, dtype=torch.float64)},), CPU)
    assert all(v.dtype == torch.float32 and v.ndim == 0
               for v in hp[0].values())


def test_convert_round_trip_owns_its_memory(trees):
    """numpy → port → numpy is exact (bfloat16 travels as float32), and the
    port's tensors never alias the arrays they came from."""
    from repro_torch.convert import (opt_state_from_numpy, params_from_numpy,
                                     to_numpy)
    ref_params, _ = trees
    host = jax.device_get(ref_params)
    port = params_from_numpy(host, CPU)
    port["outer"]["head"].add_(1.0)                     # in place, port only
    assert not np.array_equal(np_f32(port["outer"]["head"]),
                              host["outer"]["head"])
    port["outer"]["head"].sub_(1.0)
    back = to_numpy(params_from_numpy(host, CPU, dtype=torch.bfloat16))
    want = jax.tree.map(lambda x: np_f32(jnp.asarray(x, jnp.bfloat16)), host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    ropt, popt = _both()
    rstate = jax.device_get(ropt.init(ref_params))
    pstate = opt_state_from_numpy(rstate.step, rstate.moments, CPU)
    back = to_numpy(pstate)
    assert type(back).__name__ == "OptState" and back.step == 0
    wq = back.moments["stacks"]["blocks"]["attn"]["wq"]
    assert type(wq).__name__ == "FactoredState" and wq.v is None
    assert np.array_equal(wq.r, rstate.moments["stacks"]["blocks"]["attn"]
                          ["wq"].r)
