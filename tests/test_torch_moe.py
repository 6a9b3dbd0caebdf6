"""PyTorch port vs the JAX reference: the mixture-of-experts FFN
(``models/moe.py``) against ``repro.models.moe._moe_ffn_local`` — output,
load-balance loss, the set of dropped tokens and the gradients, at a
capacity that drops tokens (1.25, the configs' own) and at one that drops
none (8.0), for both router scores — and deepseek-moe-16b's smoke config
end to end: the fused AdaLomo step against the reference's and against the
port's own unfused step, greedy tokens of both serving engines against the
JAX engines, and params and AdaLomo state (4-D expert stacks, their r and c)
through the checkpoint both ways.  fp32 on the CPU, inputs made with numpy
from a seed, weights from the reference's ``init_params``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core import optimizers as ref_opt
from repro.models import moe as ref_moe
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import PagedEngine as RefPagedEngine
from repro.serve.engine import PagedServeConfig as RefPagedConfig
from repro.serve.engine import ServeConfig as RefConfig
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.tree import (pytree_leaves, pytree_unflatten,
                                   tree_flatten_with_path, tree_leaves,
                                   tree_map)
from repro_torch.models import moe
from repro_torch.serve.engine import (Engine, PagedEngine, PagedServeConfig,
                                      ServeConfig)
from torch_parity import (CPU, assert_trees_close, convert_opt_state,
                          jax_batch, make_batch, np_f32, ref_params_and_copy,
                          smoke_archs, torch_batch)

MOE_ID = "deepseek-moe-16b"
D = 64
# fp32 on both sides, other summation orders: the tolerances of the
# transformer's loss-and-gradient test
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# |Δloss| and parameters: the reference's own fused drop-in bounds
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(cf: float, score: str):
    kw = dict(n_routed=8, top_k=2, d_ff_expert=32, n_shared=1,
              capacity_factor=cf, router_score=score)
    return ref_moe.MoEConfig(**kw), moe.MoEConfig(**kw)


def _inputs(cf, score, seed=0):
    rcfg, pcfg = _cfgs(cf, score)
    rp = ref_moe.moe_init(jax.random.PRNGKey(seed), D, rcfg)
    pp = params_from_numpy(jax.device_get(rp), CPU)
    # tokens that share a direction crowd the same experts, so that a
    # capacity factor of 1.25 drops some of them (unit RMS, as after a norm)
    rng = np.random.default_rng(seed)
    x = ((rng.standard_normal((2, 64, D)) + 2.0 * rng.standard_normal(D))
         / np.sqrt(5.0)).astype(np.float32)
    return rcfg, pcfg, rp, pp, x


def _ref_keep(params, x, cfg):
    """The reference's drop set: its routing and slot lines
    (``_moe_ffn_local``), which it does not return."""
    B, S, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", x, params["router"])
    scores = (jax.nn.sigmoid(logits) if cfg.router_score == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    _, idx = jax.lax.top_k(scores, cfg.top_k)
    flat = idx.reshape(B, S * cfg.top_k)
    oh = jax.nn.one_hot(flat, cfg.n_routed, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - 1, flat[..., None],
                              axis=-1)[..., 0]
    C = ref_moe.capacity(S, cfg)
    return (np.asarray(idx),
            np.asarray(pos < C).reshape(B, S, cfg.top_k))


CASES = [(cf, score) for cf in (1.25, 8.0) for score in ("softmax",
                                                         "sigmoid")]


@pytest.mark.parametrize("cf,score", CASES)
def test_moe_ffn_matches_reference(cf, score):
    rcfg, pcfg, rp, pp, x = _inputs(cf, score)
    ry, raux = ref_moe._moe_ffn_local(rp, jnp.asarray(x), rcfg)
    py, paux = moe.moe_ffn(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-5)
    # routing and the drop set
    gates, idx, slot, keep, _ = moe.route(pp, torch.from_numpy(x), pcfg)
    ridx, rkeep = _ref_keep(rp, jnp.asarray(x), rcfg)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_array_equal(keep.numpy(), rkeep)
    C = moe.capacity(64, pcfg)
    assert C == ref_moe.capacity(64, rcfg)
    assert bool((slot[~keep] == C).all()) and bool((slot[keep] < C).all())
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    if cf == 8.0:
        assert keep.all()
    else:
        assert not keep.all(), "the case must drop tokens"
    # a dropped (token, slot) contributes nothing: with every kept gate
    # zeroed only the shared experts remain
    no_route = dict(pp, router=torch.zeros_like(pp["router"]))
    assert torch.isfinite(moe.moe_ffn(no_route, torch.from_numpy(x),
                                      pcfg)[0]).all()


@pytest.mark.parametrize("cf,score", CASES)
def test_moe_ffn_gradients_match_reference(cf, score):
    """Gradients of sum(y * t) + aux with respect to x and every MoE weight,
    for a cotangent t from the seed."""
    rcfg, pcfg, rp, pp, x = _inputs(cf, score, seed=1)
    t = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def ref_f(params, xx):
        y, aux = ref_moe._moe_ffn_local(params, xx, rcfg)
        return jnp.sum(y * jnp.asarray(t)) + aux

    rgp, rgx = jax.grad(ref_f, argnums=(0, 1))(rp, jnp.asarray(x))
    p_req = tree_map(lambda a: a.requires_grad_(True), pp)
    x_req = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(p_req, x_req, pcfg)
    val = torch.sum(y * torch.from_numpy(t)) + aux
    leaves = tree_leaves(p_req)
    grads = torch.autograd.grad(val, leaves + [x_req])
    it = iter(grads[:-1])
    pgp = tree_map(lambda _: next(it), p_req)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(rgx),
                               **GRAD_TOL)
    assert_trees_close(pgp, rgp, what=f"cf {cf} {score}", **GRAD_TOL)
    # the router gets a gradient from the gates and from the aux loss
    assert float(pgp["router"].abs().sum()) > 0


def test_capacity_matches_reference():
    for E, K, cf in ((64, 6, 1.25), (8, 2, 1.25), (8, 2, 8.0), (256, 8, 1.0)):
        rcfg = ref_moe.MoEConfig(n_routed=E, top_k=K, d_ff_expert=8,
                                 capacity_factor=cf)
        pcfg = moe.MoEConfig(n_routed=E, top_k=K, d_ff_expert=8,
                             capacity_factor=cf)
        for S in (1, 7, 16, 64, 1000, 1024, 4096):
            assert moe.capacity(S, pcfg) == ref_moe.capacity(S, rcfg)
    full = moe.MoEConfig(n_routed=64, top_k=6, d_ff_expert=1408)
    assert moe.capacity(1024, full) == 124 and moe.capacity(1, full) == 4


# --------------------------------------------------------------------------
# deepseek-moe-16b smoke config, end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_archs():
    ref, port = smoke_archs(MOE_ID)
    assert port.cfg.moe == moe.MoEConfig(**dataclasses.asdict(ref.cfg.moe))
    return ref, port


def test_fused_adalomo_step_matches_reference(moe_archs):
    """Two fused AdaLomo steps from the same weights and batch: loss,
    metrics, params and the OptState (r [L, E, m], c [L, E, n] for the
    expert stacks) against the reference's fused step."""
    ref_arch, port_arch = moe_archs
    ref_params, port_params = ref_params_and_copy(ref_arch)
    batch = make_batch(ref_arch.cfg.vocab, 2, 16)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rstep = jax.jit(lambda p, s, b: ref_arch.make_fused_train_step(ropt)(
        p, s, b, hparams=1e-3))
    pstep = port_arch.make_fused_train_step(popt)
    rp, rs = ref_params, ropt.init(ref_params)
    pp, ps = port_params, popt.init(port_params)
    for _ in range(2):
        rp, rs, rloss, rmetrics = rstep(rp, rs, jax_batch(batch))
        _, ps, ploss, pmetrics = pstep(pp, ps, torch_batch(batch),
                                       hparams=1e-3)
        assert abs(float(ploss) - float(rloss)) < LOSS_TOL
        for k in rmetrics:
            np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                       rtol=1e-4, atol=1e-6)
    assert_trees_close(pp, rp, what="moe fused", **PARAM_TOL)
    conv = convert_opt_state(rs)
    assert int(ps.step) == int(conv.step) == 2
    r_stack = ps.moments["stacks"]["blocks"]["moe"]["w_gate"]
    assert tuple(r_stack.r.shape) == (2, 8, 64)
    assert tuple(r_stack.c.shape) == (2, 8, 32)
    for (kp, a), (_, b) in zip(tree_flatten_with_path(ps.moments),
                               tree_flatten_with_path(conv.moments)):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(np_f32(x), np_f32(y), rtol=1e-4,
                                           atol=1e-7, err_msg="/".join(kp))


def test_fused_equals_unfused_within_port(moe_archs):
    """The port's fused step == grads of its ``unfused_loss_fn`` +
    ``Opt.step`` (the counterpart of the reference's
    ``test_fused_equals_unfused_special_families``): the aux loss's
    gradient survives the fused engine."""
    ref_arch, port_arch = moe_archs
    _, p_fused = ref_params_and_copy(ref_arch, seed=1)
    _, p_unfused = ref_params_and_copy(ref_arch, seed=1)
    batch = torch_batch(make_batch(ref_arch.cfg.vocab, 2, 16, seed=1))
    opt = opt_lib.get_opt("adalomo")
    s_fused = opt.init(p_fused)
    _, _, loss_f, metrics = port_arch.make_fused_train_step(opt)(
        p_fused, s_fused, batch, hparams=1e-3)
    p_req = tree_map(lambda t: t.detach().requires_grad_(True), p_unfused)
    loss_u, _ = port_arch.make_loss_fn()(p_req, batch)
    it = iter(torch.autograd.grad(loss_u, tree_leaves(p_req)))
    grads = tree_map(lambda _: next(it), p_req)
    assert float(grads["stacks"]["blocks"]["moe"]["router"].abs().sum()) > 0
    opt.step(p_unfused, grads, opt.init(p_unfused), 1e-3)
    np.testing.assert_allclose(float(loss_f), float(loss_u.detach()),
                               rtol=1e-5)
    for (kp, a), (_, b) in zip(tree_flatten_with_path(p_fused),
                               tree_flatten_with_path(p_unfused)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg="/".join(kp))
    # the loss carries the aux term: it is above the plain cross entropy
    assert float(loss_f) > float(metrics["loss"]) - 1e-6


PROMPTS = [[5, 17, 23, 9], [101, 44], [7] * 6, [3, 4, 5, 6, 7, 8, 9, 10, 11],
           [42] * 14]


def test_paged_engine_greedy_matches_reference(moe_archs):
    """Mid-flight admission, 3 slots over 5 requests: capacity per prefill
    bucket (right-padded) and per decode step (C = 4) as in the reference."""
    ref, port = moe_archs
    rp, pp = ref_params_and_copy(ref, seed=2)
    kw = dict(page_size=8, num_pages=32, max_batch=3, max_pages_per_seq=8,
              chunk=4, max_new_tokens=8, bucket_min=8)

    def midflight(eng):
        rids = [eng.submit(p) for p in PROMPTS[:3]]
        eng.step()
        rids += [eng.submit(p) for p in PROMPTS[3:]]
        eng.run()
        return [eng.requests[r].out for r in rids]

    want = midflight(RefPagedEngine(ref, rp, RefPagedConfig(**kw)))
    eng = PagedEngine(port, pp, PagedServeConfig(**kw), device=CPU)
    free0 = eng.allocator.n_free
    got = midflight(eng)
    assert got == want
    assert all(len(o) == 8 for o in got)
    assert eng.allocator.n_free == free0


@pytest.mark.parametrize("prompts", [PROMPTS[:2], [[5, 17, 23, 9, 2, 11],
                                                   [101, 44, 3, 3, 8, 61]]])
def test_legacy_engine_greedy_matches_reference(moe_archs, prompts):
    ref, port = moe_archs
    rp, pp = ref_params_and_copy(ref, seed=3)
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=8)).generate(prompts)
    got = Engine(port, pp, ServeConfig(max_new_tokens=8),
                 device=CPU).generate(prompts)
    assert got == want


def _moe_state_trees(ref_arch):
    """The smoke MoE model's params and an AdaLomo state with non-zero
    moments, in both packages (one unfused reference update)."""
    ref_params, _ = ref_params_and_copy(ref_arch, seed=4)
    ropt = ref_opt.get_opt("adalomo")
    grads = jax.tree.map(lambda p: jnp.cos(p) * 0.01, ref_params)
    ref_params, ref_state = ropt.step(ref_params, grads,
                                      ropt.init(ref_params), 1e-3)
    port = (params_from_numpy(jax.device_get(ref_params), CPU),
            convert_opt_state(ref_state))
    return (ref_params, ref_state), port


def test_expert_stacks_cross_the_checkpoint_both_ways(moe_archs, tmp_path):
    ref_arch, _ = moe_archs
    ref_tree, port_tree = _moe_state_trees(ref_arch)
    # the port's files restore in the reference, bitwise
    CheckpointManager(tmp_path / "p", async_write=False).save(3, port_tree)
    step, got, _ = RefManager(tmp_path / "p").restore(template=ref_tree)
    assert step == 3
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the reference's files restore in the port, bitwise
    RefManager(tmp_path / "r", async_write=False).save(4, ref_tree)
    template = pytree_unflatten(
        port_tree, [torch.zeros_like(t) for t in pytree_leaves(port_tree)])
    step, got, _ = CheckpointManager(tmp_path / "r").restore(
        template=template)
    assert step == 4
    shapes = set()
    for a, b in zip(pytree_leaves(got), jax.tree_util.tree_leaves(ref_tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        shapes.add(a.ndim)
    assert 4 in shapes          # [L, E, m, n] expert stacks
    w = got[1].moments["stacks"]["blocks"]["moe"]["w_down"]
    assert tuple(w.r.shape) == (2, 8, 32) and tuple(w.c.shape) == (2, 8, 64)
