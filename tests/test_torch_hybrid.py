"""PyTorch port vs the JAX reference: the ``hybrid`` family
(``models/hybrid.py``, zamba2-1.2b's smoke config: 4 layers, the shared
attention block applied at layers 0 and 2).

``_shared_attn`` in its train and decode forms; the fused AdaLomo step,
where the shared block's gradients accumulate over its two applications and
``x0``'s gradient reaches the embedding through the carry, in both the
one-pass and the two-pass ``global_grad_norm`` modes; the unfused loss and
its gradients; prefill (state cache and the applications' K/V rings) and
decode through the plain version of K4, ``Engine.generate`` against the JAX
``Engine`` at temperature 0; the paged refusal.  fp32 on the CPU; inputs
made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as ref_opt
from repro.models import hybrid as ref_H
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefConfig
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.decode_attention import decode_attention as KD
from repro_torch.models import hybrid as H
from repro_torch.serve.engine import (Engine, PagedEngine, PagedServeConfig,
                                      ServeConfig)
from torch_parity import (CPU, assert_trees_close, jax_batch, jax_flat,
                          make_batch, np_f32, port_flat, ref_params_and_copy,
                          smoke_archs, torch_batch)

ARCH = "zamba2-1.2b"
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def archs():
    return smoke_archs(ARCH)


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def _lora_nonzero(rp, pp, seed):
    """The LoRA B sides start at zero; fill them from a seed in both trees so
    that the per-application deltas take part in the comparisons."""
    rng = np.random.default_rng(seed)
    rblocks = dict(rp["stacks"]["blocks"])
    for k in ("lora_qB", "lora_kB", "lora_vB"):
        v = (0.05 * rng.standard_normal(pp["stacks"]["blocks"][k].shape)
             ).astype(np.float32)
        pp["stacks"]["blocks"][k].copy_(torch.from_numpy(v))
        rblocks[k] = jnp.asarray(v)
    rp = dict(rp, stacks={"blocks": rblocks})
    return rp, pp


def test_shared_attn_train_and_decode_match_reference(archs):
    """The train form over a sequence (causal attention through the
    dispatcher) and the decode form over a ring whose slot 5 the token
    writes (positions shared by the batch: the plain K4 on the CPU)."""
    ref, port = archs
    rp, pp = _lora_nonzero(*ref_params_and_copy(ref, seed=2), seed=2)
    cfg = ref.cfg
    rl = jax.tree.map(lambda a: a[2], rp["stacks"]["blocks"])
    pl = _layer(pp["stacks"]["blocks"], 2)
    rng = np.random.default_rng(2)
    B, S, d = 2, 9, cfg.d_model
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    x0 = rng.standard_normal((B, S, d)).astype(np.float32)
    want, _ = ref_H._shared_attn(rp["shared"], rl, cfg, jnp.asarray(x),
                                 jnp.asarray(x0),
                                 jnp.arange(S, dtype=jnp.float32))
    got, (k, v) = H._shared_attn(pp["shared"], pl, port.cfg,
                                 torch.from_numpy(x), torch.from_numpy(x0),
                                 torch.arange(S, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(k.shape) == tuple(v.shape) == (B, S, cfg.n_kv_heads,
                                                cfg.head_dim)
    W, cur = 8, 5
    kc = rng.standard_normal((B, W, cfg.n_kv_heads, cfg.head_dim)
                             ).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos_tab = np.where(np.arange(W) <= cur, np.arange(W), -1).astype(np.int32)
    want, (wk, wv) = ref_H._shared_attn(
        rp["shared"], rl, cfg, jnp.asarray(x[:, :1]), jnp.asarray(x0[:, :1]),
        jnp.asarray([cur], jnp.float32),
        cache=(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos_tab)),
        cur=jnp.asarray(cur, jnp.int32))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    before = KD.decode_attention.launches
    got, none = H._shared_attn(
        pp["shared"], pl, port.cfg, torch.from_numpy(x[:, :1]),
        torch.from_numpy(x0[:, :1]), torch.tensor([cur], dtype=torch.int32),
        cache=(tk, tv, torch.from_numpy(pos_tab)),
        cur=torch.tensor(cur, dtype=torch.int32))
    assert none is None and KD.decode_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("global_grad_norm", [None, 1.0],
                         ids=["one_pass", "two_pass"])
def test_fused_adalomo_steps_match_reference(archs, global_grad_norm):
    """Two fused AdaLomo steps from the same weights and batch: losses,
    metrics, params (the shared block's, updated once a step from the sum
    over its two applications, the LoRA deltas' and the embedding's, which
    gets x0's gradient through the carry) and the step count.  The LoRA B
    sides start at zero, as the init draws them, so the first step's LoRA
    A gradients are zero (their moments decay toward eps) and the second
    step's are not."""
    ref, port = archs
    rp, pp = ref_params_and_copy(ref, seed=5)
    b = make_batch(ref.cfg.vocab, 2, 16, seed=5)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rstep = jax.jit(lambda p, s, bb: ref.make_fused_train_step(
        ropt, global_grad_norm=global_grad_norm)(p, s, bb, hparams=1e-3))
    pstep = port.make_fused_train_step(popt,
                                       global_grad_norm=global_grad_norm)
    rs, ps = ropt.init(rp), popt.init(pp)
    for _ in range(2):
        rp, rs, rloss, rmetrics = rstep(rp, rs, jax_batch(b))
        _, ps, ploss, pmetrics = pstep(pp, ps, torch_batch(b), hparams=1e-3)
        assert abs(float(ploss) - float(rloss)) < LOSS_TOL
        for k in rmetrics:
            np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                       rtol=1e-4, atol=1e-6)
    assert_trees_close(pp, rp, what="zamba2 fused", **PARAM_TOL)
    assert int(ps.step) == 2
    assert float(pp["stacks"]["blocks"]["lora_qB"].abs().max()) > 0


def test_unfused_loss_and_gradients_match_reference(archs):
    """The same model as one differentiable function: loss, metrics and
    every gradient (the shared block's summed over its applications)."""
    ref, port = archs
    rp, pp = _lora_nonzero(*ref_params_and_copy(ref, seed=4), seed=4)
    b = make_batch(ref.cfg.vocab, 2, 12, seed=4)
    (rloss, rmetrics), rgrads = jax.value_and_grad(
        ref.make_loss_fn(), has_aux=True)(rp, jax_batch(b))
    leaves = tree_leaves(pp)
    for t in leaves:
        t.requires_grad_(True)
    ploss, pmetrics = port.make_loss_fn()(pp, torch_batch(b))
    grads = torch.autograd.grad(ploss, leaves)
    assert abs(float(ploss.detach()) - float(rloss)) < LOSS_TOL
    for k in rmetrics:
        np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                   rtol=1e-5, atol=1e-6)
    for (path, want), g in zip(jax_flat(rgrads), grads):
        np.testing.assert_allclose(np_f32(g), want, rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def test_prefill_cache_and_decode_match_reference(archs):
    """``make_prefill_step`` then three decode steps through the plain
    version of K4 (no launch): logits and every cache leaf (conv windows,
    fp32 SSM states, the two applications' K/V rings of the prompt's 10
    slots, ``pos``, ``cur``) after each, 1e-5.  The ring is sized to the
    prompt, so the first decode token writes slot 0 and evicts position 0,
    as the reference's does."""
    ref, port = archs
    rp, pp = _lora_nonzero(*ref_params_and_copy(ref, seed=6), seed=6)
    toks = np.random.default_rng(6).integers(
        1, ref.cfg.vocab, (2, 10)).astype(np.int32)
    rlog, rcache = ref.make_prefill_step()(rp, {"tokens": jnp.asarray(toks)})
    plog, pcache = port.make_prefill_step()(pp, {"tokens":
                                                 torch.from_numpy(toks)})
    rdec, pdec = jax.jit(ref.make_decode_step()), port.make_decode_step()
    before = KD.decode_attention.launches
    for i in range(4):
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL,
                                   err_msg=f"logits after {i} decode steps")
        assert set(pcache) == set(rcache)
        for k in ("conv", "ssm", "attn_k", "attn_v"):
            assert tuple(pcache[k].shape) == rcache[k].shape
            np.testing.assert_allclose(pcache[k].numpy(),
                                       np.asarray(rcache[k]), **TOL,
                                       err_msg=f"{k} after {i} steps")
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))
        assert int(pcache["cur"]) == int(rcache["cur"]) == 10 + i
        nxt = np.argmax(np.asarray(rlog), -1).astype(np.int32)[:, None]
        rlog, rcache = rdec(rp, rcache, {"tokens": jnp.asarray(nxt)})
        plog, pcache = pdec(pp, pcache, {"tokens": torch.from_numpy(nxt)})
    assert KD.decode_attention.launches == before
    assert pcache["pos"][0] == 10
    want = ref.init_cache(3, 7)
    got = port.init_cache(3, 7, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(np_f32(got[k]), np_f32(want[k]))
    # a prefill into a ring wider than the prompt leaves the tail empty
    _, wide = H.make_prefill_step(port.cfg, max_len=16)(
        pp, {"tokens": torch.from_numpy(toks)})
    _, rwide = ref_H.make_prefill_step(ref.cfg, max_len=16)(
        rp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_array_equal(wide["pos"].numpy(),
                                  np.asarray(rwide["pos"]))
    np.testing.assert_allclose(wide["attn_k"].numpy(),
                               np.asarray(rwide["attn_k"]), **TOL)


@pytest.mark.parametrize("prompts", [
    [[5, 17, 23, 9, 2, 11], [101, 44, 3, 3, 8, 61]],
    [[5, 17, 23, 9], [101, 44, 3], [7] * 6]], ids=["equal", "ragged"])
def test_engine_greedy_matches_reference(archs, prompts):
    """The legacy Engine: greedy tokens equal to the JAX Engine's
    (temperature 0), the shared attention through the plain K4."""
    ref, port = archs
    rp, pp = _lora_nonzero(*ref_params_and_copy(ref, seed=7), seed=7)
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=8)).generate(prompts)
    got = Engine(port, pp, ServeConfig(max_new_tokens=8),
                 device=CPU).generate(prompts)
    assert got == want


def test_init_layout_and_paged_refusal(archs):
    """The init's tree equals the reference's in paths, shapes and dtypes,
    with the shared block under ``shared`` and the LoRA B sides zero; the
    paged halves and ``PagedEngine`` refuse the family; a prompt shorter
    than ``d_conv - 1`` raises ``ValueError``."""
    ref, port = archs
    pp = port.init_params(0, device="cpu")
    rp = ref.init_params(jax.random.PRNGKey(0))
    assert [p for p, _ in jax_flat(rp)] == [p for p, _ in port_flat(pp)]
    assert [tuple(x.shape) for x in tree_leaves(pp)] == \
        [x.shape for x in jax.tree.leaves(rp)]
    assert sorted(pp["shared"]) == sorted(rp["shared"])
    for k in ("lora_qB", "lora_kB", "lora_vB"):
        assert not pp["stacks"]["blocks"][k].any()
    assert not port.supports_paged_serving()
    with pytest.raises(ValueError, match="family 'hybrid'"):
        PagedEngine(port, pp, PagedServeConfig(), device=CPU)
    with pytest.raises(ValueError, match="shorter than"):
        port.make_prefill_step()(pp, {"tokens": torch.ones((1, 2),
                                                           dtype=torch.int32)})
