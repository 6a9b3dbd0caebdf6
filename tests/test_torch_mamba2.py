"""PyTorch port vs the JAX reference: the ``mamba2`` family
(``models/mamba2.py``, mamba2-1.3b's smoke config).

``ssd_chunked`` forward at the reference test's ``(S, chunk)`` cases and at
the published chunk of 128 (2e-4), its gradients against ``jax.grad`` at
chunk 8; at chunk 128 the reference's gradient is NaN (it exponentiates the
upper triangle before masking it) where the port's is finite and equal to a
float64 per-timestep recurrence under autograd.  ``_causal_conv`` and
``mamba2_mix`` in both forms; the fused AdaLomo step and the unfused loss;
prefill, decode and the state cache; ``Engine.generate`` against the JAX
``Engine`` at temperature 0; the short-prompt and paged refusals.  fp32 on
the CPU; inputs made with numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as ref_opt
from repro.models import mamba2 as ref_M2
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.tree import tree_leaves
from repro_torch.models import mamba2 as M2
from repro_torch.serve.engine import (Engine, PagedEngine, PagedServeConfig,
                                      ServeConfig)
from torch_parity import (CPU, assert_trees_close, jax_batch, jax_flat,
                          make_batch, np_f32, port_flat, ref_params_and_copy,
                          smoke_archs, torch_batch)

ARCH = "mamba2-1.3b"
# the reference test's SSD tolerance; the fused drop-in bounds
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def archs():
    return smoke_archs(ARCH)


def _ssd_inputs(seed, B, S, H, P, G, N, *, published=False):
    """numpy x, dt, A, Bm, Cm, D.  ``published``: A from -1 to -16 over the
    heads (``A_log = log(linspace(1, 16, H))``) and dt = softplus(N(0, 1) -
    2.25), the published init's ranges."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    raw = rng.standard_normal((B, S, H)).astype(np.float32)
    if published:
        dt = np.log1p(np.exp(raw - 2.25))
        A = -np.linspace(1.0, 16.0, H)
    else:
        dt = np.log1p(np.exp(raw))
        A = -np.exp(rng.standard_normal(H) * 0.5)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


def _naive_ssd_torch(x, dt, A, Bm, Cm, D):
    """The per-timestep recurrence s_t = exp(dt_t A) s_{t-1} + dt_t B_t
    x_t^T, y_t = C_t s_t + D x_t (the reference test's ``_naive_ssd``, the
    decode step's update applied S times), differentiable, in the inputs'
    dtype."""
    B, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)
    Ch = Cm.repeat_interleave(rep, dim=2)
    s = torch.zeros((B, H, P, Bm.shape[3]), dtype=x.dtype)
    ys = []
    for t in range(S):
        s = s * torch.exp(dt[:, t] * A)[:, :, None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], s)
                  + x[:, t] * D[:, None])
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("S,chunk,published", [
    (16, 4, False), (20, 8, False), (8, 8, False), (31, 8, False),
    (256, 128, True)])
def test_ssd_chunked_matches_reference(S, chunk, published):
    arrays = _ssd_inputs(S + chunk, 2, S, 4, 8, 2, 16, published=published)
    want_y, want_s = ref_M2.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                                        return_state=True)
    got_y, got_s = M2.ssd_chunked(*map(torch.from_numpy, arrays), chunk,
                                  return_state=True)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **SSD_TOL)
    if published:
        # and both against the per-timestep recurrence
        naive_y, _ = _naive_ssd_torch(*(torch.from_numpy(a).double()
                                        for a in arrays))
        np.testing.assert_allclose(got_y.numpy(), naive_y.numpy(), **SSD_TOL)


def _ssd_grads_ref(arrays, cot, chunk):
    def f(*a):
        return jnp.sum(ref_M2.ssd_chunked(*a, chunk) * cot)
    return jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))


def _ssd_grads_port(arrays, cot, chunk, fn=None):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = (fn or (lambda *a: M2.ssd_chunked(*a, chunk)))(*ts)
    torch.sum(y * torch.from_numpy(cot).to(y.dtype)).backward()
    return [t.grad for t in ts]


def test_ssd_gradients_match_reference_at_chunk_8():
    """d/d(x, dt, A, Bm, Cm, D) of a random projection of y, against
    ``jax.grad`` of the reference (finite at this chunk)."""
    arrays = _ssd_inputs(3, 2, 20, 4, 8, 2, 16)
    cot = np.random.default_rng(4).standard_normal(
        (2, 20, 4, 8)).astype(np.float32)
    want = _ssd_grads_ref(arrays, cot, 8)
    got = _ssd_grads_port(arrays, cot, 8)
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        assert np.isfinite(np.asarray(w)).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_ssd_gradient_at_chunk_128_finite_where_reference_is_nan():
    """The published chunk and init ranges (8 heads, A from -1 to -16): the
    reference's dt-gradient is NaN (0 * inf in its masked exponential); the
    port's gradients are finite and equal to a float64 per-timestep
    recurrence's under autograd (2e-4 of the largest)."""
    arrays = _ssd_inputs(7, 1, 256, 8, 4, 1, 8, published=True)
    cot = np.random.default_rng(8).standard_normal(
        (1, 256, 8, 4)).astype(np.float32)
    ref_grads = _ssd_grads_ref(arrays, cot, 128)
    assert np.isnan(np.asarray(ref_grads[1])).any()
    got = _ssd_grads_port(arrays, cot, 128)
    oracle = _ssd_grads_port(
        [a.astype(np.float64) for a in arrays], cot, 128,
        fn=lambda *a: _naive_ssd_torch(*a)[0])
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, oracle):
        assert torch.isfinite(g).all(), name
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-4 * scale, err_msg=name)
    # at chunk 8 the reference is finite and the oracle agrees with it
    small = _ssd_grads_ref(arrays, cot, 8)
    np.testing.assert_allclose(np.asarray(small[1]), oracle[1].numpy(),
                               rtol=2e-4, atol=2e-4 * float(
                                   oracle[1].abs().max()))


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = ref_M2._causal_conv(*map(jnp.asarray, (x, w, b)))
    got = M2._causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mamba2_mix_train_and_decode_match_reference(archs):
    """The mixer over a sequence, and its one-token decode form from a
    random conv window and SSM state (output, window, state)."""
    ref, port = archs
    rp, pp = ref_params_and_copy(ref, seed=3)
    rl = jax.tree.map(lambda a: a[1], rp["stacks"]["blocks"])
    pl = {k: (v[1] if not isinstance(v, dict) else
              {kk: vv[1] for kk, vv in v.items()})
          for k, v in pp["stacks"]["blocks"].items()}
    cfg = ref.cfg
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    want = ref_M2.mamba2_mix(rl, cfg, jnp.asarray(h))
    got = M2.mamba2_mix(pl, port.cfg, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    conv = rng.standard_normal((2, cfg.d_conv - 1, cfg.conv_dim)
                               ).astype(np.float32)
    ssm = rng.standard_normal((2, cfg.n_heads, cfg.headdim, cfg.d_state)
                              ).astype(np.float32)
    want = ref_M2.mamba2_mix(rl, cfg, jnp.asarray(h[:, :1]),
                             jnp.asarray(conv), jnp.asarray(ssm), decode=True)
    got = M2.mamba2_mix(pl, port.cfg, torch.from_numpy(h[:, :1]),
                        torch.from_numpy(conv), torch.from_numpy(ssm),
                        decode=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fused_adalomo_steps_match_reference(archs):
    """Two fused AdaLomo steps from the same weights and batch: losses,
    metrics, params and the OptState at the fused drop-in bounds."""
    ref, port = archs
    rp, pp = ref_params_and_copy(ref, seed=5)
    b = make_batch(ref.cfg.vocab, 2, 16, seed=5)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rstep = jax.jit(lambda p, s, bb: ref.make_fused_train_step(ropt)(
        p, s, bb, hparams=1e-3))
    pstep = port.make_fused_train_step(popt)
    rs, ps = ropt.init(rp), popt.init(pp)
    for _ in range(2):
        rp, rs, rloss, rmetrics = rstep(rp, rs, jax_batch(b))
        _, ps, ploss, pmetrics = pstep(pp, ps, torch_batch(b), hparams=1e-3)
        assert abs(float(ploss) - float(rloss)) < LOSS_TOL
        assert set(pmetrics) == set(rmetrics)
        for k in rmetrics:
            np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                       rtol=1e-4, atol=1e-6)
    assert_trees_close(pp, rp, what="mamba2 fused", **PARAM_TOL)
    assert int(ps.step) == 2


def test_fused_step_at_the_published_chunk_keeps_params_finite(archs):
    """The smoke config at chunk 128 over 2 x 256 tokens, every ``dt_bias``
    at the top of the published init's range (softplus(dt_bias) = 0.1): one
    fused AdaLomo step of the reference leaves non-finite params (the NaN
    of its SSD backward); the port's step keeps every param finite and its
    loss equals the reference's (the forwards agree)."""
    ref, port = (dataclasses.replace(a, cfg=dataclasses.replace(
        a.cfg, chunk=128)) for a in archs)
    rp = jax.device_get(ref.init_params(jax.random.PRNGKey(9)))
    blocks = rp["stacks"]["blocks"]
    blocks["dt_bias"] = np.full_like(np.asarray(blocks["dt_bias"]),
                                     np.log(np.expm1(0.1)))
    pp = params_from_numpy(rp, CPU)
    rp = jax.tree.map(jnp.asarray, rp)
    b = make_batch(ref.cfg.vocab, 2, 256, seed=9)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rp2, _, rloss, _ = jax.jit(lambda p, s, bb: ref.make_fused_train_step(
        ropt)(p, s, bb, hparams=1e-3))(rp, ropt.init(rp), jax_batch(b))
    _, _, ploss, _ = port.make_fused_train_step(popt)(
        pp, popt.init(pp), torch_batch(b), hparams=1e-3)
    assert abs(float(ploss) - float(rloss)) < LOSS_TOL
    assert not all(np.isfinite(x).all() for _, x in jax_flat(rp2))
    assert all(np.isfinite(x).all() for _, x in port_flat(pp))


def test_unfused_loss_and_gradients_match_reference(archs):
    ref, port = archs
    rp, pp = ref_params_and_copy(ref, seed=4)
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


def test_prefill_state_cache_and_decode_match_reference(archs):
    """``make_prefill_step`` then three decode steps: logits and the state
    cache (``conv`` before the activation, fp32 ``ssm``, ``cur``) after
    each, 1e-5; the empty cache of ``init_cache``."""
    ref, port = archs
    rp, pp = ref_params_and_copy(ref, seed=6)
    toks = np.random.default_rng(6).integers(
        1, ref.cfg.vocab, (2, 10)).astype(np.int32)
    rlog, rcache = ref.make_prefill_step()(rp, {"tokens": jnp.asarray(toks)})
    plog, pcache = port.make_prefill_step()(pp, {"tokens":
                                                 torch.from_numpy(toks)})
    rdec, pdec = jax.jit(ref.make_decode_step()), port.make_decode_step()
    for i in range(4):
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL,
                                   err_msg=f"logits after {i} decode steps")
        assert set(pcache) == set(rcache) == {"conv", "ssm", "cur"}
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(pcache[k].numpy(),
                                       np.asarray(rcache[k]), **TOL,
                                       err_msg=f"{k} after {i} steps")
        assert pcache["ssm"].dtype == torch.float32
        assert int(pcache["cur"]) == int(rcache["cur"]) == 10 + i
        nxt = np.argmax(np.asarray(rlog), -1).astype(np.int32)[:, None]
        rlog, rcache = rdec(rp, rcache, {"tokens": jnp.asarray(nxt)})
        plog, pcache = pdec(pp, pcache, {"tokens": torch.from_numpy(nxt)})
    want = ref.init_cache(3, 7)
    got = port.init_cache(3, 7, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(np_f32(got[k]), np_f32(want[k]))


@pytest.mark.parametrize("prompts", [
    [[5, 17, 23, 9, 2, 11], [101, 44, 3, 3, 8, 61]],
    [[5, 17, 23, 9], [101, 44, 3], [7] * 6]], ids=["equal", "ragged"])
def test_engine_greedy_matches_reference(archs, prompts):
    """The legacy Engine over the state cache: greedy tokens equal to the
    JAX Engine's (temperature 0; ragged prompts right-padded with token 0,
    as the reference pads them)."""
    ref, port = archs
    rp, pp = ref_params_and_copy(ref, seed=7)
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=8)).generate(prompts)
    got = Engine(port, pp, ServeConfig(max_new_tokens=8),
                 device=CPU).generate(prompts)
    assert got == want


def test_short_prompt_and_paged_serving_refuse(archs):
    """A prompt shorter than ``d_conv - 1`` tokens raises ``ValueError``
    (the reference's conv tail would have the wrong shape); the paged
    halves and ``PagedEngine`` refuse the family."""
    _, port = archs
    pp = port.init_params(0, device="cpu")
    with pytest.raises(ValueError, match="shorter than"):
        port.make_prefill_step()(pp, {"tokens": torch.ones((1, 2),
                                                           dtype=torch.int32)})
    assert not port.supports_paged_serving()
    with pytest.raises(ValueError, match="family 'mamba2'"):
        PagedEngine(port, pp, PagedServeConfig(), device=CPU)
    with pytest.raises(ValueError, match="transformer family only"):
        port.make_paged_decode_step()


def test_init_params_reference_draws(archs):
    """The deterministic leaves equal the reference's (``A_log``, ``D``,
    zero conv bias, zero-centred norms); the random ones are drawn from the
    reference's distributions: ``dt_bias`` is the inverse softplus of a
    value in [1e-3, 1e-1], ``conv_w`` has std 0.2; each layer differs."""
    ref, port = archs
    cfg = dataclasses.replace(port.cfg, n_layers=3, d_model=256)
    pp = M2.init_params(0, cfg, device="cpu")
    rp = ref_M2.init_params(jax.random.PRNGKey(0), dataclasses.replace(
        ref.cfg, n_layers=3, d_model=256))
    blocks, rblocks = pp["stacks"]["blocks"], rp["stacks"]["blocks"]
    for k in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(np_f32(blocks[k]), np_f32(rblocks[k]),
                                   rtol=1e-6, atol=0)
    dt = torch.nn.functional.softplus(blocks["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert abs(float(blocks["conv_w"].std()) - 0.2) < 0.01
    assert not torch.equal(blocks["in_proj"][0], blocks["in_proj"][1])
    again = M2.init_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pp),
                                                 tree_leaves(again)))
