"""PyTorch port vs the JAX reference: the ``encdec`` family
(``models/encdec.py``, whisper-base's smoke config: 2 + 2 layers, d 64, 4/4
heads, 24 frames).

``layers.mlp``; the encoder and decoder bodies; the unfused loss and every
gradient; the fused AdaLomo step, whose decoder sweep sums the encoder
output's gradient through the ctx (the cross-stream gradient) before the
encoder's own sweep, in fp32 and in bf16, and against the port's own
unfused gradients plus ``opt.step``; the prefill cache and decode steps
through the plain version of K4 over a ring that wraps; the decode
sinusoid; the ``frames`` stream of ``run/data.py`` and a ``run(spec)``; the
refusals (``Engine``, ``global_grad_norm``, paged serving).  fp32 on the CPU
unless stated; inputs made with numpy from a seed, weights the reference's
``init_params`` carried over by ``convert.params_from_numpy``."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as ref_opt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import encdec as ref_E
from repro.models import layers as ref_L
from repro.run import spec as ref_spec_mod
from repro.run.data import make_batch_iter as ref_batch_iter
from repro.run.runner import run as ref_run
from repro_torch.convert import params_from_numpy
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.decode_attention import decode_attention as KD
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.run import spec as spec_mod
from repro_torch.run.data import EVAL_SEED_OFFSET, make_batch_iter
from repro_torch.run.runner import run
from repro_torch.serve.engine import (Engine, PagedEngine, PagedServeConfig,
                                      ServeConfig)
from torch_parity import (CPU, assert_trees_close, jax_batch, np_f32,
                          port_flat, smoke_archs, torch_batch)

ARCH = "whisper-base"
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 on both sides: the bounds tests/test_torch_transformer.py uses there
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def archs():
    return smoke_archs(ARCH)


@functools.cache
def _ref_init(cfg):
    return jax.jit(lambda key: ref_E.init_params(key, cfg))


def _weights(ref, seed: int):
    """The reference's ``init_params`` (compiled once per config) and the
    same weights converted for the port."""
    rp = _ref_init(ref.cfg)(jax.random.PRNGKey(seed))
    return rp, params_from_numpy(jax.device_get(rp), CPU)


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    """Tokens, labels (a few ignored) and frames, from ``seed``."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    lab[0, :3] = -1
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": lab,
            "frames": rng.standard_normal((B, cfg.n_frames, cfg.d_model)
                                          ).astype(np.float32)}


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def _grads(loss_fn, params, batch):
    """Loss, metrics and the gradient tree of the port's ``loss_fn``."""
    p_req = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(p_req, batch)
    it = iter(torch.autograd.grad(loss, tree_leaves(p_req)))
    return loss, metrics, tree_map(lambda _: next(it), p_req)


# --------------------------------------------------------------------------
# Layers and bodies
# --------------------------------------------------------------------------

def test_mlp_matches_reference():
    """The plain 2-layer MLP with biases (tanh gelu) against the
    reference's, fp32, 1e-5."""
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("w_up", (16, 40)), ("b_up", (40,)), ("w_down", (40, 16)),
        ("b_down", (16,)))}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = ref_L.mlp({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), "gelu")
    got = L.mlp(torch_batch(p), torch.from_numpy(x), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stack", ["enc", "dec"])
def test_bodies_match_reference(archs, stack):
    """One encoder layer over 24 frames (non-causal attention), one decoder
    layer over 10 tokens (causal self-attention, then cross-attention over
    the 24 frames), 1e-5."""
    ref, port = archs
    rp, pp = _weights(ref, 1)
    cfg = ref.cfg
    rng = np.random.default_rng(1)
    S = cfg.n_frames if stack == "enc" else 10
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.n_frames, cfg.d_model)
                              ).astype(np.float32)
    rbody = (ref_E.make_enc_body if stack == "enc" else ref_E.make_dec_body)
    pbody = (E.make_enc_body if stack == "enc" else E.make_dec_body)
    rl = jax.tree.map(lambda a: a[1], rp["stacks"][stack])
    want = jax.jit(rbody(cfg), static_argnums=3)(
        rl, ((), jnp.asarray(enc)), jnp.asarray(x), 1)
    got, = pbody(port.cfg)(_layer(pp["stacks"][stack], 1),
                           ({}, torch.from_numpy(enc)),
                           (torch.from_numpy(x),), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# Train
# --------------------------------------------------------------------------

def test_loss_and_gradients_match_reference(archs):
    """``loss_fn``: loss, metrics and the gradient of every leaf (the tied
    embedding's from the logits and the lookup, the encoder's through the
    cross-attention) against ``jax.value_and_grad``, rtol 1e-4 / atol
    1e-5."""
    ref, port = archs
    rp, pp = _weights(ref, 2)
    b = _batch(ref.cfg, 2, 12, seed=2)
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        ref.make_loss_fn(), has_aux=True))(rp, jax_batch(b))
    ploss, pmetrics, pgrads = _grads(port.make_loss_fn(), pp, torch_batch(b))
    assert abs(float(ploss) - float(rloss)) < LOSS_TOL
    for k in rmetrics:
        np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                   rtol=1e-5, atol=1e-6)
    assert_trees_close(pgrads, rgrads, what="grads", **GRAD_TOL)
    assert float(pgrads["stacks"]["enc"]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adalomo_steps_match_reference(dtype):
    """Two fused AdaLomo steps from the same weights and batch: losses,
    metrics, every param and the step count.  In bf16 (both packages'
    configs replaced) ``d(enc_out)`` is summed over the decoder's layers in
    bf16, as the reference's scan carry sums it; bounds 2e-2 there."""
    ref, port = smoke_archs(ARCH)
    if dtype == "bfloat16":
        ref = dataclasses.replace(ref, cfg=dataclasses.replace(
            ref.cfg, dtype=jnp.bfloat16))
        port = dataclasses.replace(port, cfg=dataclasses.replace(
            port.cfg, dtype=torch.bfloat16))
    rp, pp = _weights(ref, 5)
    assert pp["stacks"]["dec"]["self_attn"]["wq"].dtype == getattr(torch,
                                                                   dtype)
    b = _batch(ref.cfg, 2, 16, seed=5)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rstep = jax.jit(lambda p, s, bb: ref.make_fused_train_step(ropt)(
        p, s, bb, hparams=1e-3))
    pstep = port.make_fused_train_step(popt)
    rs, ps = ropt.init(rp), popt.init(pp)
    loss_tol = LOSS_TOL if dtype == "float32" else BF16_TOL["atol"]
    for _ in range(2):
        rp, rs, rloss, rmetrics = rstep(rp, rs, jax_batch(b))
        _, ps, ploss, pmetrics = pstep(pp, ps, torch_batch(b), hparams=1e-3)
        assert abs(float(ploss) - float(rloss)) < loss_tol
        for k in rmetrics:
            np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                       rtol=1e-4 if dtype == "float32"
                                       else 2e-2, atol=1e-6)
    tol = PARAM_TOL if dtype == "float32" else BF16_TOL
    assert_trees_close(pp, rp, what=f"whisper fused {dtype}", **tol)
    assert int(ps.step) == 2


def test_fused_step_equals_unfused_gradients_plus_step(archs):
    """The cross-stream check in the port alone (the reference's
    ``test_fused_equals_unfused_special_families``): the fused step, whose
    encoder sees the decoder's summed ``d(enc_out)``, equals the unfused
    gradients of ``loss_fn`` applied by ``opt.step``."""
    ref, port = archs
    _, pp = _weights(ref, 1)
    p0 = tree_map(torch.clone, pp)
    b = torch_batch(_batch(port.cfg, 2, 16, seed=1))
    opt = opt_lib.get_opt("adalomo", backend="torch")
    pu = tree_map(torch.clone, pp)
    loss_u, _, grads = _grads(port.make_loss_fn(), pu, b)
    opt.step(pu, grads, opt.init(pu), 1e-3)
    _, _, loss_f, _ = port.make_fused_train_step(opt)(
        pp, opt.init(pp), b, hparams=1e-3)
    np.testing.assert_allclose(float(loss_f), float(loss_u), rtol=1e-5)
    for (path, x), (_, y) in zip(port_flat(pp), port_flat(pu)):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, err_msg=path)
    assert not torch.equal(pp["stacks"]["enc"]["attn"]["wk"],
                           p0["stacks"]["enc"]["attn"]["wk"])


# --------------------------------------------------------------------------
# Serve
# --------------------------------------------------------------------------

def test_prefill_cache_matches_reference(archs):
    """The encoder's output and every cache leaf (cross K/V over the 24
    frames, the empty ring, ``pos``, ``cur``) in the reference's dtypes."""
    ref, port = archs
    rp, pp = _weights(ref, 3)
    frames = _batch(ref.cfg, 2, 1, seed=3)["frames"]
    renc, rcache = jax.jit(ref.make_prefill_step(max_decode_len=8))(
        rp, {"frames": jnp.asarray(frames)})
    penc, pcache = port.make_prefill_step(max_decode_len=8)(
        pp, {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(penc.numpy(), np.asarray(renc), **TOL)
    assert sorted(pcache) == sorted(rcache)
    for k in rcache:
        assert tuple(pcache[k].shape) == rcache[k].shape, k
        assert str(pcache[k].dtype).removeprefix("torch.") == \
            str(rcache[k].dtype), k
        np.testing.assert_allclose(np_f32(pcache[k]), np_f32(rcache[k]),
                                   **TOL, err_msg=k)


def test_decode_steps_match_reference(archs):
    """12 decode steps over a ring of 8 slots (it wraps after 8): each
    step's logits within 1e-5 of the reference's and the greedy tokens
    equal; both attentions a step go through the plain version of K4 on the
    CPU (no kernel launch)."""
    ref, port = archs
    rp, pp = _weights(ref, 4)
    frames = _batch(ref.cfg, 2, 1, seed=4)["frames"]
    _, rcache = jax.jit(ref.make_prefill_step(max_decode_len=8))(
        rp, {"frames": jnp.asarray(frames)})
    _, pcache = port.make_prefill_step(max_decode_len=8)(
        pp, {"frames": torch.from_numpy(frames)})
    rdec = jax.jit(ref.make_decode_step())
    pdec = port.make_decode_step()
    rtok = jnp.asarray([[1], [2]], jnp.int32)
    ptok = torch.tensor([[1], [2]], dtype=torch.int32)
    before = KD.decode_attention.launches
    for t in range(12):
        rlog, rcache = rdec(rp, rcache, {"tokens": rtok})
        plog, pcache = pdec(pp, pcache, {"tokens": ptok})
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), **TOL,
                                   err_msg=f"step {t}")
        rtok = jnp.argmax(rlog, axis=-1).astype(jnp.int32)[:, None]
        ptok = torch.argmax(plog, dim=-1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(rtok))
    assert KD.decode_attention.launches == before
    assert int(pcache["cur"]) == 12
    np.testing.assert_array_equal(pcache["pos"].numpy(),
                                  np.asarray(rcache["pos"]))
    for k in ("self_k", "self_v"):
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(rcache[k]),
                                   **TOL)


def test_decode_sinusoid_row_matches_reference_table():
    """The decode step's sinusoid, one row computed on the device, against
    rows of the reference's table (``min(cur, 2**16 - 1)``: positions past
    its end take its last row), at whisper-base's width.  The same fp32
    arithmetic, but the two libraries' ``exp`` differ by up to one ulp in
    the frequencies (at most 2**-24, all <= 1), which moves an angle at
    position p by up to p * 2**-24 before its own rounding: the bound is
    4 * 2**-24 * max(p, 1)."""
    d = 512
    table = np.asarray(ref_E._sinusoid(2 ** 16, d))

    def atol(p):
        return 4 * 2.0 ** -24 * max(p, 1)

    for cur in (0, 1, 447, 1499, 2 ** 16 - 1, 2 ** 16 + 7):
        p = min(cur, 2 ** 16 - 1)
        row = torch.clamp_max(torch.tensor(cur, dtype=torch.int32),
                              2 ** 16 - 1).to(torch.float32)
        got = E._sinusoid_at(row.reshape(1, 1), d)[0].numpy()
        np.testing.assert_allclose(got, table[p], rtol=0, atol=atol(p),
                                   err_msg=str(cur))
    got = E._sinusoid(448, d, "cpu").numpy()
    for p in range(448):
        np.testing.assert_allclose(got[p], table[p], rtol=0, atol=atol(p),
                                   err_msg=str(p))


# --------------------------------------------------------------------------
# The data layer, run(spec) and the refusals
# --------------------------------------------------------------------------

def _run_specs(total: int = 2):
    mk = lambda m: m.RunSpec(                               # noqa: E731
        model=m.ModelSpec(ARCH, smoke=True),
        data=(DataConfig if m is spec_mod else RefDataConfig)(
            vocab=0, seq_len=16, global_batch=2, seed=3),
        opt=m.OptSpec(name="adalomo", lr=1e-3),
        steps=m.StepSpec(total=total), seed=3, log_every=0)
    return mk(ref_spec_mod), mk(spec_mod)


def test_batch_iter_frames_equal_reference(archs):
    """``run/data.py``'s stream: tokens, labels and ``frames`` bit for bit
    the reference's, from step 0, from a resumed step and on the eval
    stream; the leaves are ``train_batch_specs``'s."""
    ref, port = archs
    rspec, pspec = _run_specs()
    for start, offset in ((0, 0), (3, 0), (1, EVAL_SEED_OFFSET)):
        rit = ref_batch_iter(rspec, ref, start, seed_offset=offset)
        pit = make_batch_iter(pspec, port, start, seed_offset=offset)
        for _ in range(2):
            rb, pb = next(rit), next(pit)
            assert sorted(pb) == sorted(rb) == ["frames", "labels", "tokens"]
            for k in rb:
                assert pb[k].dtype == rb[k].dtype, k
                np.testing.assert_array_equal(pb[k], rb[k])
    specs = port.train_batch_specs(2, 16)
    assert specs["frames"] == ((2, 24, 64), torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in pb.items()} == {
        k: (s, str(dt).removeprefix("torch.")) for k, (s, dt) in
        specs.items()}
    assert sorted(specs) == sorted(ref.train_batch_specs(2, 16))


def test_run_matches_reference_and_the_launcher_trains(archs, tmp_path,
                                                       capsys):
    """Two steps of ``run(spec)`` in both packages from the same weights:
    losses within 1e-4, params at the fused bounds; then the launcher's
    recipe ``--arch whisper-base --smoke`` on the CPU."""
    ref, _ = archs
    rspec, pspec = _run_specs()
    rp, pp = _weights(ref, 3)
    rres = ref_run(rspec, params=rp, log_fn=lambda s: None)
    pres = run(pspec, params=pp, device="cpu", log_fn=lambda s: None)
    np.testing.assert_allclose(pres.history["loss"], rres.history["loss"],
                               atol=LOSS_TOL, rtol=0)
    assert_trees_close(pres.params, rres.params, **PARAM_TOL)
    from repro_torch.launch.train import main
    hist = tmp_path / "h.json"
    main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
          "--seq", "16", "--device", "cpu", "--history-out", str(hist)])
    assert "final loss" in capsys.readouterr().out
    losses = json.loads(hist.read_text())["loss"]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_engine_grad_norm_and_paged_serving_refuse(archs):
    """``Engine`` refuses the family (the reference's fails on a
    broadcast), naming the step functions that serve it; the fused step
    refuses ``global_grad_norm`` (the reference's ignores it); paged
    serving refuses it at the registry and the engine, as the reference's
    ``supports_paged_serving`` does."""
    ref, port = archs
    pp = port.init_params(0, device="cpu")
    with pytest.raises(ValueError, match="make_decode_step"):
        Engine(port, pp, ServeConfig(), device=CPU)
    with pytest.raises(ValueError, match="global_grad_norm"):
        port.make_fused_train_step(opt_lib.get_opt("adalomo"),
                                   global_grad_norm=1.0)
    assert not port.supports_paged_serving() and \
        not ref.supports_paged_serving()
    with pytest.raises(ValueError, match="paged serving"):
        PagedEngine(port, pp, PagedServeConfig(), device=CPU)
