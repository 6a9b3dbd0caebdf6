"""PyTorch port vs the JAX reference: prefix-LM and paligemma-3b.

The prefix mask (``MaskSpec.has_prefix`` with per-row ``prefix_len``) in the
direct, blockwise and flash branches of ``models/layers.py``, values and
gradients; the dispatcher's routing (a windowed prefix batch never takes
the window gather, packed segments refuse a prefix); a fused AdaLomo step of
paligemma-3b's smoke config through both attention branches; the data
layer's ``prefix_embed``/``prefix_len`` extras; the legacy prefill's ring
cache and ``Engine.generate(extras=...)``; and paged serving refusing
prefix-LM as the reference's does.  fp32 on the CPU, numpy-made inputs on
both sides, the reference tests' tolerances."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as ref_opt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import layers as ref_L
from repro.run import spec as ref_spec_mod
from repro.run.data import EVAL_SEED_OFFSET
from repro.run.data import make_batch_iter as ref_batch_iter
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import PagedEngine as RefPagedEngine
from repro.serve.engine import PagedServeConfig as RefPagedConfig
from repro.serve.engine import ServeConfig as RefConfig
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.tree import tree_map
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.run import spec as spec_mod
from repro_torch.run.data import make_batch_iter
from repro_torch.serve.engine import (Engine, PagedEngine, PagedServeConfig,
                                      ServeConfig)
from torch_parity import (CPU, assert_trees_close, jax_batch, make_batch,
                          patch_attention_thresholds, ref_params_and_copy,
                          smoke_archs, torch_batch)

PALI = "paligemma-3b"
PREFIX = np.asarray([5, 11], np.int32)    # two rows, two prefix lengths
# |Δloss| and parameters: the reference's own fused drop-in bounds
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.fixture(scope="module")
def pali():
    ref, port = smoke_archs(PALI)
    rp, pp = ref_params_and_copy(ref, seed=7)
    return ref, port, rp, pp


def _prefix_batch(cfg, B: int, S: int, seed: int) -> dict:
    """Tokens, labels and a prefix of ``cfg.n_prefix_tokens`` embeddings
    (float32, as the data layer draws them) for every row."""
    b = make_batch(cfg.vocab, B, S, seed=seed)
    rng = np.random.default_rng(seed + 1)
    b["prefix_embed"] = rng.standard_normal(
        (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    b["prefix_len"] = np.full((B,), cfg.n_prefix_tokens, np.int32)
    return b


# --------------------------------------------------------------------------
# The mask in the three branches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 6])
def test_direct_prefix_attention_values_and_grads_match_reference(window):
    """The dispatcher's direct branch (24 tokens) with the rows' prefixes of
    5 and 11: output and dq, dk, dv at 2e-5; keys inside a row's prefix are
    seen by every query of that row, and a window never cuts them."""
    B, S, H, K, dh = 2, 24, 4, 2, 16
    q, k, v = _arrays(S, (B, S, H, dh), (B, S, K, dh), (B, S, K, dh))
    pos = np.arange(S, dtype=np.int32)

    def f_ref(q, k, v):
        o = ref_L.attention(q, k, v, q_pos=jnp.asarray(pos),
                            kv_pos=jnp.asarray(pos),
                            spec=ref_L.MaskSpec(window=window,
                                                has_prefix=True),
                            prefix_len=jnp.asarray(PREFIX))
        return jnp.sum(o * jnp.cos(o)), o

    (rval, rout), rgrads = jax.value_and_grad(
        f_ref, argnums=(0, 1, 2), has_aux=True)(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = L.attention(tq, tk, tv, q_pos=torch.from_numpy(pos),
                      kv_pos=torch.from_numpy(pos),
                      spec=L.MaskSpec(window=window, has_prefix=True),
                      prefix_len=torch.from_numpy(PREFIX))
    grads = torch.autograd.grad(torch.sum(out * torch.cos(out)),
                                (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rout),
                               rtol=2e-5, atol=2e-5)
    for a, b, nm in zip(grads, rgrads, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5, err_msg=f"d{nm}")
    # the mask itself, and that the prefix changed the answer
    m = L._mask_block(torch.from_numpy(pos), torch.from_numpy(pos),
                      L.MaskSpec(window=window, has_prefix=True),
                      prefix_len=torch.from_numpy(PREFIX))
    want = ref_L._mask_block(jnp.asarray(pos), jnp.asarray(pos),
                             ref_L.MaskSpec(window=window, has_prefix=True),
                             jnp.asarray(PREFIX))
    np.testing.assert_array_equal(m.numpy(), np.asarray(want))
    assert m.shape == (B, S, S) and bool(m[1, 0, 10]) and not bool(m[0, 0, 10])
    causal = L.attention(*_t(q, k, v), q_pos=torch.from_numpy(pos),
                         kv_pos=torch.from_numpy(pos),
                         spec=L.MaskSpec(window=window))
    assert float((causal - out.detach()).abs().max()) > 1e-2


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("S", [24, 65])
def test_block_prefix_attention_matches_reference(S, window):
    """Blocks of 16 (S = 65 pads both axes): output and lse at rtol/atol
    2e-5, as the reference's blockwise == direct test; and equal to the
    direct branch on the same mask."""
    B, K, G, dh = 2, 2, 2, 16
    q, k, v = _arrays(S, (B, S, K, G, dh), (B, S, K, dh), (B, S, K, dh))
    pos = np.arange(S, dtype=np.int32)
    want, want_lse = ref_L._block_attention(
        *_j(q, k, v, pos, pos),
        ref_L.MaskSpec(causal=True, window=window, has_prefix=True),
        jnp.asarray(PREFIX), dh ** -0.5, q_block=16, kv_block=16,
        return_lse=True)
    spec = L.MaskSpec(causal=True, window=window, has_prefix=True)
    got, lse = L._block_attention(
        *_t(q, k, v, pos, pos), spec, dh ** -0.5, q_block=16, kv_block=16,
        return_lse=True, prefix_len=torch.from_numpy(PREFIX))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)
    direct = L.attention(*_t(q.reshape(B, S, K * G, dh), k, v), spec=spec,
                         q_pos=torch.from_numpy(pos),
                         kv_pos=torch.from_numpy(pos),
                         prefix_len=torch.from_numpy(PREFIX),
                         force_direct=True)
    np.testing.assert_allclose(got.reshape(B, S, K * G, dh).numpy(),
                               direct.numpy(), rtol=2e-5, atol=2e-5)


SPECS = {"causal": dict(causal=True), "window9": dict(causal=True, window=9)}


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_flash_prefix_value_and_grads_match_reference(spec, tiles):
    """The flash branch's forward and recomputing backward with the prefix
    mask, against the reference's ``jax.custom_vjp``: the scalar at rtol
    5e-5, gradients at rtol 1e-4 / atol 1e-5 (the reference's flash-VJP
    tolerances); ``prefix_len`` gets no gradient."""
    S, B, K, G, dh = 64, 2, 2, 2, 16
    q, k, v = _arrays(S + 1, (B, S, K, G, dh), (B, S, K, dh), (B, S, K, dh))
    pos = np.arange(S, dtype=np.int32)
    pl = np.asarray([9, 30], np.int32)

    def f_ref(q, k, v):
        o = ref_L._flash_attention(
            q, k, v, jnp.asarray(pos), jnp.asarray(pos),
            ref_L.MaskSpec(has_prefix=True, **SPECS[spec]), jnp.asarray(pl),
            dh ** -0.5, 16, 16, tiles=tiles)
        return jnp.sum(o * jnp.cos(o))

    rval, rgrads = jax.value_and_grad(f_ref, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    o = L._flash_attention(tq, tk, tv, torch.from_numpy(pos),
                           torch.from_numpy(pos),
                           L.MaskSpec(has_prefix=True, **SPECS[spec]),
                           dh ** -0.5, 16, 16, tiles=tiles,
                           prefix_len=torch.from_numpy(pl))
    assert o.grad_fn is not None and "Flash" in type(o.grad_fn).__name__
    val = torch.sum(o * torch.cos(o))
    grads = torch.autograd.grad(val, (tq, tk, tv))
    np.testing.assert_allclose(float(val.detach()), float(rval), rtol=5e-5)
    for a, b, nm in zip(grads, rgrads, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{nm}")


def test_windowed_prefix_batch_never_takes_the_gather(monkeypatch):
    """With the thresholds shrunk (direct ≤ 16, blocks of 16), 64 keys and
    a window of 8 send a causal batch to the window gather; the same batch
    with a prefix goes to the flash branch in both packages, and its output
    equals the direct branch's and the reference's."""
    patch_attention_thresholds(monkeypatch)
    B, S, H, K, dh, window = 2, 64, 4, 2, 8, 8
    q, k, v = _arrays(3, (B, S, H, dh), (B, S, K, dh), (B, S, K, dh))
    pos = np.arange(S, dtype=np.int32)
    pl = np.asarray([3, 20], np.int32)
    taken = []
    for name in ("_swa_gather_attention", "_flash_attention"):
        real = getattr(L, name)
        monkeypatch.setattr(L, name, lambda *a, _n=name, _r=real, **kw: (
            taken.append(_n), _r(*a, **kw))[1])
    kw = dict(q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos))
    L.attention(*_t(q, k, v), spec=L.MaskSpec(window=window), **kw)
    assert taken == ["_swa_gather_attention"]
    spec = L.MaskSpec(window=window, has_prefix=True)
    got = L.attention(*_t(q, k, v), spec=spec,
                      prefix_len=torch.from_numpy(pl), **kw)
    assert taken == ["_swa_gather_attention", "_flash_attention"]
    direct = L.attention(*_t(q, k, v), spec=spec,
                         prefix_len=torch.from_numpy(pl), force_direct=True,
                         **kw)
    want = ref_L.attention(*_j(q, k, v), spec=ref_L.MaskSpec(
        window=window, has_prefix=True), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), prefix_len=jnp.asarray(pl))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_segments_with_a_prefix_are_refused():
    """Packed segments and a prefix: the reference asserts, the port raises
    ``ValueError``, in every branch (checked before dispatch)."""
    B, S = 1, 8
    q, k, v = _arrays(0, (B, S, 2, 8), (B, S, 1, 8), (B, S, 1, 8))
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg = np.zeros((B, S), np.int32)
    with pytest.raises(AssertionError, match="prefix-LM"):
        ref_L.attention(*_j(q, k, v), spec=ref_L.MaskSpec(
            has_prefix=True, segmented=True), q_pos=jnp.asarray(pos),
            kv_pos=jnp.asarray(pos), q_seg=jnp.asarray(seg),
            kv_seg=jnp.asarray(seg), prefix_len=jnp.asarray([2]))
    for force_direct in (True, False):
        with pytest.raises(ValueError, match="prefix-LM"):
            L.attention(*_t(q, k, v), spec=L.MaskSpec(
                has_prefix=True, segmented=True),
                q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
                q_seg=torch.from_numpy(seg), kv_seg=torch.from_numpy(seg),
                prefix_len=torch.tensor([2]), force_direct=force_direct)


# --------------------------------------------------------------------------
# paligemma-3b's smoke config: train, data, serve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["direct", "flash"])
def test_fused_adalomo_step_matches_reference(pali, branch, monkeypatch):
    """One fused AdaLomo step of paligemma-3b's smoke config (tied head,
    embed scale, gelu, 8 prefix embeddings ahead of 16 tokens, prefix-LM)
    from the same weights and batch: |Δloss| ≤ 1e-4, metrics at 1e-4,
    params at rtol 1e-4 / atol 1e-5.  ``flash`` shrinks the thresholds in
    both packages, so the 24 positions take the flash branch (forward and
    recomputing backward) with the prefix mask."""
    if branch == "flash":
        patch_attention_thresholds(monkeypatch)
    ref, port, rp0, pp0 = pali
    pp = tree_map(torch.clone, pp0)
    batch = _prefix_batch(ref.cfg, 2, 16, seed=5)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rp, _, rloss, rmetrics = jax.jit(
        lambda p, s, b: ref.make_fused_train_step(ropt)(
            p, s, b, hparams=1e-3))(rp0, ropt.init(rp0), jax_batch(batch))
    _, _, ploss, pmetrics = port.make_fused_train_step(popt)(
        pp, popt.init(pp), torch_batch(batch), hparams=1e-3)
    assert abs(float(ploss) - float(rloss)) < LOSS_TOL
    assert float(pmetrics["ntokens"]) == 2 * 16       # the prefix has none
    for k in rmetrics:
        np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                   rtol=1e-4, atol=1e-6)
    assert_trees_close(pp, rp, what=branch, **PARAM_TOL)


def _run_specs():
    mk = lambda m: m.RunSpec(                               # noqa: E731
        model=m.ModelSpec(PALI, smoke=True),
        data=(DataConfig if m is spec_mod else RefDataConfig)(
            vocab=0, seq_len=16, global_batch=2, seed=3),
        opt=m.OptSpec(name="adalomo", lr=1e-3),
        steps=m.StepSpec(total=3), seed=3, log_every=0)
    return mk(ref_spec_mod), mk(spec_mod)


def test_batch_iter_extras_equal_reference(pali):
    """``run/data.py``'s stream: tokens, labels, ``prefix_embed`` and
    ``prefix_len`` bit for bit the reference's, from step 0, from a resumed
    step and on the eval stream; the leaves are ``train_batch_specs``'s, in
    their shapes and dtypes."""
    ref, port, _, _ = pali
    rspec, pspec = _run_specs()
    for start, offset in ((0, 0), (4, 0), (2, EVAL_SEED_OFFSET)):
        rit = ref_batch_iter(rspec, ref, start, seed_offset=offset)
        pit = make_batch_iter(pspec, port, start, seed_offset=offset)
        for _ in range(3):
            rb, pb = next(rit), next(pit)
            assert sorted(pb) == sorted(rb)
            for k in rb:
                assert pb[k].dtype == rb[k].dtype, k
                np.testing.assert_array_equal(pb[k], rb[k])
    specs = port.train_batch_specs(2, 16)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in pb.items()} == {
        k: (s, str(dt).removeprefix("torch.")) for k, (s, dt) in
        specs.items()}
    assert sorted(specs) == sorted(ref.train_batch_specs(2, 16))
    # a step's draw depends on its step: two steps differ
    a, b = (next(make_batch_iter(pspec, port, s)) for s in (0, 1))
    assert not np.array_equal(a["prefix_embed"], b["prefix_embed"])


def test_prefill_cache_matches_reference(pali):
    """The legacy prefill over 8 prefix embeddings and 12 tokens: the last
    logits, and a ring of W = S = 20 slots holding the prefix's K/V, equal
    to the reference's at 1e-5."""
    ref, port, rp, pp = pali
    b = _prefix_batch(ref.cfg, 2, 12, seed=9)
    del b["labels"]
    rlog, rcache = jax.jit(ref.make_prefill_step())(rp, jax_batch(b))
    plog, pcache = port.make_prefill_step()(pp, torch_batch(b))
    np.testing.assert_allclose(plog.numpy(), np.asarray(rlog), rtol=1e-5,
                               atol=1e-5)
    assert sorted(pcache) == sorted(rcache)
    assert tuple(pcache["k"].shape) == (2, 2, 20, 1, 16)
    for k in ("k", "v"):
        np.testing.assert_allclose(pcache[k].numpy(), np.asarray(rcache[k]),
                                   rtol=1e-5, atol=1e-5)
    for k in ("pos", "cur"):
        np.testing.assert_array_equal(pcache[k].numpy(),
                                      np.asarray(rcache[k]))


@pytest.mark.parametrize("lengths", [(10, 10), (4, 9)])
def test_engine_generate_with_extras_matches_reference(pali, lengths):
    """``Engine.generate(prompts, extras={prefix_embed, prefix_len})``:
    greedy tokens equal to the JAX ``Engine``'s.  The ring is S = text + 8
    slots wide, so the first decode token overwrites the first patch's K/V
    in both packages; equal and unequal prompts."""
    ref, port, rp, pp = pali
    rng = np.random.default_rng(sum(lengths))
    prompts = [rng.integers(1, ref.cfg.vocab, n).tolist() for n in lengths]
    extras = {k: v for k, v in _prefix_batch(ref.cfg, 2, 1, 11).items()
              if k.startswith("prefix")}
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=8)).generate(
        prompts, extras=extras)
    got = Engine(port, pp, ServeConfig(max_new_tokens=8),
                 device=CPU).generate(prompts, extras=extras)
    assert got == want
    # the prefix is read: another draw of it changes the tokens
    other = dict(extras, prefix_embed=3.0 * extras["prefix_embed"][::-1])
    assert Engine(port, pp, ServeConfig(max_new_tokens=8),
                  device=CPU).generate(prompts, extras=other) != got


def test_paged_serving_refuses_prefix_lm(pali):
    """``PagedEngine``, the registry's paged halves and the model's refuse
    paligemma, as the reference's do (it asserts)."""
    ref, port, rp, pp = pali
    assert not port.supports_paged_serving()
    assert port.supports_paged_serving() == ref.supports_paged_serving()
    with pytest.raises(AssertionError):
        RefPagedEngine(ref, rp, RefPagedConfig())
    with pytest.raises(ValueError, match="prefix-LM"):
        PagedEngine(port, pp, PagedServeConfig(), device=CPU)
    for make in (port.make_prefill_kv_step, port.make_paged_decode_step,
                 lambda: T.make_prefill_kv_step(port.cfg),
                 lambda: T.init_page_pool(port.cfg, 4, 8, device="cpu")):
        with pytest.raises(ValueError, match="prefix-LM"):
            make()
    # without the mask the same config could be served paged
    plain = dataclasses.replace(port, cfg=dataclasses.replace(
        port.cfg, prefix_lm=False))
    assert plain.supports_paged_serving()
