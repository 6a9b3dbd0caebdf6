"""PyTorch port vs the JAX reference: the long-sequence attention branches of
``models/layers.py`` — blockwise online-softmax attention, the sliding-window
gather, the flash backward (``_FlashAttention``) against the reference's
``jax.custom_vjp``, and the dispatcher past 2048 tokens against
``force_direct``.  fp32 on the CPU, numpy-made inputs on both sides, the
reference tests' tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_L
from repro_torch.models import layers as L


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("S", [24, 65])
def test_block_attention_matches_reference(S, window):
    """Blocks of 16 (S = 65 pads both axes); rtol/atol 2e-5 as the
    reference's blockwise == direct test."""
    B, K, G, dh = 2, 2, 2, 16
    q, k, v = _arrays(S, (B, S, K, G, dh), (B, S, K, dh), (B, S, K, dh))
    pos = np.arange(S, dtype=np.int32)
    want, want_lse = ref_L._block_attention(
        *_j(q, k, v, pos, pos), ref_L.MaskSpec(causal=True, window=window),
        None, dh ** -0.5, q_block=16, kv_block=16, return_lse=True)
    got, lse = L._block_attention(
        *_t(q, k, v, pos, pos), L.MaskSpec(causal=True, window=window),
        dh ** -0.5, q_block=16, kv_block=16, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S,window,q_block", [(96, 16, 16), (90, 16, 16),
                                              (70, 5, 32)])
def test_swa_gather_matches_reference(S, window, q_block):
    """S = 90 and 70 leave a ragged last query block, whose window start the
    reference's ``dynamic_slice`` clamps."""
    B, K, G, dh = 1, 4, 1, 8
    q, k, v = _arrays(S + window, (B, S, K, G, dh), (B, S, K, dh),
                      (B, S, K, dh))
    pos = np.arange(S, dtype=np.int32)
    want = ref_L._swa_gather_attention(
        *_j(q, k, v, pos, pos), ref_L.MaskSpec(causal=True, window=window),
        dh ** -0.5, q_block=q_block)
    got = L._swa_gather_attention(
        *_t(q, k, v, pos, pos), L.MaskSpec(causal=True, window=window),
        dh ** -0.5, q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    direct = L.attention(*_t(q.reshape(B, S, K * G, dh), k, v),
                         spec=L.MaskSpec(window=window),
                         q_pos=torch.from_numpy(pos),
                         kv_pos=torch.from_numpy(pos), force_direct=True)
    np.testing.assert_allclose(got.reshape(B, S, K * G, dh).numpy(),
                               direct.numpy(), rtol=2e-5, atol=2e-5)


SPECS = {"causal": dict(causal=True), "window9": dict(causal=True, window=9),
         "non_causal": dict(causal=False)}


def _flash_value_and_grads(S, spec_kw, tiles, loss):
    B, K, G, dh = 2, 2, 2, 16
    q, k, v = _arrays(S, (B, S, K, G, dh), (B, S, K, dh), (B, S, K, dh))
    pos = np.arange(S, dtype=np.int32)
    rspec = ref_L.MaskSpec(**spec_kw)

    def f_ref(q, k, v):
        o = ref_L._flash_attention(q, k, v, jnp.asarray(pos),
                                   jnp.asarray(pos), rspec, None, dh ** -0.5,
                                   16, 16, tiles=tiles)
        return loss(o, jnp)

    rval, rgrads = jax.value_and_grad(f_ref, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    o = L._flash_attention(tq, tk, tv, torch.from_numpy(pos),
                           torch.from_numpy(pos), L.MaskSpec(**spec_kw),
                           dh ** -0.5, 16, 16, tiles=tiles)
    val = loss(o, torch)
    grads = torch.autograd.grad(val, (tq, tk, tv))
    return (val, grads), (rval, rgrads)


@pytest.mark.parametrize("tiles", [1, 2, 4])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_flash_value_and_grads_match_reference(spec, tiles):
    """The reference's flash-VJP tolerances: the scalar at rtol 5e-5 (sums
    in other association orders), gradients at rtol 1e-4 / atol 1e-5."""
    (val, grads), (rval, rgrads) = _flash_value_and_grads(
        64, SPECS[spec], tiles, lambda o, xp: xp.sum(o * xp.cos(o)))
    np.testing.assert_allclose(float(val.detach()), float(rval), rtol=5e-5)
    for a, b, nm in zip(grads, rgrads, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{nm}")


def test_flash_non_divisible_blocks_match_reference():
    (val, grads), (rval, rgrads) = _flash_value_and_grads(
        50, SPECS["causal"], 1, lambda o, xp: xp.sum(xp.tanh(o)))
    np.testing.assert_allclose(float(val.detach()), float(rval), rtol=1e-5)
    for a, b, nm in zip(grads, rgrads, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{nm}")


def test_flash_without_grad_runs_forward_only():
    q, k, v = _t(*_arrays(0, (1, 40, 1, 2, 8), (1, 40, 1, 8), (1, 40, 1, 8)))
    pos = torch.arange(40, dtype=torch.int32)
    with torch.no_grad():
        out = L._flash_attention(q.requires_grad_(True), k, v, pos, pos,
                                 L.MaskSpec(), 8 ** -0.5, 16, 16)
    assert out.grad_fn is None
    want = L._block_attention(q.detach(), k, v, pos, pos, L.MaskSpec(),
                              8 ** -0.5, 16, 16)
    assert torch.equal(out, want)


@pytest.mark.parametrize("window,branch", [(None, "_flash_attention"),
                                           (1500, "_flash_attention"),
                                           (8, "_swa_gather_attention")])
def test_dispatcher_past_2048_matches_direct(window, branch, monkeypatch):
    """S = 2100 at tiny widths: the branch the reference's dispatcher takes
    (flash below window + 1024, the gather above it) against force_direct,
    forward and, through the flash branch, gradients."""
    calls = []
    real = getattr(L, branch)
    monkeypatch.setattr(L, branch,
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    S, H, K, dh = 2100, 2, 1, 8
    q, k, v = _arrays(1, (1, S, H, dh), (1, S, K, dh), (1, S, K, dh))
    pos = torch.arange(S, dtype=torch.int32)
    spec = L.MaskSpec(window=window)
    outs, grads = [], []
    for force in (False, True):
        tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
        o = L.attention(tq, tk, tv, spec=spec, q_pos=pos, kv_pos=pos,
                        force_direct=force)
        outs.append(o.detach())
        grads.append(torch.autograd.grad(torch.sum(torch.sin(o)),
                                         (tq, tk, tv)))
    assert len(calls) == 1
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=2e-5,
                               atol=2e-5)
    for a, b, nm in zip(*grads, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{nm}")
    want = ref_L.attention(*_j(q, k, v),
                           spec=ref_L.MaskSpec(window=window),
                           q_pos=jnp.arange(S, dtype=jnp.int32),
                           kv_pos=jnp.arange(S, dtype=jnp.int32))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
