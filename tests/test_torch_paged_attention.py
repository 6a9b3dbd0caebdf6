"""PyTorch port vs the JAX reference: paged decode attention.

The port's plain ``paged_decode_attention_ref`` and ``ops.paged_decode_attention``
(on the CPU: the plain version) against the reference's gather oracle and its
Pallas kernel in interpret mode, over the reference's cases; a danube-shaped
case against the gather oracle only (interpret mode is slow at that grid); the
scratch-page garbage case; ``layers.decode_attention`` against the
reference's.  Inputs are made with numpy from a seed and handed to both.
Tolerances are the reference's own: fp32 1e-5, bf16 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    paged_decode_attention_pallas)
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref,
    paged_decode_attention_ref as jax_paged_ref)
from repro_torch.kernels.decode_attention import decode_attention as KD
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.models import layers as L
from torch_parity import np_f32

# B, H, K, dh, page_size, P, window, seq_lens — tests/serve/test_paged_attention.py
CASES = [
    (3, 8, 2, 64, 8, 4, None, (19, 9, 25)),
    (2, 4, 4, 32, 16, 2, None, (1, 32)),
    (4, 8, 8, 64, 4, 8, 6, (30, 3, 17, 8)),
    (1, 16, 4, 128, 8, 3, None, (24,)),
]
# h2o-danube-1.8b's heads (32 query, 8 KV, dh 80) and pages of 16, ragged
DANUBE = [(5, 32, 8, 80, 16, 19, w, (1, 15, 16, 17, 300)) for w in (None, 6)]
# B, W, H, K, dh, window, cur — tests/kernels/test_decode_attention_kernel.py
DENSE_CASES = [
    (2, 128, 8, 2, 64, None, 100),
    (1, 300, 4, 4, 128, None, 250),
    (3, 512, 16, 4, 64, 64, 400),
    (2, 64, 8, 8, 32, None, 10),
    (1, 1024, 32, 8, 128, 256, 900),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _paged_inputs(seed, B, H, K, dh, ps, P, seq_lens):
    """q, a pool whose pages are shuffled over the sequences (random values
    everywhere, page 0 and unused slots included), block tables, lengths."""
    rng = np.random.default_rng(seed)
    N = 1 + B * P
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kp = rng.standard_normal((N, ps, K, dh)).astype(np.float32)
    vp = rng.standard_normal((N, ps, K, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    return q, kp, vp, bt, np.asarray(seq_lens, np.int32)


def _both(arrays, dtype):
    """The same values as JAX and torch arrays; float arrays in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
         for a in arrays]
    t = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
         else torch.from_numpy(a) for a in arrays]
    return j, t


def _close(port, ref, dtype):
    np.testing.assert_allclose(np_f32(port), np_f32(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,K,dh,ps,P,window,seq_lens", CASES)
def test_paged_matches_reference_and_pallas(B, H, K, dh, ps, P, window,
                                            seq_lens, dtype):
    (jq, jk, jv, jbt, jsl), (q, k, v, bt, sl) = _both(
        _paged_inputs(B * 31 + P, B, H, K, dh, ps, P, seq_lens), dtype)
    want = jax_paged_ref(jq, jk, jv, jbt, jsl, window=window)
    pallas = paged_decode_attention_pallas(jq, jk, jv, jbt, jsl,
                                           window=window, interpret=True)
    got = paged_decode_attention_ref(q, k, v, bt, sl, window=window)
    _close(got, want, dtype)
    _close(got, pallas, dtype)
    for use_kernel in (None, False):
        out = ops.paged_decode_attention(q[:, None], k, v, bt, sl,
                                         window=window, use_kernel=use_kernel)
        assert out.shape == (B, 1, H, dh) and out.dtype == q.dtype
        _close(out[:, 0], want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,K,dh,ps,P,window,seq_lens", DANUBE)
def test_paged_danube_shape_matches_reference(B, H, K, dh, ps, P, window,
                                              seq_lens, dtype):
    (jq, jk, jv, jbt, jsl), (q, k, v, bt, sl) = _both(
        _paged_inputs(7, B, H, K, dh, ps, P, seq_lens), dtype)
    want = jax_paged_ref(jq, jk, jv, jbt, jsl, window=window)
    _close(paged_decode_attention_ref(q, k, v, bt, sl, window=window), want,
           dtype)
    # the kernel's wrapper on a CPU tensor is the plain version, unlaunched
    before = KD.paged_decode_attention.launches
    _close(KD.paged_decode_attention(q, k, v, bt, sl, window=window), want,
           dtype)
    assert KD.paged_decode_attention.launches == before


def test_paged_ignores_scratch_garbage():
    """Unallocated block-table tail entries point at scratch page 0; junk
    there must never leak into the output (reference test, same shapes)."""
    B, H, K, dh, ps, P = 2, 4, 2, 32, 8, 4
    q, kp, vp, bt, sl = _paged_inputs(7, B, H, K, dh, ps, P, (5, 11))
    out1 = paged_decode_attention_ref(*map(torch.from_numpy,
                                           (q, kp, vp, bt, sl)))
    kp2, vp2, bt2 = kp.copy(), vp.copy(), bt.copy()
    kp2[0], vp2[0] = 1e9, -1e9
    bt2[:, 2:] = 0                     # tail -> scratch (lens fit 2 pages)
    out2 = paged_decode_attention_ref(*map(torch.from_numpy,
                                           (q, kp2, vp2, bt2, sl)))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = jax_paged_ref(*map(jnp.asarray, (q, kp2, vp2, bt2, sl)))
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_empty_row_gives_mean_of_v_like_the_reference():
    """A sequence with no valid position: the dense oracle softmaxes a row
    of NEG_INF to uniform in both packages (the kernels return 0 there; the
    engine never makes such a row)."""
    arrays = _paged_inputs(3, 2, 4, 2, 32, 8, 2, (0, 9))
    (jq, jk, jv, jbt, jsl), (q, k, v, bt, sl) = _both(arrays, "float32")
    got = paged_decode_attention_ref(q, k, v, bt, sl)
    _close(got, jax_paged_ref(jq, jk, jv, jbt, jsl), "float32")


def test_use_kernel_true_on_cpu_raises():
    q, k, v, bt, sl = map(torch.from_numpy,
                          _paged_inputs(0, 2, 4, 2, 32, 8, 2, (3, 9)))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(q[:, None], k, v, bt, sl, use_kernel=True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,W,H,K,dh,window,cur", DENSE_CASES)
def test_decode_attention_matches_reference(B, W, H, K, dh, window, cur,
                                            dtype):
    rng = np.random.default_rng(B * W)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    vc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    pos = np.where(np.arange(W) <= cur, np.arange(W), -1).astype(np.int32)
    kv_pos = np.broadcast_to(pos, (B, W)).copy()
    q_pos = np.full((B,), cur, np.int32)
    (jq, jk, jv, jkp, jqp), (tq, tk, tv, tkp, tqp) = _both(
        (q, kc, vc, kv_pos, q_pos), dtype)
    want = jax_decode_ref(jq, jk, jv, kv_pos=jkp, q_pos=jqp, window=window)
    got = decode_attention_ref(tq, tk, tv, kv_pos=tkp, q_pos=tqp,
                               window=window)
    _close(got, want, dtype)
    layer = L.decode_attention(tq[:, None], tk, tv, kv_pos=tkp, q_pos=tqp,
                               window=window)
    assert layer.shape == (B, 1, H, dh)
    _close(layer[:, 0], want, dtype)
