"""PyTorch port vs the JAX reference: no-cross-segment attention for packed
batches (``models/layers.py``) — the direct, blockwise and flash branches,
forward and gradients, against the reference's own functions and against a
per-document oracle; the bitwise zero-leakage identity; the ``segmented``
consistency error; and the dispatcher never sending a packed batch to the
window gather.  Mirrors ``tests/models/test_segment_attention.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_L
from repro_torch.models import layers as L
from torch_parity import patch_attention_thresholds

B, S, K, G, dh = 2, 48, 2, 2, 16
H = K * G
ROWS = [[12, 20, 16], [30, 10]]  # row 1 has an 8-slot padding tail
SCALE = dh ** -0.5
# tolerances of the reference's test: the oracle 2e-5, flash value 5e-5,
# flash gradients rtol 1e-4 / atol 1e-5; port vs reference at fp32 1e-5.
ORACLE_TOL = 2e-5
REF_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _meta():
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, lens in enumerate(ROWS):
        o = 0
        for j, n in enumerate(lens):
            seg[b, o:o + n] = j + 1
            pos[b, o:o + n] = np.arange(n)
            o += n
    return seg, pos


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, S, H, dh)).astype(np.float32),
            rng.standard_normal((B, S, K, dh)).astype(np.float32),
            rng.standard_normal((B, S, K, dh)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _oracle(q, k, v, window=None):
    """Per-document direct attention of the port on sliced inputs — no
    packing, no segment ids."""
    spec = L.MaskSpec(causal=True, window=window)
    out = np.zeros((B, S, H, dh), np.float32)
    for b, lens in enumerate(ROWS):
        o = 0
        for n in lens:
            sl = slice(o, o + n)
            po = torch.arange(n)
            qs, ks, vs = _t(q[b:b + 1, sl], k[b:b + 1, sl], v[b:b + 1, sl])
            out[b, sl] = L.attention(qs, ks, vs, spec=spec, q_pos=po,
                                     kv_pos=po, force_direct=True)[0].numpy()
            o += n
    return out


def _real(seg):
    return (seg > 0)[..., None, None]


@pytest.mark.parametrize("window", [None, 7])
def test_direct_matches_reference_and_oracle(qkv, window):
    q, k, v = qkv
    seg, pos = _meta()
    o = L.attention(*_t(q, k, v), spec=L.MaskSpec(window=window,
                                                   segmented=True),
                    q_pos=_t(pos)[0], kv_pos=_t(pos)[0], q_seg=_t(seg)[0],
                    kv_seg=_t(seg)[0], force_direct=True).numpy()
    want = ref_L.attention(*_j(q, k, v), spec=ref_L.MaskSpec(
        window=window, segmented=True), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), q_seg=jnp.asarray(seg),
        kv_seg=jnp.asarray(seg), force_direct=True)
    np.testing.assert_allclose(o, np.asarray(want), **REF_TOL)
    err = np.abs(o - _oracle(q, k, v, window)) * _real(seg)
    assert err.max() < ORACLE_TOL


@pytest.mark.parametrize("tiles", [1, 2])
def test_block_matches_reference_and_oracle(qkv, tiles):
    q, k, v = qkv
    seg, pos = _meta()
    spec = L.MaskSpec(causal=True, segmented=True)
    o, lse = L._block_attention(
        _t(q)[0].reshape(B, S, K, G, dh), *_t(k, v, pos, pos), spec, SCALE,
        16, 16, tiles, return_lse=True, q_seg=_t(seg)[0], kv_seg=_t(seg)[0])
    want, want_lse = ref_L._block_attention(
        jnp.asarray(q).reshape(B, S, K, G, dh), *_j(k, v, pos, pos),
        ref_L.MaskSpec(causal=True, segmented=True), None, SCALE,
        q_block=16, kv_block=16, tiles=tiles, return_lse=True,
        q_seg=jnp.asarray(seg), kv_seg=jnp.asarray(seg))
    live = seg > 0
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **REF_TOL)
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(want_lse)[live],
                               **REF_TOL)
    err = np.abs(o.numpy().reshape(B, S, H, dh) - _oracle(q, k, v)) \
        * _real(seg)
    assert err.max() < ORACLE_TOL


def test_block_with_shared_positions_broadcasts_them_per_row(qkv):
    """``(S,)`` positions with segment ids are the reference's broadcast
    ``(B, S)`` rows: the same output either way."""
    q, k, v = qkv
    seg, _ = _meta()
    spec = L.MaskSpec(causal=True, segmented=True)
    shared = torch.arange(S)
    qr = _t(q)[0].reshape(B, S, K, G, dh)
    a = L._block_attention(qr, *_t(k, v), shared, shared, spec, SCALE, 16,
                           16, q_seg=_t(seg)[0], kv_seg=_t(seg)[0])
    b = L._block_attention(qr, *_t(k, v), shared.expand(B, S),
                           shared.expand(B, S), spec, SCALE, 16, 16,
                           q_seg=_t(seg)[0], kv_seg=_t(seg)[0])
    assert torch.equal(a, b)


@pytest.mark.parametrize("branch", ["direct", "block"])
def test_zero_leakage_is_bitwise(qkv, branch):
    """Replace every token outside segment 1 with junk k/v: segment 1's
    output is *bitwise* unchanged — masked logits are exact zeros after the
    softmax (direct) or after the online-softmax correction (blockwise),
    and the shapes are the same."""
    q, k, v = qkv
    seg, pos = _meta()
    spec = L.MaskSpec(causal=True, segmented=True)
    tq, tpos, tseg = _t(q, pos, seg)

    def att(k_, v_):
        if branch == "direct":
            return L.attention(tq, k_, v_, spec=spec, q_pos=tpos,
                               kv_pos=tpos, q_seg=tseg, kv_seg=tseg,
                               force_direct=True).numpy()
        return L._block_attention(tq.reshape(B, S, K, G, dh), k_, v_, tpos,
                                  tpos, spec, SCALE, 16, 16, q_seg=tseg,
                                  kv_seg=tseg).reshape(B, S, H, dh).numpy()

    tgt = seg == 1
    keep = tgt[..., None, None]
    o_ref = att(*_t(k, v))
    o_scrub = att(*_t(np.where(keep, k, 7.25).astype(np.float32),
                      np.where(keep, v, -3.5).astype(np.float32)))
    np.testing.assert_array_equal(o_ref[tgt], o_scrub[tgt])


def _flash_and_direct_grads(q, k, v, seg, pos, tiles):
    """dq, dk, dv of the port's flash branch and of its direct branch under
    autograd, with padded slots carrying no gradient signal."""
    spec = L.MaskSpec(causal=True, segmented=True)
    live = torch.from_numpy(seg > 0)[:, :, None, None, None]
    tpos, tseg = _t(pos, seg)
    out = {}
    for name in ("flash", "direct"):
        tq, tk, tv = [x.requires_grad_(True) for x in _t(q, k, v)]
        qr = tq.reshape(B, S, K, G, dh)
        if name == "flash":
            o = L._flash_attention(qr, tk, tv, tpos, tpos, spec, SCALE, 16,
                                   16, tiles, q_seg=tseg, kv_seg=tseg)
        else:
            o = L.attention(tq, tk, tv, spec=spec, q_pos=tpos, kv_pos=tpos,
                            q_seg=tseg, kv_seg=tseg, force_direct=True
                            ).reshape(B, S, K, G, dh)
        o = o * live
        val = torch.sum(o * torch.cos(o))
        out[name] = (val.item(), *[g.numpy() for g in
                                   torch.autograd.grad(val, (tq, tk, tv))])
    return out


@pytest.mark.parametrize("tiles", [1, 2])
def test_flash_value_and_grads_match_direct_and_reference(qkv, tiles):
    """The flash branch's forward and its recomputing backward (dq, dk,
    dv) against the port's direct branch under autograd and against the
    reference's ``_flash_attention`` under ``jax.value_and_grad``."""
    q, k, v = qkv
    seg, pos = _meta()
    got = _flash_and_direct_grads(q, k, v, seg, pos, tiles)
    live = (seg > 0)[:, :, None, None, None]
    rspec = ref_L.MaskSpec(causal=True, segmented=True)

    def f_ref(q_, k_, v_):
        o = ref_L._flash_attention(
            q_.reshape(B, S, K, G, dh), k_, v_, jnp.asarray(pos),
            jnp.asarray(pos), rspec, None, SCALE, 16, 16, tiles=tiles,
            q_seg=jnp.asarray(seg), kv_seg=jnp.asarray(seg)) * live
        return jnp.sum(o * jnp.cos(o))

    rv, rg = jax.value_and_grad(f_ref, argnums=(0, 1, 2))(*_j(q, k, v))
    np.testing.assert_allclose(got["flash"][0], got["direct"][0], rtol=5e-5)
    np.testing.assert_allclose(got["flash"][0], float(rv), rtol=5e-5)
    for i, name in enumerate(("dq", "dk", "dv"), start=1):
        np.testing.assert_allclose(got["flash"][i], got["direct"][i],
                                   err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(got["flash"][i], np.asarray(rg[i - 1]),
                                   err_msg=name, **GRAD_TOL)


def test_flash_grads_do_not_cross_segments(qkv):
    """A loss on segment 1 of row 0 only: every other slot's dk and dv are
    exact zeros in the flash backward."""
    q, k, v = qkv
    seg, pos = _meta()
    spec = L.MaskSpec(causal=True, segmented=True)
    tq, tk, tv = [x.requires_grad_(True) for x in _t(q, k, v)]
    tpos, tseg = _t(pos, seg)
    o = L._flash_attention(tq.reshape(B, S, K, G, dh), tk, tv, tpos, tpos,
                           spec, SCALE, 16, 16, q_seg=tseg, kv_seg=tseg)
    tgt = torch.zeros(B, S, dtype=torch.bool)
    tgt[0] = tseg[0] == 1
    dk, dv = torch.autograd.grad((o[tgt] ** 2).sum(), (tk, tv))
    assert torch.count_nonzero(dk[~tgt]) == 0
    assert torch.count_nonzero(dv[~tgt]) == 0
    assert torch.count_nonzero(dk[tgt]) > 0


def test_segmented_consistency_raises(qkv):
    """The reference asserts ``spec.segmented == (q_seg is not None)``; the
    port raises a ``ValueError`` either way round."""
    q, k, v = qkv
    seg, pos = _meta()
    tq, tk, tv, tpos, tseg = _t(q, k, v, pos, seg)
    with pytest.raises(ValueError, match="segmented"):
        L.attention(tq, tk, tv, spec=L.MaskSpec(causal=True), q_pos=tpos,
                    kv_pos=tpos, q_seg=tseg, kv_seg=tseg)
    with pytest.raises(ValueError, match="segmented"):
        L.attention(tq, tk, tv, spec=L.MaskSpec(causal=True, segmented=True),
                    q_pos=torch.arange(S), kv_pos=torch.arange(S))


def test_packed_batch_past_the_window_never_takes_the_gather(qkv,
                                                             monkeypatch):
    """With the thresholds shrunk (direct ≤ 16, blocks of 16) and a window
    of 8, S = 48 is past ``window + block``: an unpacked batch takes the
    window gather, a packed one the flash branch — as in the reference,
    whose dispatcher is run under the same thresholds."""
    q, k, v = qkv
    seg, pos = _meta()
    patch_attention_thresholds(monkeypatch, direct=16, block=16)
    calls = []
    real_gather = L._swa_gather_attention
    monkeypatch.setattr(L, "_swa_gather_attention",
                        lambda *a, **kw: calls.append(1) or real_gather(
                            *a, **kw))
    tq, tk, tv, tpos, tseg = _t(q, k, v, pos, seg)
    L.attention(tq, tk, tv, spec=L.MaskSpec(window=8), q_pos=torch.arange(S),
                kv_pos=torch.arange(S))
    assert calls == [1]                        # the unpacked batch: gather
    o = L.attention(tq, tk, tv, spec=L.MaskSpec(window=8, segmented=True),
                    q_pos=tpos, kv_pos=tpos, q_seg=tseg, kv_seg=tseg)
    assert calls == [1]                        # the packed batch: not
    want = ref_L.attention(*_j(q, k, v), spec=ref_L.MaskSpec(
        window=8, segmented=True), q_pos=jnp.asarray(pos),
        kv_pos=jnp.asarray(pos), q_seg=jnp.asarray(seg),
        kv_seg=jnp.asarray(seg))
    live = _real(seg)
    np.testing.assert_allclose(o.numpy() * live, np.asarray(want) * live,
                               **REF_TOL)
    err = np.abs(o.numpy() - _oracle(q, k, v, window=8)) * live
    assert err.max() < ORACLE_TOL


def test_rope_with_per_row_positions_matches_reference():
    """RoPE at ``(B, S)`` positions that restart per document: sin/cos per
    row, ``[B, S, 1, d]`` against ``[B, S, H, d]``."""
    rng = np.random.default_rng(2)
    _, pos = _meta()
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    sin, cos = L.rope_sincos(torch.from_numpy(pos), dh)
    assert sin.shape == (B, S, dh // 2)
    got = L.apply_rope(torch.from_numpy(x), sin, cos).numpy()
    rs, rc = ref_L.rope_sincos(jnp.asarray(pos), dh)
    want = ref_L.apply_rope(jnp.asarray(x), rs, rc)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    # a document's rotation depends on its own positions only: row 0's
    # third document (offset 32) is rotated as if it started the row
    solo_sin, solo_cos = L.rope_sincos(torch.arange(16), dh)
    solo = L.apply_rope(torch.from_numpy(x[:1, 32:48]), solo_sin, solo_cos)
    np.testing.assert_array_equal(got[:1, 32:48], solo.numpy())
