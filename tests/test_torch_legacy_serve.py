"""PyTorch port vs the JAX reference: legacy static-batch serving over a ring
KV cache.

``make_prefill_step`` / ``make_decode_step`` / ``init_cache`` of the port
against the reference's on the danube smoke config (window 8, so the ring
wraps), including prompts past the (patched) direct-attention threshold;
the reference's decode == prefill and ring == full-cache equivalences
re-run on the port; ``Engine`` greedy tokens against the JAX ``Engine``
(equal prompts, right-padded unequal prompts, EOS freezing), one host copy
per decode step; ``ops.decode_attention`` on the CPU against the reference's
K4 ``decode_attention_pallas`` in interpret mode over the kernel tests'
cases and their ragged-ring property.  fp32 unless stated; inputs made with
numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline CI: deterministic shim (tests/_compat)
    from hypothesis_stub import given, settings, strategies as st

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas)
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefConfig
from repro_torch.kernels.decode_attention import decode_attention as KD
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import ring_decode_attention_ref
from repro_torch.serve.engine import Engine, ServeConfig
from torch_parity import (CPU, np_f32, patch_attention_thresholds,
                          ref_params_and_copy, smoke_archs, tiny_llama_archs)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def danube():
    ref, port = smoke_archs()
    assert port.cfg.window == 8
    rp, pp = ref_params_and_copy(ref, seed=2)
    return ref, port, rp, pp


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)).astype(
        np.int32)


def _assert_cache_close(port_cache, ref_cache):
    for name in ("k", "v"):
        np.testing.assert_allclose(np_f32(port_cache[name]),
                                   np_f32(ref_cache[name]), **TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(port_cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    assert int(port_cache["cur"]) == int(ref_cache["cur"])


@pytest.mark.parametrize("S", [5, 12])
def test_prefill_and_decode_steps_match_reference(danube, S):
    """S = 5: a ring of 5 slots (the prompt's length) whose first decode
    step overwrites position 0; S = 12: a ring of the window's 8 slots.
    Six decode steps, logits and the whole cache after each."""
    ref, port, rp, pp = danube
    toks = _tokens(port.cfg.vocab, 2, S, seed=S)
    rlog, rcache = jax.jit(ref.make_prefill_step())(
        rp, {"tokens": jnp.asarray(toks)})
    plog, pcache = port.make_prefill_step()(pp,
                                            {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(np_f32(plog), np_f32(rlog), **TOL)
    assert pcache["k"].shape == (2, 2, min(S, 8), 2, 16)
    _assert_cache_close(pcache, rcache)
    rdec = jax.jit(ref.make_decode_step())
    pdec = port.make_decode_step()
    nxt = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)[:, None]
    for _ in range(6):
        rlog, rcache = rdec(rp, rcache, {"tokens": jnp.asarray(nxt)})
        plog, pcache2 = pdec(pp, pcache, {"tokens": torch.from_numpy(nxt)})
        assert pcache2 is pcache                    # updated in place
        np.testing.assert_allclose(np_f32(plog), np_f32(rlog), **TOL)
        _assert_cache_close(pcache, rcache)
        nxt = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)[:, None]


def test_decode_matches_prefill_logits(danube):
    """Token-by-token decode from an empty cache reproduces the prefill's
    last-position logits (the reference's own equivalence, 2e-4)."""
    _, port, _, pp = danube
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(port.cfg.vocab, B, S, seed=3))
    lg_prefill, _ = port.make_prefill_step()(pp, {"tokens": toks})
    decode = port.make_decode_step()
    cache = port.init_cache(B, S + 4, device="cpu")
    assert cache["k"].shape[2] == port.cfg.window
    for t in range(S):
        lg, cache = decode(pp, cache, {"tokens": toks[:, t:t + 1]})
    np.testing.assert_allclose(lg.numpy(), lg_prefill.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert int(cache["cur"]) == S


def test_swa_ring_cache_decode(danube):
    """SWA decode with a ring of W slots matches decode with a cache larger
    than the sequence."""
    _, port, _, pp = danube
    T = 14                                          # beyond the window
    toks = torch.from_numpy(_tokens(port.cfg.vocab, 1, T, seed=4))
    decode = port.make_decode_step()
    ring = port.init_cache(1, max_len=port.cfg.window, device="cpu")
    assert ring["k"].shape[2] == port.cfg.window
    big = dict(port.init_cache(1, max_len=64, device="cpu"))
    for t in range(T):
        lg_r, ring = decode(pp, ring, {"tokens": toks[:, t:t + 1]})
        lg_b, big = decode(pp, big, {"tokens": toks[:, t:t + 1]})
    np.testing.assert_allclose(lg_r.numpy(), lg_b.numpy(), rtol=2e-4,
                               atol=2e-4)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------

PROMPTS = {"equal": [[5, 17, 23, 9, 2, 11], [101, 44, 3, 3, 8, 61]],
           "unequal": [[5, 17, 23, 9], [101, 44], [7] * 11]}


@pytest.mark.parametrize("arch", ["danube_smoke", "tiny_llama"])
@pytest.mark.parametrize("prompts", sorted(PROMPTS))
def test_engine_greedy_matches_reference(arch, prompts):
    """Right-padded unequal prompts are sampled at the longest length - 1
    in both engines; the ring is sized to the prompt in both."""
    ref, port = smoke_archs() if arch == "danube_smoke" else \
        tiny_llama_archs(layers=2, d=64)
    rp, pp = ref_params_and_copy(ref, seed=0)
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=10)).generate(
        PROMPTS[prompts])
    got = Engine(port, pp, ServeConfig(max_new_tokens=10),
                 device=CPU).generate(PROMPTS[prompts])
    assert got == want
    assert all(len(o) == 10 for o in got)


def test_engine_eos_freezes_rows_like_reference(danube):
    ref, port, rp, pp = danube
    prompts = PROMPTS["unequal"]
    probe = Engine(port, pp, ServeConfig(max_new_tokens=8),
                   device=CPU).generate(prompts)
    eos = probe[0][2]                   # row 0's third token becomes EOS
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=8,
                                        eos_id=eos)).generate(prompts)
    got = Engine(port, pp, ServeConfig(max_new_tokens=8, eos_id=eos),
                 device=CPU).generate(prompts)
    assert got == want
    assert got[0] == probe[0][:3] and got[0][-1] == eos
    assert all(len(o) <= 8 for o in got)


def test_engine_one_host_copy_per_decode_step(danube, monkeypatch):
    """Each emitted step reads tokens and the done mask back in one
    ``.cpu()``; nothing else leaves the device (no ``.item()``, no
    ``int(tensor)``, no ``.tolist()``)."""
    _, port, _, pp = danube
    calls = {"cpu": 0, "item": 0, "tolist": 0, "__int__": 0}
    for name in calls:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    out = Engine(port, pp, ServeConfig(max_new_tokens=7),
                 device=CPU).generate(PROMPTS["unequal"])
    monkeypatch.undo()
    assert all(len(o) == 7 for o in out)
    assert calls == {"cpu": 7, "item": 0, "tolist": 0, "__int__": 0}


def test_engine_rejects_extras_and_foreign_params(danube):
    _, port, _, pp = danube
    eng = Engine(port, pp, ServeConfig(), device=CPU)
    # danube has no modality prefix: a prefix is not one of its inputs
    with pytest.raises(ValueError, match="not inputs of"):
        eng.generate([[1, 2]], extras={"prefix_embed": np.zeros((1, 2, 4))})
    with pytest.raises(ValueError, match="params lie on"):
        Engine(port, pp, ServeConfig(), device="meta")


def test_use_kernel_true_on_cpu_raises(danube):
    _, port, _, pp = danube
    eng = Engine(port, pp, ServeConfig(use_kernel=True, max_new_tokens=3),
                 device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        eng.generate([[1, 2, 3]])
    q = torch.zeros(1, 1, 4, 16)
    kc = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, kc, kc, torch.arange(8, dtype=torch.int32),
                             7, use_kernel=True)


# --------------------------------------------------------------------------
# Past the direct-attention threshold (patched small in both packages)
# --------------------------------------------------------------------------

# window 8: S > 8 + 16 takes the sliding-window gather; window 48: the
# blockwise (flash) branch, as a window-less model would
BRANCHES = {"swa_gather": 8, "flash": 48}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_legacy_prefill_past_threshold_matches_reference(branch,
                                                         monkeypatch):
    patch_attention_thresholds(monkeypatch)
    ref, port = smoke_archs(window=BRANCHES[branch])
    rp, pp = ref_params_and_copy(ref, seed=5)
    toks = _tokens(port.cfg.vocab, 2, 40, seed=6)
    rlog, rcache = jax.jit(ref.make_prefill_step())(
        rp, {"tokens": jnp.asarray(toks)})
    plog, pcache = port.make_prefill_step()(pp,
                                            {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(np_f32(plog), np_f32(rlog), **TOL)
    _assert_cache_close(pcache, rcache)
    prompts = [toks[0].tolist(), toks[1, :33].tolist()]
    want = RefEngine(ref, rp, RefConfig(max_new_tokens=6)).generate(prompts)
    got = Engine(port, pp, ServeConfig(max_new_tokens=6),
                 device=CPU).generate(prompts)
    assert got == want


# --------------------------------------------------------------------------
# ops.decode_attention (K4's drop-in) against the reference's K4
# --------------------------------------------------------------------------

# B, W, H, K, dh, window, cur — tests/kernels/test_decode_attention_kernel.py
CASES = [
    (2, 128, 8, 2, 64, None, 100),
    (1, 300, 4, 4, 128, None, 250),
    (3, 512, 16, 4, 64, 64, 400),
    (2, 64, 8, 8, 32, None, 10),
    (1, 1024, 32, 8, 128, 256, 900),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _ring_inputs(seed, B, W, H, K, dh, cur):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    vc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    pos = np.where(np.arange(W) <= cur, np.arange(W), -1).astype(np.int32)
    return q, kc, vc, pos


def _both_ways(q, kc, vc, pos, cur, dtype, window=None, kv_block=128):
    jdt, tdt, _ = DTYPES[dtype]
    want = decode_attention_pallas(
        *(jnp.asarray(a, jdt) for a in (q, kc, vc)), jnp.asarray(pos),
        float(cur), window=window, kv_block=kv_block, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kc, vc))
    got = ops.decode_attention(tq[:, None], tk, tv, torch.from_numpy(pos),
                               torch.tensor(cur, dtype=torch.int32),
                               window=window, kv_block=kv_block)
    return got[:, 0], want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,W,H,K,dh,window,cur", CASES)
def test_ring_decode_attention_matches_reference_kernel(B, W, H, K, dh,
                                                        window, cur, dtype):
    q, kc, vc, pos = _ring_inputs(B * W, B, W, H, K, dh, cur)
    got, want = _both_ways(q, kc, vc, pos, cur, dtype, window)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(np_f32(got), np_f32(want), rtol=tol, atol=tol)
    again, _ = _both_ways(q, kc, vc, pos, cur, dtype, window, kv_block=32)
    assert torch.equal(got, again)       # kv_block changes nothing


@settings(max_examples=12, deadline=None)
@given(W=st.integers(16, 400), K=st.sampled_from([1, 2, 4]),
       G=st.sampled_from([1, 2, 4]), dh=st.sampled_from([32, 64]),
       kv_block=st.sampled_from([32, 128]))
def test_property_ragged_ring(W, K, G, dh, kv_block):
    """Partially filled rings with any W against the kernel's block size
    (the reference property's tolerance, 2e-5)."""
    cur = max(W // 2, 1)
    q, kc, vc, pos = _ring_inputs(W * K, 2, W, K * G, K, dh, cur)
    got, want = _both_ways(q, kc, vc, pos, cur, "float32", kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_wrapped_ring_with_window_matches_reference_kernel():
    """A wrapped ring: kv_pos is a rotation of the last W positions, the
    query sits past them, and a window cuts the oldest."""
    B, W, H, K, dh = 2, 96, 8, 2, 64
    cur = 250
    q, kc, vc, _ = _ring_inputs(9, B, W, H, K, dh, cur)
    pos = np.roll(np.arange(cur - W + 1, cur + 1), 37).astype(np.int32)
    for window in (None, 50):
        got, want = _both_ways(q, kc, vc, pos, cur, "float32", window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("B,K,W", [(4, 8, 4096), (8, 8, 1024), (1, 8, 4096),
                                   (2, 1, 16), (3, 4, 513), (1, 1, 100000)])
def test_ring_split_covers_the_ring_in_whole_tiles(B, K, W):
    """K4's runs: whole rounds of 64 slots (four warps of 16; whole tiles of
    32 for the fp32 loop), every slot in exactly one run, no empty run, about
    two blocks a SM once the ring is long enough; at danube's timing shapes
    (32/8 heads) one wave that reaches every SM.  The tickets: at least B * K
    zeros, allocated once.  danube's head dim, 80."""
    S, span = KD.ring_split(B, K, W, 80)
    assert span % 64 == 0 and S * span >= W > (S - 1) * span
    assert B * K * S <= 2 * 132 * 2 or span == 64
    if (B, K, W) in ((4, 8, 4096), (8, 8, 1024), (1, 8, 4096)):
        assert 132 <= B * K * S <= 132 * 2
        assert 128 <= span <= 512
    counters = KD.ring_counters(torch.device("cpu"), B * K)
    assert counters.dtype == torch.int32 and counters.numel() >= B * K
    assert not counters.any()
    assert KD.ring_counters(torch.device("cpu"), B * K) is counters


def test_kernel_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor never reaches the kernel: the plain version, with q_pos
    as an int or a 0-d tensor, and no launch counted."""
    q, kc, vc, pos = _ring_inputs(1, 2, 40, 8, 2, 32, 30)
    tq, tk, tv, tp = map(torch.from_numpy, (q, kc, vc, pos))
    before = KD.decode_attention.launches
    a = KD.decode_attention(tq, tk, tv, tp, 30, window=16)
    b = KD.decode_attention(tq, tk, tv, tp,
                            torch.tensor(30, dtype=torch.int32), window=16)
    want = ring_decode_attention_ref(tq, tk, tv, tp, 30, window=16)
    assert torch.equal(a, want) and torch.equal(b, want)
    assert KD.decode_attention.launches == before


def test_legacy_entry_points_default_to_the_card(danube):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    _, port, _, pp = danube
    for call in (lambda: Engine(port, pp, ServeConfig()),
                 lambda: port.init_cache(2, 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
