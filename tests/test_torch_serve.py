"""PyTorch port vs the JAX reference: paged continuous-batching serving.

The port's ``PagedEngine`` on the CPU against the reference's ``PagedEngine``
(its jnp path) from the same converted weights: token-for-token greedy
equality with mid-flight admission, preemption, EOS and a sliding-window
model; the reference's engine invariants (pages conserved, rejection, a
fixed decode signature, prefill within the warmed buckets); and one prefill
plus one paged decode step against ``make_prefill_kv_step`` /
``make_paged_decode_step`` at 1e-5 (fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.engine import PagedEngine as RefEngine
from repro.serve.engine import PagedServeConfig as RefConfig
from repro_torch.serve.engine import PagedEngine, PagedServeConfig
from torch_parity import (CPU, np_f32, patch_attention_thresholds,
                          ref_params_and_copy, smoke_archs, tiny_llama_archs)

PROMPTS = [[5, 17, 23, 9], [101, 44], [7] * 6, [3, 4, 5, 6, 7, 8, 9, 10, 11],
           [42] * 14]


@pytest.fixture(scope="module")
def tiny():
    ref, port = tiny_llama_archs(layers=2, d=64)
    ref_params, port_params = ref_params_and_copy(ref, seed=0)
    return ref, port, ref_params, port_params


def _kw(**kw):
    base = dict(page_size=8, num_pages=32, max_batch=3, max_pages_per_seq=8,
                chunk=4, max_new_tokens=8, bucket_min=8)
    base.update(kw)
    return base


def _ref_engine(arch, params, **kw):
    return RefEngine(arch, params, RefConfig(**_kw(**kw)))


def _port_engine(arch, params, **kw):
    return PagedEngine(arch, params, PagedServeConfig(**_kw(**kw)),
                       device=CPU)


def _midflight(eng, prompts, n_first, steps_before):
    """Submit ``n_first`` prompts, run ``steps_before`` rounds, submit the
    rest (they join the running batch), run to the end."""
    rids = [eng.submit(p) for p in prompts[:n_first]]
    for _ in range(steps_before):
        eng.step()
    rids += [eng.submit(p) for p in prompts[n_first:]]
    eng.run()
    return [eng.requests[r].out for r in rids]


def test_midflight_admission_matches_reference(tiny):
    ref, port, rp, pp = tiny
    want = _midflight(_ref_engine(ref, rp), PROMPTS, 2, 2)
    eng = _port_engine(port, pp)
    got = _midflight(eng, PROMPTS, 2, 2)
    assert got == want
    assert all(len(o) == 8 for o in got)
    assert eng.allocator.n_free == eng.scfg.num_pages - 1


def test_preemption_matches_reference(tiny):
    """A pool too small for all admitted sequences forces preemption; the
    re-prefill over prompt+generated reproduces the reference's stream."""
    ref, port, rp, pp = tiny
    kw = dict(page_size=4, num_pages=14, max_pages_per_seq=16,
              max_new_tokens=24)
    want = _ref_engine(ref, rp, **kw).generate(PROMPTS[:3])
    eng = _port_engine(port, pp, **kw)
    assert eng.generate(PROMPTS[:3]) == want
    assert sum(r.n_preempted for r in eng.requests.values()) > 0, \
        "pool was large enough that preemption never happened"
    assert eng.scheduler.counters["preempted"] > 0
    assert eng.allocator.n_free == eng.scfg.num_pages - 1


def test_eos_matches_reference_and_frees_pages(tiny):
    ref, port, rp, pp = tiny
    probe = _port_engine(port, pp).generate([PROMPTS[0]])[0]
    eos = probe[2]                     # the third greedy token becomes EOS
    want = _ref_engine(ref, rp, eos_id=eos).generate([PROMPTS[0]])[0]
    eng = _port_engine(port, pp, eos_id=eos)
    n_free_before = eng.allocator.n_free
    out = eng.generate([PROMPTS[0]])[0]
    assert out == want == probe[:3] and out[-1] == eos
    assert not eng.scheduler.has_work()
    assert eng.allocator.n_free == n_free_before
    assert len(eng.generate([PROMPTS[1]])[0]) > 0     # pages reusable
    assert eng.allocator.n_free == n_free_before


def test_swa_midflight_matches_reference():
    """Sliding-window arch (danube smoke, window 8): the paged decode mask
    gives the reference's tokens for ragged prompts joining mid-flight."""
    ref, port = smoke_archs()
    assert port.supports_paged_serving() and port.cfg.window == 8
    rp, pp = ref_params_and_copy(ref, seed=1)
    prompts = [[5, 17, 23, 9, 2, 11, 3], [101, 44], [7] * 12]
    want = _midflight(_ref_engine(ref, rp, max_new_tokens=10), prompts, 1, 1)
    got = _midflight(_port_engine(port, pp, max_new_tokens=10), prompts, 1, 1)
    assert got == want


def test_pages_conserved_across_rounds(tiny):
    _, port, _, pp = tiny
    eng = _port_engine(port, pp)
    total = eng.allocator.n_free
    for round_prompts in (PROMPTS[:3], PROMPTS[3:], PROMPTS[1:4]):
        eng.generate(round_prompts)
        assert eng.allocator.n_free == total


def test_max_new_tokens_zero_and_oversize_rejection(tiny):
    _, port, _, pp = tiny
    eng = _port_engine(port, pp)
    assert eng.generate([[1, 2, 3]], max_new_tokens=0) == [[]]
    assert eng.allocator.n_free == eng.scfg.num_pages - 1
    with pytest.raises(ValueError):
        eng.submit([1] * 100)          # exceeds per-seq/pool capacity


def test_decode_signature_fixed_after_warmup(tiny):
    """A mixed-length continuous-batching workload runs the decode chunk
    with one input signature, and prefill only with warmed buckets."""
    _, port, _, pp = tiny
    rng = np.random.RandomState(0)
    lens = [16, 40, 100, 256, 23, 180]
    prompts = [list(rng.randint(1, 250, size=n).astype(int)) for n in lens]
    eng = PagedEngine(port, pp, PagedServeConfig(
        page_size=32, num_pages=41, max_batch=3, max_pages_per_seq=9,
        chunk=2, max_new_tokens=4, bucket_min=16), device=CPU)
    eng.warmup([min(lens), max(lens)])   # buckets 16..256
    assert eng.decode_compile_count() == 1
    warmed = eng.prefill_compile_count()
    assert warmed == 5
    assert eng.allocator.n_free == 40    # warmup touched no live state
    rids = [eng.submit(p) for p in prompts[:3]]
    eng.step()
    rids += [eng.submit(p) for p in prompts[3:]]
    eng.run()
    assert all(len(eng.requests[r].out) == 4 for r in rids)
    eng.generate([prompts[1][:17], prompts[3][:77]])
    assert eng.decode_compile_count() == 1
    assert eng.prefill_compile_count() == warmed


def test_temperature_sampling_is_seeded_and_conserves_pages(tiny):
    """Gumbel-argmax sampling from the engine's generator: the same seed
    gives the same tokens, ids stay in the vocabulary, no page leaks."""
    _, port, _, pp = tiny
    outs = []
    for _ in range(2):
        eng = _port_engine(port, pp, temperature=1.0, seed=3)
        outs.append(eng.generate(PROMPTS[:3]))
        assert eng.allocator.n_free == eng.scfg.num_pages - 1
    assert outs[0] == outs[1]
    assert all(0 <= t < port.cfg.vocab for o in outs[0] for t in o)


def test_use_kernel_true_on_cpu_raises(tiny):
    _, port, _, pp = tiny
    eng = _port_engine(port, pp, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        eng.generate([PROMPTS[0]])


@pytest.mark.parametrize("window", [8, 48])
def test_prefill_past_direct_threshold_matches_reference(window,
                                                         monkeypatch):
    """A prompt whose prefill bucket (64) is past the direct-attention
    threshold, patched to 16 (blocks of 16) in both packages: window 8 takes
    the sliding-window gather, window 48 the blockwise (flash) branch, and
    the port's PagedEngine gives the JAX PagedEngine's greedy tokens."""
    patch_attention_thresholds(monkeypatch)
    ref, port = smoke_archs(window=window)
    rp, pp = ref_params_and_copy(ref, seed=7)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, port.cfg.vocab, 37).tolist(), [3, 9, 4]]
    kw = dict(max_batch=2, max_new_tokens=8)
    want = _ref_engine(ref, rp, **kw).generate(prompts)
    assert _port_engine(port, pp, **kw).generate(prompts) == want


def test_prefill_and_paged_decode_step_match_reference(tiny):
    """One bucketed prefill (two right-padded prompts) and one paged decode
    step over a shuffled pool: logits, K/V and the written pages at 1e-5."""
    ref, port, rp, pp = tiny
    cfg = port.cfg
    lengths = np.array([5, 11], np.int32)
    S, ps, P = 16, 4, 4
    rng = np.random.default_rng(0)
    tokens = np.zeros((2, S), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(1, cfg.vocab, n)
    rlog, rk, rv = jax.jit(ref.make_prefill_kv_step())(
        rp, {"tokens": jnp.asarray(tokens), "length": jnp.asarray(lengths)})
    plog, pk, pv = port.make_prefill_kv_step()(
        pp, {"tokens": torch.from_numpy(tokens),
             "length": torch.from_numpy(lengths)})
    for a, b in ((plog, rlog), (pk, rk), (pv, rv)):
        np.testing.assert_allclose(np_f32(a), np_f32(b), rtol=1e-5,
                                   atol=1e-5)

    # scatter the reference's K/V into a shuffled pool, numpy on both sides
    N = 1 + 2 * P
    bt = rng.permutation(np.arange(1, N)).reshape(2, P).astype(np.int32)
    pools = {}
    for name, kv in (("k", np.asarray(rk)), ("v", np.asarray(rv))):
        pool = rng.standard_normal(
            (cfg.n_layers, N, ps, cfg.n_kv_heads, cfg.head_dim)
        ).astype(np.float32)
        for b, n in enumerate(lengths):
            for j in range(n):
                pool[:, bt[b, j // ps], j % ps] = kv[:, b, j]
        pools[name] = pool
    nxt = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)[:, None]
    emit = np.array([True, True])
    jbatch = {"tokens": jnp.asarray(nxt), "block_tables": jnp.asarray(bt),
              "seq_lens": jnp.asarray(lengths), "emit": jnp.asarray(emit)}
    rlogits, rpages = jax.jit(ref.make_paged_decode_step())(
        rp, {k: jnp.asarray(v) for k, v in pools.items()}, jbatch)
    ppages = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tbatch = {"tokens": torch.from_numpy(nxt),
              "block_tables": torch.from_numpy(bt),
              "seq_lens": torch.from_numpy(lengths),
              "emit": torch.from_numpy(emit)}
    plogits, out_pages = port.make_paged_decode_step()(pp, ppages, tbatch)
    assert out_pages is ppages                      # updated in place
    np.testing.assert_allclose(np_f32(plogits), np_f32(rlogits), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(np_f32(ppages[name]),
                                   np_f32(rpages[name]), rtol=1e-5,
                                   atol=1e-5)
        assert not np.array_equal(np_f32(ppages[name]), pools[name])
