"""K3's and K4's split into runs and the combine of the runs' states, in
plain PyTorch, against the JAX reference.

Each run of a split leaves the state a block of the kernel leaves
(``torch_parity.run_state_model``: its valid slots' softmax state, the
neutral state where it has none); the runs are combined in the kernel's
order (``torch_parity.combine_runs_model``: at dh 256 past 8 runs in
groups of 8 first; each combine takes the heads' maxima and the states'
weights first, then sums in order).  That is held against
the reference's K4 ``decode_attention_pallas`` and K3
``paged_decode_attention_pallas`` in interpret mode at fp32 1e-5, and the
log-sum-exp against one taken in float64 from the same scores: paligemma-3b's
8 query heads on one KV head at dh 256 over 20 and 64 runs, danube's 32/8
at dh 80, runs with no valid slot among them, and heads with no valid slot
at all (0, lse -inf).  Then the head-dim-aware splits: every slot in exactly
one run, paligemma's rings in one wave.  Inputs made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas, paged_decode_attention_pallas)
from repro_torch.kernels.decode_attention import decode_attention as KD
from torch_parity import combine_runs_model, np_f32, run_state_model

TOL = dict(rtol=1e-5, atol=1e-5)
SMS = 132


def _ring(seed, B, W, H, K, dh, cur, wrapped):
    """q, caches [B, W, K, dh] and slot positions: a partly filled ring
    (positions 0..cur, -1 after) or a wrapped one (slot (p - 1) % W holds
    position p)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    vc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    slots = np.arange(W)
    pos = (cur - W + 1 + (slots - cur) % W if wrapped
           else np.where(slots <= cur, slots, -1)).astype(np.int32)
    return q, kc, vc, pos


def _ring_model(q, kc, vc, pos, cur, window, S, span):
    """K4 over the runs [r * span, min(W, (r + 1) * span)), r < S: each
    run's state, then the combine; ``(out [B, H, dh], lse [B, H])``."""
    B, H, dh = q.shape
    W, K = kc.shape[1], kc.shape[2]
    G = H // K
    valid = (pos >= 0) & (pos <= cur)
    if window:
        valid &= cur - pos < window
    out, lse = torch.zeros(B, H, dh), torch.zeros(B, H)
    for b in range(B):
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G]
            states = [run_state_model(
                qg, kc[b, r * span:(r + 1) * span, kh],
                vc[b, r * span:(r + 1) * span, kh],
                valid[r * span:(r + 1) * span], dh ** -0.5)
                for r in range(S)]
            acc, m, l = (torch.stack(x) for x in zip(*states))
            out[b, kh * G:(kh + 1) * G], lse[b, kh * G:(kh + 1) * G] = \
                combine_runs_model(acc, m, l,
                                   tree=KD.run_groups(S, dh) > 0)
    return out, lse


def _lse64(q, kc, valid_bw, K):
    """Each head's log-sum-exp of its scaled scores over the valid slots,
    in float64 (``valid_bw [B, W]``); -inf where none is valid."""
    B, H, dh = q.shape
    G = H // K
    s = np.einsum("bkgd,bwkd->bkgw", q.reshape(B, K, G, dh).astype(np.float64),
                  kc.astype(np.float64)) * dh ** -0.5
    s = np.where(valid_bw[:, None, None, :], s, -np.inf)
    mx = s.max(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = np.log(np.exp(s - np.where(np.isfinite(mx), mx, 0)).sum(-1)) + \
            np.where(np.isfinite(mx), mx, 0)[..., 0]
    return np.where(np.isfinite(mx[..., 0]), lse, -np.inf).reshape(B, H)


# (B, W, H, K, dh, window, cur, wrapped, S, span): paligemma-3b's heads over
# its prefix phase's ring (20 runs of 64) and over 64 runs of a wrapped ring
# of 4096, a partly filled ring whose last runs hold no valid slot, and
# danube's 32/8 at dh 80 with a window
RING_CASES = [
    (4, 1280, 8, 1, 256, None, 1280 + 31, True, 20, 64),
    (1, 4096, 8, 1, 256, None, 4096 + 2047, True, 64, 64),
    (2, 1280, 8, 1, 256, None, 700, False, 10, 128),
    (2, 1024, 32, 8, 80, 256, 1024 - 200, False, 8, 128),
]


@pytest.mark.parametrize("B,W,H,K,dh,window,cur,wrapped,S,span", RING_CASES)
def test_ring_runs_combined_match_reference(B, W, H, K, dh, window, cur,
                                            wrapped, S, span):
    q, kc, vc, pos = _ring(B * W + dh, B, W, H, K, dh, cur, wrapped)
    assert (S - 1) * span < W <= S * span
    want = decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, kc, vc)), jnp.asarray(pos), float(cur),
        window=window, interpret=True)
    out, lse = _ring_model(*(torch.from_numpy(a) for a in (q, kc, vc, pos)),
                           cur, window, S, span)
    np.testing.assert_allclose(out.numpy(), np_f32(want), **TOL)
    valid = (pos >= 0) & (pos <= cur)
    if window:
        valid &= cur - pos < window
    want_lse = _lse64(q, kc, np.broadcast_to(valid, (B, W)), K)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    if not wrapped:       # the runs past cur hold no valid slot
        assert not valid[(S - 1) * span:].any()


@pytest.mark.parametrize("dh,H,K", [(256, 8, 1), (80, 32, 8)])
def test_heads_with_no_valid_slot_give_zero_and_neg_inf(dh, H, K):
    """Every slot past the query (positions above q_pos): each run holds the
    neutral state and the combine gives 0 and -inf, as the kernels do (the
    reference gives mean(V) there)."""
    q, kc, vc, _ = _ring(dh, 2, 640, H, K, dh, 600, False)
    pos = torch.arange(1000, 1640, dtype=torch.int32)
    out, lse = _ring_model(*(torch.from_numpy(a) for a in (q, kc, vc)), pos,
                           500, None, 10, 64)
    assert torch.equal(out, torch.zeros_like(out))
    assert bool(torch.isneginf(lse).all())


def _paged(seed, B, H, K, dh, ps, P, lens):
    rng = np.random.default_rng(seed)
    N = 1 + B * P
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kp = rng.standard_normal((N, ps, K, dh)).astype(np.float32)
    vp = rng.standard_normal((N, ps, K, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


# (B, H, K, dh, page_size, P, window, seq_lens, S): paligemma-3b's heads
# over 20 runs with a short sequence (its last runs empty) and a sequence
# with no token; danube's heads with a window
PAGED_CASES = [
    (3, 8, 1, 256, 16, 20, None, (320, 37, 0), 20),
    (2, 32, 8, 80, 16, 16, 100, (256, 130), 4),
]


@pytest.mark.parametrize("B,H,K,dh,ps,P,window,lens,S", PAGED_CASES)
def test_paged_runs_combined_match_reference(B, H, K, dh, ps, P, window,
                                             lens, S):
    q, kp, vp, bt, sl = _paged(B * P + dh, B, H, K, dh, ps, P, lens)
    want = np_f32(paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, sl)), window=window,
        interpret=True))
    tq, tk, tv, tbt = (torch.from_numpy(a) for a in (q, kp, vp, bt))
    N = kp.shape[0]
    k_rows, v_rows = tk.reshape(N * ps, K, dh), tv.reshape(N * ps, K, dh)
    G = H // K
    for b, n_all in enumerate(lens):
        lo = max(0, n_all - window) if window else 0
        runs = KD.paged_runs(n_all, window, P * ps, S)
        for kh in range(K):
            states = []
            for t_lo, t_hi in runs:
                t = torch.arange(t_lo, t_hi)
                rows = tbt[b, t // ps].long() * ps + t % ps
                states.append(run_state_model(
                    tq[b, kh * G:(kh + 1) * G], k_rows[rows, kh],
                    v_rows[rows, kh], t >= lo, dh ** -0.5))
            acc, m, l = (torch.stack(x) for x in zip(*states))
            out, lse = combine_runs_model(acc, m, l,
                                          tree=KD.run_groups(S, dh) > 0)
            if n_all == 0:     # the kernel's 0 where the reference's mean(V)
                assert torch.equal(out, torch.zeros_like(out))
                assert bool(torch.isneginf(lse).all())
                continue
            np.testing.assert_allclose(out.numpy(),
                                       want[b, kh * G:(kh + 1) * G], **TOL)


# --------------------------------------------------------------------------
# the head-dim-aware splits
# --------------------------------------------------------------------------

def test_blocks_per_sm_follow_the_loops_shared_memory():
    """The bf16 loops' shared memory a block: the wide loop (dh 256) fits
    three blocks an SM, the narrow loop's private stages at dh 160 one; every
    head dim but dh 160 aims at two."""
    assert KD.bf16_smem_bytes(256) == 72_720
    assert 3 * (KD.bf16_smem_bytes(256) + 1024) <= 233_472
    assert KD.bf16_smem_bytes(80) == 67_584
    for dh in KD.HEAD_DIMS:
        assert KD.blocks_per_sm(dh) == (1 if dh == 160 else 2)


@pytest.mark.parametrize("dh", KD.HEAD_DIMS)
@pytest.mark.parametrize("B,K,W", [(4, 1, 1280), (8, 1, 4352), (4, 1, 4096),
                                   (4, 8, 4096), (16, 8, 448), (3, 2, 100)])
def test_ring_split_by_head_dim_covers_each_slot_once(dh, B, K, W):
    """Every slot in exactly one run of whole 64-slot rounds, no empty run,
    and at most one wave of ``blocks_per_sm(dh)`` blocks on each SM unless
    a run is one round long."""
    S, span = KD.ring_split(B, K, W, dh)
    assert span % 64 == 0 and (S - 1) * span < W <= S * span
    covered = np.zeros(W, int)
    for r in range(S):
        covered[r * span:min(W, (r + 1) * span)] += 1
    assert (covered == 1).all()
    assert B * K * S <= SMS * KD.blocks_per_sm(dh) or span == 64
    if dh in KD.WIDE_HEAD_DIMS:     # the kernels take GROUP_RUNS ** 2 runs
        assert S <= KD.WIDE_MAX_RUNS <= KD.GROUP_RUNS ** 2


@pytest.mark.parametrize("B,W", [(4, 1280), (8, 4352), (4, 4096)])
def test_paligemma_rings_in_one_wave(B, W):
    """paligemma-3b's three rings (8/1 heads, dh 256) in one wave of two
    blocks an SM (the wide loop fits three), no more than
    ``WIDE_MAX_RUNS`` runs a sequence."""
    S, span = KD.ring_split(B, 1, W, 256)
    assert KD.blocks_per_sm(256) == 2
    assert B * S <= SMS * 2 and (S - 1) * span < W <= S * span
    assert S <= KD.WIDE_MAX_RUNS


@pytest.mark.parametrize("dh", KD.HEAD_DIMS)
@pytest.mark.parametrize("B,K,P", [(8, 1, 64), (8, 8, 64), (1, 8, 128),
                                   (3, 2, 7)])
def test_paged_split_by_head_dim_covers_live_tokens_once(dh, B, K, P):
    """Every live token of a sequence in exactly one of ``paged_split``'s
    runs, for full, short and windowed sequences; at most one wave of
    ``blocks_per_sm(dh)`` blocks on each SM when the tables are full,
    unless a run is one round long."""
    ps = 16
    cap = P * ps
    S = KD.paged_split(B, K, P, ps, dh)
    per = -(-(-(-cap // 64)) // S)
    assert B * K * S <= SMS * KD.blocks_per_sm(dh) or per == 1
    for n_all, window in ((cap, None), (cap // 2 + 3, None), (1, None),
                          (cap, 100), (cap + 9, 40)):
        n = min(n_all, cap)
        lo = max(0, n_all - window) if window else 0
        live = []
        for t_lo, t_hi in KD.paged_runs(n_all, window, cap, S):
            live += range(max(t_lo, lo), t_hi)
        assert live == list(range(lo, n))


@pytest.mark.parametrize("S,G,dh,groups,floats", [
    (1, 8, 256, 0, 2064), (8, 8, 256, 0, 2064), (9, 8, 256, 2, 2064),
    (20, 8, 256, 3, 2064), (64, 8, 256, 8, 2064), (65, 8, 256, 9, 2064),
    (20, 1, 256, 3, 260), (16, 4, 16, 0, 72), (64, 1, 64, 0, 66),
    (20, 8, 128, 0, 1040), (20, 4, 80, 0, 328), (20, 3, 24, 0, 78)])
def test_workspace_holds_the_run_and_group_states(S, G, dh, groups, floats):
    """A run's state: at the wide loop's head dim padded to whole 16-byte
    pieces, elsewhere ``G * (dh + 2)`` floats, unpadded; at the
    wide loop's head dim, past ``GROUP_RUNS`` runs, a (sequence, KV head) gets
    ``ceil(S / 8)`` group states after every pair's run states and a
    ticket for each group beside the last combine's; the meta device
    allocates what the card would (the dry run's view of the launch)."""
    assert KD.run_groups(S, dh) == groups
    assert KD.state_floats(G, dh) == floats
    assert floats % 4 == 0 if dh == 256 else floats == G * (dh + 2)
    part, counters = KD._workspace(3, 2, S, G, dh, torch.device("meta"),
                                   KD.ring_counters)
    assert part.numel() == 3 * 2 * (S + groups) * floats
    assert counters.numel() >= 3 * 2 * (1 + groups)
