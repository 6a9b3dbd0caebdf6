"""PyTorch port vs the JAX reference: AdaLomo per-tensor maths
(``core/adalomo.py``) and the fused update op (``kernels/adalomo_update``).

Inputs are made from a seed with numpy and fed to both packages.  On the CPU
the port's op runs the plain PyTorch versions of its CUDA kernels; the
reference's Pallas kernels run in interpret mode, as in its own tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adalomo as ref_al
from repro.kernels.adalomo_update.adalomo_update import stats_pallas
from repro.kernels.adalomo_update.ops import adalomo_update as ref_op
from repro_torch.core import adalomo as al
from repro_torch.core import optimizers as opt_lib
from repro_torch.kernels.adalomo_update import adalomo_update as K
from repro_torch.kernels.adalomo_update.ops import adalomo_update as port_op
from repro_torch.kernels.adalomo_update.ref import adalomo_step_ref
from torch_parity import np_f32

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, step, seed=0, lead=()):
    """p, g, r, c as float32 numpy; zero state at step 1 (as the reference's
    kernel tests make them)."""
    rng = np.random.default_rng(seed)
    full = tuple(lead) + tuple(shape)
    p = (rng.standard_normal(full) * 0.1).astype(np.float32)
    g = (rng.standard_normal(full) * 0.3).astype(np.float32)
    live = np.float32(step > 1) * np.float32(1e-2)
    r = rng.random(full[:-1]).astype(np.float32) * live
    c = rng.random(full[:-2] + full[-1:]).astype(np.float32) * live
    return p, g, r, c


def _j(x, dt="float32"):
    return jnp.asarray(x).astype(JDT[dt])


def _t(x, dt="float32"):
    return torch.from_numpy(np.array(x)).to(TDT[dt])


# --------------------------------------------------------------------------
# core/adalomo.py
# --------------------------------------------------------------------------

CASES = {
    # name: (shape, lead, cfg kwargs, hparams, param dtype)
    "factored": ((48, 80), (), {}, {}, "float32"),
    "unfactored_1d": ((96,), (), {}, {}, "float32"),
    "small_dim_unfactored": ((8, 80), (), {}, {}, "float32"),
    "experts_3d": ((32, 48), (3,), {}, {}, "float32"),
    "literal_div_v": ((48, 80), (), {"literal_div_v": True}, {}, "float32"),
    "weight_decay": ((48, 80), (), {}, {"weight_decay": 0.5, "lr": 0.1},
                     "float32"),
    "clip_beta": ((48, 80), (), {}, {"clip": 0.3, "beta": 0.9}, "float32"),
    "no_bias_correction": ((48, 80), (), {"bias_correction": False}, {},
                           "float32"),
    "bf16_param": ((48, 80), (), {}, {}, "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("step", [1.0, 5.0])
def test_update_tensor_matches_reference(name, step):
    """``update_tensor`` vs the reference's.  fp32: 1e-5 (same arithmetic,
    other summation order); bf16 param: 5e-3, under one bf16 ulp at these
    magnitudes (the reference's own kernel tolerance)."""
    shape, lead, ckw, hp, pdt = CASES[name]
    hp = {"lr": 5e-4, **hp}
    p, g, r, c = _inputs(shape, step, seed=len(name), lead=lead)
    rcfg, pcfg = ref_al.AdaLomoConfig(**ckw), al.AdaLomoConfig(**ckw)
    rs = ref_al.init_state(_j(p, pdt), rcfg)
    ps = al.init_state(_t(p, pdt), pcfg)
    assert [x is None for x in rs] == [x is None for x in ps]
    if rs.v is None:
        rs = ref_al.FactoredState(_j(r), _j(c), None)
        ps = al.FactoredState(_t(r), _t(c), None)
    elif step > 1:
        v = np.abs(g) * 1e-2
        rs = ref_al.FactoredState(None, None, _j(v))
        ps = al.FactoredState(None, None, _t(v))
    rp, rns = ref_al.update_tensor(_j(p, pdt), _j(g), rs,
                                   step=jnp.float32(step), cfg=rcfg,
                                   **{k: jnp.float32(v) for k, v in hp.items()})
    pp, pns = al.update_tensor(_t(p, pdt), _t(g), ps, step=step, cfg=pcfg,
                               **hp)
    assert pp.dtype == TDT[pdt]
    tol = 1e-5 if pdt == "float32" else 5e-3
    np.testing.assert_allclose(np_f32(pp), np_f32(rp), rtol=tol, atol=tol)
    for a, b in zip(pns, rns):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(np_f32(a), np_f32(b), rtol=3e-5,
                                       atol=1e-7)


def test_compute_update_matches_reference():
    p, g, r, c = _inputs((48, 80), 3.0, seed=3)
    ru, _ = ref_al.compute_update(
        _j(p), _j(g), ref_al.FactoredState(_j(r), _j(c), None),
        step=jnp.float32(3.0), cfg=ref_al.AdaLomoConfig())
    pu, _ = al.compute_update(
        _t(p), _t(g), al.FactoredState(_t(r), _t(c), None), step=3.0,
        cfg=al.AdaLomoConfig())
    assert pu.dtype == torch.float32
    np.testing.assert_allclose(np_f32(pu), np_f32(ru), rtol=1e-5, atol=1e-7)


def test_stacked_1d_uses_batch_dims():
    """A stacked norm scale [L, d] is L 1-D tensors: ``batch_dims=1`` equals
    the reference's vmap over L (not one L×d matrix)."""
    L, d = 20, 24
    rng = np.random.default_rng(1)
    p = rng.standard_normal((L, d)).astype(np.float32)
    g = rng.standard_normal((L, d)).astype(np.float32)
    rcfg, pcfg = ref_al.AdaLomoConfig(), al.AdaLomoConfig()
    ps = al.init_state(_t(p), pcfg, batch_dims=1)
    assert ps.v is not None and ps.v.shape == (L, d)
    assert al.init_state(_t(p), pcfg).v is None     # as a matrix: factored
    rs = jax.vmap(lambda x: ref_al.init_state(x, rcfg))(_j(p))
    rp, rns = jax.vmap(lambda pi, gi, si: ref_al.update_tensor(
        pi, gi, si, lr=jnp.float32(1e-2), step=jnp.float32(1.0), cfg=rcfg))(
            _j(p), _j(g), rs)
    pp, pns = al.update_tensor(_t(p), _t(g), ps, lr=1e-2, step=1.0, cfg=pcfg,
                               batch_dims=1)
    np.testing.assert_allclose(np_f32(pp), np_f32(rp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_f32(pns.v), np_f32(rns.v), rtol=1e-6)


@pytest.mark.parametrize("shape", [(64, 128), (8, 128), (128,), (4, 32, 64)])
def test_state_layout_and_bytes(shape):
    rcfg, pcfg = ref_al.AdaLomoConfig(), al.AdaLomoConfig()
    assert al._should_factor(shape, pcfg) == ref_al._should_factor(shape, rcfg)
    rs = ref_al.init_state(jnp.zeros(shape, jnp.bfloat16), rcfg)
    ps = al.init_state(torch.zeros(shape, dtype=torch.bfloat16), pcfg)
    for a, b in zip(ps, rs):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
            assert a.dtype == torch.float32
    assert (al.state_bytes(torch.zeros(shape), pcfg)
            == ref_al.state_bytes(jnp.zeros(shape), rcfg))
    assert al.DEFAULT_HPARAMS == ref_al.DEFAULT_HPARAMS


# --------------------------------------------------------------------------
# kernels/adalomo_update: the op on the CPU vs the reference's Pallas kernels
# --------------------------------------------------------------------------

SHAPES = [(64, 128), (256, 512), (300, 700), (128, 130), (1000, 96),
          (16, 4096)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("pdt,gdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "bfloat16")])
def test_op_matches_reference_kernels(shape, pdt, gdt):
    """The reference's own tolerances: params 1e-5 in fp32 and 5e-3 where a
    bf16 value is stored (one rounding at the final write); r and c rtol
    3e-5 / atol 1e-5 for another summation order."""
    m, n = shape
    for step in (1.0, 5.0):
        p, g, r, c = _inputs(shape, step, seed=m * 7 + n)
        rp, rr, rc = ref_op(_j(p, pdt), _j(g, gdt), _j(r), _j(c), 5e-4, step,
                            interpret=True, block=(128, 256))
        tp, tr, tc = _t(p, pdt), _t(r), _t(c)
        out = port_op(tp, _t(g, gdt), tr, tc, 5e-4, step)
        assert out[0] is tp and out[1] is tr and out[2] is tc   # in place
        tol = 1e-5 if pdt == "float32" else 5e-3
        np.testing.assert_allclose(np_f32(tp), np_f32(rp), rtol=tol, atol=tol)
        np.testing.assert_allclose(np_f32(tr), np_f32(rr), rtol=3e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(np_f32(tc), np_f32(rc), rtol=3e-5,
                                   atol=1e-5)


def test_op_stacked_matches_reference_vmap():
    L, m, n = 3, 96, 160
    p, g, r, c = _inputs((m, n), 1.0, seed=0, lead=(L,))
    rp, rr, rc = ref_op(_j(p), _j(g), _j(r), _j(c), 1e-3, 1.0, interpret=True,
                        block=(64, 128))
    tp, tr, tc = _t(p), _t(r), _t(c)
    port_op(tp, _t(g), tr, tc, 1e-3, 1.0)
    np.testing.assert_allclose(np_f32(tp), np_f32(rp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_f32(tr), np_f32(rr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np_f32(tc), np_f32(rc), rtol=1e-5, atol=1e-6)
    # statistics are per slice: slice 1 alone gives the same numbers
    sp, sr, sc = _t(p[1]), _t(r[1]), _t(c[1])
    port_op(sp, _t(g[1]), sr, sc, 1e-3, 1.0)
    np.testing.assert_allclose(np_f32(sp), np_f32(tp[1]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["literal", "weight_decay_small",
                                  "weight_decay_large", "tensor_hparams"])
def test_op_variants_match_reference(kind):
    """``literal_div_v``; weight decay with RMS(θ) of the un-decayed θ (at
    lr=0.1, wd=0.5 a decayed θ would be 5% off); hparams as 0-d tensors."""
    p, g, r, c = _inputs((96, 160), 2.0, seed=6)
    ckw, lr, wd = {}, 1e-3, 0.0
    if kind == "literal":
        ckw = {"literal_div_v": True}
    elif kind == "weight_decay_small":
        wd = 0.1
    elif kind == "weight_decay_large":
        lr, wd = 0.1, 0.5
    rp, rr, rc = ref_op(_j(p), _j(g), _j(r), _j(c), lr, 2.0, 0.999, wd, 1.0,
                        cfg=ref_al.AdaLomoConfig(**ckw), interpret=True,
                        block=(64, 128))
    tp, tr, tc = _t(p), _t(r), _t(c)
    args = (lr, 2.0, 0.999, wd, 1.0)
    if kind == "tensor_hparams":
        args = tuple(torch.tensor(a, dtype=torch.float32) for a in args)
    port_op(tp, _t(g), tr, tc, *args, cfg=al.AdaLomoConfig(**ckw))
    np.testing.assert_allclose(np_f32(tp), np_f32(rp), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np_f32(tr), np_f32(rr), rtol=2e-5, atol=2e-7)
    np.testing.assert_allclose(np_f32(tc), np_f32(rc), rtol=2e-5, atol=2e-7)


def test_op_equals_port_oracle_and_plain_kernel_versions():
    """Within the port: op == ``ref.adalomo_step_ref`` (``update_tensor``),
    and the plain versions of K1/K2 mutate nothing."""
    p, g, r, c = _inputs((40, 72), 4.0, seed=9)
    want = adalomo_step_ref(_t(p), _t(g), _t(r), _t(c), lr=1e-3, step=4.0,
                            weight_decay=0.1)
    tp, tr, tc = _t(p), _t(r), _t(c)
    port_op(tp, _t(g), tr, tc, 1e-3, 4.0, 0.999, 0.1, 1.0)
    for a, b in zip((tp, tr, tc), want):
        np.testing.assert_allclose(np_f32(a), np_f32(b), rtol=1e-5, atol=1e-7)
    r0, c0 = _t(r), _t(c)
    nr, nc = K.adalomo_stats_ref(_t(g), r0, c0, torch.tensor(0.999),
                                 eps_stat=1e-30)
    assert torch.equal(r0, _t(r)) and nr is not r0 and nc is not c0


def test_kernel_wrappers_count_no_launch_on_cpu():
    """The launch counters move only where a CUDA kernel is launched."""
    before = (K.adalomo_stats.launches, K.adalomo_update.launches)
    p, g, r, c = _inputs((32, 48), 1.0)
    port_op(_t(p), _t(g), _t(r), _t(c), 1e-3, 1.0)
    assert (K.adalomo_stats.launches, K.adalomo_update.launches) == before


def test_backend_cuda_on_cpu_tensor_raises():
    rule = opt_lib.get_rule("adalomo", backend="cuda")
    p = torch.zeros(32, 48)
    with pytest.raises(ValueError, match="CUDA"):
        rule.update(p, torch.ones(32, 48), rule.init(p),
                    dict(rule.hparams), 1.0)
    with pytest.raises(ValueError, match="backend"):
        opt_lib.get_rule("adalomo", backend="pallas")


# Every [m, n] the train step passes to K2 for h2o-danube-1.8b, the ragged
# shapes of the on-card checks, and a stacked tensor (L, m, n).
_DANUBE_SHAPES = [(1, 2560, 2560), (1, 2560, 640), (1, 2560, 6912),
                  (1, 6912, 2560), (1, 32000, 2560), (1, 2560, 32000)]
_RAGGED_SHAPES = [(1, 300, 700), (1, 128, 130), (1, 1000, 96),
                  (1, 16, 4096), (3, 300, 700)]


@pytest.mark.parametrize("L,m,n", _DANUBE_SHAPES + _RAGGED_SHAPES)
def test_update_tiling_covers_each_element_once(L, m, n):
    """K2's tiles: every element of a slice in exactly one tile of exactly
    one block's walk, partials [L, blocks, 2], and at danube's shapes at
    least BLOCKS_PER_SM blocks for each of the card's SMs."""
    t = K.update_tiling(L, m, n)
    seen = np.zeros((t.row_tiles * K.TILE_ROWS, t.col_tiles * K.TILE_COLS),
                    np.int32)
    walked = []
    for b in range(t.blocks):
        for tile in t.walk(b):
            r0, c0 = t.tile(tile)
            seen[r0:r0 + K.TILE_ROWS, c0:c0 + K.TILE_COLS] += 1
            walked.append(tile)
    assert sorted(walked) == list(range(t.tiles))
    assert (seen == 1).all()
    assert seen.shape[0] - K.TILE_ROWS < m <= seen.shape[0]
    assert seen.shape[1] - K.TILE_COLS < n <= seen.shape[1]
    assert t.partials_shape(L) == (L, t.blocks, 2)
    assert 1 <= t.blocks <= t.tiles
    if (L, m, n) in _DANUBE_SHAPES:
        assert L * t.blocks >= K.BLOCKS_PER_SM * K.SMS


@pytest.mark.parametrize("L,m,n", _DANUBE_SHAPES + _RAGGED_SHAPES)
def test_stats_tiling_covers_each_element_once(L, m, n):
    """K1's tiles: every element of a slice in exactly one block's tile,
    the partials and tickets laid out as the kernel's C interface says, and
    at danube's shapes other than 2560 x 640 at least one block a SM."""
    t = K.stats_tiling(L, m, n)
    assert t.rows in K.STATS_ROWS
    seen = np.zeros((t.bands * t.rows, t.strips * K.STATS_COLS), np.int32)
    for band in range(t.bands):
        for strip in range(t.strips):
            r0, c0 = t.tile(band, strip)
            seen[r0:r0 + t.rows, c0:c0 + K.STATS_COLS] += 1
    assert (seen == 1).all()
    assert seen.shape[0] - t.rows < m <= seen.shape[0]
    assert seen.shape[1] - K.STATS_COLS < n <= seen.shape[1]
    assert t.row_partials_shape(L) == (L, t.strips, t.bands * t.rows)
    assert t.col_partials_shape(L) == (L, t.bands, t.strips * K.STATS_COLS)
    assert t.tickets(L) == L * (t.bands + t.strips)
    assert t.blocks(L) == L * t.bands * t.strips
    if (L, m, n) in _DANUBE_SHAPES and (m, n) != (2560, 640):
        assert t.blocks(L) >= K.SMS
    # a taller tile only where the shortest leaves too many bands to fold
    assert t.bands <= K.STATS_MAX_BANDS or t.rows == K.STATS_ROWS[-1]
    if t.rows > K.STATS_ROWS[0]:
        assert -(-m // (t.rows // 2)) > K.STATS_MAX_BANDS


def _stats_tiled(g, r, c, beta, eps_stat):
    """K1's arithmetic in plain PyTorch: per-tile row and column partials,
    each band's row partials added in strip order and each strip's column
    partials in band order, as the kernel's folds do."""
    L, m, n = g.shape
    t = K.stats_tiling(L, m, n)
    g2 = torch.square(g.to(torch.float32)) + eps_stat
    rows = torch.zeros((L, t.strips, m))
    cols = torch.zeros((L, t.bands, n))
    for band in range(t.bands):
        for strip in range(t.strips):
            r0, c0 = t.tile(band, strip)
            tile = g2[:, r0:r0 + t.rows, c0:c0 + K.STATS_COLS]
            rows[:, strip, r0:r0 + t.rows] = tile.sum(dim=-1)
            cols[:, band, c0:c0 + K.STATS_COLS] = tile.sum(dim=-2)
    rsum, csum = rows[:, 0], cols[:, 0]
    for s in range(1, t.strips):
        rsum = rsum + rows[:, s]
    for b in range(1, t.bands):
        csum = csum + cols[:, b]
    return beta * r + (1.0 - beta) * rsum, beta * c + (1.0 - beta) * csum


@pytest.mark.parametrize("L,m,n", [(1, 300, 700), (1, 128, 130),
                                   (1, 1000, 96), (3, 96, 160)])
@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
def test_stats_tiled_fold_matches_reference_kernel(L, m, n, gdt):
    """K1's tiling and fold order, modelled in plain PyTorch, against the
    reference's Pallas statistics kernel in interpret mode (r and c rtol
    3e-5 / atol 1e-5: another summation order)."""
    p, g, r, c = _inputs((m, n), 5.0, seed=m + n, lead=(L,))
    # the reference pads to whole blocks, as its op does: zero rows and
    # columns add only eps_stat = 1e-30 to the sums
    pm, pn = -m % 64, -n % 128
    gp = np.pad(g, ((0, 0), (0, pm), (0, pn)))
    want = jax.vmap(lambda gi, ri, ci: stats_pallas(
        gi, ri, ci, beta=jnp.float32(0.999), eps_stat=1e-30, block=(64, 128),
        interpret=True))(_j(gp, gdt), _j(np.pad(r, ((0, 0), (0, pm)))),
                         _j(np.pad(c, ((0, 0), (0, pn)))))
    want = (want[0][:, :m], want[1][:, :n])
    got = _stats_tiled(_t(g, gdt), _t(r), _t(c), 0.999, 1e-30)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_f32(a), np_f32(b), rtol=3e-5,
                                   atol=1e-5)
