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
