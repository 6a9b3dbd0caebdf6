"""PyTorch port vs the JAX reference: the configs the port knows
(``configs/*.py``, ``models/registry.py``) — fields, shapes, parameter counts
and cells equal to the reference's (deepseek-v3-671b's MLA and MTP fields
too; paligemma-3b's prefix fields; the state-space configs mamba2-1.3b and
zamba2-1.2b; the encoder-decoder whisper-base), an unknown architecture
refused — one
fused AdaLomo step of each dense smoke config against the reference's,
paged serving of the new dense smoke configs against the JAX engine,
``layers.layernorm`` with the reference's eps trap, and the plain versions
of K3 and K4 at the head dims the new configs bring (120, 160, paligemma's
256 over a query group of 8, and the smoke configs' 16 and 24; a query
group of 1) against the reference's oracles and its Pallas kernels in
interpret mode.  fp32 on the CPU unless stated; inputs made with numpy from a seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as ref_shapes
from repro.core import optimizers as ref_opt
from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas, paged_decode_attention_pallas)
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jax_paged_ref)
from repro.models import layers as ref_L
from repro.models.registry import get_arch as ref_get_arch
from repro.serve.engine import PagedEngine as RefPagedEngine
from repro.serve.engine import PagedServeConfig as RefPagedConfig
from repro_torch.configs import shapes
from repro_torch.core import optimizers as opt_lib
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels.decode_attention import decode_attention as KD
from repro_torch.kernels.decode_attention import ops
from repro_torch.models import layers as L
from repro_torch.models.registry import ARCH_IDS, get_arch
from repro_torch.serve.engine import PagedEngine, PagedServeConfig
from torch_parity import (CPU, assert_trees_close, jax_batch, make_batch,
                          np_f32, ref_params_and_copy, smoke_archs,
                          torch_batch)

NEW = ("deepseek-moe-16b", "qwen3-32b", "stablelm-12b", "h2o-danube-3-4b",
       "deepseek-v3-671b", "paligemma-3b")
DENSE_NEW = NEW[1:4]
SSM = ("mamba2-1.3b", "zamba2-1.2b")
ENCDEC = ("whisper-base",)
UNKNOWN = ("no-such-arch",)
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# |Δloss| and parameters: the reference's own fused drop-in bounds
LOSS_TOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for sub in ("moe", "mla"):
        if out.get(sub) is not None:
            out[sub] = dataclasses.asdict(out[sub])
    return out


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch_id", NEW + SSM + ENCDEC)
def test_config_fields_match_reference(arch_id, smoke):
    port, ref = get_arch(arch_id, smoke=smoke), ref_get_arch(arch_id,
                                                            smoke=smoke)
    assert (port.arch_id, port.family) == (ref.arch_id, ref.family)
    want = _fields(ref.cfg)
    want["dtype"] = TORCH_DTYPES[ref.cfg.dtype]
    assert _fields(port.cfg) == want


@pytest.mark.parametrize("arch_id", NEW + SSM + ENCDEC)
def test_param_counts_and_cells_match_reference(arch_id):
    """Counted from shapes on the meta device (nothing allocated)."""
    port, ref = get_arch(arch_id), ref_get_arch(arch_id)
    assert port.cfg.param_count() == ref.cfg.param_count()
    assert port.cfg.active_param_count() == ref.cfg.active_param_count()
    assert port.supported_cells() == ref.supported_cells()
    if arch_id == "deepseek-moe-16b":
        assert port.cfg.param_count() == 16_879_568_896
        assert port.cfg.active_param_count() < port.cfg.param_count() // 4
    if arch_id == "deepseek-v3-671b":
        assert port.cfg.param_count() == 704_131_741_696
        assert port.cfg.active_param_count() == 37_891_717_120
    if arch_id == "paligemma-3b":
        assert port.cfg.param_count() == 2_508_662_784
    if arch_id == "mamba2-1.3b":
        assert port.cfg.param_count() == 1_343_740_928
    if arch_id == "zamba2-1.2b":
        assert port.cfg.param_count() == 1_207_176_064
        assert port.cfg.n_attn_applications() == 7
    if arch_id == "whisper-base":
        assert port.cfg.param_count() == 70_686_208


def test_registry_and_shapes():
    assert sorted(ARCH_IDS) == sorted(("h2o-danube-1.8b",) + NEW + SSM +
                                      ENCDEC)
    for arch_id in UNKNOWN:
        with pytest.raises(KeyError, match="unknown architecture"):
            get_arch(arch_id)
    assert shapes.SHAPES == {k: shapes.ShapeSpec(**dataclasses.asdict(v))
                             for k, v in ref_shapes.SHAPES.items()}
    assert shapes.LONG_OK == ref_shapes.LONG_OK
    for arch_id in NEW + SSM + ENCDEC + UNKNOWN:
        assert shapes.cells_for(arch_id) == ref_shapes.cells_for(arch_id)


@pytest.mark.parametrize("arch_id", NEW + SSM + ENCDEC)
def test_smoke_init_matches_reference_shapes(arch_id):
    ref, port = smoke_archs(arch_id)
    rp = ref.init_params(jax.random.PRNGKey(0))
    pp = port.init_params(0, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(pp)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rp)]
    assert [x.dtype for x in tree_leaves(pp)] == \
        [TORCH_DTYPES[x.dtype.type] if x.dtype != jnp.int32 else torch.int32
         for x in jax.tree.leaves(rp)]


@pytest.mark.parametrize("arch_id", DENSE_NEW)
def test_fused_adalomo_step_matches_reference(arch_id):
    """One fused AdaLomo step of the smoke config: loss, metrics and params
    against the reference's fused step from the same weights and batch."""
    ref_arch, port_arch = smoke_archs(arch_id)
    ref_params, port_params = ref_params_and_copy(ref_arch, seed=5)
    batch = make_batch(ref_arch.cfg.vocab, 2, 16, seed=5)
    ropt = ref_opt.get_opt("adalomo", backend="jnp")
    popt = opt_lib.get_opt("adalomo", backend="torch")
    rp, _, rloss, rmetrics = jax.jit(
        lambda p, s, b: ref_arch.make_fused_train_step(ropt)(
            p, s, b, hparams=1e-3))(ref_params, ropt.init(ref_params),
                                    jax_batch(batch))
    _, _, ploss, pmetrics = port_arch.make_fused_train_step(popt)(
        port_params, popt.init(port_params), torch_batch(batch),
        hparams=1e-3)
    assert abs(float(ploss) - float(rloss)) < LOSS_TOL
    for k in rmetrics:
        np.testing.assert_allclose(float(pmetrics[k]), float(rmetrics[k]),
                                   rtol=1e-4, atol=1e-6)
    assert_trees_close(port_params, rp, what=arch_id, **PARAM_TOL)


PROMPTS = [[5, 17, 23, 9], [101, 44], [7] * 6, [3, 4, 5, 6, 7, 8, 9, 10, 11]]


@pytest.mark.parametrize("arch_id", ["stablelm-12b", "h2o-danube-3-4b"])
def test_paged_engine_greedy_matches_reference(arch_id):
    """Layernorm and partial rotary (stablelm) and a window (danube-3) in
    both serving halves: greedy tokens equal to the JAX engine's."""
    ref, port = smoke_archs(arch_id)
    rp, pp = ref_params_and_copy(ref, seed=6)
    kw = dict(page_size=8, num_pages=32, max_batch=3, max_pages_per_seq=8,
              chunk=4, max_new_tokens=6, bucket_min=8)
    want = RefPagedEngine(ref, rp, RefPagedConfig(**kw)).generate(PROMPTS)
    got = PagedEngine(port, pp, PagedServeConfig(**kw),
                      device=CPU).generate(PROMPTS)
    assert got == want


def test_layernorm_matches_reference_with_its_eps():
    """``norm_apply`` hands its own eps (1e-6) to ``layernorm``, whose
    default is 1e-5, in both packages; on rows of small variance the two
    eps give visibly different outputs, so the test tells them apart."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 5, 48)) * 3e-3).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(48)).astype(np.float32)
    rparams = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    pparams = {"scale": torch.from_numpy(scale),
               "bias": torch.from_numpy(bias)}
    want = ref_L.norm_apply(rparams, jnp.asarray(x), kind="layernorm")
    got = L.norm_apply(pparams, torch.from_numpy(x), kind="layernorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    own_default = L.layernorm(torch.from_numpy(x), pparams["scale"],
                              pparams["bias"])
    np.testing.assert_allclose(
        own_default.numpy(),
        np.asarray(ref_L.layernorm(jnp.asarray(x), rparams["scale"],
                                   rparams["bias"])), rtol=1e-5, atol=1e-5)
    assert float((own_default - got).abs().max()) > 1e-2
    # bf16 in, bf16 out, computed in fp32
    got16 = L.norm_apply(pparams, torch.from_numpy(x).to(torch.bfloat16),
                         kind="layernorm")
    want16 = ref_L.norm_apply(rparams, jnp.asarray(x, jnp.bfloat16),
                              kind="layernorm")
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(np_f32(got16), np_f32(want16), rtol=1e-2,
                               atol=1e-2)
    init = L.norm_init(48, "layernorm", device="cpu")
    rinit = ref_L.norm_init(48, "layernorm")
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(rinit[k]))


# --------------------------------------------------------------------------
# K3 and K4's plain versions at the new head dims
# --------------------------------------------------------------------------

# the reference's paged-attention tolerances: fp32 1e-5, bf16 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# B, H, K, dh, page size, P, window, seq_lens: danube-3's heads (group 4,
# dh 120) and stablelm's (group 4, dh 160) cut to 2 KV heads; the MoE
# model's query group of 1 (dh 128); paligemma's 8 heads over 1 (dh 256);
# the smoke configs' dh 16 (group 4 over 1, as paligemma's smoke config)
# and dh 24 (danube-3's smoke config: group 2)
PAGED = [(2, 8, 2, 120, 16, 3, None, (19, 40)),
         (2, 8, 2, 120, 16, 3, 6, (19, 40)),
         (2, 8, 2, 160, 8, 4, None, (1, 30)),
         (3, 4, 4, 128, 8, 3, 5, (3, 24, 11)),
         (2, 8, 1, 256, 16, 3, None, (19, 40)),
         (2, 4, 1, 16, 8, 4, 6, (5, 29)),
         (2, 4, 2, 24, 8, 3, None, (9, 20))]
# B, W, H, K, dh, window, cur
RING = [(2, 96, 8, 2, 120, None, 70), (2, 96, 8, 2, 120, 32, 150),
        (2, 64, 8, 2, 160, None, 40), (1, 80, 4, 4, 128, 16, 200),
        (2, 64, 8, 1, 256, None, 40), (2, 64, 8, 1, 256, None, 100),
        (2, 48, 4, 1, 16, 8, 60), (1, 80, 4, 2, 24, None, 50)]


def _paged_inputs(seed, B, H, K, dh, ps, P, seq_lens):
    rng = np.random.default_rng(seed)
    N = 1 + B * P
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kp = rng.standard_normal((N, ps, K, dh)).astype(np.float32)
    vp = rng.standard_normal((N, ps, K, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, N)).reshape(B, P).astype(np.int32)
    return q, kp, vp, bt, np.asarray(seq_lens, np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,K,dh,ps,P,window,seq_lens", PAGED)
def test_paged_plain_version_at_new_head_dims(B, H, K, dh, ps, P, window,
                                              seq_lens, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _paged_inputs(dh + B, B, H, K, dh, ps, P, seq_lens)
    j = [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
         for a in arrays]
    t = [torch.from_numpy(a).to(tdt) if a.dtype == np.float32
         else torch.from_numpy(a) for a in arrays]
    want = jax_paged_ref(*j, window=window)
    pallas = paged_decode_attention_pallas(*j, window=window, interpret=True)
    assert dh in KD.HEAD_DIMS
    before = KD.paged_decode_attention.launches
    got = ops.paged_decode_attention(t[0][:, None], *t[1:], window=window)
    assert KD.paged_decode_attention.launches == before
    for ref in (want, pallas):
        np.testing.assert_allclose(np_f32(got[:, 0]), np_f32(ref), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,W,H,K,dh,window,cur", RING)
def test_ring_plain_version_at_new_head_dims(B, W, H, K, dh, window, cur,
                                             dtype):
    """A ring that is partly filled (cur < W) or wrapped (cur >= W: slot
    (p - 1) % W holds position p)."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(W + dh)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    vc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    slots = np.arange(W)
    if cur < W:
        pos = np.where(slots <= cur, slots, -1)
    else:
        pos = cur - W + 1 + np.remainder(slots - cur, W)
    pos = pos.astype(np.int32)
    want = decode_attention_pallas(
        *(jnp.asarray(a, jdt) for a in (q, kc, vc)), jnp.asarray(pos),
        float(cur), window=window, kv_block=32, interpret=True)
    assert dh in KD.HEAD_DIMS
    before = KD.decode_attention.launches
    got = ops.decode_attention(
        torch.from_numpy(q).to(tdt)[:, None], torch.from_numpy(kc).to(tdt),
        torch.from_numpy(vc).to(tdt), torch.from_numpy(pos),
        torch.tensor(cur, dtype=torch.int32), window=window)
    assert KD.decode_attention.launches == before
    np.testing.assert_allclose(np_f32(got[:, 0]), np_f32(want), rtol=tol,
                               atol=tol)
