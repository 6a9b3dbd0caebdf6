"""PyTorch port vs the JAX reference: the dense GQA transformer's train path
(``models/layers.py``, ``models/transformer.py``) — loss, metrics and full
gradients of ``unfused_loss_fn`` at converted weights against
``jax.value_and_grad`` of the reference, fp32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_L
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.models.registry import get_arch, paper_llama_1b
from repro_torch.models.transformer import LMConfig, make_fused_spec
from torch_parity import (ARCH_ID, assert_trees_close, jax_batch, make_batch,
                          np_f32, ref_params_and_copy, smoke_archs,
                          torch_batch)

VARIANTS = {
    "base_window8": {},
    "no_window": {"window": None},
    "window3": {"window": 3},
    "qk_norm": {"qk_norm": True},
    "tie_embeddings": {"tie_embeddings": True},
    "z_loss": {"z_loss": 1e-3},
    "rope_pct_half": {"rope_pct": 0.5},
    "embed_scale_gelu": {"embed_scale": True, "act": "gelu"},
}


def _ignore_some_labels(batch):
    batch = dict(batch)
    lab = batch["labels"].copy()
    lab[0, :3] = -1
    batch["labels"] = lab
    return batch


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_loss_and_grads_match_reference(name):
    """rtol 1e-4 / atol 1e-5: fp32 on both sides, the same arithmetic with
    other summation orders in the matmuls and reductions."""
    ref_arch, port_arch = smoke_archs(**VARIANTS[name])
    ref_params, port_params = ref_params_and_copy(ref_arch, seed=1)
    batch = _ignore_some_labels(make_batch(ref_arch.cfg.vocab, 2, 16, seed=2))

    (rloss, rmetrics), rgrads = jax.value_and_grad(
        ref_arch.make_loss_fn(), has_aux=True)(ref_params, jax_batch(batch))

    p_req = tree_map(lambda t: t.requires_grad_(True), port_params)
    loss, metrics = port_arch.make_loss_fn()(p_req, torch_batch(batch))
    leaves = tree_leaves(p_req)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    pgrads = tree_map(lambda _: next(it), p_req)

    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    assert sorted(metrics) == sorted(rmetrics)
    for k in rmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(metrics["ntokens"]) == 2 * 16 - 3
    assert_trees_close(pgrads, rgrads, rtol=1e-4, atol=1e-5, what=name)


def test_window_mask_matches_reference():
    q = np.arange(12, dtype=np.int32)
    for window in (None, 1, 4, 12):
        rm = ref_L._mask_block(jnp.asarray(q), jnp.asarray(q),
                               ref_L.MaskSpec(causal=True, window=window),
                               None)
        pm = L._mask_block(torch.from_numpy(q), torch.from_numpy(q),
                           L.MaskSpec(causal=True, window=window))
        assert np.array_equal(pm.numpy(), np.asarray(rm))
    assert not np.array_equal(
        L._mask_block(torch.from_numpy(q), torch.from_numpy(q),
                      L.MaskSpec(window=4)).numpy(),
        L._mask_block(torch.from_numpy(q), torch.from_numpy(q),
                      L.MaskSpec()).numpy())


@pytest.mark.parametrize("rope_pct", [1.0, 0.5, 0.0])
def test_rope_and_rmsnorm_match_reference(rope_pct):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    d_rot = int(16 * rope_pct) // 2 * 2
    rs, rc = ref_L.rope_sincos(jnp.asarray(pos), max(d_rot, 2))
    ps, pc = L.rope_sincos(torch.from_numpy(pos), max(d_rot, 2))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs), atol=1e-6)
    ry = ref_L.apply_rope(jnp.asarray(x), rs, rc, rope_pct)
    py = L.apply_rope(torch.from_numpy(x), ps, pc, rope_pct)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(ref_L.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)


def test_attention_bf16_scores_are_fp32():
    """Scores are formed in fp32 from bf16 operands, as the reference's
    ``preferred_element_type=float32``: the port agrees with the reference
    on bf16 inputs to bf16 output precision."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    ro = ref_L.attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         spec=ref_L.MaskSpec(window=4), q_pos=jnp.asarray(pos),
                         kv_pos=jnp.asarray(pos))
    po = L.attention(*(torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v)),
                     spec=L.MaskSpec(window=4), q_pos=torch.from_numpy(pos),
                     kv_pos=torch.from_numpy(pos))
    assert po.dtype == torch.bfloat16
    np.testing.assert_allclose(np_f32(po), np_f32(ro), rtol=2e-2, atol=2e-2)


def test_logits_are_fp32_from_bf16_params():
    """Decided and stated: logits come out in fp32 with fp32 accumulation
    from bf16 parameters (an fp32 product of the bf16 values), not rounded
    to bf16 first."""
    from repro_torch.models.transformer import _logits
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)
                         ).to(torch.bfloat16)
    cfg = get_arch(ARCH_ID, smoke=True).cfg
    out = _logits({"head": w}, cfg, h)
    assert out.dtype == torch.float32
    exact = h.double() @ w.double()
    np.testing.assert_allclose(out.double().numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_long_sequences_name_the_unported_branch():
    q = torch.zeros(1, 2049, 2, 4)
    kv = torch.zeros(1, 2049, 1, 4)
    pos = torch.arange(2049)
    with pytest.raises(NotImplementedError, match="_flash_attention"):
        L.attention(q, kv, kv, spec=L.MaskSpec(), q_pos=pos, kv_pos=pos)
    with pytest.raises(NotImplementedError, match="_swa_gather_attention"):
        L.attention(q, kv, kv, spec=L.MaskSpec(window=8), q_pos=pos,
                    kv_pos=pos)


@pytest.mark.parametrize("field,value", [("moe", object()), ("mla", object()),
                                         ("mtp", True), ("prefix_lm", True)])
def test_unported_model_features_raise(field, value):
    cfg = dataclasses.replace(get_arch(ARCH_ID, smoke=True).cfg,
                              **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        make_fused_spec(cfg)


def test_configs_and_init_match_reference_shapes():
    """Published widths are the reference's; init draws from an explicit
    generator on the device asked for; ``param_count`` allocates nothing."""
    from repro.models.registry import get_arch as ref_get_arch
    from repro.models.registry import paper_llama_1b as ref_llama
    for ref, port in ((ref_get_arch(ARCH_ID), get_arch(ARCH_ID)),
                      (ref_llama(), paper_llama_1b())):
        for f in dataclasses.fields(LMConfig):
            if f.name != "dtype":
                assert getattr(port.cfg, f.name) == getattr(ref.cfg, f.name)
        assert port.cfg.dtype == torch.bfloat16
    assert get_arch(ARCH_ID).cfg.param_count() == \
        ref_get_arch(ARCH_ID).cfg.param_count()
    ref_arch, port_arch = smoke_archs()
    ref_params = ref_arch.init_params(jax.random.PRNGKey(0))
    a = port_arch.init_params(0, device="cpu")
    b = port_arch.init_params(0, device="cpu")
    c = port_arch.init_params(1, device="cpu")
    shapes = lambda t: [tuple(x.shape) for x in tree_leaves(t)]  # noqa: E731
    assert shapes(a) == [tuple(x.shape) for x in jax.tree.leaves(ref_params)]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))
    assert not torch.equal(a["outer"]["head"], c["outer"]["head"])
    assert port_arch.train_batch_specs(4, 16) == {
        "tokens": ((4, 16), torch.int32), "labels": ((4, 16), torch.int32)}
    with pytest.raises(KeyError, match="not ported"):
        get_arch("qwen3-32b")
