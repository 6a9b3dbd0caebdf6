"""Sharded serving's pieces without a world (``serve/sharded.py``).

K4's partial entry on the CPU (its plain version,
``ring_decode_attention_partial_ref`` through ``ops``) over two and four
blocks of a ring, merged by ``combine_partials``, against the reference's
``decode_attention_ref`` and ``decode_attention_pallas(interpret=True)`` on
the whole ring at the reference kernel tests' cases and tolerances (fp32
1e-5, bf16 3e-2; ``tests/kernels/test_decode_attention_kernel.py``); a
block with no valid slot (``o = 0``, ``lse = -inf``, weighed 0); a rank's
cache block (``Zero3.cache_block``) against the reference's
``cache_pspecs`` on several layouts; and the dry run's serving cells of
the seven transformer-family configs (smoke widths at the cells' shapes),
traced per rank on 16 × 16 and 2 × 16 × 16, whose resting bytes equal the
``reckoned`` block.  Inputs made with numpy from a seed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas)
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.sharding import rules as ref_rules
from repro_torch.configs import paligemma_3b
from repro_torch.kernels.decode_attention import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AXES_BY_NDIM, MeshLayout
from repro_torch.models.registry import get_arch
from repro_torch.serve.sharded import combine_partials, sharded_serving
from repro_torch.sharding.zero import Zero3
from torch_parity import plan_mesh

CASES = [
    # B, W, H, K, dh, window, cur: the reference kernel tests' CASES
    (2, 128, 8, 2, 64, None, 100),
    (1, 300, 4, 4, 128, None, 250),
    (3, 512, 16, 4, 64, 64, 400),
    (2, 64, 8, 8, 32, None, 10),
    (1, 1024, 32, 8, 128, 256, 900),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TRANSFORMERS = ("h2o-danube-1.8b", "h2o-danube-3-4b", "stablelm-12b",
                "qwen3-32b", "deepseek-moe-16b", "deepseek-v3-671b",
                "paligemma-3b")


def _inputs(B, W, H, K, dh, cur, dtype):
    rng = np.random.default_rng(B * W + H)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    vc = rng.standard_normal((B, W, K, dh)).astype(np.float32)
    pos = np.where(np.arange(W) <= cur, np.arange(W), -1).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(x, jdt) for x in (q, kc, vc)] + [jnp.asarray(pos)],
            [torch.from_numpy(x).to(tdt) for x in (q, kc, vc)]
            + [torch.from_numpy(pos)])


_WHOLE = {}


def _whole(case, dtype):
    """The reference's oracle and its Pallas kernel (interpret mode) on the
    whole ring, once a case."""
    if (case, dtype) not in _WHOLE:
        B, W, H, K, dh, window, cur = case
        (q, kc, vc, pos), _ = _inputs(B, W, H, K, dh, cur, dtype)
        ref = decode_attention_ref(
            q, kc, vc, kv_pos=jnp.broadcast_to(pos[None], (B, W)),
            q_pos=jnp.full((B,), cur, jnp.int32), window=window)
        pallas = decode_attention_pallas(q, kc, vc, pos, float(cur),
                                         window=window, kv_block=128,
                                         interpret=True)
        _WHOLE[case, dtype] = [np.asarray(x, np.float32)
                               for x in (ref, pallas)]
    return _WHOLE[case, dtype]


def _merged(case, dtype, blocks):
    """The ring cut into ``blocks`` blocks of slots, each through the
    partial entry, merged and cast once to the cache dtype."""
    B, W, H, K, dh, window, cur = case
    _, (q, kc, vc, pos) = _inputs(B, W, H, K, dh, cur, dtype)
    n = W // blocks
    parts = [ops.decode_attention_partial(
        q[:, None], kc[:, i * n:(i + 1) * n].contiguous(),
        vc[:, i * n:(i + 1) * n].contiguous(), pos[i * n:(i + 1) * n],
        cur, window=window) for i in range(blocks)]
    o = combine_partials(torch.stack([p[0] for p in parts]),
                         torch.stack([p[1] for p in parts]))
    return o.to(q.dtype), parts


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_merged_blocks_match_whole_ring(case, dtype, blocks):
    got, parts = _merged(case, dtype, blocks)
    assert all(o.dtype == lse.dtype == torch.float32 for o, lse in parts)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for want in _whole(case, dtype):
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                   rtol=tol, atol=tol)


def test_block_without_a_valid_slot_weighs_nothing():
    """A block whose slots are all empty or past the query gives o = 0 and
    lse = -inf (not the dense oracle's mean of V); merged with a live block
    it leaves that block's output bit for bit; every block empty gives 0."""
    case = (2, 64, 8, 8, 32, None, 10)              # slots 11..63 empty
    _, parts = _merged(case, "float32", 4)
    for o, lse in parts[1:]:
        assert torch.equal(o, torch.zeros_like(o))
        assert torch.isneginf(lse).all()
    o0, lse0 = parts[0]
    assert torch.isfinite(lse0).all()
    merged = combine_partials(torch.stack([o0, parts[1][0]]),
                              torch.stack([lse0, parts[1][1]]))
    assert torch.equal(merged, o0)
    empty = combine_partials(torch.stack([p[0] for p in parts[1:]]),
                             torch.stack([p[1] for p in parts[1:]]))
    assert torch.equal(empty, torch.zeros_like(empty))


# (mesh dims, batch rows, ring slots): rows and slots that divide, a batch
# of one (long_500k's), slots the model axis does not divide
LAYOUTS = [((2, 2), 4, 8), ((1, 2), 4, 8), ((2,), 4, 8), ((2, 2, 2), 4, 8),
           ((2, 2), 1, 8), ((1, 4), 2, 6)]


@pytest.mark.parametrize("arch_id", ["h2o-danube-1.8b", "deepseek-v3-671b"])
@pytest.mark.parametrize("dims,B,W", LAYOUTS)
def test_cache_block_is_cache_pspecs_block(arch_id, dims, B, W):
    """``Zero3.cache_block`` on every rank of the layout: its block of
    each leaf is the slice the reference's ``cache_pspecs`` gives it (rows
    over ``pod`` × ``data``, slots over ``model``, ``pos`` and ``cur``
    whole), and ``slot_block`` names the same slots."""
    arch = get_arch(arch_id, smoke=True)
    meta = arch.init_params(0, device="meta")
    rng = np.random.default_rng(W)
    whole = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in arch.init_cache(B, W, device="cpu").items()
        if v.ndim >= 3}
    whole["pos"] = torch.arange(W, dtype=torch.int32)
    whole["cur"] = torch.tensor(W, dtype=torch.int32)
    layout = MeshLayout(dims, AXES_BY_NDIM[len(dims)])
    specs = ref_rules.cache_pspecs({k: v.numpy() for k, v in whole.items()},
                                   ref_rules.MeshAxes(layout), B)
    for rank in range(layout.size):
        mesh = plan_mesh(dims, rank)
        zero = Zero3(mesh, meta)
        got = zero.cache_block(whole, B)
        for k, t in whole.items():
            want = t
            for dim, ax in enumerate(specs[k]):
                if ax is None:
                    continue
                parts, i = ((dims[-1], mesh.tile_index) if ax == "model"
                            else (mesh.batch_size, mesh.batch_index))
                n = t.shape[dim] // parts
                want = want.narrow(dim, i * n, n)
            assert torch.equal(got[k], want), (k, rank, specs[k])
        lo, hi = zero.slot_block(W)
        assert got[next(iter(got))].shape[2] == hi - lo


@pytest.fixture()
def pali_prefix_16(monkeypatch):
    """paligemma-3b's smoke config with a 16-row modality prefix: its own 8
    and the cells' 32,768 tokens do not divide over 16 model ranks (the
    published 256 do)."""
    smoke = paligemma_3b.smoke_config
    monkeypatch.setattr(paligemma_3b, "smoke_config", lambda: dataclasses
                        .replace(smoke(), n_prefix_tokens=16))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "prefill_32k"])
@pytest.mark.parametrize("arch_id", TRANSFORMERS)
def test_dry_serving_cell_rests_as_reckoned(arch_id, shape_name, mesh_kind,
                                            pali_prefix_16):
    """A transformer-family serving cell on a mesh is one rank's trace
    (``n_chips`` the mesh's size): its resting bytes (param blocks, and a
    decode cell's cache block) equal the ``reckoned`` bytes under
    ``param_pspecs`` and ``cache_pspecs``; a decode step launches K4's
    partial entry once a GQA layer (none for MLA, none in a prefill)."""
    mesh = D.mesh_shape(mesh_kind)
    cell = D.build_cell(arch_id, shape_name, mesh, smoke=True)
    res = D.cell_result(cell, mesh_kind, mesh)
    rk = res["memory"]["reckoned"]
    assert res["n_chips"] == np.prod(mesh)
    assert res["memory"]["resting_bytes"] == (
        rk["param_bytes_per_device"] + rk["cache_bytes_per_device"]) > 0
    cfg = get_arch(arch_id, smoke=True).cfg
    gqa = shape_name == "decode_32k" and cfg.mla is None
    assert res["kernel_launches"] == (
        {"decode_attention_partial": cfg.n_layers} if gqa else {})
    assert res["collective_stats"]["calls"] > 0


def test_baseline_serving_cell_gathers_no_kv():
    """``--baseline``'s prefill cell: the same resting bytes, every model
    rank its rows' whole sequence, so no K/V tile is gathered."""
    opt, base = (D.build_cell("h2o-danube-1.8b", "prefill_32k", (16, 16),
                              smoke=True, optimized=o) for o in (True, False))
    assert base["trace"].resting_bytes == opt["trace"].resting_bytes
    assert base["trace"].stats["gather_bytes"] < \
        opt["trace"].stats["gather_bytes"]


def test_other_families_keep_the_one_device_trace():
    """mamba2, zamba2 and whisper split their caches otherwise: sharded
    serving refuses them, and their serving cells on a mesh stay the
    one-device trace beside the reckoning."""
    with pytest.raises(ValueError, match="transformer family"):
        sharded_serving(get_arch("mamba2-1.3b", smoke=True),
                        plan_mesh((1, 2), 0))
    cell = D.build_cell("mamba2-1.3b", "decode_32k", (16, 16), smoke=True)
    assert cell["n_chips"] == 1 and "reckoned" in cell
