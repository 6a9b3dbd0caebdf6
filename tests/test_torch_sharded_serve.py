"""Sharded serving's pieces without a world (``serve/sharded.py``).

K4's partial entry on the CPU (its plain version,
``ring_decode_attention_partial_ref`` through ``ops``) over two and four
blocks of a ring, merged by ``combine_partials``, against the reference's
``decode_attention_ref`` and ``decode_attention_pallas(interpret=True)`` on
the whole ring at the reference kernel tests' cases and tolerances (fp32
1e-5, bf16 3e-2; ``tests/kernels/test_decode_attention_kernel.py``); a
block with no valid slot (``o = 0``, ``lse = -inf``, weighed 0); a rank's
cache block (``Zero3.cache_block``) of every family's cache against the
reference's ``cache_pspecs`` on several layouts (a model axis of 3 splits
mamba's conv taps); mamba's mixer on a model axis of 3, whose split
conv taps are gathered before the conv and cut after it, against its
whole-window and whole-sequence forms, and its serving steps traced per
rank on that axis; and the dry run's
serving cells of the seven transformer-family configs and of mamba2,
zamba2 and whisper (smoke widths at the cells' shapes), traced per rank on
16 × 16 and 2 × 16 × 16, whose resting bytes equal the ``reckoned`` block.
Inputs made with numpy from a seed.
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
from repro_torch.configs import mamba2_1_3b, paligemma_3b, zamba2_1_2b
from repro_torch.kernels.decode_attention import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AXES_BY_NDIM, MeshLayout
from repro_torch.models import mamba2 as M2
from repro_torch.models.registry import get_arch
from repro_torch.serve.sharded import _mix_block, _mix_prefill, combine_partials
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R
from repro_torch.sharding.zero import Zero3, rest_pspecs
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
# of one (long_500k's), slots the model axis does not divide, a model axis
# of 3 (mamba's 3 conv taps split, its 8 smoke heads whole)
LAYOUTS = [((2, 2), 4, 8), ((1, 2), 4, 8), ((2,), 4, 8), ((2, 2, 2), 4, 8),
           ((2, 2), 1, 8), ((1, 4), 2, 6), ((1, 3), 2, 6)]


@pytest.mark.parametrize("arch_id", ["h2o-danube-1.8b", "deepseek-v3-671b",
                                     "mamba2-1.3b", "zamba2-1.2b",
                                     "whisper-base"])
@pytest.mark.parametrize("dims,B,W", LAYOUTS)
def test_cache_block_is_cache_pspecs_block(arch_id, dims, B, W):
    """``Zero3.cache_block`` on every rank of the layout: its block of
    each leaf is the slice the reference's ``cache_pspecs`` gives it (rows
    over ``pod`` × ``data``; dim 2 over ``model`` — a ring's slots,
    mamba's conv taps and SSM heads, whisper's frames — where the axis
    divides it; ``pos`` and ``cur`` whole), and ``slot_block`` names the
    same block of every dim 2."""
    arch = get_arch(arch_id, smoke=True)
    meta = arch.init_params(0, device="meta")
    rng = np.random.default_rng(W)
    empty = arch.init_cache(B, W, device="cpu")
    whole = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in empty.items() if v.ndim >= 3}
    if "pos" in empty:
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
            if t.ndim >= 3:
                lo, hi = zero.slot_block(t.shape[2])
                assert got[k].shape[2] == hi - lo, (k, rank)


def _mix_layer():
    """mamba2's smoke config and layer 1 of its params (seeded)."""
    arch = get_arch("mamba2-1.3b", smoke=True)
    blocks = arch.init_params(0, device="cpu")["stacks"]["blocks"]
    return arch, {k: (v[1] if not isinstance(v, dict) else
                      {kk: vv[1] for kk, vv in v.items()})
                  for k, v in blocks.items()}


@pytest.mark.parametrize("rank", range(3))
def test_split_taps_decode_as_the_whole_mixer(rank, monkeypatch):
    """A model axis of 3 splits mamba's 3 conv taps (its 8 smoke heads
    stay whole): rank ``r``'s one-token mixer on its tap gathers the taps
    over ``model`` once, on their dim, before the conv (a stub all-gather
    that checks the rank's block and joins the three in rank order), and
    keeps tap ``r`` of the next window.  Output, tap and state equal
    ``mamba2_mix``'s decode on the whole window (held against the
    reference in ``tests/test_torch_mamba2.py``) bit for bit."""
    arch, p = _mix_layer()
    cfg = arch.cfg
    rng = np.random.default_rng(3)
    h, conv, ssm = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((2, 1, cfg.d_model),
                                   (2, cfg.d_conv - 1, cfg.conv_dim),
                                   (2, cfg.n_heads, cfg.headdim,
                                    cfg.d_state)))
    want = M2.mamba2_mix(p, cfg, h, conv, ssm, decode=True)
    taps = [conv[:, i:i + 1] for i in range(3)]
    gathered = []

    def all_gather(x, dim, group):
        assert torch.equal(x, taps[rank])
        gathered.append(dim)
        return torch.cat(taps, dim)

    monkeypatch.setattr(C, "all_gather", all_gather)
    zero = Zero3(plan_mesh((1, 3), rank), arch.init_params(0, device="meta"))
    out, tap, state = M2.mamba2_mix(p, cfg, h, taps[rank].clone(), ssm,
                                    decode=True, **_mix_block(zero, cfg))
    assert gathered == [1]                # the taps; the heads are whole
    assert torch.equal(out, want[0])
    assert torch.equal(tap, want[1][:, rank:rank + 1])
    assert torch.equal(state, want[2])


@pytest.mark.parametrize("rank", range(3))
def test_split_taps_prefill_keeps_the_rank_tap(rank):
    """Rank ``r``'s prefill mixer on a model axis of 3 (no tile: the
    whole sequence) writes tap ``r`` of the conv tail and every head's
    final state, and returns every row: the whole-sequence mixer's
    (``mamba2._mix_seq``, held against the reference in
    ``tests/test_torch_mamba2.py``), bit for bit."""
    arch, p = _mix_layer()
    cfg = arch.cfg
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model)).astype(
        np.float32))
    out, tail, state = M2._mix_seq(p, cfg, h, return_state=True)
    zero = Zero3(plan_mesh((1, 3), rank), arch.init_params(0, device="meta"))
    conv = torch.empty((2, 1, cfg.conv_dim))
    ssm = torch.empty((2, cfg.n_heads, cfg.headdim, cfg.d_state))
    got = _mix_prefill(p, cfg, zero, h, conv, ssm)
    assert torch.equal(got, out)
    assert torch.equal(conv, tail[:, rank:rank + 1])
    assert torch.equal(ssm, state)


@pytest.mark.parametrize("rank", range(3))
def test_dry_serving_on_a_model_axis_of_3(rank):
    """mamba2's serving steps traced for rank ``r`` of (1, 3): a prefill of
    12 tokens and two decode steps leave the rank's one conv tap and every
    head, each decode step gathers its layers' taps over ``model`` once a
    layer; a decode step from a whole cache rests the rank's param and
    cache blocks, as ``rest_pspecs`` and ``cache_pspecs`` reckon them."""
    arch = get_arch("mamba2-1.3b", smoke=True)
    cfg, B = arch.cfg, 2
    block, tr = D.trace_serving(arch, (1, 3), rank=rank,
                                prompt={"tokens": ((B, 12), torch.int32)},
                                decode_steps=2)
    assert block["conv"].shape == (cfg.n_layers, B, 1, cfg.conv_dim)
    assert block["ssm"].shape[2] == cfg.n_heads
    taps = [c for c in tr.log if c["kind"] == "all_gather"
            and c["shape"] == [B, 1, cfg.conv_dim]]
    assert len(taps) == 2 * cfg.n_layers
    assert all(c["axes"] == ["model"] for c in taps)
    whole = arch.init_cache(B, 8, device="meta")
    _, tr = D.trace_serving(arch, (1, 3), rank=rank, cache=whole)
    layout = MeshLayout((1, 3), AXES_BY_NDIM[2])
    axes = R.MeshAxes(layout)
    meta = arch.init_params(0, device="meta")
    assert tr.resting_bytes == (
        D.pspec_bytes(meta, rest_pspecs(meta, axes), layout.shape)
        + D.pspec_bytes(whole, R.cache_pspecs(whole, axes, B),
                        layout.shape))


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


@pytest.fixture()
def ssm_published_chunk(monkeypatch):
    """mamba2's and zamba2's smoke configs with the published SSD chunk of
    128 (the smoke chunk of 8 makes the cells' 32,768 tokens 4,096
    chunks, each a step of the trace's scan)."""
    for mod in (mamba2_1_3b, zamba2_1_2b):
        smoke = mod.smoke_config
        monkeypatch.setattr(mod, "smoke_config", lambda smoke=smoke: (
            dataclasses.replace(smoke(), chunk=128)))


OTHER_CELLS = [(a, s) for a in ("mamba2-1.3b", "zamba2-1.2b")
               for s in ("prefill_32k", "decode_32k", "long_500k")] + [
    ("whisper-base", "prefill_32k"), ("whisper-base", "decode_32k")]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch_id,shape_name", OTHER_CELLS)
def test_dry_serving_cell_of_other_families_rests_as_reckoned(
        arch_id, shape_name, mesh_kind, ssm_published_chunk):
    """A mamba2, zamba2 or whisper serving cell on a mesh is one rank's
    trace too (``n_chips`` the mesh's size), its resting bytes the
    ``reckoned`` bytes (mamba's conv bias whole over ``model``); a decode
    step launches K4's partial entry once an application of zamba2's
    shared block, and twice a whisper decoder layer, or once with the
    whole-ring entry once where the model axis does not divide the frames
    (the smoke config's 24 over 16); mamba2 and a prefill launch none."""
    mesh = D.mesh_shape(mesh_kind)
    cell = D.build_cell(arch_id, shape_name, mesh, smoke=True)
    res = D.cell_result(cell, mesh_kind, mesh)
    rk = res["memory"]["reckoned"]
    assert res["n_chips"] == np.prod(mesh)
    assert res["memory"]["resting_bytes"] == (
        rk["param_bytes_per_device"] + rk["cache_bytes_per_device"]) > 0
    cfg = get_arch(arch_id, smoke=True).cfg
    want = {}
    if shape_name != "prefill_32k" and arch_id == "zamba2-1.2b":
        want = {"decode_attention_partial": cfg.n_attn_applications()}
    elif shape_name != "prefill_32k" and arch_id == "whisper-base":
        split = cfg.n_frames % mesh[-1] == 0
        want = {"decode_attention_partial": cfg.n_dec_layers * (1 + split)}
        if not split:
            want["decode_attention"] = cfg.n_dec_layers
    assert res["kernel_launches"] == want
    assert res["collective_stats"]["calls"] > 0
