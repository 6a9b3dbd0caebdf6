"""Every decoder-only family beside the transformer's on a model axis,
over ``gloo`` worlds on the host, held against the JAX package's
single-device run of the same spec from the same weights.

paligemma-3b's modality prefix: the ``P + S`` sequence (the batch's
``prefix_embed`` rows, then its tokens) tiled evenly over ``model``, so a
tile holds prefix rows, token rows or both; the prefix-LM mask from
absolute positions against K/V gathered over ``model``; each tile scoring
only its own token rows.  The smoke config's prefix is ``P = 8``.  On
(1, 2) at 16 tokens the tiles are 12 rows, tile 0 the prefix and 4
tokens; on (1, 4) they are 6 rows, so the prefix and its mask run across a
tile edge; on (1, 2) at 8 tokens tile 0 is all prefix and has no label;
(2, 2) cuts the rows too.  One case keeps the modality prefix under a
causal mask (``prefix_lm=False``), so the mask and the tiling are held
apart; its runs in both packages take the prefix-LM config's batches (the
reference draws prefix embeddings for a prefix-LM config only).

mamba2-1.3b and zamba2-1.2b: each rank's mamba mixer runs on its tile's
normed input gathered whole over ``model`` (the chunked SSD and the causal
conv run along the whole sequence) and keeps its own rows; zamba2's shared
attention block runs at the tile's absolute positions against K/V gathered
over ``model``.  Fused AdaLomo and LOMO, and unfused AdamW.  zamba2's smoke
config applies its shared block twice (layers 0 and 2 of 4), so the shared
gradients sum over two applications on every rank, in the leaves' own
dtype as the reference does, before the ZeRO-3 scatter sums them over the
ranks.  In bf16 that is held as ``test_torch_sharded_bf16.py`` holds
danube on ``(2,)``: the elements beyond the sharded tolerance plus one
bf16 ulp, each package's sharded run against its own unsharded run, the
port's no more than the reference's GSPMD run's on ``(1, 2)``.

Two worlds serve every case, one of two ranks and one of four
(``_torch_elastic_worker.start_world``), and the reference's bf16 runs in
a subprocess; the reference's fp32 runs are made in this process
meanwhile, once for each config, sequence and optimizer.  Tolerances are
the reference's own for its sharded run
(``tests/distribution/_dist_script.py``): loss rtol 1e-5, atol 1e-5;
params rtol 5e-4, atol 1e-5, with AdamW's near-zero-gradient elements
counted apart (``torch_parity.params_close``)."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import layers as ref_L
from repro.run import spec as ref_spec_mod
from repro.run.data import make_batch_iter as ref_batch_iter
from repro.run.runner import run as ref_run
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import layers as L
from repro_torch.run import run
from torch_parity import (assert_trees_close, bf16_outside, params_close,
                          patch_attention_thresholds, ref_params_and_copy,
                          smoke_archs)
from _torch_elastic_worker import dtype_arch, make_spec, start_world

PALI, MAMBA, ZAMBA = "paligemma-3b", "mamba2-1.3b", "zamba2-1.2b"
P = 8                   # paligemma's smoke n_prefix_tokens
STEPS = 3
SEQ = 32                # mamba2's chunks of 8: a tile of 16 on (1, 2)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
# paligemma: case -> (mesh, tokens, prefix_lm)
PREFIX_CASES = {
    "s16_1x2": ((1, 2), 16, True),     # tiles of 12: P + 4 tokens, 12
    "s8_1x2": ((1, 2), 8, True),       # tiles of 8: all prefix, 8 tokens
    "s16_1x4": ((1, 4), 16, True),     # tiles of 6: the prefix crosses
    "s16_2x2": ((2, 2), 16, True),
    "causal_1x4": ((1, 4), 16, False),
}
# the state-space families: case -> (arch, mesh, optimizer), SEQ tokens
SSM_CASES = {
    "mamba_1x2": (MAMBA, (1, 2), "adalomo"),
    "mamba_2x2": (MAMBA, (2, 2), "adalomo"),
    "zamba_1x2": (ZAMBA, (1, 2), "adalomo"),
    "zamba_1x4": (ZAMBA, (1, 4), "adalomo"),
    "zamba_adamw_1x2": (ZAMBA, (1, 2), "adamw"),
    "zamba_lomo_1x2": (ZAMBA, (1, 2), "lomo"),
}
# (P, S) cut by Zero3.rows on (1, 2): T = 10 > P, T = P = 16, T = 16 < P,
# and 3 + 16 rows, which two tiles do not divide
CUTS = [(4, 16), (16, 16), (24, 8), (3, 16)]
# The most elements of zamba2's smoke params (bf16, 3 steps on (1, 2))
# either package may leave beyond the sharded tolerance plus one ulp, of
# 192 736: twice the reference's measured count on the CPU (225; the
# port's 73).
BF16_BOUND = 450
HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, os.pardir, "src")


def _ref_arch(arch_id, prefix_lm=True):
    ref, _ = smoke_archs(arch_id)
    if prefix_lm:
        return ref
    return dataclasses.replace(ref, cfg=dataclasses.replace(
        ref.cfg, prefix_lm=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results and the reference's single-device runs."""
    d = tmp_path_factory.mktemp("model_axis_families")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, HERE, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    bf16_ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_bf16_reference.py"),
         str(d), ZAMBA, "1x2", str(STEPS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    init = {}
    for arch_id in (PALI, MAMBA, ZAMBA):
        ref_params, port_params = ref_params_and_copy(_ref_arch(arch_id))
        path = str(d / f"init_{arch_id}.pt")
        torch.save(port_params, path)
        init[arch_id] = (path, ref_params, port_params)
    worlds = {}

    def add(shape, case):
        worlds.setdefault(math.prod(shape), []).append(case)

    for name, (shape, seq, prefix_lm) in PREFIX_CASES.items():
        add(shape, dict(
            kind="run", arch=PALI, shape=list(shape), total=STEPS, seq=seq,
            ckpt=str(d / name), init=init[PALI][0],
            out=str(d / f"{name}.json"),
            overrides=None if prefix_lm else {"prefix_lm": False}))
    add((1, 2), dict(kind="prefix_rows", arch=PALI, shape=[1, 2],
                     cuts=CUTS, out=str(d / "rows")))
    for name, (arch_id, shape, opt) in SSM_CASES.items():
        add(shape, dict(
            kind="run", arch=arch_id, shape=list(shape), total=STEPS,
            seq=SEQ, opt=opt, ckpt=str(d / name), init=init[arch_id][0],
            out=str(d / f"{name}.json")))
    zamba16 = _ref_arch(ZAMBA)
    _, port16 = ref_params_and_copy(dataclasses.replace(
        zamba16, cfg=dataclasses.replace(zamba16.cfg, dtype=jnp.bfloat16)))
    torch.save(port16, str(d / "init_bf16.pt"))
    add((1, 2), dict(
        kind="run", arch=ZAMBA, shape=[1, 2], total=STEPS, seq=SEQ,
        ckpt=str(d / "zamba_bf16"), init=str(d / "init_bf16.pt"),
        dtype="bfloat16", out=str(d / "zamba_bf16.json")))
    waits = [start_world(w, str(d / f"store{w}"), cases)
             for w, cases in sorted(worlds.items())]
    ref = {}
    for seq, prefix_lm in sorted({(s, p) for _, s, p
                                  in PREFIX_CASES.values()}):
        # the causal run takes the prefix-LM config's batches
        spec = make_spec(PALI, spec_mod=ref_spec_mod, data_cls=RefDataConfig,
                         total=STEPS, seq_len=seq)
        ref[PALI, seq, prefix_lm] = ref_run(
            spec, arch=_ref_arch(PALI, prefix_lm),
            params=jax.tree.map(lambda x: x.copy(), init[PALI][1]),
            batch_iter=ref_batch_iter(spec, _ref_arch(PALI)),
            log_fn=lambda s: None)
    for arch_id, opt in sorted({(a, o) for a, _, o in SSM_CASES.values()}):
        ref[arch_id, opt] = ref_run(
            make_spec(arch_id, spec_mod=ref_spec_mod, data_cls=RefDataConfig,
                      total=STEPS, seq_len=SEQ, opt=opt),
            arch=_ref_arch(arch_id),
            params=jax.tree.map(lambda x: x.copy(), init[arch_id][1]),
            log_fn=lambda s: None)
    single16 = run(make_spec(ZAMBA, total=STEPS, seq_len=SEQ),
                   arch=dtype_arch(ZAMBA, torch.bfloat16),
                   params=tree_map(torch.clone, port16), device="cpu",
                   log_fn=lambda s: None).params
    for wait in waits:
        wait()
    _, tree, _ = CheckpointManager(d / "zamba_bf16").restore(
        STEPS, template=(port16, get_opt("adalomo").init(port16)))
    f32 = [[t.to(torch.float32).numpy() for t in tree_leaves(x)]
           for x in (tree[0], single16)]
    _, stderr = bf16_ref.communicate(timeout=300)
    assert bf16_ref.returncode == 0, stderr[-3000:]
    bf16 = json.loads((d / "ref.json").read_text())
    bf16["port"] = bf16_outside(*f32)
    bf16["n_port"] = sum(a.size for a in f32[0])
    return {"dir": d, "ref": ref, "init": init, "bf16": bf16}


@pytest.mark.parametrize("name", list(PREFIX_CASES))
def test_prefix_on_a_model_axis_matches_reference(runs, name):
    """Losses and final params against the reference's single-device run:
    the tile's prefix rows and token rows, its absolute positions under
    the prefix-LM (or causal) mask, the prefix rows dropped from its
    scores only, and the loss a sum over the global token count."""
    shape, seq, prefix_lm = PREFIX_CASES[name]
    ref = runs["ref"][PALI, seq, prefix_lm]
    h = json.loads((runs["dir"] / f"{name}.json").read_text())
    assert h["step"] == list(range(STEPS))
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    port = runs["init"][PALI][2]
    _, tree, _ = CheckpointManager(runs["dir"] / name).restore(
        STEPS, template=(port, get_opt("adalomo").init(port)))
    assert_trees_close(tree[0], ref.params, what=name, **PARAM_TOL)


def test_causal_and_prefix_lm_runs_differ(runs):
    """The causal case is not the prefix-LM run under another name: the
    mask moves the losses far outside the tolerance."""
    a = runs["ref"][PALI, 16, True].history["loss"]
    b = runs["ref"][PALI, 16, False].history["loss"]
    assert np.max(np.abs(np.subtract(a, b))) > 1e-3


@pytest.mark.parametrize("cut", range(len(CUTS)))
def test_rows_cut_the_prefix_then_the_tokens(runs, cut):
    """``Zero3.rows`` on (1, 2): tile ``i`` of the ``P + S`` rows is
    ``[iT, (i+1)T)``; it takes ``prefix_embed``'s rows below ``P`` and the
    tokens' and labels' rows at and past it, shifted by ``P``;
    ``prefix_len`` stays whole; ``tile`` is ``[B, T]``.  A ``P + S`` two
    tiles do not divide raises, naming it."""
    P_, S = CUTS[cut]
    n = P_ + S
    for rank in range(2):
        got = json.loads((runs["dir"] / f"rows.rank{rank}.json")
                         .read_text())[cut]
        if n % 2:
            assert "P + S = 3 + 16 = 19" in got["error"]
            continue
        T = n // 2
        rows = list(range(rank * T, (rank + 1) * T))
        assert got["tile"] == [4, T]
        assert got["prefix_embed"] == [float(r) for r in rows if r < P_]
        assert got["tokens"] == [r for r in rows if r >= P_]
        assert got["labels"] == [-r for r in rows if r >= P_]
        assert got["prefix_len"] == [P_] * 4


@pytest.mark.parametrize("name", list(SSM_CASES))
def test_state_space_on_a_model_axis_matches_reference(runs, name):
    """Losses and final params against the reference's single-device run:
    the mixer on the gathered sequence with the tile's rows kept, the
    parameter gradients summed over the tiles, and (zamba2) the shared
    block's queries at the tile's positions over the gathered K/V."""
    arch_id, shape, opt = SSM_CASES[name]
    ref = runs["ref"][arch_id, opt]
    h = json.loads((runs["dir"] / f"{name}.json").read_text())
    assert h["step"] == list(range(STEPS))
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    port = runs["init"][arch_id][2]
    _, tree, _ = CheckpointManager(runs["dir"] / name).restore(
        STEPS, template=(port, get_opt(opt).init(port)))
    params_close(tree[0], ref.params, name, opt=opt, **PARAM_TOL)
    gathers = {(a, k): n for a, k, n in h["gathers"]}
    if opt != "adamw":
        assert gathers[("model", "dense")] > 0


def test_zamba2_bf16_on_1x2_within_the_reference_band(runs):
    """zamba2's smoke config in bf16 on (1, 2), 3 fused AdaLomo steps:
    the port's elements beyond rtol 5e-4 / atol 1e-5 plus one bf16 ulp of
    its own unsharded run are no more than the reference's GSPMD run
    leaves against its unsharded run (the shared block's gradients summed
    over its two applications in bf16 on every rank, then over the
    ranks), and both within :data:`BF16_BOUND`."""
    got = runs["bf16"]
    print("zamba2 bf16 (1, 2) elements outside tolerance", got)
    assert got["n_port"] == got["elements"]
    ref = got["outside"][str(STEPS)]
    assert ref <= BF16_BOUND and got["port"] <= BF16_BOUND, got
    assert got["port"] <= ref, got


# --------------------------------------------------------------------------
# The prefix-LM mask on a tile, in process: a rank's tile of the queries at
# its absolute positions against the whole sequence's K/V, against the
# reference's whole-sequence attention cut to the tile.
# --------------------------------------------------------------------------

B, ATT_SEQ, K, G, DH = 2, 48, 2, 2, 16
TP = 3                               # tiles of 16
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(2)
    H = K * G
    return {n: rng.standard_normal(shape).astype(np.float32) for n, shape in
            (("q", (B, ATT_SEQ, H, DH)), ("k", (B, ATT_SEQ, K, DH)),
             ("v", (B, ATT_SEQ, K, DH)), ("w", (B, ATT_SEQ, H, DH)))}


def _ref_tile(x, prefix, tile):
    sel = np.zeros((1, ATT_SEQ, 1, 1), np.float32)
    sel[:, tile] = 1.0
    pos = jnp.arange(ATT_SEQ)
    plen = jnp.asarray(prefix, jnp.int32)

    def f(q, k, v):
        out = ref_L.attention(q, k, v, spec=ref_L.MaskSpec(
            causal=True, has_prefix=True), q_pos=pos, kv_pos=pos,
            prefix_len=plen)
        return jnp.sum(out * (x["w"] * sel)), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]))
    return np.asarray(out)[:, tile], [np.asarray(g) for g in grads]


def _port_tile(x, prefix, tile, i):
    q = torch.from_numpy(x["q"][:, tile].copy()).requires_grad_(True)
    k = torch.from_numpy(x["k"]).requires_grad_(True)
    v = torch.from_numpy(x["v"]).requires_grad_(True)
    pos = torch.arange(ATT_SEQ, dtype=torch.int32)
    out = L.attention(q, k, v, spec=L.MaskSpec(causal=True, has_prefix=True),
                      q_pos=pos[tile], kv_pos=pos,
                      prefix_len=torch.tensor(prefix, dtype=torch.int32),
                      q_offset=i * (ATT_SEQ // TP))
    grads = torch.autograd.grad(
        torch.sum(out * torch.from_numpy(x["w"][:, tile].copy())), (q, k, v))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("prefix", [[20, 5], [40, 16]])
@pytest.mark.parametrize("branch", ["direct", "flash"])
def test_prefix_lm_tile_attention_matches_whole_sequence(monkeypatch, branch,
                                                         prefix):
    """Each tile's output and gradients (dq on its rows, dk and dv its
    queries' share) with rows' prefixes that end inside tile 0, on its
    edge, inside tile 1 and inside tile 2, in the direct branch and in the
    flash branch (blocks of 8, its custom VJP)."""
    if branch == "flash":
        patch_attention_thresholds(monkeypatch, direct=16, block=8)
    x = _inputs()
    n = ATT_SEQ // TP
    for i in range(TP):
        tile = slice(i * n, (i + 1) * n)
        want, grads = _ref_tile(x, prefix, tile)
        got, port_grads = _port_tile(x, prefix, tile, i)
        np.testing.assert_allclose(got, want, err_msg=f"tile {i}", **TOL)
        np.testing.assert_allclose(port_grads[0], grads[0][:, tile],
                                   err_msg=f"dq tile {i}", **GRAD_TOL)
        for j, what in ((1, "dk"), (2, "dv")):
            np.testing.assert_allclose(port_grads[j], grads[j],
                                       err_msg=f"{what} tile {i}",
                                       **GRAD_TOL)
