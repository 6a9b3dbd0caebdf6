"""The encoder-decoder family (whisper-base) on a model axis, over ``gloo``
worlds on the host, held against the JAX package's single-device run of
the same spec from the same weights.

Each rank holds a tile of the frames and a tile of the tokens, each
sequence tiled along its own length (``Zero3.rows``): at whisper's smoke
config (24 frames) and 16 tokens, tiles of 12 frames and 8 tokens on
(1, 2) and (2, 2), of 6 and 4 on (1, 4).  Both stacks run on their tiles at
the tiles' absolute positions, their self-attention against K/V gathered
over ``model``; the encoder's output is gathered whole once a step for the
decoder's cross-attention, and its gradient, each rank's tokens' share, is
summed over ``model`` and cut to the frame tile before the encoder's
sweep.  Fused AdaLomo on (1, 2), (2, 2) and (1, 4), fused LOMO and unfused
AdamW on (1, 2), with evaluation (``loss_fn(zero=)``) on (1, 2); fused
AdaLomo on (1, 5) at 20 tokens, where 5 does not divide the 24 frames:
every rank holds them whole and runs the encoder whole; and fused
AdaLomo in bf16 on (1, 2), held as ``test_torch_model_axis_families.py``
holds zamba2: the elements beyond the sharded tolerance plus one bf16 ulp,
each package's sharded run against its own unsharded run, the port's no
more than the reference's GSPMD run's.

One world of two ranks, one of four and one of five
(``_torch_elastic_worker.start_world``) run every case; the reference's
bf16 runs are made in a subprocess and its fp32 runs in this process
meanwhile.  Tolerances are the reference's own for its sharded run
(``tests/distribution/_dist_script.py``): loss rtol 1e-5, atol 1e-5;
params rtol 5e-4, atol 1e-5, with AdamW's near-zero-gradient elements
counted apart (``torch_parity.params_close``).

``Zero3.rows`` at whisper-base's full size (1500 frames, 448 tokens) is
held on the meta device with no world (``torch_parity.plan_mesh``): the
frames tiled apart from the tokens on (1, 2) and (1, 4), a ``ValueError``
naming the tokens a model axis of 3 does not divide, and the frames kept
whole on every rank of a model axis of 8, which does not divide them."""
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
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.registry import get_arch
from repro_torch.run import run
from repro_torch.sharding.zero import Zero3
from torch_parity import (bf16_outside, params_close, plan_mesh,
                          ref_params_and_copy, smoke_archs)
from _torch_elastic_worker import dtype_arch, make_spec, start_world

WHISPER = "whisper-base"
STEPS = 3
SEQ = 16
EVAL_EVERY = 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
# case -> (mesh, optimizer, evaluation)
CASES = {
    "adalomo_1x2": ((1, 2), "adalomo", True),
    "adalomo_2x2": ((2, 2), "adalomo", False),
    "adalomo_1x4": ((1, 4), "adalomo", False),
    "lomo_1x2": ((1, 2), "lomo", False),
    "adamw_1x2": ((1, 2), "adamw", False),
    "adalomo_1x5": ((1, 5), "adalomo", False),
}
# the tokens of a case, where not SEQ: 5 divides 20 tokens, not 24 frames
CASE_SEQ = {"adalomo_1x5": 20}
# The most elements of whisper's smoke params (bf16, 3 steps on (1, 2))
# either package may leave beyond the sharded tolerance plus one ulp, of
# 175 488: twice the reference's count on the CPU (79).
BF16_BOUND = 160
HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, os.pardir, "src")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results and the reference's single-device runs."""
    d = tmp_path_factory.mktemp("model_axis_encdec")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, HERE, os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    bf16_ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_bf16_reference.py"),
         str(d), WHISPER, "1x2", str(STEPS), str(SEQ)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ref_arch, _ = smoke_archs(WHISPER)
    ref_params, port_params = ref_params_and_copy(ref_arch)
    torch.save(port_params, str(d / "init.pt"))
    _, port16 = ref_params_and_copy(dataclasses.replace(
        ref_arch, cfg=dataclasses.replace(ref_arch.cfg, dtype=jnp.bfloat16)))
    torch.save(port16, str(d / "init_bf16.pt"))
    worlds = {}
    for name, (shape, opt, evaluate) in CASES.items():
        worlds.setdefault(math.prod(shape), []).append(dict(
            kind="run", arch=WHISPER, shape=list(shape), total=STEPS,
            seq=CASE_SEQ.get(name, SEQ), opt=opt, ckpt=str(d / name),
            init=str(d / "init.pt"),
            eval_every=EVAL_EVERY if evaluate else 0,
            out=str(d / f"{name}.json")))
    worlds[2].append(dict(
        kind="run", arch=WHISPER, shape=[1, 2], total=STEPS, seq=SEQ,
        ckpt=str(d / "bf16"), init=str(d / "init_bf16.pt"),
        dtype="bfloat16", out=str(d / "bf16.json")))
    waits = [start_world(w, str(d / f"store{w}"), cases)
             for w, cases in sorted(worlds.items())]
    ref = {}
    for opt, evaluate, seq in sorted({(o, e, CASE_SEQ.get(n, SEQ))
                                      for n, (_, o, e) in CASES.items()}):
        ref[opt, evaluate, seq] = ref_run(
            make_spec(WHISPER, spec_mod=ref_spec_mod, data_cls=RefDataConfig,
                      total=STEPS, seq_len=seq, opt=opt,
                      eval_every=EVAL_EVERY if evaluate else 0),
            arch=ref_arch,
            params=jax.tree.map(lambda x: x.copy(), ref_params),
            log_fn=lambda s: None)
    single16 = run(make_spec(WHISPER, total=STEPS, seq_len=SEQ),
                   arch=dtype_arch(WHISPER, torch.bfloat16),
                   params=tree_map(torch.clone, port16), device="cpu",
                   log_fn=lambda s: None).params
    for wait in waits:
        wait()
    _, tree, _ = CheckpointManager(d / "bf16").restore(
        STEPS, template=(port16, get_opt("adalomo").init(port16)))
    f32 = [[t.to(torch.float32).numpy() for t in tree_leaves(x)]
           for x in (tree[0], single16)]
    _, stderr = bf16_ref.communicate(timeout=300)
    assert bf16_ref.returncode == 0, stderr[-3000:]
    bf16 = json.loads((d / "ref.json").read_text())
    bf16["port"] = bf16_outside(*f32)
    bf16["n_port"] = sum(a.size for a in f32[0])
    return {"dir": d, "ref": ref, "init": port_params, "bf16": bf16}


@pytest.mark.parametrize("name", list(CASES))
def test_whisper_on_a_model_axis_matches_reference(runs, name):
    """Losses, evaluation losses and final params against the reference's
    single-device run: both stacks on their tiles at absolute positions,
    the cross-attention over every frame, the encoder's gradient summed
    over the tiles, the parameter gradients summed over the ranks."""
    shape, opt, evaluate = CASES[name]
    ref = runs["ref"][opt, evaluate, CASE_SEQ.get(name, SEQ)]
    h = json.loads((runs["dir"] / f"{name}.json").read_text())
    assert h["step"] == list(range(STEPS))
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    if evaluate:
        assert len(h["eval_loss"]) == len(ref.history["eval_loss"]) == 1
        np.testing.assert_allclose(h["eval_loss"], ref.history["eval_loss"],
                                   **LOSS_TOL)
    port = runs["init"]
    _, tree, _ = CheckpointManager(runs["dir"] / name).restore(
        STEPS, template=(port, get_opt(opt).init(port)))
    params_close(tree[0], ref.params, name, opt=opt, **PARAM_TOL)
    gathers = {(a, k): n for a, k, n in h["gathers"]}
    # 5 divides no dim of the smoke config: every leaf rests whole there
    assert (gathers.get(("model", "dense"), 0) > 0) == (shape[1] != 5)


def test_whisper_bf16_on_1x2_within_the_reference_band(runs):
    """whisper's smoke config in bf16 on (1, 2), 3 fused AdaLomo steps:
    the port's elements beyond rtol 5e-4 / atol 1e-5 plus one bf16 ulp of
    its own unsharded run are no more than the reference's GSPMD run
    leaves against its unsharded run, and both within
    :data:`BF16_BOUND`."""
    got = runs["bf16"]
    print("whisper bf16 (1, 2) elements outside tolerance", got)
    assert got["n_port"] == got["elements"]
    ref = got["outside"][str(STEPS)]
    assert ref <= BF16_BOUND and got["port"] <= BF16_BOUND, got
    assert got["port"] <= ref, got


# --------------------------------------------------------------------------
# Zero3.rows at whisper-base's full size, on the meta device, no world
# --------------------------------------------------------------------------

B, FRAMES, TOKENS, D = 4, 1500, 448, 512


@pytest.fixture(scope="module")
def meta_params():
    return get_arch(WHISPER).init_params(0, device="meta")


def _global_batch():
    meta = torch.device("meta")
    return {"tokens": torch.empty((B, TOKENS), dtype=torch.int32,
                                  device=meta),
            "labels": torch.empty((B, TOKENS), dtype=torch.int32,
                                  device=meta),
            "frames": torch.empty((B, FRAMES, D), device=meta)}


@pytest.mark.parametrize("tp", [2, 4])
def test_rows_tile_the_frames_apart_from_the_tokens(meta_params, tp):
    """On (1, tp) rank ``i`` holds frames ``[iF/tp, (i+1)F/tp)`` (the
    view's offset into the batch says which) and tokens and labels
    ``[iS/tp, (i+1)S/tp)``; ``tile`` is the token tile and
    ``frame_tile`` the frame tile."""
    batch = _global_batch()
    nf, nt = FRAMES // tp, TOKENS // tp
    for i in range(tp):
        zero = Zero3(plan_mesh((1, tp), i), meta_params)
        cut = zero.rows(batch)
        assert tuple(cut["frames"].shape) == (B, nf, D)
        assert cut["frames"].storage_offset() == i * nf * D
        for k in ("tokens", "labels"):
            assert tuple(cut[k].shape) == (B, nt)
            assert cut[k].storage_offset() == i * nt
        assert zero.tile == (B, nt) and zero.frame_tile == (B, nf)


@pytest.mark.parametrize("tp,leaf", [(3, "tokens"), (8, "frames")])
def test_rows_name_the_sequence_a_model_axis_does_not_divide(meta_params,
                                                             tp, leaf):
    """A model axis of 3 divides the 1500 frames but not the 448 tokens:
    ``rows`` raises, naming the leaf, on every rank.  One of 8 divides the
    tokens but not the frames: every rank keeps the frames whole (its
    encoder runs whole) and tiles the tokens."""
    for i in range(tp):
        zero = Zero3(plan_mesh((1, tp), i), meta_params)
        if leaf == "tokens":
            with pytest.raises(ValueError, match=f"a batch's {leaf} "):
                zero.rows(_global_batch())
            continue
        cut = zero.rows(_global_batch())
        assert tuple(cut["frames"].shape) == (B, FRAMES, D)
        assert zero.frame_tile == (B, FRAMES)
        assert zero.tile == (B, TOKENS // tp)
