"""deepseek-v3-671b on a model axis: MLA on sequence tiles (the per-token
latent gathered over ``model``), the MTP head on the tiles, and routed
experts expert-parallel where the axis divides them and run whole on every
model rank where it does not — fused AdaLomo over ``gloo`` worlds on the
host, held against the JAX package's single-device run of the same spec
from the same weights.

Three worlds are spawned (``_torch_elastic_worker.run_world``): two ranks
on (1, 2), where the 8 routed experts split 4 a rank, three on (1, 3),
where every rank runs all 8, and four on (2, 2), where MLA's down
projections rest as 2-D blocks.  The reference runs in this process.
Tolerances are the reference's own for its sharded run
(``tests/distribution/_dist_script.py``): loss rtol 1e-5, atol 1e-5;
params rtol 5e-4, atol 1e-5."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.run import spec as ref_spec_mod
from repro.run.runner import run as ref_run
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import tree_flatten_with_path, tree_map
from repro_torch.launch.mesh import MeshLayout
from repro_torch.models.registry import get_arch
from repro_torch.run import run
from repro_torch.run.hooks import Hook
from repro_torch.sharding.rules import MeshAxes
from repro_torch.sharding.zero import param_places
from torch_parity import assert_trees_close, ref_params_and_copy, smoke_archs
from _torch_elastic_worker import aux_arch, make_spec, run_world

MLA = "deepseek-v3-671b"
SEQ = 12              # a tile of 6 on (1, 2), of 4 on (1, 3)
STEPS = 3
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
# a load-balance weight 1000x the config's: the experts' gradient taken
# from one model rank's tile, or the aux loss's counted once a model rank,
# moves the run far outside the tolerance
AUX_HEAVY = 1.0


def _ref_arch(aux_weight=None):
    ref, _ = smoke_archs(MLA)
    if aux_weight is None:
        return ref
    moe = dataclasses.replace(ref.cfg.moe, router_aux_weight=aux_weight)
    return dataclasses.replace(ref, cfg=dataclasses.replace(ref.cfg,
                                                            moe=moe))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device runs and both worlds' results."""
    d = tmp_path_factory.mktemp("model_axis_mla")
    out = {"dir": d, "ref": {}, "init": {}}
    for name, weight in (("mla", None), ("heavy", AUX_HEAVY)):
        ref_params, port_params = ref_params_and_copy(_ref_arch(weight))
        init = str(d / f"init_{name}.pt")
        torch.save(port_params, init)
        out["init"][name] = (init, port_params)
        out["ref"][name] = ref_run(
            make_spec(MLA, spec_mod=ref_spec_mod, data_cls=RefDataConfig,
                      total=STEPS, seq_len=SEQ),
            arch=_ref_arch(weight), params=ref_params, log_fn=lambda s: None)
    init = out["init"]
    run_world(2, str(d / "store2"), [
        dict(kind="run", arch=MLA, shape=[1, 2], total=STEPS, seq=SEQ,
             ckpt=str(d / "E2"), init=init["mla"][0], out=str(d / "E2.json")),
        dict(kind="mtp_positions", arch=MLA, shape=[1, 2], seq=SEQ,
             out=str(d / "pos"))])
    run_world(3, str(d / "store3"), [
        dict(kind="run", arch=MLA, shape=[1, 3], total=STEPS, seq=SEQ,
             ckpt=str(d / "W3"), init=init["mla"][0], out=str(d / "W3.json")),
        dict(kind="run", arch=MLA, shape=[1, 3], total=STEPS, seq=SEQ,
             ckpt=str(d / "H3"), aux_weight=AUX_HEAVY, init=init["heavy"][0],
             out=str(d / "H3.json"))])
    run_world(4, str(d / "store4"), [
        dict(kind="run", arch=MLA, shape=[2, 2], total=STEPS, seq=SEQ,
             ckpt=str(d / "B4"), init=init["mla"][0],
             out=str(d / "B4.json"))])
    return out


def _single(runs, name):
    """The port's own single-device run: its ``aux_loss`` and
    ``mtp_loss``, metrics the reference does not report."""
    got = {"aux": [], "mtp": []}

    class Metrics(Hook):
        def on_step_end(self, ctx, ev):
            got["aux"].append(ev.metrics["aux_loss"])
            got["mtp"].append(ev.metrics["mtp_loss"])

    run(make_spec(MLA, total=STEPS, seq_len=SEQ),
        arch=aux_arch(MLA, AUX_HEAVY) if name == "heavy" else None,
        params=tree_map(torch.clone, runs["init"][name][1]),
        hooks=[Metrics()], device="cpu", log_fn=lambda s: None)
    return got


@pytest.mark.parametrize("case,name,shape", [
    ("E2", "mla", (1, 2)), ("W3", "mla", (1, 3)), ("H3", "heavy", (1, 3)),
    ("B4", "mla", (2, 2))])
def test_mla_mtp_moe_on_a_model_axis_match_reference(runs, case, name,
                                                     shape):
    """Losses and final params against the reference's single-device run;
    ``mtp_loss`` and ``aux_loss`` against the port's own at the loss
    tolerance.  (1, 2) runs the experts expert-parallel, (1, 3) runs all
    eight on every rank; ``H3`` weighs the load-balance loss 1000x; on
    (2, 2) ``w_dq`` and ``mtp_proj`` rest as 2-D blocks (K1's mode 3),
    ``w_uq`` split by rows and ``w_uk``/``w_uv`` by columns over
    ``model``, the batch's rows over ``data``."""
    ref = runs["ref"][name]
    h = json.loads((runs["dir"] / f"{case}.json").read_text())
    assert h["step"] == list(range(STEPS))
    np.testing.assert_allclose(h["loss"], ref.history["loss"], **LOSS_TOL)
    port = runs["init"][name][1]
    _, tree, _ = CheckpointManager(runs["dir"] / case).restore(
        STEPS, template=(port, get_opt("adalomo").init(port)))
    assert_trees_close(tree[0], ref.params, what=str(shape), **PARAM_TOL)
    single = _single(runs, name)
    assert all(m > 0 for m in h["mtp"]) and all(a > 0 for a in h["aux"])
    np.testing.assert_allclose(h["mtp"], single["mtp"], **LOSS_TOL)
    np.testing.assert_allclose(h["aux"], single["aux"], **LOSS_TOL)
    gathers = {(a, k): n for a, k, n in h["gathers"]}
    assert gathers.get(("model", "expert"), 0) == 0


def test_mtp_head_sees_the_tile_positions(runs):
    """On (1, 2) the MTP head's block on tile k is given positions
    k S/2 .. (k+1) S/2 - 1 for its queries and 0 .. S-1 for its keys (the
    whole sequence's latent)."""
    n = SEQ // 2
    for rank in range(2):
        got = json.loads((runs["dir"] / f"pos.rank{rank}.json").read_text())
        assert got["tile"] == [8, n]
        assert got["seen"]
        for ctx in got["seen"]:
            assert ctx["pos"] == list(range(rank * n, (rank + 1) * n))
            assert ctx["kv_pos"] == list(range(SEQ))


def test_rank_blocks_own_their_memory(runs):
    """On (1, 2) every resting block after ``program.init`` is a tensor of
    its own, no view keeping the whole leaf alive, the embedding's rows
    (a slice along the leading dim, contiguous in the whole) included."""
    for rank in range(2):
        got = json.loads((runs["dir"] / f"pos.rank{rank}.json").read_text())
        assert got["owned"] and all(got["owned"])


@pytest.mark.parametrize("arch_id,dims,split", [
    (MLA, (1, 2), True), (MLA, (1, 3), False), (MLA, (2, 3), False),
    ("deepseek-moe-16b", (1, 3), False), ("deepseek-moe-16b", (2, 2), True)])
def test_expert_stacks_rest_whole_where_the_axis_does_not_divide(
        arch_id, dims, split):
    """At full width: where ``model`` divides the routed experts, each
    expert stack rests split on its expert dim and keeps that split at use
    (expert parallelism); where it does not, the rules' shape guard leaves
    the expert dim whole, so the stack is a dense leaf (split over
    ``data`` only), gathered whole and its gradient summed over ``model``.
    No other dim of a stack goes to ``model``."""
    meta = get_arch(arch_id).init_params(0, device="meta")
    places = param_places(meta, MeshAxes(MeshLayout(dims, ("data",
                                                           "model"))))
    stacks = {"/".join(kp): pl for kp, pl in tree_flatten_with_path(places)
              if "/moe/w_" in "/".join(kp) and "shared" not in "/".join(kp)}
    assert sorted(k.rsplit("/", 1)[1] for k in stacks) == [
        "w_down", "w_gate", "w_up"]
    for path, pl in stacks.items():
        assert pl.model == (1 if split else None), path
        assert pl.ep == split, path
        # [L, E, d, f] or [L, E, f, d]: the data split on d
        assert pl.data == (3 if path.endswith("w_down") else 2), path
