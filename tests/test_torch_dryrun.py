"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's (``repro.launch.dryrun``): the step's abstract signature, the
registry's input and cache specs and each cell's ``meta`` block for every
arch × cell at full width, the resting bytes a device on the production
layouts, the roofline terms, the CLI with ``reanalyze`` and
``collective_breakdown``, and the reference's own dry-run tests
(``tests/run/test_program.py``) ported.  Both sides are abstract: nothing
is lowered or allocated at full width."""
import functools
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.optimizers import get_opt as ref_get_opt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models.registry import ARCH_IDS, get_arch as ref_get_arch
from repro.run import (ModelSpec as RefModelSpec, OptSpec as RefOptSpec,
                       RunSpec as RefRunSpec, StepSpec as RefStepSpec,
                       build_step_program as ref_build_step_program)
from repro.sentinel import SentinelSpec as RefSentinelSpec
from repro.sharding import rules as ref_rules
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.optimizers import get_opt
from repro_torch.core.tree import (pytree_leaves, tree_flatten_with_path,
                                   tree_leaves)
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import collective_breakdown, dryrun as D, reanalyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import OpTrace
from repro_torch.models.registry import get_arch
from repro_torch.run import (MeshSpec, ModelSpec, OptSpec, RunSpec,
                             StepSpec, build_step_program, run)
from repro_torch.run.data import make_batch_iter
from repro_torch.run.runner import batch_to_device
from repro_torch.sentinel import SentinelSpec
from repro_torch.sharding.rules import MeshAxes
from repro_torch.sharding.zero import rest_places

DANUBE = "h2o-danube-1.8b"
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.bool_): torch.bool}
CELLS = [(a, s) for a in ARCH_IDS
         for s in get_arch(a, smoke=True).supported_cells()]
LAYOUTS = {"16x16": make_production_mesh(),
           "2x16x16": make_production_mesh(multi_pod=True)}


class StandIn:
    """What the reference's MeshAxes reads of a mesh."""

    def __init__(self, layout):
        self.axis_names = layout.axis_names
        self.shape = layout.shape


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch_id):
    arch = ref_get_arch(arch_id)
    return arch, jax.eval_shape(arch.init_params, jax.random.PRNGKey(0))


def _sig(tree) -> list:
    """``[(shape, torch dtype)]`` of a tree's leaves in JAX's order (dicts
    by sorted key): the port's tensors or the reference's abstract
    arrays."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sig(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _sig(t)]
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), tree.dtype)]
    if isinstance(tree, (int, float)):
        return [((), type(tree))]
    return [(tuple(tree.shape), DTYPES[jnp.dtype(tree.dtype)])]


def _specs_sig(specs: dict) -> dict:
    """``{leaf: (shape, torch dtype)}`` of either package's batch specs."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, tuple):
            out[k] = (tuple(v[0]), v[1])
        elif isinstance(v, torch.Tensor):
            out[k] = (tuple(v.shape), v.dtype)
        else:
            out[k] = (tuple(v.shape), DTYPES[jnp.dtype(v.dtype)])
    return out


# ---------------------------------------------------------------------
# abstract_args (the reference's test_program.py:126)
# ---------------------------------------------------------------------

ARGS_CASES = {"padded": {}, "packed": {"packing": True},
              "sentinel": {"sentinel": True}}


def _both_specs(case):
    kw = ARGS_CASES[case]
    out = []
    for mods in ((RefRunSpec, RefModelSpec, RefOptSpec, RefStepSpec,
                  RefDataConfig, RefSentinelSpec),
                 (RunSpec, ModelSpec, OptSpec, StepSpec, DataConfig,
                  SentinelSpec)):
        RS, MS, OS, SS, DC, SE = mods
        extra = {"sentinel": SE(enabled=True)} if kw.get("sentinel") else {}
        out.append(RS(model=MS(arch=DANUBE, smoke=True),
                      data=DC(vocab=0, seq_len=32, global_batch=4,
                              packing=kw.get("packing", False)),
                      opt=OS(name="adalomo", lr=1e-3, schedule="constant"),
                      steps=SS(total=4), log_every=0, **extra))
    return out


@pytest.mark.parametrize("case", sorted(ARGS_CASES))
def test_abstract_args_match_concrete_signature(case):
    """``abstract_args`` has the shapes and dtypes of ``prog.init``, of a
    real batch and of the reference's ``abstract_args`` (jnp dtypes as
    torch's), hparams included, and the sentinel slot with the guard."""
    ref_spec, spec = _both_specs(case)
    prog = build_step_program(spec, device="cpu")
    args = prog.abstract_args()
    assert all(t.device.type == "meta"
               for t in tree_leaves(args[0]) + pytree_leaves(args[1]))
    params, state = prog.init(0)
    assert _sig(args[0]) == _sig(params)
    assert _sig(pytree_leaves(args[1])) == _sig(pytree_leaves(state))
    batch = batch_to_device(next(make_batch_iter(spec, prog.arch)),
                            torch.device("cpu"))
    assert _specs_sig(args[2]) == _specs_sig(
        {k: (tuple(v.shape), v.dtype) for k, v in batch.items()})
    assert sorted(args[3]) == sorted(prog.hparams_fn(1)) and "lr" in args[3]
    ref = ref_build_step_program(ref_spec).abstract_args()
    assert len(ref) == len(args) == (5 if case == "sentinel" else 4)
    assert _sig(args[0]) == _sig(ref[0])
    assert _sig(pytree_leaves(args[1])) == _sig(jax.tree.leaves(ref[1]))
    assert _specs_sig(args[2]) == _specs_sig(ref[2])
    assert _sig(args[3]) == _sig(ref[3])
    if case == "sentinel":
        assert _sig(tuple(args[4])) == _sig(tuple(ref[4]))


# ---------------------------------------------------------------------
# input and cache specs, meta (every arch x cell, full width)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("arch_id,shape_name", CELLS)
def test_input_and_cache_specs_match_reference(arch_id, shape_name):
    ref, _ = _ref_abstract(arch_id)
    arch = get_arch(arch_id)
    assert _specs_sig(arch.input_specs(shape_name)) == _specs_sig(
        ref.input_specs(shape_name))
    if SHAPES[shape_name].kind == "train" and arch.supports_packing():
        assert _specs_sig(arch.input_specs(shape_name, packed=True)) == \
            _specs_sig(ref.input_specs(shape_name, packed=True))
    if SHAPES[shape_name].kind == "decode":
        cache = arch.cache_specs(shape_name)
        assert all(t.device.type == "meta" for t in tree_leaves(cache)
                   if isinstance(t, torch.Tensor))
        assert _sig(cache) == _sig(ref.cache_specs(shape_name))
    else:
        with pytest.raises(ValueError, match="decode cell"):
            arch.cache_specs(shape_name)


@pytest.mark.parametrize("arch_id,shape_name", CELLS)
def test_meta_matches_reference(arch_id, shape_name):
    """``n_params``, ``n_active_params``, ``tokens_per_step`` and ``kind``
    as the reference's dry run reckons them (``jax.eval_shape`` and
    ``cfg.active_param_count()``, no lowering)."""
    ref, abstract = _ref_abstract(arch_id)
    sh = SHAPES[shape_name]
    if sh.kind == "decode":
        tokens = sh.global_batch
    elif sh.kind == "prefill" and ref.family == "encdec":
        tokens = sh.global_batch * ref.cfg.n_frames
    else:
        tokens = sh.global_batch * sh.seq_len
    want = {"kind": sh.kind,
            "n_params": sum(math.prod(x.shape)
                            for x in jax.tree.leaves(abstract)),
            "n_active_params": ref.cfg.active_param_count(),
            "tokens_per_step": tokens}
    got = D.cell_meta(get_arch(arch_id), arch_id, shape_name)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_train_batch_specs_agree_with_input_specs(arch_id):
    """The reference's test_program.py:158: the registry's input_specs and
    the run layer's train batch signature are one function."""
    arch = get_arch(arch_id)
    for shape_name in arch.supported_cells():
        sh = SHAPES[shape_name]
        if sh.kind != "train":
            continue
        assert arch.input_specs(shape_name) == arch.train_batch_specs(
            sh.global_batch, sh.seq_len)


# ---------------------------------------------------------------------
# build_cell's train cell is the step program (test_program.py:172)
# ---------------------------------------------------------------------

def test_build_cell_traces_the_step_program():
    """The train cell traces the function ``build_step_program`` returns,
    on a dry (4, 2) mesh, with ``lr`` in its hparams, and its spec is
    the one ``run(spec)`` trains on that mesh."""
    cell = D.build_cell(DANUBE, "train_4k", (4, 2), smoke=True)
    prog, spec = cell["program"], cell["spec"]
    assert cell["meta"]["kind"] == "train"
    assert prog.step.__qualname__.startswith("build_step_program")
    assert prog.zero is not None and prog.zero.mesh.backend == "dry"
    assert spec.mesh.shape == (4, 2) and spec.steps.fused
    assert "lr" in prog.hparams_fn(1)
    tr = cell["trace"]
    assert tr.launches["adalomo_stats_partial"] > 0 and tr.stats["calls"] > 0
    assert RunSpec.from_dict(cell["meta"]["run_spec"]) == spec


@pytest.mark.parametrize("arch_id,shape_name", [(DANUBE, "train_4k"),
                                                ("whisper-base",
                                                 "decode_32k")])
def test_dry_cell_allocates_nothing_off_the_meta_device(arch_id,
                                                        shape_name):
    """A traced cell (smoke widths at the cell's shapes, on (2, 2)) makes
    no tensor storage on the CPU: everything it holds is on the meta
    device."""
    cpu = OpTrace("cpu")
    with cpu:
        cell = D.build_cell(arch_id, shape_name, (2, 2), smoke=True)
    assert cpu.peak == 0 and cell["trace"].n_ops > 0


def test_run_optimized_false_on_one_position_mesh_matches_reference():
    """``run(spec)`` with ``MeshSpec(shape=(1,), optimized=False)`` trains
    the baseline plan on a world of one process, as the reference's
    ``run()`` trains that spec (its live path reads no such flag): losses
    and params at the reference's sharded tolerance.  The same spec's dry
    trace on (2,) is the baseline plan's."""
    import torch.distributed as dist

    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.run import MeshSpec as RefMeshSpec
    from repro.run.runner import run as ref_run
    from torch_parity import (assert_trees_close, ref_params_and_copy,
                              smoke_archs)
    kw = dict(steps=StepSpec(total=2), log_every=0)
    spec = RunSpec(model=ModelSpec(DANUBE, smoke=True),
                   data=DataConfig(vocab=0, seq_len=16, global_batch=4),
                   mesh=MeshSpec(kind="single", shape=(1,),
                                 optimized=False), **kw)
    ref_spec = RefRunSpec(model=RefModelSpec(DANUBE, smoke=True),
                          data=RefDataConfig(vocab=0, seq_len=16,
                                             global_batch=4),
                          mesh=RefMeshSpec(kind="single", shape=(1,),
                                           optimized=False),
                          steps=RefStepSpec(total=2), log_every=0)
    ref_params, params = ref_params_and_copy(smoke_archs(DANUBE)[0])
    ref = ref_run(ref_spec, params=ref_params, log_fn=lambda s: None)
    owned = not dist.is_initialized()
    try:
        got = run(spec, params=params, device="cpu", log_fn=lambda s: None)
        assert got.program.zero is not None
        assert not got.program.zero.optimized
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    np.testing.assert_allclose(got.history["loss"], ref.history["loss"],
                               rtol=1e-5, atol=1e-5)
    assert_trees_close(got.params, ref.params, rtol=5e-4, atol=1e-5)
    tr = D.trace_train(spec, mesh=(2,))
    assert not tr.program.zero.optimized and tr.program.zero.tile is None


# ---------------------------------------------------------------------
# resting bytes a device against the reference's pspecs
# ---------------------------------------------------------------------

# vectors the rules split over model that the port rests whole over model
# (zero.rest_places: the optimizer rules' sharded forms take matrices)
VECTORS_WHOLE = {"mamba2-1.3b": ["stacks/blocks/conv_b"],
                 "zamba2-1.2b": ["stacks/blocks/mamba/conv_b"]}


def _parts(spec, shape) -> int:
    n = 1
    for ax in spec:
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            n *= shape[a]
    return n


def _state_share(shape, pl, name, sizes) -> int:
    """How many parts the port cuts a param's state tensor into: r with
    the param's row-side splits (all but the last dim), c with its
    column-side ones (all but the second last), v and the rest as the
    param."""
    n = len(shape)
    skip = {"r": n - 1, "c": n - 2}.get(name)
    parts = 1
    for d, size in ((pl.data, sizes.get("data", 1)),
                    (pl.model, sizes.get("model", 1))):
        if d is not None and d != skip:
            parts *= size
    return parts


def _reference_resting(arch_id, layout) -> int:
    """A rank's resting bytes on ``layout`` reckoned from the reference's
    ``param_pspecs`` (module helpers above; the test below says how)."""
    lay = LAYOUTS[layout]
    ref, abstract = _ref_abstract(arch_id)
    axes = ref_rules.MeshAxes(StandIn(lay))
    specs = ref_rules.param_pspecs(abstract, axes)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    ref_params = 0
    whole, reckoned = [], 0
    for (path, x), sp in zip(flat, jax.tree.leaves(specs, is_leaf=is_p)):
        full = math.prod(x.shape) * x.dtype.itemsize
        name = "/".join(p.key for p in path)
        ref_params += full // _parts(sp, lay.shape)
        lead = int(name.startswith("stacks/"))
        if "model" in sp and len(x.shape) - lead < 2:
            whole.append(name)
            reckoned += (full // _parts([a for a in sp if a != "model"],
                                        lay.shape)
                         - full // _parts(sp, lay.shape))
    assert whole == VECTORS_WHOLE.get(arch_id, [])

    arch = get_arch(arch_id)
    meta = arch.init_params(0, device="meta")
    state = get_opt("adalomo").init(meta)
    places = rest_places(meta, MeshAxes(lay))
    state_bytes = state.step.numel() * state.step.element_size()
    for (key, pl), (_, t) in zip(tree_flatten_with_path(places),
                                 tree_flatten_with_path(meta)):
        st = _leaf(state.moments, key)
        for name, s in zip(st._fields, st):
            if s is not None:
                state_bytes += (s.numel() * s.element_size()
                                // _state_share(tuple(t.shape), pl, name,
                                                lay.shape))
    return ref_params + reckoned + state_bytes


def _dry_resting(arch_id, layout, *, optimized=True) -> int:
    lay = LAYOUTS[layout]
    arch = get_arch(arch_id)
    spec = D.train_spec(arch, arch_id, "train_4k", lay.dims,
                        optimized=optimized)
    return D.trace_train(spec, arch=arch, mesh=lay.dims,
                         steps=0).resting_bytes


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_resting_bytes_match_reference_pspecs(arch_id, layout):
    """A rank's resting bytes (params and AdaLomo state, traced on the
    meta device) are the reference's params under ``param_pspecs``, but
    for the named vectors rested whole over model, plus the state as the
    port rests it: each state tensor with its own param (r its rows, c its
    columns), where the reference's ``opt_pspecs`` matches state to params
    by shape alone and leaves most of it replicated."""
    assert _dry_resting(arch_id, layout) == _reference_resting(arch_id,
                                                               layout)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_baseline_resting_bytes_equal_optimized_and_reference(arch_id,
                                                              layout):
    """The baseline plan (``--baseline``) rests params and state where the
    optimized plan does, as the reference keeps ``p_shard``/``o_shard``
    in both modes: its dry cell's resting bytes equal the optimized
    cell's and the reckoning from the reference's ``param_pspecs``."""
    got = _dry_resting(arch_id, layout, optimized=False)
    assert got == _dry_resting(arch_id, layout) == _reference_resting(
        arch_id, layout)


def _leaf(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------
# roofline, the CLI, reanalyze, collective_breakdown
# ---------------------------------------------------------------------

def _ref_dryrun_module():
    """``repro.launch.dryrun``, imported with this process's jax backend up
    already (the module sets XLA_FLAGS for a 512-device host platform when
    it is imported) and the environment left as it was."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref_dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref_dryrun


@pytest.fixture(scope="module")
def smoke_cell(tmp_path_factory):
    """``main`` on danube's smoke config, one train cell on (2, 2)."""
    d = tmp_path_factory.mktemp("dryrun")
    D.main(["--arch", DANUBE, "--shape", "train_4k", "--mesh", "2x2",
            "--smoke", "--artifact-dir", str(d)])
    path = d / f"{DANUBE}__train_4k__2x2__smoke.json"
    return path, json.loads(path.read_text())


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_roofline_terms_equal_reference(kind, smoke_cell, monkeypatch):
    ref_dryrun = _ref_dryrun_module()
    res = dict(smoke_cell[1], kind=kind)
    for name, ref_name in (("PEAK_FLOPS", "PEAK_FLOPS"),
                           ("HBM_BW", "HBM_BW"), ("LINK_BW", "ICI_BW")):
        monkeypatch.setattr(D, name, getattr(ref_dryrun, ref_name))
    assert D.roofline_terms(res) == ref_dryrun.roofline_terms(res)


def test_main_reanalyze_and_breakdown(smoke_cell, tmp_path):
    path, res = smoke_cell
    assert res["kind"] == "train" and res["n_chips"] == 4
    assert res["kernel_launches"]["adalomo_stats_partial"] > 0
    assert res["collectives"]["total_wire_bytes"] > 0
    assert res["memory"]["peak_bytes"] >= res["memory"]["resting_bytes"] > 0
    for suffix in (".runspec.json", ".ops.json.gz", ".coll.json.gz"):
        assert path.with_suffix(suffix).exists()
    # reanalyze reproduces the cost keys bitwise from the saved traces
    copy = tmp_path / path.name
    for suffix in (".json", ".ops.json.gz", ".coll.json.gz"):
        copy.with_suffix(suffix).write_bytes(
            path.with_suffix(suffix).read_bytes())
    assert reanalyze.reanalyze(copy) == res
    assert copy.read_text() == path.read_text()
    # the breakdown's rows add up to the cell's wire bytes
    log = collective_breakdown.load(str(path.with_suffix(".coll.json.gz")))
    rows = collective_breakdown.breakdown(log, top=len(log))
    assert sum(r[0] for r in rows) == res["collectives"]["total_wire_bytes"]
    assert sum(r[1] for r in rows) == sum(
        res["collectives"]["counts"].values())


def test_main_baseline_traces_the_baseline_plan(smoke_cell, tmp_path,
                                                monkeypatch, capsys):
    """``main --baseline``: the same cell under the baseline plan, written
    to the baseline directory (``BASELINE_DIR`` by default): its spec
    carries ``optimized=False``, its resting bytes and K1/K2 launches are
    the optimized cell's, and it reduce-scatters nothing; the script's
    table sets the two cells side by side."""
    monkeypatch.setattr(D, "BASELINE_DIR", tmp_path / "baseline")
    D.main(["--arch", DANUBE, "--shape", "train_4k", "--mesh", "2x2",
            "--smoke", "--baseline"])
    path = tmp_path / "baseline" / f"{DANUBE}__train_4k__2x2__smoke.json"
    base, opt = json.loads(path.read_text()), smoke_cell[1]
    assert not base["run_spec"]["mesh"]["optimized"]
    assert opt["run_spec"]["mesh"]["optimized"]
    assert base["memory"]["resting_bytes"] == opt["memory"]["resting_bytes"]
    assert base["kernel_launches"] == opt["kernel_launches"]
    assert base["collective_stats"]["scatter_bytes"] == 0 < \
        opt["collective_stats"]["scatter_bytes"]
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_dryrun_table", os.path.join(os.path.dirname(__file__),
                                           os.pardir, "scripts",
                                           "torch_dryrun_table.py"))
    table = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(table)
    capsys.readouterr()
    table.main(["--dir", str(smoke_cell[0].parent), "--against",
                str(path.parent), "--mesh", "2x2__smoke"])
    row = [r for r in capsys.readouterr().out.splitlines()
           if r.startswith(f"| {DANUBE} |")]
    assert len(row) == 1 and row[0].count(" / ") == 6
