"""The dry run: every (arch × shape × mesh) cell's per-rank memory, FLOPs,
HBM bytes and collective bytes, from a trace of the step the card would
run.  Counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell on ``ShapeDtypeStruct``s over
512 host devices.  The port runs the real step of one rank on the meta
device instead: no storage is allocated and no card is touched.  A mesh
layout becomes a dry mesh (``launch/mesh.py::make_dry_mesh``): this
process plays rank ``r`` of 16 × 16 or 2 × 16 × 16, and its process groups
only record (``sharding/collectives.py::DryGroup``).
``launch/op_analysis.py`` counts every dispatched op under the reference's
cost model and follows the bytes alive, the kernel wrappers record the
launches the card would make (``kernels/dry.py``), and the collectives log
every call with its bytes.

  * a **train** cell builds the reference's ``RunSpec`` (fused AdaLomo,
    constant schedule, one step) with the mesh's shape, and the program
    ``run(spec)`` trains: ``build_step_program`` and, on a mesh, the
    ZeRO-3 plan of ``fleet.elastic.sharded_program``;
  * a **prefill** or **decode** cell on a mesh traces rank ``r``'s
    serving step (``serve/sharded.py``, the reference's GSPMD partition of
    ``make_prefill_step`` / ``make_decode_step``), every family's: its
    param blocks and its block of the cache (decode) at their places —
    a ring's slots, mamba's SSM heads and whisper's cross frames over
    ``model`` where the axis divides them — a prefill on the global batch
    (its rows and sequence tile; whisper's frames alone, tiled where the
    axis divides them), a decode step of one token a row; ``n_chips`` is
    the mesh's size, so the costs are a device's.  The cell keeps each
    device's param and cache bytes under ``sharding/zero.py::rest_pspecs``
    and ``rules.cache_pspecs``, reckoned, as a cross-check of the traced
    resting bytes.  ``rest_pspecs`` is the rule ``Zero3`` rests params by:
    the reference's ``param_pspecs`` with every vector whole over
    ``model``, where the reference splits mamba's conv bias (on 16 × 16
    and 2 × 16 × 16, 391,680 more bytes a device for mamba2-1.3b and
    300,960 for zamba2-1.2b; nothing for the other configs);
  * ``--mesh one`` traces any cell on one device, with no mesh (a serving
    cell's one-device step, to set beside a rank's).

``--baseline`` (``optimized=False``) traces the train cells under the
paper-faithful baseline plan, as the reference's ``--baseline`` lowers
them with no activation policy and no gradient constraint: the spec's
``MeshSpec(optimized=False)``, whose sharded program
(``Zero3(optimized=False)``) runs every rank's rows' whole sequence and
all-reduces whole gradients, with params and state resting as in the
optimized plan; and the serving cells on a mesh under the same plan (no
sequence tile in the prefill, expert stacks gathered whole).  Baseline
artifacts go to ``runs/dryrun_torch_baseline/``.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      h2o-danube-1.8b --shape train_4k --mesh 2x2 --rank 3
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      h2o-danube-1.8b --shape train_4k --mesh single --baseline

Artifacts: ``runs/dryrun_torch/{arch}__{shape}__{mesh}.json`` (with
``.runspec.json`` for train cells, the aggregated op trace
``.ops.json.gz`` and the collectives' log ``.coll.json.gz``); an existing
artifact is kept unless ``--force``.  The reference's
``cost_analysis_xla``, ``collectives_loop_blind`` and ``.hlo.gz`` are XLA's
own and have no counterpart here.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch"
BASELINE_DIR = ARTIFACT_DIR.parent / "dryrun_torch_baseline"

# NVIDIA H100 80GB HBM3, 700 W (nvidia-smi's name and power limit on the
# card these cells are for): spec-sheet figures, per card, for the
# roofline terms, not calibrated on it.
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # B/s
LINK_BW = 450e9            # NVLink B/s per direction

MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16), "one": None}
KERNELS = ("adalomo_stats", "adalomo_update", "adalomo_stats_partial",
           "adalomo_stats_fold", "adalomo_update_partials",
           "adalomo_update_apply", "paged_decode_attention",
           "decode_attention", "decode_attention_partial")


def mesh_shape(kind: str) -> tuple:
    """``single`` (16 × 16), ``multi`` (2 × 16 × 16), ``one`` (None: one
    device, no mesh) or any ``AxB[xC]``."""
    if kind in MESH_SHAPES:
        return MESH_SHAPES[kind]
    try:
        shape = tuple(int(n) for n in kind.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh {kind!r}: expected single, multi or "
                         f"AxB[xC]") from None
    if not 1 <= len(shape) <= 3 or min(shape) < 1:
        raise ValueError(f"mesh {kind!r}: 1-3 positive sizes")
    return shape


def _wrappers() -> dict:
    from repro_torch.kernels.adalomo_update import adalomo_update as K12
    from repro_torch.kernels.decode_attention import decode_attention as K34
    return {name: getattr(K12, name, None) or getattr(K34, name)
            for name in KERNELS}


def _counts() -> tuple:
    """The collectives' STATS and each kernel wrapper's launch count
    (``mode3``: K1's mode-3 launches), as they stand."""
    from repro_torch.sharding import collectives as C
    fns = _wrappers()
    launches = {n: f.launches for n, f in fns.items()}
    launches["mode3"] = fns["adalomo_stats_partial"].both_launches
    return dict(C.STATS), launches


def _since(before: tuple) -> tuple:
    """What was added to :func:`_counts` since ``before`` (the launches
    that were made only)."""
    stats, launches = _counts()
    return ({k: v - before[0][k] for k, v in stats.items()},
            {k: v - before[1][k] for k, v in launches.items()
             if v != before[1][k]})


@contextlib.contextmanager
def _counters_kept():
    """The collectives' STATS and the kernel wrappers' counts as they were
    before the block, whatever the block adds (a dry trace's launches are
    no launches on the card)."""
    from repro_torch.sharding import collectives as C
    before = _counts()
    try:
        yield
    finally:
        C.STATS.update(before[0])
        fns = _wrappers()
        for n, f in fns.items():
            f.launches = before[1][n]
        fns["adalomo_stats_partial"].both_launches = before[1]["mode3"]


@dataclasses.dataclass
class Trace:
    """What one traced call did on one rank: the op rows
    (``OpTrace.records``), the kernel launches' records, the collectives'
    log, ``stats`` (what it added to ``collectives.STATS``),
    ``launches`` (the launches it made, by wrapper, and ``mode3``: K1's
    mode-3 launches), the bytes alive before it (``argument_bytes``), their
    ``resting_bytes`` part (params and optimizer state), its
    ``peak_bytes``, and for a train step its ``program`` and each step's
    counts (``per_step``)."""

    records: list
    launch_records: list
    log: list
    stats: dict
    launches: dict
    argument_bytes: int = 0
    resting_bytes: int = 0
    peak_bytes: int = 0
    init_peak_bytes: int = 0
    n_ops: int = 0
    seconds: float = 0.0
    per_step: list = dataclasses.field(default_factory=list)
    program: object = None

    def cost(self) -> dict:
        from repro_torch.launch.op_analysis import cost_of
        return cost_of(self.records, self.launch_records, self.log)


def trace(init, fn, *, device="meta") -> tuple:
    """``init()`` then ``fn(resting, arguments)`` under an ``OpTrace`` of
    ``device``, with the kernels' launch records and the collectives' log
    on.  ``init`` makes the trees of tensors alive before ``fn``, returned
    as ``(resting, arguments)``: its own peak is ``init_peak_bytes``;
    ``resting`` (params and optimizer state) and ``arguments`` (the batch,
    a cache) count as alive when ``fn`` starts.  Returns ``(fn's result,
    Trace)``; the STATS and launch counts are left as they were."""
    from repro_torch.kernels import dry
    from repro_torch.launch.op_analysis import OpTrace
    from repro_torch.sharding import collectives as C
    t0 = time.time()
    with _counters_kept():
        before = _counts()
        tr = OpTrace(device)
        with tr:
            resting, arguments = init()
        init_peak = tr.peak
        tr = OpTrace(device)
        rest = tr.adopt(resting)
        tr.adopt(arguments)
        arg = tr.live
        outer, dry.SINK = dry.SINK, []
        try:
            with C.recording() as log, tr:
                out = fn(resting, arguments)
            sink = dry.SINK
        finally:
            dry.SINK = outer
        stats, launches = _since(before)
    return out, Trace(records=tr.records(), launch_records=sink, log=log,
                      stats=stats, launches=launches, argument_bytes=arg,
                      resting_bytes=rest, peak_bytes=tr.peak,
                      init_peak_bytes=init_peak, n_ops=tr.n_ops,
                      seconds=time.time() - t0)


def meta_batch(specs: dict, device="meta") -> dict:
    """A batch of empty tensors from ``{leaf: (shape, dtype)}``."""
    return {k: torch.empty(shape, dtype=dt, device=device)
            for k, (shape, dt) in specs.items()}


def train_program(spec, *, arch=None, mesh=None, rank: int = 0,
                  device="meta"):
    """The program ``run(spec)`` trains, on the meta device: on ``mesh``
    (a shape) the sharded one of rank ``rank`` of a dry mesh
    (``fleet.elastic.sharded_program``), else ``build_step_program``."""
    from repro_torch.fleet.elastic import sharded_program
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.run.program import build_step_program
    if arch is None:
        from repro_torch.models.registry import get_arch
        arch = get_arch(spec.model.arch, smoke=spec.model.smoke)
    if mesh is None:
        return build_step_program(spec, arch, device=device)
    return sharded_program(spec, make_dry_mesh(mesh, rank), arch=arch,
                           device=device)


def trace_train(spec, *, arch=None, mesh=None, rank: int = 0,
                steps: int = 1) -> Trace:
    """Rank ``rank``'s ``steps`` train steps of ``spec`` traced on the
    meta device (``mesh``: the mesh's shape, None for one device), the
    program's ``init`` traced first (its peak apart), then each step on
    the global batch with the spec's hparams, as ``run`` drives it.  The
    Trace's counts are per run of ``steps`` steps (``steps=0``: the
    resting and argument bytes and the init's peak alone); ``per_step``
    holds each step's ``stats`` and ``launches``."""
    prog = train_program(spec, arch=arch, mesh=mesh, rank=rank)
    d = spec.data
    per_step = []

    def init():
        params, state = prog.init(spec.seed)
        batch = meta_batch(prog.arch.train_batch_specs(
            d.global_batch, d.seq_len, packed=d.packing))
        sent = prog.init_sentinel()
        return (params, state), (batch, sent)

    def steps_fn(resting, arguments):
        (params, state), (batch, sent) = resting, arguments
        loss = None
        for i in range(steps):
            hp = prog.hparams_fn(i + 1)
            before = _counts()
            if sent is None:
                params, state, loss, _ = prog.step(params, state, batch, hp)
            else:
                params, state, loss, _, sent = prog.step(params, state,
                                                         batch, hp, sent)
            stats, launches = _since(before)
            per_step.append({"stats": stats, "launches": launches})
        return loss

    _, tr = trace(init, steps_fn)
    tr.program = prog
    tr.per_step = per_step
    return tr


def trace_serving(arch, mesh, *, rank: int = 0, optimized: bool = True,
                  prompt=None, cache=None, decode_steps: int = 1,
                  **prefill_kw) -> tuple:
    """Rank ``rank``'s sharded serving steps of ``arch``
    (``serve/sharded.py``, any family) on a dry mesh of shape ``mesh``,
    traced on the meta device: the prefill of a global batch of the specs
    ``prompt`` (``{leaf: (shape, dtype)}``: ``tokens``, or an
    encoder-decoder's ``frames``) and then ``decode_steps`` decode steps
    from its cache, or, given ``cache`` (a whole cache on the meta device,
    ``Arch.cache_specs``), ``decode_steps`` decode steps from this rank's
    block of it.  ``prefill_kw``: the family's prefill keywords
    (``sharded_serving``).  Returns ``(the final cache block, Trace)``:
    ``per_step`` the prefill's and then each decode step's ``stats`` and
    ``launches``; ``resting_bytes`` the rank's param blocks and, given
    ``cache``, its cache block."""
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.serve.sharded import sharded_serving
    srv = sharded_serving(arch, make_dry_mesh(mesh, rank),
                          optimized=optimized, **prefill_kw)
    if cache is None:
        B = prompt["tokens" if "tokens" in prompt else "frames"][0][0]
    else:
        B = next(t for t in cache.values() if t.ndim >= 3).shape[1]
    # the rank's cache block, cut before the trace: the whole cache is no
    # rank's memory
    block = None if cache is None else srv.zero.cache_block(cache, B)
    per_step = []

    def init():
        params = srv.zero.place_params(arch.init_params(0, device="meta"))
        if cache is None:
            return params, meta_batch(prompt)
        return (params, block), None

    def counted(fn, *args):
        before = _counts()
        out = fn(*args)
        stats, launches = _since(before)
        per_step.append({"stats": stats, "launches": launches})
        return out

    def steps(resting, batch):
        if cache is None:
            params = resting
            _, held = counted(srv.prefill_step, params, batch)
        else:
            params, held = resting
        tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
        for _ in range(decode_steps):
            _, held = counted(srv.decode_step, params, held,
                              {"tokens": tokens})
        return held

    held, tr = trace(init, steps)
    tr.per_step = per_step
    return held, tr


# --------------------------------------------------------------------------
# cells
# --------------------------------------------------------------------------

def cell_meta(arch, arch_id: str, shape_name: str) -> dict:
    """The reference's ``meta`` block: params, active params and tokens a
    step, from shapes on the meta device."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core.tree import tree_leaves
    sh = SHAPES[shape_name]
    n_params = sum(t.numel() for t in tree_leaves(
        arch.init_params(0, device="meta")))
    if sh.kind == "decode":
        tokens = sh.global_batch
    elif sh.kind == "prefill" and arch.family == "encdec":
        tokens = sh.global_batch * arch.cfg.n_frames      # encoder only
    else:
        tokens = sh.global_batch * sh.seq_len
    return {"arch": arch_id, "shape": shape_name, "kind": sh.kind,
            "n_params": int(n_params),
            "n_active_params": int(arch.cfg.active_param_count()),
            "tokens_per_step": int(tokens),
            "global_batch": sh.global_batch, "seq_len": sh.seq_len}


def train_spec(arch, arch_id: str, shape_name: str, mesh, *,
               packed: bool = False, smoke: bool = False,
               optimized: bool = True):
    """The reference's train-cell ``RunSpec`` (``dryrun.py``: fused
    AdaLomo, constant schedule, one step), with the mesh's shape, so that
    ``run(spec)`` trains the traced program (``optimized=False``: the
    baseline plan)."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.run.spec import (MeshSpec, ModelSpec, OptSpec, RunSpec,
                                      StepSpec)
    sh = SHAPES[shape_name]
    kind = "none" if mesh is None else (
        "multi" if math.prod(mesh) > 256 else "single")
    return RunSpec(
        model=ModelSpec(arch=arch_id, smoke=smoke),
        data=DataConfig(vocab=arch.cfg.vocab, seq_len=sh.seq_len,
                        global_batch=sh.global_batch, packing=packed),
        opt=OptSpec(name="adalomo", schedule="constant"),
        steps=StepSpec(total=1, fused=True),
        mesh=MeshSpec(kind=kind, shape=mesh, optimized=optimized))


def pspec_bytes(tree, specs, shape: dict) -> int:
    """A device's bytes of ``tree`` under the partition specs ``specs`` on
    a mesh of axis sizes ``shape``: each leaf's bytes over the product of
    the sizes of the axes its spec splits it over."""
    from repro_torch.core.tree import tree_leaves
    total = 0
    for t, sp in zip(tree_leaves(tree), tree_leaves(specs)):
        if not isinstance(t, torch.Tensor):
            continue
        parts = 1
        for ax in sp:
            for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                parts *= shape[a]
        total += t.numel() * t.element_size() // parts
    return total


def build_cell(arch_id: str, shape_name: str, mesh=None, *,
               packed: bool = False, rank: int = 0,
               smoke: bool = False, optimized: bool = True) -> dict:
    """Trace one cell (module docstring) and return its result: ``meta``,
    ``trace`` (a :class:`Trace`), ``n_chips`` (the devices whose one the
    trace is: the mesh's size, or 1 for a one-device trace), and for a
    train cell ``spec`` and ``program``; for a serving cell on a mesh
    ``reckoned`` (its param and cache bytes a device).  ``smoke``: the
    config's smoke width and depth at the cell's shapes (a quick check of
    the path).  ``optimized=False``: the baseline plan of a train cell and
    of a serving cell on a mesh."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models.registry import get_arch
    arch = get_arch(arch_id, smoke=smoke)
    sh = SHAPES[shape_name]
    meta = cell_meta(arch, arch_id, shape_name)
    if sh.kind == "train":
        spec = train_spec(arch, arch_id, shape_name, mesh, packed=packed,
                          smoke=smoke, optimized=optimized)
        meta["run_spec"] = spec.to_dict()
        meta["packed"] = bool(packed)
        tr = trace_train(spec, arch=arch, mesh=mesh, rank=rank)
        return {"meta": meta, "trace": tr, "spec": spec,
                "program": tr.program,
                "n_chips": 1 if mesh is None else math.prod(mesh)}
    if mesh is None:
        return {"meta": meta, "n_chips": 1,
                "trace": _serving_trace(arch_id, shape_name, smoke)}
    prompt = None
    if sh.kind == "prefill":
        prompt = arch.input_specs(shape_name)
        if arch.family == "encdec":
            prompt = {"frames": prompt["frames"]}    # what it reads
    _, tr = trace_serving(
        arch, mesh, rank=rank, optimized=optimized, prompt=prompt,
        cache=(arch.cache_specs(shape_name) if sh.kind == "decode"
               else None),
        decode_steps=int(sh.kind == "decode"))
    params = arch.init_params(0, device="meta")
    cache = arch.cache_specs(shape_name) if sh.kind == "decode" else None
    from repro_torch.launch.mesh import AXES_BY_NDIM, MeshLayout
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.zero import rest_pspecs
    layout = MeshLayout(tuple(mesh), AXES_BY_NDIM[len(mesh)])
    axes = R.MeshAxes(layout)
    reckoned = {
        "param_bytes_per_device": pspec_bytes(
            params, rest_pspecs(params, axes), layout.shape),
        "cache_bytes_per_device": (0 if cache is None else pspec_bytes(
            cache, R.cache_pspecs(cache, axes, sh.global_batch),
            layout.shape)),
        "how": "reckoned under zero.rest_pspecs (rules.param_pspecs, "
               "vectors whole over model) / cache_pspecs, not traced"}
    return {"meta": meta, "trace": tr, "n_chips": math.prod(mesh),
            "reckoned": reckoned}


def _serving_trace(arch_id: str, shape_name: str, smoke: bool) -> Trace:
    """A prefill or decode cell's trace on one device (``--mesh one``)."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models.registry import get_arch
    arch = get_arch(arch_id, smoke=smoke)
    prefill = SHAPES[shape_name].kind == "prefill"

    def init():
        batch = meta_batch(arch.input_specs(shape_name))
        if prefill and arch.family == "encdec":
            batch = {k: batch[k] for k in ("tokens", "frames")}
        cache = None if prefill else arch.cache_specs(shape_name)
        return arch.init_params(0, device="meta"), (batch, cache)

    if prefill:
        fn = (arch.make_prefill_step(max_decode_len=448)
              if arch.family == "encdec" else arch.make_prefill_step())
        return trace(init, lambda params, a: fn(params, a[0]))[1]
    fn = arch.make_decode_step()
    return trace(init, lambda params, a: fn(params, a[1], a[0]))[1]


def cell_result(cell: dict, mesh_kind: str, mesh) -> dict:
    """A cell's JSON: the reference's keys (``meta``, ``mesh``,
    ``n_chips``, the cost keys, ``collectives``) with ``trace_s`` for its
    ``lower_s``/``compile_s``, ``memory`` for its ``memory_analysis`` and
    ``kernel_launches``."""
    tr = cell["trace"]
    cost = tr.cost()
    res = {
        **cell["meta"],
        "mesh": mesh_kind, "mesh_shape": list(mesh) if mesh else None,
        "n_chips": int(cell["n_chips"]),
        "trace_s": round(tr.seconds, 2),
        "memory": {"resting_bytes": tr.resting_bytes,
                   "argument_bytes": tr.argument_bytes,
                   "peak_bytes": max(tr.peak_bytes, tr.init_peak_bytes),
                   "step_peak_bytes": tr.peak_bytes,
                   "init_peak_bytes": tr.init_peak_bytes},
        "collectives": cost["collectives"],
        "flops_per_device": cost["flops"],
        "dot_flops_per_device": cost["dot_flops"],
        "hbm_bytes_per_device": cost["bytes"],
        "transcendentals_per_device": cost["transcendentals"],
        "kernel_launches": tr.launches,
        "collective_stats": tr.stats,
        "n_ops": tr.n_ops,
    }
    if "reckoned" in cell:
        res["memory"]["reckoned"] = cell["reckoned"]
    return res


def _cell_name(arch_id, shape_name, mesh_kind, packed, rank, smoke) -> str:
    name = f"{arch_id}__{shape_name}__{mesh_kind}"
    if smoke:
        name += "__smoke"
    if packed:
        name += "__packed"
    if rank:
        name += f"__rank{rank}"
    return name


def save_cell(res: dict, tr: Trace, out_path: Path) -> None:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(res, indent=1))
    if "run_spec" in res:
        out_path.with_suffix(".runspec.json").write_text(
            json.dumps(res["run_spec"], indent=1) + "\n")
    with gzip.open(out_path.with_suffix(".ops.json.gz"), "wt") as f:
        json.dump({"ops": tr.records, "launches": tr.launch_records}, f)
    with gzip.open(out_path.with_suffix(".coll.json.gz"), "wt") as f:
        json.dump(tr.log, f)


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, *,
             force: bool = False, save: bool = True, packed: bool = False,
             artifact_dir=None, rank: int = 0, smoke: bool = False,
             optimized: bool = True) -> dict:
    """One cell's result (:func:`cell_result`), read from its artifact
    when there is one (unless ``force``), else traced and saved under
    ``artifact_dir`` (default :data:`ARTIFACT_DIR`, or
    :data:`BASELINE_DIR` with ``optimized=False``)."""
    adir = (Path(artifact_dir) if artifact_dir else
            ARTIFACT_DIR if optimized else BASELINE_DIR)
    out_path = adir / (_cell_name(arch_id, shape_name, mesh_kind, packed,
                                  rank, smoke) + ".json")
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    mesh = mesh_shape(mesh_kind)
    cell = build_cell(arch_id, shape_name, mesh, packed=packed, rank=rank,
                      smoke=smoke, optimized=optimized)
    res = cell_result(cell, mesh_kind, mesh)
    res["rank"] = rank
    if save:
        save_cell(res, cell["trace"], out_path)
    return res


def roofline_terms(res: dict) -> dict:
    """The three roofline terms (seconds) of a cell, the reference's
    arithmetic with this module's constants."""
    compute_s = res["flops_per_device"] / PEAK_FLOPS
    memory_s = res["hbm_bytes_per_device"] / HBM_BW
    coll = res["collectives"]
    coll_raw = coll["total_wire_bytes"] / LINK_BW
    coll_s = coll.get("total_wire_bytes_bf16eq",
                      coll["total_wire_bytes"]) / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    n = res["n_active_params"]
    toks = res["tokens_per_step"]
    model_flops = (6 if res["kind"] == "train" else 2) * n * toks
    hlo_global = res["flops_per_device"] * res["n_chips"]
    terms.update({
        "collective_s_raw": coll_raw,
        "dominant": dom,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_global,
        "useful_ratio": model_flops / hlo_global if hlo_global else 0.0,
        "roofline_fraction": (model_flops / PEAK_FLOPS / res["n_chips"])
        / bound if bound else 0.0,
    })
    return terms


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Trace every (arch x shape x mesh) cell on the meta "
                    "device.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    help="single (16x16), multi (2x16x16), both, one (a "
                         "single device, no mesh), or any AxB[xC]")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh this process plays")
    ap.add_argument("--smoke", action="store_true",
                    help="the configs' smoke width and depth")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--packed", action="store_true",
                    help="trace train cells on the segment-packed batch "
                         "layout; other and non-packable cells are skipped")
    ap.add_argument("--baseline", action="store_true",
                    help="the paper-faithful baseline sharding (no "
                         "activation policy, whole gradients all-reduced, "
                         "expert stacks gathered whole); writes to "
                         "runs/dryrun_torch_baseline/")
    ap.add_argument("--artifact-dir", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models.registry import ARCH_IDS, get_arch

    if args.all:
        cells = [(a, s) for a in ARCH_IDS
                 for s in get_arch(a, smoke=True).supported_cells()]
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = ([args.shape] if args.shape else
                  get_arch(args.arch, smoke=True).supported_cells())
        cells = [(args.arch, s) for s in shapes]
    if args.packed:
        cells = [(a, s) for a, s in cells
                 if SHAPES[s].kind == "train"
                 and get_arch(a, smoke=True).supports_packing()]
        if not cells:
            ap.error("--packed: no packable train cells selected")
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])

    failures = []
    t0 = time.time()
    for arch_id, shape_name in cells:
        for mk in meshes:
            tag = f"{arch_id} × {shape_name} × {mk}"
            if args.packed:
                tag += " × packed"
            if args.baseline:
                tag += " × baseline"
            try:
                res = run_cell(arch_id, shape_name, mk, force=args.force,
                               packed=args.packed, rank=args.rank,
                               artifact_dir=args.artifact_dir,
                               smoke=args.smoke,
                               optimized=not args.baseline)
                terms = roofline_terms(res)
                print(f"OK   {tag:55s} trace={res['trace_s']:7.1f}s "
                      f"peak={res['memory']['peak_bytes'] / 2**30:9.2f}GiB "
                      f"dom={terms['dominant']:<13s} "
                      f"roofline={terms['roofline_fraction']:.3f}",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — report & continue
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    print(f"\n{len(cells) * len(meshes)} cells in {time.time() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        sys.exit(1)
    print("\nALL CELLS PASSED")


if __name__ == "__main__":
    main()
