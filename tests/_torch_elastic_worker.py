"""The ranks of the sharded-run tests (``test_torch_elastic.py``,
``test_torch_model_axis*.py``, ``test_torch_mesh_optimizers.py``,
``test_torch_sharded_bf16.py``, ``test_torch_dryrun_world.py``): one
``gloo`` world a call of :func:`run_world`, running a list of cases in
order, each rank writing what the parent process compares.  Imports torch
and the port only (no JAX), so that a world starts quickly."""
import json
import os
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def make_spec(arch, *, shape=None, total=6, ckpt=None, every=3,
              packing=False, sentinel=False, eval_every=0, spec_mod=None,
              data_cls=None, opt="adalomo", lr=1e-3, microbatches=1,
              trust_max=0.0, observe=0, factored_every=0, guard_mod=None,
              probes_mod=None, seq_len=32, optimized=True):
    """The cases' RunSpec, in either package (``spec_mod``: its
    ``run.spec``; ``data_cls``: its ``DataConfig``; ``guard_mod`` /
    ``probes_mod``: the modules of its ``SentinelSpec`` and
    ``ObservabilitySpec``).  ``trust_max`` > 0 turns the sentinel on with
    its trust guard; ``observe`` > 0 the probes at that cadence;
    ``optimized=False`` the mesh's baseline plan."""
    if spec_mod is None:
        from repro_torch.data.pipeline import DataConfig as data_cls
        from repro_torch.run import spec as spec_mod
        from repro_torch.sentinel import spec as guard_mod
        from repro_torch.telemetry import probes as probes_mod
    kw = {}
    if sentinel or trust_max:
        kw["sentinel"] = guard_mod.SentinelSpec(enabled=True,
                                                trust_max=trust_max)
    if observe:
        kw["observe"] = probes_mod.ObservabilitySpec(
            optimizer_every=observe, factored_every=factored_every)
    return spec_mod.RunSpec(
        model=spec_mod.ModelSpec(arch, smoke=True),
        data=data_cls(vocab=0, seq_len=seq_len, global_batch=8, seed=3,
                      packing=packing),
        opt=spec_mod.OptSpec(name=opt, lr=lr, schedule="constant"),
        steps=spec_mod.StepSpec(total=total, microbatches=microbatches),
        mesh=(spec_mod.MeshSpec(kind="multi", shape=tuple(shape),
                                optimized=optimized)
              if shape else spec_mod.MeshSpec()),
        checkpoint=spec_mod.CheckpointSpec(dir=ckpt, every=every,
                                           resume=True),
        eval=spec_mod.EvalSpec(every=eval_every, n_batches=2),
        seed=3, log_every=0, **kw)


GGN_CLIP = 0.5        # LOMO's two-pass global-norm clip, below the norm


def lomo_steps(spec, params, zero=None, steps=3):
    """``steps`` fused LOMO steps with ``global_grad_norm`` through the step
    program (``run`` takes no clip), on the global batches of ``spec``.
    Returns the losses, the program and ``(params, opt_state)``."""
    from repro_torch.models.registry import get_arch
    from repro_torch.run.data import make_batch_iter
    from repro_torch.run.program import build_step_program
    from repro_torch.run.runner import batch_to_device
    arch = get_arch(spec.model.arch, smoke=True)
    program = build_step_program(spec, arch, device="cpu", zero=zero,
                                 global_grad_norm=GGN_CLIP)
    state = program.opt.init(params)
    if zero is not None:
        params, state = zero.shard_tree((params, state), state)
    batches = make_batch_iter(spec, arch)
    losses = []
    for i in range(steps):
        batch = batch_to_device(next(batches), torch.device("cpu"))
        params, state, loss, _ = program.step(params, state, batch,
                                              program.hparams_fn(i + 1))
        losses.append(float(loss))
    return losses, program, (params, state)


def _case(case, rank):
    from repro_torch.run import run
    from repro_torch.run.hooks import Hook

    class Capture(Hook):
        def __init__(self):
            self.aux, self.mtp, self.anomaly, self.probes = [], [], [], []

        def on_step_end(self, ctx, ev):
            self.aux.append(ev.metrics.get("aux_loss"))
            self.mtp.append(ev.metrics.get("mtp_loss"))
            sent = ev.metrics.get("sentinel", {})
            self.anomaly.append(sent.get("anomaly"))
            self.probes.append(probe_values(ev.metrics))

    kind = case["kind"]
    out = case["out"]
    if kind == "copy_step":
        if rank == 0:
            os.makedirs(case["dst"], exist_ok=True)
            shutil.copytree(case["src"], os.path.join(
                case["dst"], os.path.basename(case["src"])))
        dist.barrier()
        return
    if kind == "ggn":
        import dataclasses

        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.fleet.elastic import mesh_from_spec
        from repro_torch.models.registry import get_arch
        from repro_torch.run.spec import OptSpec
        from repro_torch.sharding.zero import Zero3
        spec = dataclasses.replace(
            make_spec(case["arch"], shape=case["shape"]),
            opt=OptSpec(name="lomo", lr=1e-2, schedule="constant"))
        zero = Zero3(mesh_from_spec(spec.mesh, "cpu"), get_arch(
            case["arch"], smoke=True).init_params(0, device="meta"))
        losses, _, tree = lomo_steps(spec, torch.load(case["init"]), zero)
        CheckpointManager(case["ckpt"], zero=zero).save(3, tree)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"loss": losses}, f)
        return
    if kind == "one_rank_probes":
        _one_rank_probes_case(case)
        return
    if kind == "shard_act":
        _shard_act_case(case, rank)
        return
    if kind == "tiles":
        _tiles_case(case, rank)
        return
    if kind == "mtp_positions":
        _mtp_positions_case(case, rank)
        return
    if kind == "prefix_rows":
        _prefix_rows_case(case, rank)
        return
    if kind == "dry_vs_live":
        _dry_vs_live_case(case, rank)
        return
    if kind == "serve":
        _serve_case(case, rank)
        return
    if kind == "mesh_error":
        from repro_torch.launch.mesh import make_mesh
        try:
            make_mesh(tuple(case["shape"]), "cpu")
            msg = ""
        except ValueError as e:
            msg = str(e)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"error": msg}, f)
        return
    spec = make_spec(case["arch"], shape=case["shape"], total=case["total"],
                     ckpt=case.get("ckpt"), every=case.get("every", 3),
                     packing=case.get("packing", False),
                     sentinel=bool(case.get("inject")),
                     eval_every=case.get("eval_every", 0),
                     opt=case.get("opt", "adalomo"),
                     lr=case.get("lr", 1e-3),
                     microbatches=case.get("microbatches", 1),
                     trust_max=case.get("trust_max", 0.0),
                     observe=case.get("observe", 0),
                     factored_every=case.get("factored_every", 0),
                     seq_len=case.get("seq", 32),
                     optimized=case.get("optimized", True))
    if kind == "roundtrip":
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.fleet.elastic import mesh_from_spec
        from repro_torch.models.registry import get_arch
        from repro_torch.run.program import build_step_program
        from repro_torch.sharding.zero import Zero3
        arch = get_arch(case["arch"], smoke=True)
        zero = Zero3(mesh_from_spec(spec.mesh, "cpu"),
                     arch.init_params(0, device="meta"))
        program = build_step_program(spec, arch, device="cpu", zero=zero)
        tree = program.init(0)
        step, _ = CheckpointManager(case["src"], zero=zero).restore_into(
            tree, step=case["step"])
        CheckpointManager(case["dst"], zero=zero).save(step, tree)
        return
    cap = Capture()
    arch = None
    if case.get("aux_weight") is not None:
        arch = aux_arch(case["arch"], case["aux_weight"])
    if case.get("dtype"):
        arch = dtype_arch(case["arch"], getattr(torch, case["dtype"]))
    batch_iter = None
    if case.get("overrides"):
        # the registered config's batches under the overridden model (a
        # causal modality prefix takes the prefix-LM config's prefix leaves)
        from repro_torch.models.registry import get_arch
        from repro_torch.run.data import make_batch_iter
        arch = cfg_arch(case["arch"], **case["overrides"])
        batch_iter = make_batch_iter(spec, get_arch(case["arch"], smoke=True))
    params = torch.load(case["init"]) if case.get("init") else None
    inject = None
    if case.get("inject"):
        from repro_torch.sentinel.inject import Injection
        kind, at = case["inject"]
        inject = Injection(kind, at_step=at)
    res = run(spec, arch=arch, params=params, device="cpu", hooks=[cap],
              batch_iter=batch_iter, inject=inject, log_fn=lambda s: None)
    gathers = res.program.zero.gathers if res.program.zero else {}
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"loss": res.history["loss"], "aux": cap.aux,
                       "mtp": cap.mtp,
                       "anomaly": cap.anomaly,
                       "eval_loss": res.history["eval_loss"],
                       "step": res.history["step"],
                       "gathers": [[a, k, n] for (a, k), n
                                   in sorted(gathers.items())],
                       "tile": (res.program.zero.tile
                                if res.program.zero else None)}, f)
    torch.save(res.params, f"{out}.rank{rank}.pt")
    with open(f"{out}.rank{rank}.probes.json", "w") as f:
        json.dump(cap.probes, f)


def _one_rank_probes_case(case):
    """The probed run of each of ``case["runs"]`` (``make_spec`` keywords)
    on a one-rank ``(1,)`` mesh and on no mesh, from one set of weights:
    whether every probe value and ``trust_worst`` is the same bits."""
    from repro_torch.core.tree import tree_map
    from repro_torch.run import run
    from repro_torch.run.hooks import Hook

    class Probes(Hook):
        def __init__(self):
            self.values = []

        def on_step_end(self, ctx, ev):
            self.values.append(probe_values(ev.metrics))

    params = torch.load(case["init"])
    out = {}
    for name, kw in case["runs"].items():
        got = []
        for shape in ((1,), None):
            hook = Probes()
            run(make_spec(case["arch"], shape=shape, **kw),
                params=tree_map(torch.clone, params), device="cpu",
                hooks=[hook], log_fn=lambda s: None)
            got.append(hook.values)
        out[name] = {"equal": got[0] == got[1], "n_values": sum(
            len(v) for v in got[0]), "steps": len(got[0])}
    with open(case["out"], "w") as f:
        json.dump(out, f)


def probe_values(metrics: dict) -> dict:
    """The probe values and the trust guard's ``trust_worst`` of one
    step's host metrics, flat: ``{"group_ratio/<group>": x,
    "eff_lr/counts": [...], "factored/<key>": x, ...}``."""
    out = {}
    health = metrics.get("opt_health", {})
    for part, vals in health.items():
        for k, v in vals.items():
            out[f"{part}/{k}"] = v.tolist() if hasattr(v, "tolist") else v
    if "trust_worst" in metrics.get("sentinel", {}):
        out["trust_worst"] = metrics["sentinel"]["trust_worst"]
    return out


def aux_arch(arch_id, weight):
    """The smoke config of ``arch_id`` (MoE) with the router's load-balance
    weight set to ``weight``."""
    import dataclasses

    from repro_torch.models.registry import get_arch
    arch = get_arch(arch_id, smoke=True)
    moe = dataclasses.replace(arch.cfg.moe, router_aux_weight=weight)
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg,
                                                             moe=moe))


def dtype_arch(arch_id, dtype):
    """The smoke config of ``arch_id`` in ``dtype`` (a torch dtype)."""
    return cfg_arch(arch_id, dtype=dtype)


def cfg_arch(arch_id, **overrides):
    """The smoke config of ``arch_id`` with ``overrides`` of its fields."""
    import dataclasses

    from repro_torch.models.registry import get_arch
    arch = get_arch(arch_id, smoke=True)
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg,
                                                             **overrides))


def _shard_act_case(case, rank):
    """Each kind of ``shard_act`` on this rank's tile of a seeded
    ``[B, S, ...]`` activation on a (1, w) mesh, and ``kv_full``'s
    backward: the gradient of ``Σ(weights · gathered)`` at the tile."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import act, rules
    mesh = make_mesh(tuple(case["shape"]), "cpu")
    x = torch.from_numpy(np.load(case["x"]))
    wts = torch.from_numpy(np.load(case["w"]))
    tp, k = mesh.size("model"), mesh.tile_index
    n = x.shape[1] // tp
    tile = x[:, k * n:(k + 1) * n].clone().requires_grad_(True)
    out = {}
    with act.use_policy(act.ActPolicy(mesh, rules.MeshAxes(mesh))):
        for kind in ("hidden", "ffn", "heads", "q_tiled", "vocab",
                     "experts", "kv_full"):
            out[kind] = act.shard_act(tile, kind).detach().numpy()
        y = act.shard_act(tile, "kv_full")
        (g,) = torch.autograd.grad((y * wts[rank]).sum(), tile)
        out["kv_full_grad"] = g.numpy()
        out["seq_tiles"] = np.array(act.seq_tiles(x.shape[1]))
        out["offset"] = np.array(act.seq_offset(n))
    np.savez(f"{case['out']}.rank{rank}.npz", **out)


def _tiles_case(case, rank):
    """One fused step of ``case["arch"]`` on the case's mesh, recording the
    shapes of the saved layer inputs (the residual constraint's input),
    the tile the batch was cut to, and the gathers by axis and kind."""
    from repro_torch.fleet.elastic import mesh_from_spec
    from repro_torch.models.registry import get_arch
    from repro_torch.run.data import make_batch_iter
    from repro_torch.run.program import build_step_program
    from repro_torch.run.runner import batch_to_device
    from repro_torch.sharding.zero import Zero3
    spec = make_spec(case["arch"], shape=case["shape"])
    arch = get_arch(case["arch"], smoke=True)
    zero = Zero3(mesh_from_spec(spec.mesh, "cpu"),
                 arch.init_params(0, device="meta"))
    saved = []
    check = zero.residual_fn()

    def recording():
        def save(carry):
            saved.append([list(t.shape) for t in carry if t.ndim >= 3])
            return check(carry)
        return save

    zero.residual_fn = recording
    program = build_step_program(spec, arch, device="cpu", zero=zero)
    params, state = program.init(0)
    batch = batch_to_device(next(make_batch_iter(spec, arch)),
                            torch.device("cpu"))
    program.step(params, state, batch, program.hparams_fn(1))
    if rank == 0:
        with open(case["out"], "w") as f:
            json.dump({"saved": saved, "tile": list(zero.tile),
                       "global": list(batch["tokens"].shape),
                       "gathers": [[a, k, n] for (a, k), n
                                   in sorted(zero.gathers.items())]}, f)


def _mtp_positions_case(case, rank):
    """One fused step of ``case["arch"]`` (an MTP config) on the case's
    mesh, recording the positions the MTP head's block is given on each
    rank: ``pos`` (its queries) and ``kv_pos`` (the keys); and, after
    ``program.init``, whether every resting block owns its memory (its
    storage no larger than itself: no view of a whole leaf)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fleet.elastic import mesh_from_spec
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_arch
    from repro_torch.run.data import make_batch_iter
    from repro_torch.run.program import build_step_program
    from repro_torch.run.runner import batch_to_device
    from repro_torch.sharding.zero import Zero3
    spec = make_spec(case["arch"], shape=case["shape"], seq_len=case["seq"])
    arch = get_arch(case["arch"], smoke=True)
    seen = []
    body_of = T.make_block_body

    def recording(cfg):
        body = body_of(cfg)
        if cfg.mtp or not arch.cfg.mtp:
            return body

        def mtp_body(p, ctx, carry, aux_idx):
            seen.append({k: ctx[1][k].tolist() for k in ("pos", "kv_pos")
                         if k in ctx[1]})
            return body(p, ctx, carry, aux_idx)
        return mtp_body

    T.make_block_body = recording
    try:
        zero = Zero3(mesh_from_spec(spec.mesh, "cpu"),
                     arch.init_params(0, device="meta"))
        program = build_step_program(spec, arch, device="cpu", zero=zero)
        params, state = program.init(0)
        owned = [t.untyped_storage().nbytes() == t.numel() * t.element_size()
                 for t in tree_leaves(params)]
        batch = batch_to_device(next(make_batch_iter(spec, arch)),
                                torch.device("cpu"))
        program.step(params, state, batch, program.hparams_fn(1))
    finally:
        T.make_block_body = body_of
    with open(f"{case['out']}.rank{rank}.json", "w") as f:
        json.dump({"seen": seen, "tile": list(zero.tile), "owned": owned},
                  f)


def _prefix_rows_case(case, rank):
    """``Zero3.rows`` of a global batch whose leaves hold their own
    positions (``prefix_embed[b, j] = j``, ``tokens[b, t] = P + t``,
    ``labels[b, t] = -(P + t)``) for each ``(P, S)`` of ``case["cuts"]``
    on the case's mesh: this rank's rows of each leaf and its tile, or the
    ``ValueError``'s message."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import get_arch
    from repro_torch.sharding.zero import Zero3
    mesh = make_mesh(tuple(case["shape"]), "cpu")
    meta = get_arch(case["arch"], smoke=True).init_params(0, device="meta")
    got = []
    for P, S in case["cuts"]:
        B = 4
        batch = {"tokens": torch.arange(P, P + S).repeat(B, 1),
                 "labels": -torch.arange(P, P + S).repeat(B, 1),
                 "prefix_len": torch.full((B,), P),
                 "prefix_embed": torch.arange(P, dtype=torch.float32)[
                     None, :, None].repeat(B, 1, 2)}
        zero = Zero3(mesh, meta, prefix=P)
        try:
            cut = zero.rows(batch)
        except ValueError as e:
            got.append({"error": str(e)})
            continue
        got.append({"tile": list(zero.tile),
                    "rows": cut["tokens"].shape[0],
                    "tokens": cut["tokens"][0].tolist(),
                    "labels": cut["labels"][0].tolist(),
                    "prefix_len": cut["prefix_len"].tolist(),
                    "prefix_embed": cut["prefix_embed"][0, :, 0].tolist()})
    with open(f"{case['out']}.rank{rank}.json", "w") as f:
        json.dump(got, f)


def _storage_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    seen = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


# the kernel launches the card's path makes for one factored update: whole
# (K1, K2), a row or column shard, a block split both ways (K1 mode 3)
_ENTRIES = {None: {"adalomo_stats": 1, "adalomo_update": 1},
            -2: {"adalomo_stats_partial": 1, "adalomo_stats_fold": 1,
                 "adalomo_update_partials": 1, "adalomo_update_apply": 1},
            0: {"adalomo_stats_partial": 1, "adalomo_stats_fold": 2,
                "adalomo_update_partials": 1, "adalomo_update_apply": 1,
                "mode3": 1}}
_ENTRIES[-1] = _ENTRIES[-2]


def _dry_vs_live_case(case, rank):
    """One fused AdaLomo step of ``case["arch"]``'s smoke config on
    ``case["shape"]`` (the baseline plan with ``case["optimized"]``
    False), live in this world under the collectives' log, and
    this rank's dry trace of the same spec: each rank writes both (the
    live updates counted as the kernel entries the card would launch for
    them: on the CPU the plain versions run)."""
    import collections

    from repro_torch.core import adalomo as A
    from repro_torch.fleet.elastic import mesh_from_spec, sharded_program
    from repro_torch.launch import dryrun as D
    from repro_torch.models.registry import get_arch
    from repro_torch.run.data import make_batch_iter
    from repro_torch.run.runner import batch_to_device
    from repro_torch.sharding import collectives as C
    spec = make_spec(case["arch"], shape=case["shape"], total=1,
                     optimized=case.get("optimized", True))
    arch = get_arch(case["arch"], smoke=True)
    prog = sharded_program(spec, mesh_from_spec(spec.mesh, "cpu"),
                           arch=arch, device="cpu")
    params, state = prog.init(spec.seed)
    resting = _storage_bytes((params, state))
    batch = batch_to_device(next(make_batch_iter(spec, arch)),
                            torch.device("cpu"))
    launches = collections.Counter()
    whole, sharded = A.update_tensor, A.update_tensor_sharded

    def count(entries, st):
        if st.v is None:
            launches.update(entries)

    def spy_whole(param, grad, st, **kw):
        count(_ENTRIES[None], st)
        return whole(param, grad, st, **kw)

    def spy_sharded(param, grad, st, *, shard, **kw):
        count(_ENTRIES[shard.axis], st)
        return sharded(param, grad, st, shard=shard, **kw)

    A.update_tensor, A.update_tensor_sharded = spy_whole, spy_sharded
    C.reset_stats()
    try:
        with C.recording() as log:
            prog.step(params, state, batch, prog.hparams_fn(1))
    finally:
        A.update_tensor, A.update_tensor_sharded = whole, sharded
    live = {"log": log, "stats": dict(C.STATS), "launches": launches,
            "resting": resting}
    tr = D.trace_train(spec, arch=arch, mesh=tuple(case["shape"]),
                       rank=rank)
    dry = {"log": tr.log, "stats": tr.stats,
           "launches": tr.launches,
           "resting": tr.resting_bytes}
    with open(f"{case['out']}.rank{rank}.json", "w") as f:
        json.dump({"live": live, "dry": dry}, f)


def _serve_case(case, rank):
    """The sharded serving steps (``serve/sharded.py``) of ``case["arch"]``'s
    smoke config (with ``case["cfg"]``'s overrides) on ``case["shape"]``
    (the baseline plan with ``case["optimized"]`` False), from the weights
    at ``case["init"]``: the prefill (``case["prefill"]``: its keywords) of
    the global prompt at ``case["prompt"]`` (an ``.npz``; an
    encoder-decoder's frames, its ``tokens`` the first decode tokens) and
    ``case["steps"]`` greedy decode steps, each step's next tokens those of
    the rows' logits gathered over the batch ranks (outside the steps),
    live in this world under the collectives' log; then this rank's dry
    trace of the same steps.  Each rank writes its rows' logits a step (an
    encoder-decoder's prefill output apart), the greedy tokens, its cache
    block after the prefill and after the last step, its rows and ring
    slots, and both runs' counts a step (the live run's plain attentions
    counted as the K4 launches the card's path makes for them)."""
    import collections

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.sharded import sharded_serving
    from repro_torch.sharding import collectives as C
    arch = cfg_arch(case["arch"], **case.get("cfg", {}))
    mesh = make_mesh(tuple(case["shape"]), "cpu")
    optimized = case.get("optimized", True)
    kw = case.get("prefill", {})
    srv = sharded_serving(arch, mesh, optimized=optimized, **kw)
    params = srv.zero.place_params(torch.load(case["init"]))
    prompt = {k: torch.from_numpy(v)
              for k, v in np.load(case["prompt"]).items()}
    encdec = arch.family == "encdec"
    batch = {"frames": prompt["frames"]} if encdec else prompt
    launches = collections.Counter()
    wrapped = {n: getattr(ops, n) for n in ("decode_attention",
                                            "decode_attention_partial")}
    steps, log = [], []

    def spy(name):
        def fn(*args, **kw):
            launches[name] += 1
            return wrapped[name](*args, **kw)
        return fn

    def measured(fn, *args):
        C.reset_stats()
        launches.clear()
        with C.recording() as calls:
            out = fn(*args)
        steps.append({"stats": dict(C.STATS), "launches": dict(launches)})
        log.extend(calls)
        return out

    def block(cache):
        return {k: v.clone().numpy() for k, v in cache.items()}

    for name in wrapped:
        setattr(ops, name, spy(name))
    try:
        out, cache = measured(srv.prefill_step, params, batch)
        got = {"logits": [], "tokens": []}
        if encdec:
            got["enc_out"] = out.numpy()
        else:
            got["logits"].append(out.numpy())
        first = block(cache)
        cache_bytes = sum(v.numel() * v.element_size()
                          for v in cache.values())
        for i in range(case["steps"]):
            if encdec and i == 0:
                tok = prompt["tokens"]
            else:
                tok = torch.argmax(out, dim=-1, keepdim=True).to(torch.int32)
                if mesh.batch_size > 1:
                    tok = C.all_gather(tok, 0, srv.zero.batch)
            got["tokens"].append(tok[:, 0].numpy())
            out, cache = measured(srv.decode_step, params, cache,
                                  {"tokens": tok})
            got["logits"].append(out.numpy())
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)
    rows = out.shape[0]
    live = {"log": log, "steps": steps, "resting": _storage_bytes(params),
            "cache": cache_bytes}
    specs = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
    dry_block, tr = D.trace_serving(arch, tuple(case["shape"]), rank=rank,
                                    optimized=optimized, prompt=specs,
                                    decode_steps=case["steps"], **kw)
    dry = {"log": tr.log, "steps": tr.per_step, "resting": tr.resting_bytes,
           "cache": sum(t.numel() * t.element_size()
                        for t in dry_block.values())}
    extra = {"enc_out": got["enc_out"]} if encdec else {}
    np.savez(f"{case['out']}.rank{rank}.npz",
             logits=np.stack(got["logits"]), tokens=np.stack(got["tokens"]),
             **extra, **{f"first_{k}": v for k, v in first.items()},
             **{f"last_{k}": v for k, v in block(cache).items()})
    with open(f"{case['out']}.rank{rank}.json", "w") as f:
        json.dump({"live": live, "dry": dry,
                   "rows": [mesh.batch_index * rows,
                            (mesh.batch_index + 1) * rows],
                   "slots": ("pos" in cache and list(
                       srv.zero.slot_block(cache["pos"].shape[0]))) or None,
                   "tile": srv.zero.tile and list(srv.zero.tile)}, f)


def _rank(rank, world, store, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for case in cases:
            _case(case, rank)
    finally:
        dist.destroy_process_group()


def start_world(world: int, store: str, cases: list,
                timeout: float = 600.0):
    """Spawn ``world`` gloo ranks on the host that run ``cases`` in order,
    and return ``wait()``, which returns when they have finished (a rank's
    failure raises; a world still running ``timeout`` seconds after the
    start is killed and raises ``TimeoutError``)."""
    ctx = mp.spawn(_rank, args=(world, store, cases), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout

    def wait() -> None:
        while not ctx.join(timeout=2.0):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"a world of {world} ranks did not "
                                   f"finish in {timeout} s")

    return wait


def run_world(world: int, store: str, cases: list,
              timeout: float = 600.0) -> None:
    """:func:`start_world` and wait for it."""
    start_world(world, store, cases, timeout)()
