"""Elastic restore: resume the same RunSpec on a different mesh.
Counterpart of ``repro.fleet.elastic``.

Checkpoints are mesh-independent (full logical arrays; see
``checkpoint/manager.py``), so "we lost a pod" is a spec edit, not a
migration: change ``spec.mesh.shape`` and resume.  The pieces:

  * :func:`mesh_from_spec` — the ``ProcessMesh`` of ``MeshSpec.shape`` over
    this process's ``torch.distributed`` world (``launch/mesh.py``);
  * :func:`program_shardings` — the placements of the program's
    ``(params, opt_state, batch, hparams[, sentinel])``: the params and
    the optimizer state as the sharded step holds them (AdaLomo's r with
    its param's rows, c with its columns; ``sharding/zero.py``) and the
    batch specs of ``sharding/rules.py`` with the sequence tiles;
  * :class:`ElasticCheckpoints` — the run's checkpoint manager, saving by
    gathering shards to rank 0 and restoring each rank's slice;
  * :func:`run_elastic` — builds the ZeRO-3 sharded program (the
    optimized plan, or with ``MeshSpec.optimized=False`` the baseline
    plan, where the reference's live run reads no such flag) and drives it
    through the stock ``run()`` loop, so resume, preemption, fault recovery
    and hooks behave as in the single-process path.

Numerics contract (``tests/test_torch_elastic.py``): resuming on the same
mesh is bitwise; on a different mesh the run matches to tight tolerance
(the order of the sums over the ranks is the only difference).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.tree import pytree_leaves, pytree_unflatten, tree_map
from repro_torch.launch.mesh import ProcessMesh, make_mesh
from repro_torch.run.program import StepProgram, build_step_program
from repro_torch.run.spec import MeshSpec, RunSpec
from repro_torch.sharding import rules as R
from repro_torch.sharding.zero import Zero3, leaf_places, rest_places


def sharded_program(spec: RunSpec, mesh: ProcessMesh, *, arch,
                    groups=None, device="cuda", inject=None) -> StepProgram:
    """The ZeRO-3 sharded program of ``spec`` on ``mesh`` (a live or a dry
    mesh): the plan :class:`Zero3` makes of the model's meta params, and
    the step program over it.  ``run_elastic`` trains it and the dry run
    (``launch/dryrun.py``) traces it.  ``spec.mesh.optimized=False``
    builds the paper-faithful baseline plan (``Zero3(optimized=False)``:
    no sequence tile, whole gradients all-reduced), whose params and
    state rest as the optimized plan's."""
    zero = Zero3(mesh, arch.init_params(spec.seed, device="meta"),
                 prefix=getattr(arch.cfg, "n_prefix_tokens", 0),
                 optimized=spec.mesh.optimized)
    return build_step_program(spec, arch, groups=groups, device=device,
                              inject=inject, zero=zero)


def mesh_from_spec(mesh: MeshSpec, device="cuda") -> ProcessMesh:
    """The mesh ``mesh.shape`` names, over this process's world (a world of
    one process is made for a one-position mesh)."""
    if mesh.shape is None:
        raise ValueError("MeshSpec.shape is required for an elastic mesh")
    return make_mesh(mesh.shape, device)


def program_shardings(program: StepProgram, mesh=None) -> tuple:
    """``(params, opt_state, batch, hparams[, sentinel])`` spec trees for
    the program's abstract signature on ``mesh`` (default: the program's
    own; a ``MeshLayout`` will do — nothing is allocated or communicated):
    the params as the sharded step rests them (``zero.rest_places``: the
    rules' places, a vector whole over ``model``), the optimizer state with
    them (r with its param's rows, c with its columns), the batch's as
    ``rules.batch_pspecs`` gives them (the leading dim over the batch axes;
    the model axis' tiles are ``Zero3.rows``'s), the hparams (and the
    sentinel's scalars, when the program carries the guard) replicated."""
    if mesh is None:
        if program.zero is None:
            raise ValueError("program_shardings: the program has no mesh; "
                             "pass one")
        mesh = program.zero.mesh
    axes = R.MeshAxes(mesh)
    meta = program.arch.init_params(program.spec.seed, device="meta")
    state = program.opt.init(meta)
    places = rest_places(meta, axes)
    n_p = len(pytree_leaves(meta))
    o_places = leaf_places(places, tree_map(lambda t: tuple(t.shape), meta),
                           state)[n_p:]

    def spec(ndim, pl):
        return R.P(*["data" if i == pl.data else
                     "model" if i == pl.model else None
                     for i in range(ndim)])

    # the rules' specs less the splits the resting places drop
    p_specs = tree_map(lambda sp, pl: R.P(*[
        ax if i in (pl.data, pl.model) else None
        for i, ax in enumerate(sp)]), R.param_pspecs(meta, axes), places)
    o_specs = pytree_unflatten(state, [
        spec(t.ndim, pl) for t, pl in zip(pytree_leaves(state), o_places)])
    d = program.spec.data
    batch = program.arch.train_batch_specs(d.global_batch, d.seq_len,
                                           packed=d.packing) if d else {}
    b_specs = R.batch_pspecs({k: torch.empty(shp, device="meta")
                              for k, (shp, _) in batch.items()}, axes)
    out = (p_specs, o_specs, b_specs,
           {k: R.P() for k in program.hparams_fn(1)})
    if program.sentinel_enabled:
        out += (R.P(),)
    return out


class ElasticCheckpoints:
    """A CheckpointManager over the same directory whose save gathers the
    run's shards to rank 0 and whose restore gives each rank its slice —
    the runner's resume and fault-recovery paths then place restored state
    without knowing about meshes."""

    def __init__(self, inner, zero: Zero3):
        from repro_torch.checkpoint.manager import CheckpointManager
        if getattr(inner, "zero", None) is not zero:
            inner = CheckpointManager(inner.dir, keep_last=inner.keep_last,
                                      zero=zero)
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)


def run_elastic(spec: RunSpec, *, arch=None, hooks=(), params=None,
                opt_state=None, batch_iter=None, eval_iter=None,
                ckpt_manager=None, start_step: int = 0, groups=None,
                device="cuda", inject=None, log_fn=print):
    """``run()`` with the step executed ZeRO-3 sharded on the
    ``spec.mesh.shape`` mesh of this process's world.

    Called by ``run()`` itself whenever the spec names a mesh shape; the
    signature mirrors ``run()``'s.  Builds the program once, places the
    initial state on the mesh (``params``/``opt_state`` given whole are
    sharded — copies), and hands everything back to the stock loop with a
    checkpoint manager that gathers on save and restores each rank's slice.
    Only rank 0 logs and writes the metrics stream."""
    device = resolve_device(device)
    mesh = mesh_from_spec(spec.mesh, device)
    if arch is None:
        from repro_torch.models.registry import get_arch
        arch = get_arch(spec.model.arch, smoke=spec.model.smoke)
    program = sharded_program(spec, mesh, arch=arch, groups=groups,
                              device=device, inject=inject)
    zero = program.zero
    if params is None:
        params, opt_state = program.init(spec.seed)
    else:
        if opt_state is None:
            opt_state = program.opt.init(params)
        params, opt_state = zero.shard_tree((params, opt_state), opt_state)

    ck = spec.checkpoint
    if ckpt_manager is None and ck.dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        ckpt_manager = CheckpointManager(ck.dir, keep_last=ck.keep_last,
                                         gc_incomplete=ck.gc_incomplete,
                                         zero=zero)
    elif ckpt_manager is not None:
        ckpt_manager = ElasticCheckpoints(ckpt_manager, zero)

    log = log_fn if mesh.rank == 0 else (lambda _msg: None)
    log(f"elastic mesh {mesh.shape} ({mesh.world} ranks, "
        f"{mesh.backend}, {device.type})")

    from repro_torch.run.runner import run
    return run(spec, arch=program.arch, program=program, hooks=hooks,
               params=params, opt_state=opt_state, batch_iter=batch_iter,
               eval_iter=eval_iter, ckpt_manager=ckpt_manager,
               start_step=start_step, groups=groups, device=device,
               log_fn=log)
