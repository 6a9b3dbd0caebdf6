"""Training launcher (PyTorch) — RunSpec parsing + ``run()``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --smoke --steps 100 --optimizer adalomo --batch 8 --seq 128

  PYTHONPATH=src python -m repro_torch.launch.train --spec runspec.json

Runs on the card; ``--device cpu`` asks for the CPU.  The flags are the
reference launcher's (``repro.launch.train``), so one command line or spec
file drives both packages — ``--sentinel*`` (the step guard and its policy
ladder) and ``--observe-*`` (the optimizer-health probes, recorded in the
``--metrics-path`` stream) included.

A run with ``--ckpt-dir D`` that is sent SIGTERM or SIGINT checkpoints at the
next step boundary and exits 75 (``PREEMPTED_EXIT_CODE``); the same command
with ``--resume`` continues it.

Scale-out (ZeRO-3 over the axes of ``--mesh-shape``: ``N`` is ``(data,)``,
``DxM`` ``(data, model)``, ``PxDxM`` ``(pod, data, model)``; a model axis
larger than 1 adds sequence and expert parallelism, for every family;
every ``--optimizer``, fused or unfused, with ``--sentinel*`` and
``--observe-*``):

  * ``--device cpu --virtual-devices N`` spawns N ``gloo`` ranks on the
    host, the counterpart of the reference's host-platform device count
    (``--mesh-shape`` defaults to ``N``; ``--virtual-devices 4
    --mesh-shape 2x2`` is a (data, model) world of four);
  * under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set) each
    process joins an NCCL world on ``cuda:LOCAL_RANK`` (``gloo`` with
    ``--device cpu``);
  * ``--virtual-devices`` on the card without ``torchrun`` raises: ranks
    are processes, one a card;
  * ``--elastic-from CKPT_DIR`` resumes the run from CKPT_DIR onto the
    current mesh (``--mesh-shape`` may name another one).
"""
import os


def _parse(argv):
    import argparse

    from repro_torch.run.spec import add_cli_args

    ap = argparse.ArgumentParser(description=__doc__)
    add_cli_args(ap)
    ap.add_argument("--spec", default=None,
                    help="RunSpec JSON file (overrides the other flags)")
    ap.add_argument("--elastic-from", default=None, metavar="CKPT_DIR",
                    help="resume this run from an existing checkpoint dir "
                         "onto the CURRENT mesh (combine with --mesh-shape "
                         "to restore onto a different rank count)")
    ap.add_argument("--virtual-devices", type=int, default=None,
                    help="with --device cpu: spawn this many gloo ranks on "
                         "the host (the mesh defaults to that many on the "
                         "data axis)")
    ap.add_argument("--history-out", default=None,
                    help="write the training history JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default; fails without a "
                         "card), cuda:N, or cpu")
    return ap.parse_args(argv)


def _spec_of(args):
    import dataclasses

    from repro_torch.run.spec import (MeshSpec, RunSpec, from_cli_args,
                                      parse_mesh_shape)
    if args.spec:
        with open(args.spec) as f:
            spec = RunSpec.from_json(f.read())
    else:
        spec = from_cli_args(args)
    shape = parse_mesh_shape(getattr(args, "mesh_shape", None))
    if shape is None and args.virtual_devices and spec.mesh.shape is None:
        shape = (args.virtual_devices,)
    if shape:
        spec = dataclasses.replace(spec, mesh=MeshSpec(
            kind="multi", optimized=spec.mesh.optimized, shape=shape))
    if args.elastic_from:
        # Elastic restore: point the spec at the existing checkpoints; the
        # sharded restore gives each rank its slice of the full arrays.
        spec = dataclasses.replace(
            spec, checkpoint=dataclasses.replace(
                spec.checkpoint, dir=args.elastic_from, resume=True,
                gc_incomplete=True))
    return spec


def _train(args, spec, device, rank: int = 0) -> int:
    import json

    from repro_torch.fleet.preempt import PREEMPTED_EXIT_CODE, Preempted
    from repro_torch.run import run

    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        result = run(spec, device=device, log_fn=say)
    except Preempted as e:
        # resumable by re-invoking with --resume
        say(f"preempted: checkpointed at step {e.step}; exiting "
            f"{PREEMPTED_EXIT_CODE} (resumable)")
        return PREEMPTED_EXIT_CODE
    if args.history_out and rank == 0:
        with open(args.history_out, "w") as f:
            json.dump(result.history, f)
    if result.history.get("loss"):
        say(f"final loss {result.history['loss'][-1]:.4f}")
    else:
        # --resume found the run already at total_steps: a no-op resume
        say(f"nothing to do: resumed at step {result.start_step} of "
            f"{spec.steps.total}")
    return 0


def _virtual_rank(rank: int, world: int, store: str, argv) -> None:
    """One of ``--virtual-devices`` gloo ranks on the host."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        args = _parse(argv)
        code = _train(args, _spec_of(args), "cpu", rank)
    finally:
        dist.destroy_process_group()
    if code:
        raise SystemExit(code)


def main(argv=None):
    import sys
    import tempfile

    import torch

    args = _parse(argv)
    spec = _spec_of(args)
    device = torch.device(args.device)
    torchrun = all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                             "LOCAL_RANK"))
    if torchrun:
        import torch.distributed as dist
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
        try:
            code = _train(args, spec, device, dist.get_rank())
        finally:
            dist.destroy_process_group()
        if code:
            raise SystemExit(code)
        return
    if args.virtual_devices and device.type != "cpu":
        raise SystemExit(
            f"--virtual-devices {args.virtual_devices} spawns gloo ranks on "
            "the host and needs --device cpu; on cards, start one process a "
            "card under torchrun")
    if args.virtual_devices and args.virtual_devices > 1:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            try:
                mp.spawn(_virtual_rank,
                         args=(args.virtual_devices, os.path.join(tmp, "store"),
                               list(sys.argv[1:] if argv is None else argv)),
                         nprocs=args.virtual_devices)
            except mp.ProcessExitedException as e:
                raise SystemExit(e.exit_code)
        return
    try:
        code = _train(args, spec, device)
    finally:
        # a one-position mesh made this process a world of one
        # (``make_mesh``): close it before exit, not in the interpreter's
        # teardown
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    if code:
        raise SystemExit(code)


if __name__ == "__main__":
    main()
