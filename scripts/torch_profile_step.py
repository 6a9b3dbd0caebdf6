#!/usr/bin/env python3
"""Where the time of one train step goes on the GPU.

    python3 scripts/torch_profile_step.py [--arch h2o-danube-1.8b]
        [--layers N] [--batch 4] [--seq 1024] [--optimizer adalomo]
        [--packing] [--mesh-shape 1]

Builds the step program of ``repro_torch`` for ``--arch`` (published width;
published depth, or ``--layers`` layers: an encoder-decoder model's encoder
and decoder get ``--layers`` each) with the optimizer's default engine (fused
AdaLomo/LOMO, unfused baselines) and, with ``--packing``, the data
pipeline's segment-packed batches (documents of 64 tokens up to the row),
takes two warm-up steps, times ``--steps``
steps untraced, then traces as many with ``torch.profiler`` and prints one
JSON object: the card and its power limit, wall time per step (untraced),
device-busy time per step (traced), the device's idle share (one minus busy
over untraced wall), device time by kind of kernel, and the largest kernels
by name.  ``--mesh-shape 1`` runs the step ZeRO-3 sharded on a one-rank
NCCL world (this process), the sharded path with every collective a copy:
NCCL's kernels are counted as "collectives".  Needs a CUDA device; ``--out
FILE`` also writes the JSON there.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.run import (ModelSpec, OptSpec, RunSpec, StepSpec,  # noqa: E402
                             build_step_program)
from repro_torch.run.data import make_batch_iter  # noqa: E402
from repro_torch.run.runner import batch_to_device, to_host  # noqa: E402

KINDS = (
    ("optimizer (K1 adalomo_stats)", ("stats_kernel", "fold_kernel")),
    ("optimizer (K2 adalomo_update)", ("adalomo::update_kernel",
                                       "partials_sum_kernel")),
    ("collectives", ("nccl", "Nccl")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas", "gemv", "sm90_xmma",
                "sm80_xmma", "splitK", "splitk")),
    ("softmax", ("softmax",)),
    ("embedding", ("embedding", "indexSelect", "index_select", "sort",
                   "radix", "Radix")),
    ("reduce", ("reduce_kernel", "Reduce")),
    ("copy / cast", ("copy", "Copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b",
                    help="a config of repro_torch.models.registry")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the published one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--optimizer", default="adalomo",
                    help="registry name (repro_torch.core.optimizers)")
    ap.add_argument("--packing", action="store_true",
                    help="segment-packed batches")
    ap.add_argument("--mesh-shape", type=int, default=None, choices=(1,),
                    help="1: the ZeRO-3 sharded step on a one-rank NCCL "
                         "world")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    spec = RunSpec(model=ModelSpec(args.arch),
                   data=DataConfig(vocab=0, seq_len=args.seq,
                                   global_batch=args.batch,
                                   packing=args.packing, min_doc_len=64),
                   opt=OptSpec(name=args.optimizer),
                   steps=StepSpec(total=2 + 2 * args.steps), log_every=0)
    arch = get_arch(args.arch)
    if args.layers is not None:
        depth = (dict(n_enc_layers=args.layers, n_dec_layers=args.layers)
                 if arch.family == "encdec" else dict(n_layers=args.layers))
        arch = dataclasses.replace(
            arch, cfg=dataclasses.replace(arch.cfg, **depth))
    zero = None
    if args.mesh_shape:
        import socket

        import torch.distributed as dist

        from repro_torch.launch.mesh import make_mesh
        from repro_torch.sharding.zero import Zero3
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
        zero = Zero3(make_mesh((args.mesh_shape,), "cuda"),
                     arch.init_params(0, device="meta"))
    program = build_step_program(spec, arch, zero=zero)
    params, state = program.init(0)
    batches = make_batch_iter(spec, arch)

    def step(i):
        nonlocal params, state
        batch = batch_to_device(next(batches), program.device)
        params, state, loss, metrics = program.step(
            params, state, batch, program.hparams_fn(i + 1))
        return to_host(loss, metrics)[0]

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    # untraced wall time first: the profiler slows the host down a lot
    t0 = time.time()
    for i in range(2, 2 + args.steps):
        step(i)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3 / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.time()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(2 + args.steps, 2 + 2 * args.steps):
            loss = step(i)
        torch.cuda.synchronize()
    traced_wall_ms = (time.time() - t0) * 1e3 / args.steps

    by_kind, by_name = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kind_of(ev.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us / 1e3 / args.steps
        by_name[ev.key] = (dev_us / 1e3 / args.steps, ev.count / args.steps)
    busy_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = {
        "card": smi, "torch": torch.__version__,
        "layers": getattr(arch.cfg, "n_layers", None) or [
            arch.cfg.n_enc_layers, arch.cfg.n_dec_layers],
        "batch": args.batch, "seq": args.seq, "optimizer": args.optimizer,
        "fused": program.fused, "packing": args.packing,
        "mesh_shape": [args.mesh_shape] if args.mesh_shape else None,
        "traced_steps": args.steps,
        "loss": loss, "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_while_traced": traced_wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_per_step_by_kind": dict(
            sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms_per_step": ms,
                         "calls_per_step": c} for n, (ms, c) in top],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    if zero is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
