#!/usr/bin/env python3
"""Where the time of one paged decode step goes on the GPU.

    python3 scripts/torch_profile_serve.py [--layers 24] [--batch 8] \
        [--prompt 1024] [--chunks 2]

Builds ``repro_torch.serve.engine.PagedEngine`` for h2o-danube-1.8b
(published width; depth by ``--layers``; bf16, random weights from a seed,
pages of 16, chunks of 8 decode steps), admits ``--batch`` requests of
``--prompt`` tokens, runs two chunks to warm up, times ``--chunks`` chunks
untraced, then traces as many with ``torch.profiler`` and prints one JSON
object: the card and its power limit, wall time per decode step (untraced),
device-busy time per decode step (traced), the device's idle share (one minus
busy over untraced wall), kernels launched per decode step, device time by
kind of kernel, and the largest kernels by name.  Needs a CUDA device;
``--out FILE`` also writes the JSON there.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.serve.engine import PagedEngine, PagedServeConfig  # noqa: E402
from torch_profile_step import kind_of  # noqa: E402

CHUNK = 8


def kind(name: str) -> str:
    if "paged_decode_kernel" in name:
        return "attention (K3 paged_decode_attention)"
    return kind_of(name)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_serve: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    arch = get_arch("h2o-danube-1.8b")
    arch = dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=args.layers))
    params = arch.init_params(0)
    P = 128
    rounds = 2 + 2 * args.chunks
    scfg = PagedServeConfig(page_size=16, max_batch=args.batch,
                            max_pages_per_seq=P,
                            num_pages=1 + args.batch * P, chunk=CHUNK,
                            max_new_tokens=CHUNK * rounds + 1)
    eng = PagedEngine(arch, params, scfg)
    rng = np.random.default_rng(0)
    for _ in range(args.batch):
        eng.submit(rng.integers(1, arch.cfg.vocab, args.prompt).tolist())
    for _ in range(2):                 # admissions, then a plain chunk
        eng.step()
    torch.cuda.synchronize()
    steps = args.chunks * CHUNK
    # untraced wall time first: the profiler slows the host down a lot
    t0 = time.perf_counter()
    for _ in range(args.chunks):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.chunks):
            eng.step()
        torch.cuda.synchronize()

    by_kind, by_name, launches = {}, {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kind(ev.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us / 1e3 / steps
        by_name[ev.key] = (dev_us / 1e3 / steps, ev.count / steps)
        launches += ev.count
    busy_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = {
        "card": smi, "torch": torch.__version__, "layers": args.layers,
        "batch": args.batch, "prompt": args.prompt,
        "traced_decode_steps": steps,
        "cached_tokens_at_end": [int(n) for n in eng._n],
        "wall_ms_per_decode_step": wall_ms,
        "device_busy_ms_per_decode_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_decode_step": launches / steps,
        "device_ms_per_decode_step_by_kind": dict(
            sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:120], "ms_per_step": ms,
                         "calls_per_step": c} for n, (ms, c) in top],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
