#!/usr/bin/env python3
"""Where the legacy engine's prefill and decode step spend GPU time.

    python3 scripts/torch_profile_legacy.py [--layers 24] [--batch 4] \
        [--prompt 6144] [--steps 8] [--out FILE]

Builds ``repro_torch.serve.engine.Engine`` for h2o-danube-1.8b (published
width; depth by ``--layers``; bf16, random weights from a seed), prefills
``--batch`` prompts of ``--prompt`` tokens (past window + 1024 tokens the
prefill takes the sliding-window gather; the ring then holds the window's
4096 slots), then runs the engine's own decode loop (decode step, sample,
one bundled device-to-host copy).  The prefill is traced once; decode steps
are timed ``--steps`` at a time untraced, then traced.  Prints one JSON
object: the card and its power limit, prefill seconds (untraced and its
device time by kind), wall and device-busy ms per decode step, the device's
idle share in decode (one minus busy over untraced wall), kernels launched
per decode step, device time by kind of kernel and the largest kernels.
Needs a CUDA device; ``--out`` also writes the JSON there.
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
from repro_torch.serve.engine import Engine, ServeConfig, _upload  # noqa: E402
from torch_profile_step import kind_of  # noqa: E402


def kind(name: str) -> str:
    if "ring_decode_kernel" in name:
        return "attention (K4 decode_attention)"
    return kind_of(name)


def device_ms_by_kind(prof, per: int) -> tuple:
    """({kind: ms}, {name: (ms, calls)}, launches), each divided by per."""
    by_kind, by_name, launches = {}, {}, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kind(ev.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us / 1e3 / per
        by_name[ev.key] = (dev_us / 1e3 / per, ev.count / per)
        launches += ev.count
    return (dict(sorted(by_kind.items(), key=lambda kv: -kv[1])), by_name,
            launches / per)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=6144)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_legacy: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    arch = get_arch("h2o-danube-1.8b")
    arch = dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=args.layers))
    params = arch.init_params(0)
    eng = Engine(arch, params, ServeConfig(max_new_tokens=0))
    rng = np.random.default_rng(0)
    toks = _upload(rng.integers(1, arch.cfg.vocab,
                                (args.batch, args.prompt)), eng.device)
    done = torch.zeros(args.batch, dtype=torch.bool, device=eng.device)
    eng._prefill(params, {"tokens": toks})          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng._prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng._prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
    prefill_kinds, _, prefill_launches = device_ms_by_kind(prof, 1)
    torch.cuda.reset_peak_memory_stats()
    tok, done = eng._sample_step(logits, torch.zeros_like(done,
                                                          dtype=torch.int32),
                                 done)

    def decode_steps(n, tok, done):
        for _ in range(n):           # Engine.generate's loop, step for step
            torch.stack([tok, done.to(torch.int32)]).cpu()
            lg, _ = eng._decode(params, cache, {"tokens": tok[:, None]})
            tok, done = eng._sample_step(lg, tok, done)
        torch.cuda.synchronize()
        return tok, done

    tok, done = decode_steps(2, tok, done)            # warm-up
    t0 = time.perf_counter()
    tok, done = decode_steps(args.steps, tok, done)
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with torch.profiler.profile(activities=acts) as prof:
        decode_steps(args.steps, tok, done)
    by_kind, by_name, launches = device_ms_by_kind(prof, args.steps)
    busy_ms = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    out = {
        "card": smi, "torch": torch.__version__, "layers": args.layers,
        "batch": args.batch, "prompt": args.prompt,
        "ring_slots": int(cache["pos"].shape[0]),
        "prefill_seconds": prefill_s,
        "prefill_device_ms_by_kind": prefill_kinds,
        "prefill_kernel_launches": prefill_launches,
        "traced_decode_steps": args.steps,
        "wall_ms_per_decode_step": wall_ms,
        "device_busy_ms_per_decode_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_decode_step": launches,
        "device_ms_per_decode_step_by_kind": by_kind,
        "top_kernels": [{"name": n[:120], "ms_per_step": ms,
                         "calls_per_step": c} for n, (ms, c) in top],
        "decode_peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
