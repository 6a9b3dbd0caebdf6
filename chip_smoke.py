#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # needs one CUDA device, no arguments

Drives ``repro_torch`` through the entry points a user would call and fails
(non-zero exit, no result line) if any phase fails or there is no CUDA device.
It imports nothing of JAX and nothing of the JAX package.  Phases, each
printing one JSON line:

  env      torch/CUDA versions, the card and its power limit, TF32 settings.
  kernels  builds the CUDA kernels from the sources in this checkout (one
           nvcc per source, all started together) and holds each against its
           plain PyTorch version on the card.  AdaLomo K1/K2: the shapes of
           h2o-danube-1.8b plus ragged ones, for every pairing of fp32 and
           bf16 params and grads; weight decay, the literal mode, a stacked
           [3, m, n] case and a bitwise re-run.  Paged decode attention K3:
           the CPU tests' cases, a danube-shaped ragged case with and without
           a window, danube serving shapes (8 sequences, 32/8 heads, dh 80,
           pages of 16, up to 2048 tokens), shuffled page tables and garbage
           in the scratch page, runs with no live slot (a short sequence in
           a wide table, a window that leaves only the last page, a
           sequence with no token, which must give 0), fp32 (1e-5) and bf16
           (3e-2), a bitwise re-run, and ten launches on the same ticket
           counters at B 1 and B 8 x 2048 tokens, bit-identical.  Ring-cache decode attention K4: the reference kernel
           tests' cases, a dozen ragged rings, danube's shapes (B 8 x W 1024
           and B 4 x W 4096, windows none, 4096 and 256) over partly filled
           rings (empty slots hold large garbage) and wrapped ones, fp32
           (1e-5) and bf16 (3e-2), a bitwise re-run, and ten launches on the
           same ticket counters at B 1 and B 4 x W 4096, bit-identical.  Then
           times kernel and plain version (CUDA events, after warm-up, inputs
           rotated so they are not served from the L2 cache) beside the least
           time the card could take, and, for K4,
           scaled_dot_product_attention on the same inputs (the library call,
           never used by the port); for K3 the two-call library path (the
           pages gathered into a dense cache, then the same call).  All four
           kernels, whose launches at danube's smaller shapes take about
           what their wrappers cost on the host, are timed as replays of a
           CUDA graph, with the eager time beside.
  train    ``repro_torch.run.run(spec)``: h2o-danube-1.8b at its published
           width and depth, random weights from a seed, AdaLomo fused into
           the backward pass, batch 4 x 1024 tokens, 3 steps.  Launch counts
           are set to 0 just before and read just after: 170 tensors a step
           go through each kernel.  One device-to-host transfer a step.
  parity   one fused step at full width and 2 layers, CUDA kernels against the
           plain PyTorch update, from the same weights and batch.
  resume   ``run(spec)`` on h2o-danube-1.8b as in train, 4 steps, with
           checkpoints every 2 steps (3.67 GB each, written under the
           system temp or ``_chip_smoke_tmp/`` and removed), eval every 2
           steps (1 batch), the metrics stream, a heartbeat and a profiler
           window over step 1.  A runs uninterrupted (K1/K2 launch counts
           set to 0 before and read after: 170 a step each; the trace holds
           170 K1 and 340 K2 kernels).  B gets SIGTERM and exits resumable
           at step 2; C resumes it; D's step raises torch.AcceleratorError
           after its 4th call and recovers from the step-2 checkpoint.
           Asserts C's and D's params and OptState bitwise equal to A's,
           their losses and eval losses equal to A's, the marker consumed,
           the metrics stream holding steps 0-3 once, no heartbeat stall.
           Reports each save's and restore's seconds and bytes, the free
           disk, straggler events, step seconds and peak memory.
  serve    ``repro_torch.serve.engine.PagedEngine``: h2o-danube-1.8b at its
           published width and depth, bf16, random weights from a seed;
           pages of 16, 8 slots, 128 pages a sequence, 1025 pages, chunks of
           8, 64 new tokens; 16 requests with prompts of 32-1900 tokens from
           a seed, 8 submitted, the other 8 after the first step (mid-flight
           admission).  Asserts: every request emits 64 tokens, every page
           comes back, K3 launches == 24 x decode steps (counted after the
           warmup), synchronising host transfers == chunks + admissions, no
           input signature the warmup had not run.
  serve_parity  at full width and 2 layers, fp32 and bf16: one decode
           step's logits through K3 against the plain version over the same
           pool (within 1e-3 fp32, 0.1 bf16), and greedy tokens of the
           engine end to end (asserted equal in fp32, reported in bf16).
  legacy_serve  ``repro_torch.serve.engine.Engine``: h2o-danube-1.8b at its
           published width and depth, bf16, random weights from a seed; 4
           prompts of 6144 tokens (prefill through the sliding-window gather,
           a ring of the window's 4096 slots that wraps every step), 64
           greedy tokens.  Asserts: 64 tokens a row inside the vocabulary,
           K4 launches == 24 x 63 decode steps, synchronising host transfers
           == 64 (one a step).
  legacy_parity  at full width and 2 layers, fp32 and bf16, after prefills of
           1024, 3072 and 6144 tokens (direct, blockwise and window-gather
           attention): one decode step's logits through K4 against the plain
           version over the same cache (1e-3 fp32, 0.1 bf16), greedy tokens
           of Engine (asserted equal in fp32, reported in bf16); then, fp32
           at danube's heads and 4096 tokens, the flash branch's value and
           gradients against direct attention's autograd.

Then the card's name and power limit, one JSON line that lists the kernels
with their measured numbers, and the result line.

``--phases timing`` (not in the default run) times the kernels as the
kernels phase does, without its checks, and prints digests of their outputs
on seeded inputs; with ``--src DIR`` it imports ``repro_torch`` from another
tree, so that one call can time a parent commit and this one with the same
script (parent, change, change, parent) and show which kernels' outputs
stayed bit-identical.

Matrix products stay full fp32 for fp32 inputs: TF32 is switched off here,
for matmul (PyTorch's default) and for cuDNN (not its default).

The whole-step re-run is reported, not asserted: the hand-written kernels
are bit-reproducible (asserted in ``kernels``), the token-embedding gradient
goes through ``F.embedding``'s sorted, fixed-order backward, and what is
left is cuBLAS, which this script does not vouch for.
"""
import argparse
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available() "
                     "is False); this script measures on the GPU only\n")
    sys.exit(1)

# --src DIR imports repro_torch from another tree (a parent commit unpacked
# beside this one), so that this script times both in one process's terms
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
for _i, _arg in enumerate(sys.argv[1:], 1):
    if _arg.startswith("--src="):
        SRC = os.path.abspath(_arg.split("=", 1)[1])
    elif _arg == "--src" and _i + 1 < len(sys.argv):
        SRC = os.path.abspath(sys.argv[_i + 1])
sys.path.insert(0, SRC)

import numpy as np  # noqa: E402

from repro_torch.core import optimizers as opt_lib  # noqa: E402
from repro_torch.core.adalomo import AdaLomoConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.adalomo_update import adalomo_update as K  # noqa: E402
from repro_torch.kernels.adalomo_update.ops import adalomo_update  # noqa: E402
from repro_torch.kernels.adalomo_update.ref import adalomo_step_ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as KD  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    paged_decode_attention_ref, ring_decode_attention_ref)
from repro_torch.models import layers as ML  # noqa: E402
from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.run import (ModelSpec, OptSpec, RunSpec, StepSpec,  # noqa: E402
                             TimingHook, run)
from repro_torch.serve.engine import (Engine, PagedEngine,  # noqa: E402
                                      PagedServeConfig, ServeConfig)
from repro_torch.serve.paging import build_block_tables  # noqa: E402

DEV = torch.device("cuda", 0)
ARCH_ID = "h2o-danube-1.8b"

# Published peaks of one H100 SXM: memory rate, and fp32 outside the tensor
# cores (both kernels do plain fp32 arithmetic).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Operations per element: K1 squares, adds eps and adds into two sums; K2 (in
# each of its two passes) forms v_hat, a square root, a division and the sums
# or the write.
K1_FLOP_PER_ELEM = 4
K2_FLOP_PER_ELEM = 13

# Per layer: wq, wo (2560, 2560); wk, wv (2560, 640); w_gate, w_up
# (2560, 6912); w_down (6912, 2560).  Outside: tok_embed, head.
N_LAYERS = 24
DANUBE_SHAPES = {(2560, 2560): 2 * N_LAYERS, (2560, 640): 2 * N_LAYERS,
                 (2560, 6912): 2 * N_LAYERS, (6912, 2560): N_LAYERS,
                 (32000, 2560): 1, (2560, 32000): 1}
TENSORS_PER_STEP = sum(DANUBE_SHAPES.values())          # 170
RAGGED_SHAPES = [(300, 700), (128, 130), (1000, 96), (16, 4096)]
DTYPE_PAIRS = [(torch.float32, torch.float32),       # (param, grad)
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32)]
# Tolerances of the reference's kernel tests: params 1e-5 in fp32, 5e-3
# where a bf16 value is stored (one bf16 rounding at the write); r and c
# rtol 3e-5 / atol 1e-5 (another summation order).
TOL_P = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
TOL_RC = dict(rtol=3e-5, atol=1e-5)

CFG = AdaLomoConfig()


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def make_inputs(shape, pdt, gdt, seed, step, lead=()):
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    full = tuple(lead) + tuple(shape)
    p = (torch.randn(full, generator=g, device=DEV) * 0.1).to(pdt)
    gr = (torch.randn(full, generator=g, device=DEV) * 0.3).to(gdt)
    live = 1e-2 if step > 1 else 0.0
    r = torch.rand(full[:-1], generator=g, device=DEV) * live
    c = torch.rand(full[:-2] + full[-1:], generator=g, device=DEV) * live
    return p, gr, r, c


def scal_for(r, lr, step, beta, wd, clip):
    """The [.., 4] scalar buffer of K2, as ``ops.adalomo_update`` forms it."""
    denom = torch.clamp_min(r.sum(dim=-1), CFG.eps_stat)
    corr = max(1.0 - beta ** step, CFG.eps_stat)
    inv = 1.0 / (denom * corr)
    return torch.stack([inv, torch.full_like(inv, lr),
                        torch.full_like(inv, 1.0 - lr * wd),
                        torch.full_like(inv, clip)], dim=-1)


def max_err(a, b) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())


def assert_close(a, b, *, rtol, atol, what):
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    bad = (a32 - b32).abs() > atol + rtol * b32.abs()
    if bool(bad.any()) or not bool(torch.isfinite(a32).all()):
        raise AssertionError(
            f"{what}: kernel and plain version disagree "
            f"(max abs err {max_err(a, b):.3e}, rtol {rtol}, atol {atol})")


def check_kernels(errs: dict) -> int:
    """K1 and K2, each against its plain version on the same inputs."""
    n = 0
    beta, lr = 0.999, 5e-4
    beta_t = torch.full((), beta, device=DEV)
    for shape in list(DANUBE_SHAPES) + RAGGED_SHAPES:
        for pdt, gdt in DTYPE_PAIRS:
            for step in (1.0, 5.0):
                p, g, r, c = make_inputs(shape, pdt, gdt,
                                         shape[0] * 7 + shape[1], step)
                what = f"{shape} {pdt}/{gdt} step {step}"
                # K1
                want_r, want_c = K.adalomo_stats_ref(g, r, c, beta_t,
                                                     eps_stat=CFG.eps_stat)
                K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
                assert_close(r, want_r, what="adalomo_stats r " + what,
                             **TOL_RC)
                assert_close(c, want_c, what="adalomo_stats c " + what,
                             **TOL_RC)
                errs["adalomo_stats"] = max(errs["adalomo_stats"],
                                            max_err(r, want_r),
                                            max_err(c, want_c))
                # K2, on the r', c' that K1 just wrote
                scal = scal_for(r, lr, step, beta, 0.0, 1.0)
                want_p = K.adalomo_update_ref(
                    p, g, r, c, scal, eps_div=CFG.eps_div,
                    eps_rms=CFG.eps_rms, literal=False)
                K.adalomo_update(p, g, r, c, scal, eps_div=CFG.eps_div,
                                 eps_rms=CFG.eps_rms, literal=False)
                assert_close(p, want_p, rtol=TOL_P[pdt], atol=TOL_P[pdt],
                             what="adalomo_update " + what)
                errs["adalomo_update"] = max(errs["adalomo_update"],
                                             max_err(p, want_p))
                n += 1
    torch.cuda.synchronize()
    return n


def check_op_variants() -> dict:
    """The whole op (K1, glue, K2) against the port's oracle: weight decay,
    the literal mode, a stacked [3, m, n] tensor, and a bitwise re-run."""
    out = {}
    cases = {"weight_decay": dict(lr=0.1, wd=0.5, cfg=CFG, lead=()),
             "literal": dict(lr=1e-3, wd=0.0,
                             cfg=AdaLomoConfig(literal_div_v=True), lead=()),
             "stacked": dict(lr=1e-3, wd=0.1, cfg=CFG, lead=(3,))}
    for name, kw in cases.items():
        p, g, r, c = make_inputs((300, 700), torch.float32, torch.float32,
                                 11, 2.0, lead=kw["lead"])
        want = adalomo_step_ref(p, g, r, c, lr=kw["lr"], step=2.0,
                                weight_decay=kw["wd"], cfg=kw["cfg"])
        adalomo_update(p, g, r, c, kw["lr"], 2.0, 0.999, kw["wd"], 1.0,
                       cfg=kw["cfg"])
        assert_close(p, want[0], rtol=2e-5, atol=2e-6, what=f"op {name} p")
        assert_close(r, want[1], rtol=2e-5, atol=2e-7, what=f"op {name} r")
        assert_close(c, want[2], rtol=2e-5, atol=2e-7, what=f"op {name} c")
        out[name] = max_err(p, want[0])
    runs = []
    for _ in range(2):
        p, g, r, c = make_inputs((2560, 6912), torch.bfloat16, torch.bfloat16,
                                 5, 3.0)
        adalomo_update(p, g, r, c, 5e-4, 3.0, 0.999, 0.01, 1.0)
        runs.append((p, r, c))
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    if not bitwise:
        raise AssertionError("the same inputs did not give bit-identical "
                             "outputs on a re-run")
    out["rerun_bitwise"] = bitwise
    return out


def time_ms(fn, sets, rounds: int) -> float:
    """Mean device time of ``fn(*set)`` over ``rounds`` passes over ``sets``."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        for s in sets:
            fn(*s)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (rounds * len(sets))


def time_graph_ms(fn, sets, rounds: int) -> float:
    """Mean device time of ``fn(*set)``, from one CUDA graph of ``rounds``
    passes over ``sets``, replayed: the host's cost per call (the wrapper's
    checks and allocations, the launch itself) drops out, which matters for
    calls that take tens of microseconds on the device."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            for s in sets:
                fn(*s)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (rounds * len(sets))


def time_kernels() -> tuple:
    """Per danube shape, bf16 params and grads (what the train step passes):
    kernel, plain-version and bound, in ms, and per step (x the shape's
    count of the 170 tensors).  Kernel and plain version are timed as
    replays of a CUDA graph, because at danube's smaller shapes an eager
    launch takes about what the wrapper costs on the host; eager_ms is the
    kernel launched one call after another from the host."""
    rows = []
    beta_t = torch.full((), 0.999, device=DEV)
    kw2 = dict(eps_div=CFG.eps_div, eps_rms=CFG.eps_rms, literal=False)

    def k1(p, g, r, c, s):
        K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)

    def k1_plain(p, g, r, c, s):
        K.adalomo_stats_ref(g, r, c, beta_t, eps_stat=CFG.eps_stat)

    def k2(p, g, r, c, s):
        K.adalomo_update(p, g, r, c, s, **kw2)

    def k2_plain(p, g, r, c, s):
        K.adalomo_update_ref(p, g, r, c, s, **kw2)

    for shape, count in DANUBE_SHAPES.items():
        m, n = shape
        set_bytes = 2 * m * n * 2
        copies = min(32, max(2, math.ceil(192e6 / set_bytes)))
        sets = []
        for i in range(copies):
            p, g, r, c = make_inputs(shape, torch.bfloat16, torch.bfloat16,
                                     i, 5.0)
            K.adalomo_stats(g, r, c, beta_t, eps_stat=CFG.eps_stat)
            sets.append((p, g, r, c, scal_for(r, 5e-4, 5.0, 0.999, 0.0, 1.0)))
        rounds = max(2, min(20, 200 // copies))
        state_bytes = 4 * (m + n)
        k1_bytes = m * n * 2 + 2 * state_bytes          # g; r, c in and out
        k2_bytes = 3 * m * n * 2 + state_bytes + 16     # theta in/out, g
        row = {"shape": list(shape), "per_step": count}
        for key, fn, plain, nbytes, flop in (
                ("stats", k1, k1_plain, k1_bytes, K1_FLOP_PER_ELEM),
                ("update", k2, k2_plain, k2_bytes, K2_FLOP_PER_ELEM)):
            row[key + "_ms"] = time_graph_ms(fn, sets, rounds)
            row[key + "_eager_ms"] = time_ms(fn, sets, rounds)
            row[key + "_plain_ms"] = time_graph_ms(plain, sets, rounds)
            row[key + "_bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                         flop * m * n / FP32_FLOP_PER_S) * 1e3
        rows.append(row)
        del sets
        torch.cuda.empty_cache()

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in rows)

    totals = {name: {k: per_step(f"{key}_{k}")
                     for k in ("ms", "eager_ms", "plain_ms", "bound_ms")}
              for name, key in (("adalomo_stats", "stats"),
                                ("adalomo_update", "update"))}
    return rows, totals


def phase_kernels() -> dict:
    t0 = time.time()
    libs = [(K.LIB_NAME, K.SOURCES), (KD.LIB_NAME, KD.SOURCES)]
    build.load_libraries(libs)         # every nvcc at once, from the sources
    K._library()
    KD._library()
    build_s = time.time() - t0
    usage = {}
    for name, sources in libs:
        log = build.build_dir(name, list(sources)) / "build.log"
        lines = log.read_text().splitlines() if log.exists() else []
        usage[name] = sorted({ln.split(":", 1)[-1].strip() for ln in lines
                              if "registers" in ln or "spill" in ln})
    errs = {"adalomo_stats": 0.0, "adalomo_update": 0.0,
            "paged_decode_attention": 0.0, "decode_attention": 0.0}
    n_cases = check_kernels(errs)
    variants = check_op_variants()
    k3_cases, k3_bitwise = check_k3(errs)
    k4_cases, k4_bitwise = check_k4(errs)
    rows, totals = time_kernels()
    k3_rows, totals["paged_decode_attention"] = time_k3()
    k4_rows, totals["decode_attention"] = time_k4()
    emit("kernels", kernels=["adalomo_stats", "adalomo_update",
                             "paged_decode_attention", "decode_attention"],
         build_seconds=build_s, ptxas=usage, cases=n_cases,
         max_abs_err=errs, op_variants=variants,
         tolerances={"param_fp32": 1e-5, "param_bf16": 5e-3, "r_c": TOL_RC,
                     "paged_fp32": 1e-5, "paged_bf16": 3e-2,
                     "ring_fp32": 1e-5, "ring_bf16": 3e-2},
         timing_dtype="bf16 param, bf16 grad", per_shape=rows,
         per_step_of_170_tensors={k: totals[k] for k in
                                  ("adalomo_stats", "adalomo_update")},
         paged_cases=k3_cases, paged_rerun_bitwise=k3_bitwise,
         paged_per_shape_bf16=k3_rows,
         paged_per_decode_step_B8_n1024=totals["paged_decode_attention"],
         ring_cases=k4_cases, ring_rerun_bitwise=k4_bitwise,
         ring_per_shape_bf16=k4_rows,
         ring_per_decode_step_B4_W4096=totals["decode_attention"])
    return {"errs": errs, "totals": totals}


# --------------------------------------------------------------------------
# K3: paged decode attention
# --------------------------------------------------------------------------

# (B, H, K, dh, page_size, P, window, seq_lens): the CPU tests' cases, a
# danube-shaped ragged case with and without a window; danube serving shapes
# (8 sequences, 32/8 heads, dh 80, pages of 16, up to 2048 tokens) are added
# in check_k3.  seq_lens include the token being decoded.
K3_CASES = [
    (3, 8, 2, 64, 8, 4, None, (19, 9, 25)),
    (2, 4, 4, 32, 16, 2, None, (1, 32)),
    (4, 8, 8, 64, 4, 8, 6, (30, 3, 17, 8)),
    (1, 16, 4, 128, 8, 3, None, (24,)),
    (5, 32, 8, 80, 16, 19, None, (1, 15, 16, 17, 300)),
    (5, 32, 8, 80, 16, 19, 6, (1, 15, 16, 17, 300)),
    # runs with no live slot: a short sequence in a wide table, a window that
    # leaves only the last page, a sequence with none
    (3, 8, 2, 64, 8, 16, 5, (3, 100, 128)),
    (2, 32, 8, 80, 16, 64, 16, (2, 1024)),
    (8, 32, 8, 80, 16, 128, 16, (0, 2, 17, 33, 700, 1024, 2047, 2048)),
]
# The reference's paged-attention tolerances (rtol = atol): fp32 1e-5; bf16
# 3e-2, where the plain version rounds the probabilities to bf16 before the
# weighted sum and the kernel keeps them in fp32.
K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
SERVE_WINDOW = 4096                 # h2o-danube-1.8b's sliding window


def k3_inputs(B, H, Kh, dh, ps, P, seq_lens, dtype, seed):
    """q, k/v pages, block tables and lengths.  Each sequence's pages are a
    shuffled draw from the pool and its table's tail points at the scratch
    page 0, which holds large garbage; every slot no live token uses holds
    random values.  Nothing a kernel must mask is zero."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    N = 1 + B * P
    q = torch.randn((B, H, dh), generator=g, device=DEV).to(dtype)
    kp = torch.randn((N, ps, Kh, dh), generator=g, device=DEV)
    vp = torch.randn((N, ps, Kh, dh), generator=g, device=DEV)
    kp[0] = 1e4
    vp[0] = -1e4
    bt = (torch.randperm(N - 1, generator=g, device=DEV) + 1).to(
        torch.int32).view(B, P)
    for b, n in enumerate(seq_lens):
        bt[b, -(-n // ps):] = 0
    sl = torch.tensor(seq_lens, dtype=torch.int32, device=DEV)
    return q, kp.to(dtype), vp.to(dtype), bt, sl


def check_k3(errs: dict) -> tuple:
    """K3 against its plain version at every case, fp32 and bf16, and a
    bitwise re-run at the danube serving shape."""
    rng = np.random.default_rng(3)
    serve_lens = tuple(int(x) for x in rng.integers(1, 2049, 6)) + (1, 2048)
    cases = K3_CASES + [(8, 32, 8, 80, 16, 128, w, serve_lens)
                        for w in (None, SERVE_WINDOW, 100)]
    n = 0
    for i, (B, H, Kh, dh, ps, P, window, lens) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, sl = k3_inputs(B, H, Kh, dh, ps, P, lens, dtype,
                                          100 + i)
            want = paged_decode_attention_ref(q, kp, vp, bt, sl,
                                              window=window)
            got = KD.paged_decode_attention(q, kp, vp, bt, sl, window=window)
            # a sequence with no token: the kernel gives 0, the plain
            # version mean(V); the others are compared
            live = torch.tensor(lens, device=DEV) > 0
            if bool((got[~live] != 0).any()):
                raise AssertionError(f"paged_decode_attention case {i}: a "
                                     "sequence with no token is not 0")
            got, want = got[live], want[live]
            tol = K3_TOL[dtype]
            assert_close(got, want, rtol=tol, atol=tol,
                         what=f"paged_decode_attention case {i} {dtype}")
            errs["paged_decode_attention"] = max(
                errs["paged_decode_attention"], max_err(got, want))
            n += 1
    q, kp, vp, bt, sl = k3_inputs(8, 32, 8, 80, 16, 128, serve_lens,
                                  torch.bfloat16, 7)
    a = KD.paged_decode_attention(q, kp, vp, bt, sl, window=SERVE_WINDOW)
    b = KD.paged_decode_attention(q, kp, vp, bt, sl, window=SERVE_WINDOW)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("paged_decode_attention: the same inputs did "
                             "not give bit-identical outputs on a re-run")
    # Ten launches back to back on the same ticket counters: each must find
    # them at 0, as the last run of the launch before left them.
    for B in (1, 8):
        args = k3_inputs(B, 32, 8, 80, 16, 128, (2048,) * B, torch.bfloat16,
                         20 + B)
        outs = [KD.paged_decode_attention(*args, window=SERVE_WINDOW)
                for _ in range(10)]
        torch.cuda.synchronize()
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"paged_decode_attention B{B} n2048: ten "
                                 "launches on reused counters were not "
                                 "bit-identical")
    return n, True


def k3_bound_ms(B, H, Kh, dh, ps, seq_lens, window, elt) -> float:
    """Least time for the function: live K/V rows read once, q read and
    out written once, the used block-table entries and lengths; or its
    operations on the fp32 units, whichever is larger."""
    live = [min(n, window) if window else n for n in seq_lens]
    nbytes = (sum(live) * Kh * dh * 2 * elt + 2 * B * H * dh * elt
              + 4 * sum(-(-n // ps) for n in seq_lens) + 4 * B)
    # per cached token and query head: q.k and p.v (2 dh each as
    # multiply-adds) and the online softmax's handful
    ops = sum(live) * H * (4 * dh + 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3


def k3_library(q, kp, vp, bt, mask):
    """The two-call library path for K3's function, never used by the port:
    gather the pages into a dense [B, P * ps, K, dh] cache (one indexing
    call each for K and V), then scaled_dot_product_attention with
    enable_gqa and a boolean mask [B, 1, 1, P * ps] made beforehand."""
    B, P = bt.shape
    _, ps, Kh, dh = kp.shape
    idx = bt.long()
    kc = kp[idx].view(B, P * ps, Kh, dh).transpose(1, 2)
    vc = vp[idx].view(B, P * ps, Kh, dh).transpose(1, 2)
    return F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                          attn_mask=mask, enable_gqa=True)


def time_k3() -> tuple:
    """bf16 at danube serving shapes (32/8 heads, dh 80, pages of 16, the
    model's window): kernel, plain version, the two-call library path
    (``k3_library``) and bound per launch, in ms.  K3 takes tens of
    microseconds, about what its wrapper costs on the host, so all three
    are timed as replays of a CUDA graph; eager_ms is the kernel launched
    one call after another from the host."""
    rng = np.random.default_rng(5)
    shapes = {"B8 n1024": (1024,) * 8, "B8 n2048": (2048,) * 8,
              "B8 ragged<=2048": tuple(int(x) for x in
                                       rng.integers(1, 2049, 8)),
              "B1 n2048": (2048,)}
    H, Kh, dh, ps = 32, 8, 80, 16
    rows = {}
    for name, lens in shapes.items():
        B, P = len(lens), -(-max(lens) // ps)
        set_bytes = (1 + B * P) * ps * Kh * dh * 2 * 2
        copies = min(16, max(2, math.ceil(200e6 / set_bytes)))
        sets = [k3_inputs(B, H, Kh, dh, ps, P, lens, torch.bfloat16, 50 + c)
                for c in range(copies)]
        rounds = max(2, 64 // copies)

        def kernel(q, kp, vp, bt, sl):
            return KD.paged_decode_attention(q, kp, vp, bt, sl,
                                             window=SERVE_WINDOW)

        eager = time_ms(kernel, sets, rounds)
        ms = time_graph_ms(kernel, sets, rounds)
        plain = time_graph_ms(
            lambda q, kp, vp, bt, sl: paged_decode_attention_ref(
                q, kp, vp, bt, sl, window=SERVE_WINDOW), sets, rounds)
        pos = torch.arange(P * ps, device=DEV)
        lens_t = torch.tensor(lens, device=DEV)
        mask = ((pos[None] < lens_t[:, None])
                & (lens_t[:, None] - 1 - pos[None] < SERVE_WINDOW))
        lib_sets = [(q, kp, vp, bt, mask[:, None, None])
                    for q, kp, vp, bt, _ in sets]
        library = time_graph_ms(k3_library, lib_sets, rounds)
        rows[name] = {"seq_lens": list(lens), "S": paged_split_of(B, P),
                      "ms": ms, "eager_ms": eager, "plain_ms": plain,
                      "library_ms": library,
                      "library_calls": "2 (page gather, then SDPA)",
                      "bound_ms": k3_bound_ms(B, H, Kh, dh, ps, lens,
                                              SERVE_WINDOW, 2)}
        del sets, lib_sets
        torch.cuda.empty_cache()
    step = rows["B8 n1024"]
    total = {k: step[k] * N_LAYERS
             for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                       "library_ms")}
    return rows, total


def paged_split_of(B, P):
    """K3's runs a sequence at danube's heads and pages of 16, where the
    tree under test has a split (None before it had one)."""
    split = getattr(KD, "paged_split", None)
    return split(B, 8, P, 16) if split else None


# --------------------------------------------------------------------------
# K4: decode attention over a ring cache
# --------------------------------------------------------------------------

# (B, W, H, K, dh, window, cur): the reference kernel tests' CASES; a dozen
# ragged rings and danube's serving shapes are added in check_k4.
K4_CASES = [
    (2, 128, 8, 2, 64, None, 100),
    (1, 300, 4, 4, 128, None, 250),
    (3, 512, 16, 4, 64, 64, 400),
    (2, 64, 8, 8, 32, None, 10),
    (1, 1024, 32, 8, 128, 256, 900),
]


def k4_inputs(B, W, H, Kh, dh, cur, dtype, seed, wrapped=False):
    """q, k/v caches [B, W, K, dh], kv_pos [W] and q_pos.  A partly filled
    ring holds positions 0..cur in slots 0..cur and -1 after them, whose
    slots hold large garbage; a wrapped ring holds the last W positions up
    to cur, rotated: slot (p - 1) % W holds position p."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    q = torch.randn((B, H, dh), generator=g, device=DEV).to(dtype)
    kc = torch.randn((B, W, Kh, dh), generator=g, device=DEV)
    vc = torch.randn((B, W, Kh, dh), generator=g, device=DEV)
    slots = torch.arange(W, device=DEV)
    if wrapped:
        pos = cur - W + 1 + torch.remainder(slots - cur, W)
    else:
        pos = torch.where(slots <= cur, slots, -1)
        kc[:, pos < 0] = 1e4
        vc[:, pos < 0] = -1e4
    q_pos = torch.full((), cur, dtype=torch.int32, device=DEV)
    return q, kc.to(dtype), vc.to(dtype), pos.to(torch.int32), q_pos


def k4_cases() -> list:
    """(B, W, H, K, dh, window, cur, wrapped) for every K4 check."""
    rng = np.random.default_rng(4)
    cases = [c + (False,) for c in K4_CASES]
    for _ in range(12):
        W = int(rng.integers(16, 401))
        Kh, G = (int(x) for x in rng.choice([1, 2, 4], 2))
        dh = int(rng.choice(KD.HEAD_DIMS))
        cases.append((2, W, Kh * G, Kh, dh, None, max(W // 2, 1), False))
    for B, W in ((8, 1024), (4, 4096)):
        for window in (None, SERVE_WINDOW, 256):
            cases.append((B, W, 32, 8, 80, window, W - 200, False))
            cases.append((B, W, 32, 8, 80, window, W + 2047, True))
    return cases


def check_k4(errs: dict) -> tuple:
    """K4 against its plain version at every case, fp32 and bf16, and a
    bitwise re-run at danube's deep ring."""
    n = 0
    for i, (B, W, H, Kh, dh, window, cur, wrapped) in enumerate(k4_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, kc, vc, pos, q_pos = k4_inputs(B, W, H, Kh, dh, cur, dtype,
                                              200 + i, wrapped)
            want = ring_decode_attention_ref(q, kc, vc, pos, q_pos,
                                             window=window)
            got = KD.decode_attention(q, kc, vc, pos, q_pos, window=window)
            tol = K3_TOL[dtype]
            assert_close(got, want, rtol=tol, atol=tol,
                         what=f"decode_attention case {i} {dtype}")
            errs["decode_attention"] = max(errs["decode_attention"],
                                           max_err(got, want))
            n += 1
    args = k4_inputs(4, 4096, 32, 8, 80, 6143, torch.bfloat16, 8, True)
    a = KD.decode_attention(*args, window=SERVE_WINDOW)
    b = KD.decode_attention(*args, window=SERVE_WINDOW)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError("decode_attention: the same inputs did not give "
                             "bit-identical outputs on a re-run")
    # Ten launches back to back on the same ticket counters: each must find
    # them at 0, as the last run of the launch before left them.
    for B in (1, 4):
        args = k4_inputs(B, 4096, 32, 8, 80, 6143, torch.bfloat16, 9 + B,
                         True)
        outs = [KD.decode_attention(*args, window=SERVE_WINDOW)
                for _ in range(10)]
        torch.cuda.synchronize()
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"decode_attention B{B} W4096: ten launches "
                                 "on reused counters were not bit-identical")
    return n, True


def k4_bound_ms(B, H, Kh, dh, W, n_valid, elt) -> float:
    """Least time for the function: the valid K/V rows read once, q read,
    out written, kv_pos and q_pos read; or its operations on the fp32
    units, whichever is larger."""
    nbytes = (B * n_valid * Kh * dh * 2 * elt + 2 * B * H * dh * elt
              + 4 * W + 4)
    ops = B * n_valid * H * (4 * dh + 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S) * 1e3


def time_k4() -> tuple:
    """bf16, danube's heads (32 query / 8 KV, dh 80) and window, a wrapped
    ring whose every slot is valid (the legacy engine's steady state):
    kernel, plain version, bound and the library call per launch, in ms.
    The library call is scaled_dot_product_attention of q [B, H, 1, dh]
    against the cache's [B, K, W, dh] views with enable_gqa and a boolean
    mask made before the timed region.  K4 takes tens of microseconds, about
    what its wrapper costs on the host, so all three are timed as replays of
    a CUDA graph; eager_ms is the kernel's time launched one call after
    another from the host."""
    H, Kh, dh = 32, 8, 80
    rows = {}
    for name, (B, W) in {"B8 W1024": (8, 1024), "B4 W4096": (4, 4096),
                         "B1 W4096": (1, 4096)}.items():
        cur = W + 2047
        set_bytes = 2 * B * W * Kh * dh * 2
        copies = min(16, max(2, math.ceil(200e6 / set_bytes)))
        sets = [k4_inputs(B, W, H, Kh, dh, cur, torch.bfloat16, 60 + c, True)
                for c in range(copies)]
        rounds = max(2, 64 // copies)

        def kernel(q, kc, vc, pos, qp):
            return KD.decode_attention(q, kc, vc, pos, qp,
                                       window=SERVE_WINDOW)

        eager = time_ms(kernel, sets, rounds)
        ms = time_graph_ms(kernel, sets, rounds)
        plain = time_graph_ms(
            lambda q, kc, vc, pos, qp: ring_decode_attention_ref(
                q, kc, vc, pos, qp, window=SERVE_WINDOW), sets, rounds)
        valid = (sets[0][3] >= 0) & (sets[0][3] <= cur) & (
            cur - sets[0][3] < SERVE_WINDOW)
        lib_sets = [(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                     valid.view(1, 1, 1, W)) for q, kc, vc, _, _ in sets]
        library = time_graph_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True), lib_sets, rounds)
        n_valid = int(valid.sum())
        rows[name] = {"B": B, "W": W, "valid_slots": n_valid, "ms": ms,
                      "eager_ms": eager, "plain_ms": plain,
                      "library_ms": library,
                      "bound_ms": k4_bound_ms(B, H, Kh, dh, W, n_valid, 2)}
        del sets, lib_sets
        torch.cuda.empty_cache()
    step = rows["B4 W4096"]
    total = {k: step[k] * N_LAYERS
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return rows, total


# --------------------------------------------------------------------------
# timing: the kernels' times alone, and digests of their outputs
# --------------------------------------------------------------------------

def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def output_digests() -> dict:
    """sha256 of each kernel's output on inputs made from seeds on the card,
    at danube's shapes.  Run against two trees (``--src``), equal digests
    show that a change left a kernel bit-identical.  K2 is fed r and c from
    the plain statistics, so that its digest does not depend on K1's."""
    out = {}
    beta_t = torch.full((), 0.999, device=DEV)
    for m, n in DANUBE_SHAPES:
        p, g, r, c = make_inputs((m, n), torch.bfloat16, torch.bfloat16, 1,
                                 5.0)
        r, c = K.adalomo_stats_ref(g, r, c, beta_t, eps_stat=CFG.eps_stat)
        r2, c2 = r.clone(), c.clone()
        K.adalomo_stats(g, r2, c2, beta_t, eps_stat=CFG.eps_stat)
        out[f"adalomo_stats {m}x{n}"] = digest(torch.cat([r2, c2]))
        K.adalomo_update(p, g, r, c, scal_for(r, 5e-4, 5.0, 0.999, 0.0, 1.0),
                         eps_div=CFG.eps_div, eps_rms=CFG.eps_rms,
                         literal=False)
        out[f"adalomo_update {m}x{n}"] = digest(p)
    for B, W in ((8, 1024), (4, 4096), (1, 4096)):
        for wrapped, cur in ((True, W + 2047), (False, W - 200)):
            args = k4_inputs(B, W, 32, 8, 80, cur, torch.bfloat16, 70,
                             wrapped)
            out[f"decode_attention B{B} W{W} cur{cur}"] = digest(
                KD.decode_attention(*args, window=SERVE_WINDOW))
    for B, n in ((8, 1024), (8, 2048), (1, 2048)):
        args = k3_inputs(B, 32, 8, 80, 16, 128, (n,) * B, torch.bfloat16, 71)
        out[f"paged_decode_attention B{B} n{n}"] = digest(
            KD.paged_decode_attention(*args, window=SERVE_WINDOW))
    torch.cuda.synchronize()
    return out


def phase_timing() -> None:
    """The kernels phase's timings without its checks, and the outputs'
    digests: the same script times a parent tree (``--src``) and this one
    in one call (parent, change, change, parent)."""
    t0 = time.time()
    build.load_libraries([(K.LIB_NAME, K.SOURCES), (KD.LIB_NAME, KD.SOURCES)])
    build_s = time.time() - t0
    rows, totals = time_kernels()
    k3_rows, totals["paged_decode_attention"] = time_k3()
    k4_rows, totals["decode_attention"] = time_k4()
    emit("timing", src=SRC, build_seconds=build_s, per_shape=rows,
         totals=totals, paged_per_shape_bf16=k3_rows,
         ring_per_shape_bf16=k4_rows, digests=output_digests())


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def phase_train(steps: int = 3) -> dict:
    spec = RunSpec(model=ModelSpec(ARCH_ID, smoke=False),
                   data=DataConfig(vocab=0, seq_len=1024, global_batch=4,
                                   seed=0),
                   opt=OptSpec(name="adalomo"),          # backend auto -> cuda
                   steps=StepSpec(total=steps), log_every=1, seed=0)
    timing = TimingHook()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            K.adalomo_stats.launches = 0
            K.adalomo_update.launches = 0
            result = run(spec, hooks=[timing],
                         log_fn=lambda s: print("  " + s, flush=True))
            launches = {"adalomo_stats": K.adalomo_stats.launches,
                        "adalomo_update": K.adalomo_update.launches}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    losses = result.history["loss"]
    params = tree_leaves(result.params)
    n_params = sum(p.numel() for p in params)
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    emit("train", arch=ARCH_ID, n_layers=result.program.arch.cfg.n_layers,
         n_params=n_params, batch=4, seq=1024, steps=steps, losses=losses,
         step_seconds=timing.step_s, launches=launches,
         host_syncs=len(syncs),
         host_sync_sites=sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                                 for w in syncs}),
         opt_step=int(result.opt_state.step),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses not finite: {losses}")
    if not finite:
        raise AssertionError("train: a parameter is not finite after the run")
    want = TENSORS_PER_STEP * steps
    if launches != {"adalomo_stats": want, "adalomo_update": want}:
        raise AssertionError(f"train: kernel launches {launches}, expected "
                             f"{want} each ({TENSORS_PER_STEP} a step)")
    if len(syncs) != steps:
        raise AssertionError(
            f"train: {len(syncs)} synchronising host transfers in {steps} "
            "steps, expected one a step")
    return {"launches": launches}


# --------------------------------------------------------------------------
# parity
# --------------------------------------------------------------------------

def phase_parity() -> None:
    arch = get_arch(ARCH_ID)
    arch = dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=2))
    base = arch.init_params(0)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(
        rng.integers(0, arch.cfg.vocab, (2, 512)).astype(np.int32)).to(DEV)
        for k in ("tokens", "labels")}

    def one_step(backend):
        params = tree_map(torch.clone, base)
        opt = opt_lib.get_opt("adalomo", backend=backend)
        state = opt.init(params)
        _, state, loss, _ = arch.make_fused_train_step(opt)(
            params, state, batch, hparams=5e-4)
        return params, float(loss)

    p_cuda, loss_cuda = one_step("cuda")
    p_again, _ = one_step("cuda")
    p_torch, loss_torch = one_step("torch")
    torch.cuda.synchronize()
    worst = 0.0
    for a, b, c in zip(tree_leaves(p_cuda), tree_leaves(p_torch),
                       tree_leaves(base)):
        assert_close(a, b, rtol=5e-3, atol=5e-3, what="parity params")
        worst = max(worst, max_err(a, b))
        if torch.equal(a, c) and a.ndim >= 2:
            raise AssertionError("parity: a matrix was not updated")
    emit("parity", n_layers=2, d_model=arch.cfg.d_model, batch=2, seq=512,
         loss_cuda=loss_cuda, loss_torch=loss_torch,
         max_abs_param_err=worst, tolerance={"params": 5e-3, "loss": 1e-3},
         step_rerun_bitwise=all(
             torch.equal(a, b) for a, b in zip(tree_leaves(p_cuda),
                                               tree_leaves(p_again))))
    if not math.isfinite(loss_cuda) or abs(loss_cuda - loss_torch) > 1e-3:
        raise AssertionError(
            f"parity: loss {loss_cuda} (cuda) vs {loss_torch} (torch)")


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------

RESUME_STEPS = 4
# bytes: a save stages its files beside the previous step's, so a directory
# holds two checkpoints of 3.67 GB at once
RESUME_MIN_FREE = 10 * 2 ** 30


def resume_root() -> str:
    """A fresh directory for the phase's checkpoints, under the system temp
    or this checkout's git-ignored ``_chip_smoke_tmp/``, whichever disk has
    more free space; the phase removes it before it returns."""
    here = os.path.dirname(os.path.abspath(__file__))
    best = max((tempfile.gettempdir(), here),
               key=lambda d: shutil.disk_usage(d).free)
    if shutil.disk_usage(best).free < RESUME_MIN_FREE:
        raise AssertionError(
            f"resume: {shutil.disk_usage(best).free} bytes free in {best}, "
            f"need {RESUME_MIN_FREE}")
    if best == here:
        best = os.path.join(here, "_chip_smoke_tmp")
        os.makedirs(best, exist_ok=True)
    return tempfile.mkdtemp(prefix="chip_smoke_resume_", dir=best)


def resume_spec(root, ckpt, metrics, *, resume=False, profile=False):
    from repro_torch.run import (CheckpointSpec, EvalSpec, FaultSpec,
                                 ProfileSpec)
    return RunSpec(
        model=ModelSpec(ARCH_ID, smoke=False),
        data=DataConfig(vocab=0, seq_len=1024, global_batch=4, seed=0),
        opt=OptSpec(name="adalomo"),
        steps=StepSpec(total=RESUME_STEPS), log_every=1, seed=0,
        checkpoint=CheckpointSpec(dir=os.path.join(root, ckpt), every=2,
                                  resume=resume, keep_last=1),
        eval=EvalSpec(every=2, n_batches=1),
        metrics_path=os.path.join(root, metrics),
        fault=FaultSpec(heartbeat_timeout_s=600.0),
        profile=ProfileSpec(dir=os.path.join(root, "prof") if profile
                            else None, start=1, steps=1))


def bitwise_equal(a, b) -> bool:
    from repro_torch.core.tree import pytree_leaves
    la, lb = pytree_leaves(a), pytree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def run_record(result, root) -> dict:
    """What one run of the phase reports: its history, step seconds (from
    its metrics stream), liveness, and the checkpoint manager's save and
    restore timings."""
    from repro_torch.run import CheckpointHook, HeartbeatHook, StragglerHook
    from repro_torch.telemetry.schema import read_stream
    mgr = result.find_hook(CheckpointHook).manager
    mgr.wait()
    hb = result.find_hook(HeartbeatHook).heartbeat
    dt = {r["step"]: r["dt_s"] for r in
          read_stream(result.program.spec.metrics_path).steps()}
    return {"start_step": result.start_step,
            "steps": result.history["step"],
            "step_seconds": [dt[s] for s in result.history["step"]],
            "losses": result.history["loss"],
            "eval_steps": result.history["eval_step"],
            "eval_losses": result.history["eval_loss"],
            "stragglers": [list(e) for e in
                           result.find_hook(StragglerHook).monitor.events],
            "heartbeat_stalled": bool(hb.stalled),
            "checkpoint_io": list(mgr.timings),
            "disk_free_bytes": shutil.disk_usage(root).free}


def profiled_kernels(path: str) -> dict:
    """CUDA kernel events in a Chrome trace, counted for K1 and K2 (K2's
    wrapper launches two kernels: its partial sums, then the update)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"kernels": len(names),
            "adalomo_stats": sum("stats_kernel" in n for n in names),
            "adalomo_update": sum("update_kernel" in n for n in names)}


def phase_resume() -> dict:
    """h2o-danube-1.8b at full width through ``run(spec)`` with checkpoints,
    eval, the metrics stream, the heartbeat and a profiler window: A
    uninterrupted; B preempted by SIGTERM; C resumed from B; D with an
    injected transient device error — C and D bitwise equal to A."""
    import signal
    from repro_torch.fleet import Preempted
    from repro_torch.run import Hook, ProfilerHook, build_step_program
    from repro_torch.telemetry.schema import read_stream

    log = lambda s: print("  " + s, flush=True)            # noqa: E731
    t0 = time.perf_counter()
    root = resume_root()
    out = {"root": root, "disk_free_bytes": shutil.disk_usage(root).free}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        # A: uninterrupted, the slice's main path
        spec_a = resume_spec(root, "ck_a", "a.jsonl", profile=True)
        K.adalomo_stats.launches = 0
        K.adalomo_update.launches = 0
        res_a = run(spec_a, log_fn=log)
        launches = {"adalomo_stats": K.adalomo_stats.launches,
                    "adalomo_update": K.adalomo_update.launches}
        out["A"] = run_record(res_a, root)
        prof = res_a.find_hook(ProfilerHook)
        if prof.trace_path is None:
            raise AssertionError("resume: the profiler wrote no trace")
        out["profile"] = {"trace_bytes": os.path.getsize(prof.trace_path),
                          "window": [1, 2],
                          **profiled_kernels(prof.trace_path)}
        out["launches_A"] = launches
        want = TENSORS_PER_STEP * RESUME_STEPS
        if launches != {"adalomo_stats": want, "adalomo_update": want}:
            raise AssertionError(f"resume: A launched {launches}, expected "
                                 f"{want} each")
        if (out["profile"]["adalomo_stats"] != TENSORS_PER_STEP or
                out["profile"]["adalomo_update"] != 2 * TENSORS_PER_STEP):
            raise AssertionError(
                f"resume: the trace of step 1 holds {out['profile']}, "
                f"expected {TENSORS_PER_STEP} K1 and "
                f"{2 * TENSORS_PER_STEP} K2 kernels")
        final_a = (res_a.params, res_a.opt_state)
        shutil.rmtree(os.path.join(root, "ck_a"))

        # B: SIGTERM at step 0's boundary (user hooks run after the
        # PreemptionHook, which sees it at step 1's): checkpoint at step 2
        class SendSigterm(Hook):
            def on_step_end(self, ctx, ev):
                if ev.step == 0:
                    os.kill(os.getpid(), signal.SIGTERM)

        from repro_torch.checkpoint.manager import CheckpointManager
        spec_b = resume_spec(root, "ck_bc", "bc.jsonl")
        mgr_b = CheckpointManager(spec_b.checkpoint.dir, keep_last=1)
        try:
            run(spec_b, hooks=[SendSigterm()], ckpt_manager=mgr_b,
                log_fn=log)
            raise AssertionError("resume: B was not preempted")
        except Preempted as e:
            out["B"] = {"preempted_at": e.step, "signum": e.signum}
        marker = mgr_b.read_preempt_marker()
        out["B"].update(marker=marker, latest_step=mgr_b.latest_step(),
                        checkpoint_io=list(mgr_b.timings),
                        disk_free_bytes=shutil.disk_usage(root).free)
        if out["B"]["preempted_at"] != 2 or (marker or {}).get("step") != 2:
            raise AssertionError(f"resume: B preempted as {out['B']}")
        torch.cuda.empty_cache()

        # C: resumed from B's checkpoint, steps 2-3
        spec_c = dataclasses.replace(
            spec_b, checkpoint=dataclasses.replace(spec_b.checkpoint,
                                                   resume=True))
        res_c = run(spec_c, log_fn=log)
        out["C"] = run_record(res_c, root)
        stream = read_stream(spec_c.metrics_path)
        out["C"]["metrics_steps"] = [r["step"] for r in stream.steps()]
        out["C"]["bitwise_equal_A"] = bitwise_equal(
            (res_c.params, res_c.opt_state), final_a)
        checks = {
            "C resumed at 2": res_c.start_step == 2,
            "C params and OptState bitwise": out["C"]["bitwise_equal_A"],
            "C losses = A's tail": (res_c.history["loss"] ==
                                    res_a.history["loss"][2:]),
            "C eval = A's tail": (res_c.history["eval_loss"] ==
                                  res_a.history["eval_loss"][1:]),
            "marker consumed": mgr_b.read_preempt_marker() is None,
            "metrics steps 0-3 once": (out["C"]["metrics_steps"] ==
                                       list(range(RESUME_STEPS)))}
        del res_c
        shutil.rmtree(os.path.join(root, "ck_bc"))
        torch.cuda.empty_cache()

        # D: a transient device error after the real call 4 (step 3)
        spec_d = resume_spec(root, "ck_d", "d.jsonl")
        prog = build_step_program(spec_d)
        real, calls = prog.step, {"n": 0}

        def flaky(params, opt_state, batch, hp):
            result = real(params, opt_state, batch, hp)
            calls["n"] += 1
            if calls["n"] == 4:
                raise torch.AcceleratorError("injected")
            return result

        prog.step = flaky
        res_d = run(spec_d, program=prog, log_fn=log)
        out["D"] = run_record(res_d, root)
        out["D"]["step_calls"] = calls["n"]
        out["D"]["recover_events"] = read_stream(spec_d.metrics_path).events(
            "recover")
        out["D"]["bitwise_equal_A"] = bitwise_equal(
            (res_d.params, res_d.opt_state), final_a)
        checks.update({
            "D params and OptState bitwise": out["D"]["bitwise_equal_A"],
            "D history = A's": (res_d.history["step"] == list(
                range(RESUME_STEPS)) and res_d.history["loss"] ==
                res_a.history["loss"]),
            "D eval = A's": res_d.history["eval_loss"] ==
            res_a.history["eval_loss"],
            "D restored step 2 once": [(r["step"], r["failed_step"]) for r in
                                       out["D"]["recover_events"]] == [(2, 3)],
            "no heartbeat stall": not any(out[r]["heartbeat_stalled"]
                                          for r in "ACD")})
        del res_d
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t0
    emit("resume", arch=ARCH_ID, batch=4, seq=1024, steps=RESUME_STEPS,
         **out)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"resume: failed {failed}")
    return {"launches": launches}


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

SERVE_CFG = dict(page_size=16, max_batch=8, max_pages_per_seq=128,
                 num_pages=1025, chunk=8, max_new_tokens=64)
SERVE_REQUESTS = 16
SERVE_PROMPT_LENS = (32, 1900)


def phase_serve() -> dict:
    """PagedEngine on h2o-danube-1.8b at its published width and depth, bf16,
    random weights from a seed: 16 requests, 8 submitted, the other 8 after
    the first step (mid-flight admission)."""
    arch = get_arch(ARCH_ID)
    params = arch.init_params(0)
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPT_LENS[0], SERVE_PROMPT_LENS[1] + 1,
                        SERVE_REQUESTS)
    prompts = [rng.integers(1, arch.cfg.vocab, int(n)).tolist()
               for n in lens]
    with tempfile.TemporaryDirectory() as tmp:
        gauges = os.path.join(tmp, "serve.jsonl")
        scfg = PagedServeConfig(**SERVE_CFG, telemetry_path=gauges)
        eng = PagedEngine(arch, params, scfg)
        free0 = eng.allocator.n_free
        t0 = time.perf_counter()
        eng.warmup(list(SERVE_PROMPT_LENS))
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        warm_prefill, warm_decode = (eng.prefill_compile_count(),
                                     eng.decode_compile_count())
        chunks0 = eng.chunk_count
        admitted0 = eng.scheduler.counters["admitted"]
        pf0, dec0 = eng.telemetry.prefill_s, eng.telemetry.decode_s
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                KD.paged_decode_attention.launches = 0
                t0 = time.perf_counter()
                rids = [eng.submit(p) for p in prompts[:8]]
                eng.step()
                rids += [eng.submit(p) for p in prompts[8:]]
                eng.run()
                wall_s = time.perf_counter() - t0
                launches = KD.paged_decode_attention.launches
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng.telemetry.close()
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    chunks = eng.chunk_count - chunks0
    admissions = eng.scheduler.counters["admitted"] - admitted0
    decode_steps = chunks * scfg.chunk
    outs = [eng.requests[r].out for r in rids]
    prefill_s = eng.telemetry.prefill_s - pf0
    decode_s = eng.telemetry.decode_s - dec0
    # the first token of each admission comes from its prefill
    decode_tokens = sum(len(o) for o in outs) - admissions
    emit("serve", arch=ARCH_ID, n_layers=arch.cfg.n_layers,
         dtype=str(arch.cfg.dtype), config=SERVE_CFG,
         requests=SERVE_REQUESTS, prompt_lens=[int(n) for n in lens],
         warmup_seconds=warmup_s, wall_seconds=wall_s,
         prefill_seconds=prefill_s, decode_seconds=decode_s,
         decode_tokens=decode_tokens,
         decode_tokens_per_s=decode_tokens / decode_s,
         ms_per_decode_step=decode_s / decode_steps * 1e3,
         chunks=chunks, decode_steps=decode_steps, admissions=admissions,
         preemptions=eng.scheduler.counters["preempted"],
         launches={"paged_decode_attention": launches},
         host_syncs=len(syncs),
         host_sync_sites=sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                                 for w in syncs}),
         decode_signatures=eng.decode_compile_count(),
         prefill_signatures=eng.prefill_compile_count(),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    bad = [i for i, o in enumerate(outs) if len(o) != SERVE_CFG[
        "max_new_tokens"]]
    if bad:
        raise AssertionError(f"serve: requests {bad} did not emit "
                             f"{SERVE_CFG['max_new_tokens']} tokens")
    if any(not 0 <= t < arch.cfg.vocab for o in outs for t in o):
        raise AssertionError("serve: a token id outside the vocabulary")
    if eng.allocator.n_free != free0 or eng.scheduler.has_work():
        raise AssertionError(f"serve: {eng.allocator.n_free} pages free "
                             f"after the run, {free0} before")
    if launches != N_LAYERS * decode_steps:
        raise AssertionError(f"serve: {launches} paged_decode_attention "
                             f"launches, expected {N_LAYERS} x "
                             f"{decode_steps} decode steps")
    if len(syncs) != chunks + admissions:
        raise AssertionError(
            f"serve: {len(syncs)} synchronising host transfers, expected "
            f"{chunks} chunks + {admissions} admissions")
    if (eng.decode_compile_count(), eng.prefill_compile_count()) != (
            warm_decode, warm_prefill):
        raise AssertionError("serve: an input signature the warmup had not "
                             "run")
    return {"launches": launches}


SERVE_PARITY_TOL = {torch.float32: 1e-3, torch.bfloat16: 0.1}
SERVE_PARITY_PROMPT_LENS = (700, 33, 1500, 257)


def phase_serve_parity() -> None:
    """The engine through K3 (use_kernel=None) against the plain version
    (use_kernel=False), at full width and 2 layers: the logits of one decode
    step over the same pool, and greedy tokens end to end."""
    rng = np.random.default_rng(1)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        arch = get_arch(ARCH_ID)
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=2, dtype=dtype))
        params = arch.init_params(0)
        prompts = [rng.integers(1, arch.cfg.vocab, n).tolist()
                   for n in SERVE_PARITY_PROMPT_LENS]
        scfg = PagedServeConfig(**dict(SERVE_CFG, max_batch=4,
                                       max_new_tokens=16))
        eng = PagedEngine(arch, params, scfg)
        for p in prompts:
            eng.submit(p)
        eng._admit_all()
        eng._ensure_ahead_all()
        tables = build_block_tables(eng.scheduler.page_lists(),
                                    scfg.max_pages_per_seq)
        batch = {"tokens": torch.from_numpy(eng._tok[:, None]).to(DEV),
                 "block_tables": torch.from_numpy(tables).to(DEV),
                 "seq_lens": torch.from_numpy(eng._n).to(DEV),
                 "emit": torch.from_numpy(~eng._done).to(DEV)}
        logits = {}
        for use_kernel in (None, False):
            pages = {k: v.clone() for k, v in eng._pages.items()}
            logits[use_kernel] = arch.make_paged_decode_step(
                use_kernel=use_kernel)(params, pages, batch)[0]
        err = max_err(logits[None], logits[False])
        tokens = {}
        for use_kernel in (None, False):
            e = PagedEngine(arch, params, dataclasses.replace(
                scfg, use_kernel=use_kernel))
            tokens[use_kernel] = e.generate(prompts)
        torch.cuda.synchronize()
        report[str(dtype)] = {
            "logits_max_abs_err": err, "tolerance": SERVE_PARITY_TOL[dtype],
            "greedy_tokens_equal": tokens[None] == tokens[False],
            "tokens_kernel": tokens[None][0][:8],
            "tokens_plain": tokens[False][0][:8]}
        if not err <= SERVE_PARITY_TOL[dtype]:
            raise AssertionError(f"serve_parity {dtype}: decode-step logits "
                                 f"differ by {err}")
        if dtype == torch.float32 and tokens[None] != tokens[False]:
            raise AssertionError("serve_parity fp32: greedy tokens differ "
                                 "between the kernel and the plain version")
        del eng, params
        torch.cuda.empty_cache()
    emit("serve_parity", n_layers=2, d_model=arch.cfg.d_model,
         prompt_lens=list(SERVE_PARITY_PROMPT_LENS), max_new_tokens=16,
         **report)


# --------------------------------------------------------------------------
# legacy serve
# --------------------------------------------------------------------------

LEGACY_BATCH = 4
LEGACY_PROMPT_LEN = 6144
LEGACY_NEW_TOKENS = 64


def _event_timed(fn, log: list):
    """``fn`` with CUDA events recorded around each call (no host sync)."""
    def run(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kwargs)
        e1.record()
        log.append((e0, e1))
        return out
    return run


def phase_legacy_serve() -> dict:
    """Engine on h2o-danube-1.8b at its published width and depth, bf16,
    random weights from a seed: 4 prompts of 6144 tokens (prefill through
    the sliding-window gather; a ring of the window's 4096 slots that wraps
    every step), 64 greedy tokens each."""
    arch = get_arch(ARCH_ID)
    params = arch.init_params(0)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, arch.cfg.vocab, LEGACY_PROMPT_LEN).tolist()
               for _ in range(LEGACY_BATCH)]
    eng = Engine(arch, params, ServeConfig(max_new_tokens=LEGACY_NEW_TOKENS))
    prefill_ev, decode_ev = [], []
    eng._prefill = _event_timed(eng._prefill, prefill_ev)
    eng._decode = _event_timed(eng._decode, decode_ev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            KD.decode_attention.launches = 0
            t0 = time.perf_counter()
            outs = eng.generate(prompts)
            wall_s = time.perf_counter() - t0
            launches = KD.decode_attention.launches
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    steps = len(decode_ev)
    prefill_s = prefill_ev[0][0].elapsed_time(prefill_ev[0][1]) / 1e3
    decode_s = decode_ev[0][0].elapsed_time(decode_ev[-1][1]) / 1e3
    emit("legacy_serve", arch=ARCH_ID, n_layers=arch.cfg.n_layers,
         dtype=str(arch.cfg.dtype), batch=LEGACY_BATCH,
         prompt_len=LEGACY_PROMPT_LEN, ring_slots=arch.cfg.window,
         max_new_tokens=LEGACY_NEW_TOKENS, wall_seconds=wall_s,
         prefill_seconds=prefill_s, decode_steps=steps,
         decode_seconds=decode_s, ms_per_decode_step=decode_s / steps * 1e3,
         decode_tokens_per_s=LEGACY_BATCH * steps / decode_s,
         launches={"decode_attention": launches}, host_syncs=len(syncs),
         host_sync_sites=sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                                 for w in syncs}),
         tokens_row0=outs[0][:8],
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if [len(o) for o in outs] != [LEGACY_NEW_TOKENS] * LEGACY_BATCH:
        raise AssertionError(f"legacy_serve: rows emitted "
                             f"{[len(o) for o in outs]} tokens, expected "
                             f"{LEGACY_NEW_TOKENS} each")
    if any(not 0 <= t < arch.cfg.vocab for o in outs for t in o):
        raise AssertionError("legacy_serve: a token id outside the vocabulary")
    if steps != LEGACY_NEW_TOKENS - 1 or launches != N_LAYERS * steps:
        raise AssertionError(f"legacy_serve: {launches} decode_attention "
                             f"launches in {steps} decode steps, expected "
                             f"{N_LAYERS} x {LEGACY_NEW_TOKENS - 1}")
    if len(syncs) != LEGACY_NEW_TOKENS:
        raise AssertionError(
            f"legacy_serve: {len(syncs)} synchronising host transfers, "
            f"expected one per emitted step ({LEGACY_NEW_TOKENS})")
    return {"launches": launches}


LEGACY_PARITY_LENS = (1024, 3072, 6144)   # direct, blockwise, window gather


def phase_legacy_parity() -> None:
    """At full width and 2 layers, fp32 and bf16: one decode step's logits
    through K4 (use_kernel=None) against the plain version (use_kernel=False)
    over the same cache, and greedy tokens of Engine end to end, after
    prefills that take each attention branch; then the flash branch's value
    and gradients against direct attention at danube's heads."""
    rng = np.random.default_rng(3)
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        arch = get_arch(ARCH_ID)
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, n_layers=2, dtype=dtype))
        params = arch.init_params(0)
        for S in LEGACY_PARITY_LENS:
            toks = torch.from_numpy(rng.integers(
                1, arch.cfg.vocab, (2, S)).astype(np.int32)).to(DEV)
            logits0, cache = arch.make_prefill_step()(params,
                                                      {"tokens": toks})
            nxt = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
            logits = {}
            for use_kernel in (None, False):
                c = {k: v.clone() for k, v in cache.items()}
                logits[use_kernel] = arch.make_decode_step(
                    use_kernel=use_kernel)(params, c, {"tokens": nxt})[0]
            err = max_err(logits[None], logits[False])
            prompts = toks.cpu().tolist()
            tokens = {u: Engine(arch, params, ServeConfig(
                max_new_tokens=16, use_kernel=u)).generate(prompts)
                for u in (None, False)}
            torch.cuda.synchronize()
            report[f"{dtype} S{S}"] = {
                "ring_slots": int(cache["pos"].shape[0]),
                "logits_max_abs_err": err,
                "tolerance": SERVE_PARITY_TOL[dtype],
                "greedy_tokens_equal": tokens[None] == tokens[False],
                "tokens_kernel": tokens[None][0][:8],
                "tokens_plain": tokens[False][0][:8]}
            if not err <= SERVE_PARITY_TOL[dtype]:
                raise AssertionError(f"legacy_parity {dtype} S={S}: "
                                     f"decode-step logits differ by {err}")
            if dtype == torch.float32 and tokens[None] != tokens[False]:
                raise AssertionError(f"legacy_parity fp32 S={S}: greedy "
                                     "tokens differ between the kernel and "
                                     "the plain version")
            del cache, c
        del params
        torch.cuda.empty_cache()
    report["flash_vs_direct"] = check_flash_vs_direct()
    emit("legacy_parity", n_layers=2, d_model=arch.cfg.d_model, batch=2,
         prompt_lens=list(LEGACY_PARITY_LENS), max_new_tokens=16, **report)


FLASH_CHECK = dict(S=4096, Kh=8, G=4, dh=80)    # B = 1, danube's heads


def check_flash_vs_direct() -> dict:
    """fp32, B = 1, S = 4096, danube's heads (8 KV x 4, dh 80) and window:
    the flash branch's value and gradients against direct attention's
    autograd, at the reference flash-VJP test's tolerances (the scalar
    rtol 5e-5; gradients rtol 1e-4, atol 1e-5)."""
    S, Kh, G, dh = (FLASH_CHECK[k] for k in ("S", "Kh", "G", "dh"))
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    base = [torch.randn(shape, generator=g, device=DEV)
            for shape in ((1, S, Kh, G, dh), (1, S, Kh, dh), (1, S, Kh, dh))]
    pos = torch.arange(S, dtype=torch.int32, device=DEV)
    spec = ML.MaskSpec(causal=True, window=SERVE_WINDOW)
    results = []
    for impl in ("flash", "direct"):
        q, k, v = (t.clone().requires_grad_(True) for t in base)
        if impl == "flash":
            o = ML._flash_attention(q, k, v, pos, pos, spec, dh ** -0.5,
                                    ML._Q_BLOCK, ML._KV_BLOCK)
        else:
            mask = ML._mask_block(pos, pos, spec)[None, None, None]
            o = ML._direct_attention(q, k, v, mask, dh ** -0.5)
        val = torch.sum(o * torch.cos(o))
        results.append((val.detach(), torch.autograd.grad(val, (q, k, v))))
        del o, val
        torch.cuda.empty_cache()
    (v1, g1), (v2, g2) = results
    out = {"value_flash": float(v1), "value_direct": float(v2)}
    if not abs(float(v1) - float(v2)) <= 5e-5 * abs(float(v2)):
        raise AssertionError(f"legacy_parity: flash value {float(v1)} vs "
                             f"direct {float(v2)}")
    for a, b, name in zip(g1, g2, "qkv"):
        assert_close(a, b, rtol=1e-4, atol=1e-5,
                     what=f"legacy_parity flash d{name}")
        out[f"d{name}_max_abs_err"] = max_err(a, b)
    return out


# --------------------------------------------------------------------------

PHASES = ("kernels", "train", "parity", "resume", "serve", "serve_parity",
          "legacy_serve", "legacy_parity")
EXTRA_PHASES = ("timing",)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-joined subset of " + ",".join(PHASES) +
                         " (the result line is printed only when all ran); "
                         "kernels,serve is a short call after touching K3 "
                         "or the paged engine, kernels,legacy_serve,"
                         "legacy_parity after touching K4, the legacy "
                         "engine or the long-sequence attention, "
                         "kernels,train,resume after touching the run "
                         "layer or the checkpoints; timing "
                         "(not in the default) times the kernels without "
                         "checking them and prints their outputs' digests")
    ap.add_argument("--src", default=SRC,
                    help="the src directory to import repro_torch from "
                         "(default: this checkout's); another tree's, to "
                         "time a parent commit with this script")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES) - set(EXTRA_PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(DEV)
    smi = nvidia_smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, nvcc=build.find_nvcc(), matmul_allow_tf32=False,
         cudnn_allow_tf32=False, src=SRC)

    if "timing" in phases:
        phase_timing()

    kern = phase_kernels() if "kernels" in phases else None
    train = phase_train() if "train" in phases else None
    torch.cuda.empty_cache()
    if "parity" in phases:
        phase_parity()
        torch.cuda.empty_cache()
    if "resume" in phases:
        phase_resume()
        # the process's first profiler start keeps its caller's frames (run
        # A's) in a reference cycle; free them before the serving phases
        gc.collect()
        torch.cuda.empty_cache()
    serve = phase_serve() if "serve" in phases else None
    torch.cuda.empty_cache()
    if "serve_parity" in phases:
        phase_serve_parity()
        torch.cuda.empty_cache()
    legacy = phase_legacy_serve() if "legacy_serve" in phases else None
    torch.cuda.empty_cache()
    if "legacy_parity" in phases:
        phase_legacy_parity()
    if set(phases) != set(PHASES):
        print("chip_smoke: partial run (--phases); no result line")
        sys.exit(3)

    kernels = []
    for name, src, replaces, launches, unit, library in (
            ("adalomo_stats", "adalomo_update/csrc/adalomo_stats.cu",
             "adalomo_update/adalomo_update.py:68",
             train["launches"]["adalomo_stats"], TRAIN_UNIT, None),
            ("adalomo_update", "adalomo_update/csrc/adalomo_update.cu",
             "adalomo_update/adalomo_update.py:137",
             train["launches"]["adalomo_update"], TRAIN_UNIT, None),
            ("paged_decode_attention",
             "decode_attention/csrc/paged_decode_attention.cu",
             "decode_attention/decode_attention.py:109",
             serve["launches"], DECODE_UNIT,
             kern["totals"]["paged_decode_attention"]["library_ms"]),
            ("decode_attention", "decode_attention/csrc/decode_attention.cu",
             "decode_attention/decode_attention.py:163",
             legacy["launches"], RING_UNIT,
             kern["totals"]["decode_attention"]["library_ms"])):
        t = kern["totals"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + src,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": launches, "max_abs_err": kern["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": library, "unit": unit})
        if name == "paged_decode_attention":
            kernels[-1]["library_note"] = PAGED_LIBRARY_NOTE
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


TRAIN_UNIT = ("one train step: the 170 matrices of h2o-danube-1.8b, bf16 "
              "params and grads")
DECODE_UNIT = ("one decode step of h2o-danube-1.8b: 24 launches, 8 sequences "
               "of 1024 cached tokens, bf16")
PAGED_LIBRARY_NOTE = ("two PyTorch calls, not one: the pages gathered into "
                      "a dense cache, then scaled_dot_product_attention "
                      "with enable_gqa and a boolean mask")
RING_UNIT = ("one decode step of h2o-danube-1.8b: 24 launches, 4 sequences "
             "over a wrapped ring of 4096 slots, window 4096, bf16")


if __name__ == "__main__":
    main()
