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
           in the scratch page, fp32 (1e-5) and bf16 (3e-2), a bitwise
           re-run.  Then times kernel and plain version (CUDA events, after
           warm-up, inputs rotated so they are not served from the L2 cache)
           beside the least time the card could take.
  train    ``repro_torch.run.run(spec)``: h2o-danube-1.8b at its published
           width and depth, random weights from a seed, AdaLomo fused into
           the backward pass, batch 4 x 1024 tokens, 3 steps.  Launch counts
           are set to 0 just before and read just after: 170 tensors a step
           go through each kernel.  One device-to-host transfer a step.
  parity   one fused step at full width and 2 layers, CUDA kernels against the
           plain PyTorch update, from the same weights and batch.
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

Then the card's name and power limit, one JSON line that lists the kernels
with their measured numbers, and the result line.

Matrix products stay full fp32 for fp32 inputs: TF32 is switched off here,
for matmul (PyTorch's default) and for cuDNN (not its default).

The whole-step re-run is reported, not asserted: the hand-written kernels
are bit-reproducible (asserted in ``kernels``), the token-embedding gradient
goes through ``F.embedding``'s sorted, fixed-order backward, and what is
left is cuBLAS, which this script does not vouch for.
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device (torch.cuda.is_available() "
                     "is False); this script measures on the GPU only\n")
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

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
from repro_torch.kernels.decode_attention.ref import \
    paged_decode_attention_ref  # noqa: E402
from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.run import (ModelSpec, OptSpec, RunSpec, StepSpec,  # noqa: E402
                             TimingHook, run)
from repro_torch.serve.engine import PagedEngine, PagedServeConfig  # noqa: E402
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


def time_kernels() -> tuple:
    """Per danube shape, bf16 params and grads (what the train step passes):
    kernel time, plain-version time and bound, in ms."""
    rows = []
    beta_t = torch.full((), 0.999, device=DEV)
    kw2 = dict(eps_div=CFG.eps_div, eps_rms=CFG.eps_rms, literal=False)
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
        k1 = time_ms(lambda p, g, r, c, s: K.adalomo_stats(
            g, r, c, beta_t, eps_stat=CFG.eps_stat), sets, rounds)
        k1_plain = time_ms(lambda p, g, r, c, s: K.adalomo_stats_ref(
            g, r, c, beta_t, eps_stat=CFG.eps_stat), sets, rounds)
        k2 = time_ms(lambda p, g, r, c, s: K.adalomo_update(
            p, g, r, c, s, **kw2), sets, rounds)
        k2_plain = time_ms(lambda p, g, r, c, s: K.adalomo_update_ref(
            p, g, r, c, s, **kw2), sets, rounds)
        state_bytes = 4 * (m + n)
        k1_bytes = m * n * 2 + 2 * state_bytes          # g; r, c in and out
        k2_bytes = 3 * m * n * 2 + state_bytes + 16     # theta in/out, g
        k1_bound = max(k1_bytes / HBM_BYTES_PER_S,
                       K1_FLOP_PER_ELEM * m * n / FP32_FLOP_PER_S) * 1e3
        k2_bound = max(k2_bytes / HBM_BYTES_PER_S,
                       K2_FLOP_PER_ELEM * m * n / FP32_FLOP_PER_S) * 1e3
        rows.append({"shape": list(shape), "per_step": count,
                     "stats_ms": k1, "stats_plain_ms": k1_plain,
                     "stats_bound_ms": k1_bound,
                     "update_ms": k2, "update_plain_ms": k2_plain,
                     "update_bound_ms": k2_bound})
        del sets
        torch.cuda.empty_cache()

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in rows)

    totals = {
        "adalomo_stats": dict(ms=per_step("stats_ms"),
                              plain_ms=per_step("stats_plain_ms"),
                              bound_ms=per_step("stats_bound_ms")),
        "adalomo_update": dict(ms=per_step("update_ms"),
                               plain_ms=per_step("update_plain_ms"),
                               bound_ms=per_step("update_bound_ms")),
    }
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
            "paged_decode_attention": 0.0}
    n_cases = check_kernels(errs)
    variants = check_op_variants()
    k3_cases, k3_bitwise = check_k3(errs)
    rows, totals = time_kernels()
    k3_rows, totals["paged_decode_attention"] = time_k3()
    emit("kernels", kernels=["adalomo_stats", "adalomo_update",
                             "paged_decode_attention"],
         build_seconds=build_s, ptxas=usage, cases=n_cases,
         max_abs_err=errs, op_variants=variants,
         tolerances={"param_fp32": 1e-5, "param_bf16": 5e-3, "r_c": TOL_RC,
                     "paged_fp32": 1e-5, "paged_bf16": 3e-2},
         timing_dtype="bf16 param, bf16 grad", per_shape=rows,
         per_step_of_170_tensors={k: totals[k] for k in
                                  ("adalomo_stats", "adalomo_update")},
         paged_cases=k3_cases, paged_rerun_bitwise=k3_bitwise,
         paged_per_shape_bf16=k3_rows,
         paged_per_decode_step_B8_n1024=totals["paged_decode_attention"])
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


def time_k3() -> tuple:
    """bf16 at danube serving shapes (32/8 heads, dh 80, pages of 16, the
    model's window): kernel, plain version and bound per launch, in ms."""
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
        ms = time_ms(lambda q, kp, vp, bt, sl: KD.paged_decode_attention(
            q, kp, vp, bt, sl, window=SERVE_WINDOW), sets, rounds)
        plain = time_ms(lambda q, kp, vp, bt, sl: paged_decode_attention_ref(
            q, kp, vp, bt, sl, window=SERVE_WINDOW), sets, rounds)
        rows[name] = {"seq_lens": list(lens), "ms": ms, "plain_ms": plain,
                      "bound_ms": k3_bound_ms(B, H, Kh, dh, ps, lens,
                                              SERVE_WINDOW, 2)}
        del sets
        torch.cuda.empty_cache()
    step = rows["B8 n1024"]
    total = {k: step[k] * N_LAYERS for k in ("ms", "plain_ms", "bound_ms")}
    return rows, total


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

PHASES = ("kernels", "train", "parity", "serve", "serve_parity")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-joined subset of " + ",".join(PHASES) +
                         " (the result line is printed only when all ran); "
                         "kernels,serve is a short call after touching the "
                         "decode-attention kernel")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(DEV)
    smi = nvidia_smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, nvcc=build.find_nvcc(), matmul_allow_tf32=False,
         cudnn_allow_tf32=False)

    kern = phase_kernels() if "kernels" in phases else None
    train = phase_train() if "train" in phases else None
    torch.cuda.empty_cache()
    if "parity" in phases:
        phase_parity()
        torch.cuda.empty_cache()
    serve = phase_serve() if "serve" in phases else None
    torch.cuda.empty_cache()
    if "serve_parity" in phases:
        phase_serve_parity()
    if set(phases) != set(PHASES):
        print("chip_smoke: partial run (--phases); no result line")
        sys.exit(3)

    kernels = []
    for name, src, replaces, launches, unit in (
            ("adalomo_stats", "adalomo_update/csrc/adalomo_stats.cu",
             "adalomo_update/adalomo_update.py:68",
             train["launches"]["adalomo_stats"], TRAIN_UNIT),
            ("adalomo_update", "adalomo_update/csrc/adalomo_update.cu",
             "adalomo_update/adalomo_update.py:137",
             train["launches"]["adalomo_update"], TRAIN_UNIT),
            ("paged_decode_attention",
             "decode_attention/csrc/paged_decode_attention.cu",
             "decode_attention/decode_attention.py:109",
             serve["launches"], DECODE_UNIT)):
        t = kern["totals"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + src,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": launches, "max_abs_err": kern["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "unit": unit})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


TRAIN_UNIT = ("one train step: the 170 matrices of h2o-danube-1.8b, bf16 "
              "params and grads")
DECODE_UNIT = ("one decode step of h2o-danube-1.8b: 24 launches, 8 sequences "
               "of 1024 cached tokens, bf16")


if __name__ == "__main__":
    main()
