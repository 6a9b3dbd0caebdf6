#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py            # needs one CUDA device, no arguments

Drives ``repro_torch`` through the entry points a user would call and fails
(non-zero exit, no result line) if any phase fails or there is no CUDA device.
It imports nothing of JAX and nothing of the JAX package.  Phases, each
printing one JSON line:

  env      torch/CUDA versions, the card and its power limit, TF32 settings.
  kernels  builds the CUDA kernels from the sources in this checkout and holds
           each against its plain PyTorch version on the card, at the shapes
           of h2o-danube-1.8b plus ragged ones, for every pairing of fp32 and
           bf16 params and grads; weight decay, the literal mode, a stacked
           [3, m, n] case and a bitwise re-run; then times kernel and plain
           version (CUDA events, after warm-up, inputs rotated so they are
           not served from the L2 cache) beside the least time the card could
           take.
  train    ``repro_torch.run.run(spec)``: h2o-danube-1.8b at its published
           width and depth, random weights from a seed, AdaLomo fused into
           the backward pass, batch 4 x 1024 tokens, 3 steps.  Launch counts
           are set to 0 just before and read just after: 170 tensors a step
           go through each kernel.  One device-to-host transfer a step.
  parity   one fused step at full width and 2 layers, CUDA kernels against the
           plain PyTorch update, from the same weights and batch.

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
from repro_torch.models.registry import get_arch  # noqa: E402
from repro_torch.run import (ModelSpec, OptSpec, RunSpec, StepSpec,  # noqa: E402
                             TimingHook, run)

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
    lib_dir = build.build_dir(K.LIB_NAME, list(K.SOURCES))
    K._library()                       # builds from csrc/ at first use
    build_s = time.time() - t0
    log = (lib_dir / "build.log").read_text() if (
        lib_dir / "build.log").exists() else ""
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    errs = {"adalomo_stats": 0.0, "adalomo_update": 0.0}
    n_cases = check_kernels(errs)
    variants = check_op_variants()
    rows, totals = time_kernels()
    emit("kernels", kernels=["adalomo_stats", "adalomo_update"],
         build_seconds=build_s, ptxas=usage[:16], cases=n_cases,
         max_abs_err=errs, op_variants=variants,
         tolerances={"param_fp32": 1e-5, "param_bf16": 5e-3, "r_c": TOL_RC},
         timing_dtype="bf16 param, bf16 grad", per_shape=rows,
         per_step_of_170_tensors=totals)
    return {"errs": errs, "totals": totals}


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

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="kernels,train,parity",
                    help="comma-joined subset of kernels,train,parity (the "
                         "result line is printed only when all three ran)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]

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
    if "parity" in phases:
        phase_parity()
    if kern is None or train is None or "parity" not in phases:
        print("chip_smoke: partial run (--phases); no result line")
        sys.exit(3)

    source = "src/repro_torch/kernels/adalomo_update/csrc/"
    replaces = "src/repro/kernels/adalomo_update/adalomo_update.py:"
    kernels = []
    for name, src, line in (("adalomo_stats", "adalomo_stats.cu", 68),
                            ("adalomo_update", "adalomo_update.cu", 137)):
        t = kern["totals"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source + src,
            "replaces": replaces + str(line),
            "launches": train["launches"][name],
            "max_abs_err": kern["errs"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "unit": "one train step: the 170 matrices of h2o-danube-1.8b, "
                    "bf16 params and grads"})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
