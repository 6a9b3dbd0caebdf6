"""``run(spec)`` — the one entrypoint for training (PyTorch).

Counterpart of ``repro.run.runner``: assembles arch + :class:`StepProgram` +
data + hook pipeline from a :class:`RunSpec` and drives the loop, with
checkpoint resume and transient-failure recovery.  The reference's
sentinel and elastic (``mesh.shape``) branches belong to later slices; a
spec that asks for them raises ``NotImplementedError``
(``program.check_ported``).

Default hook order (measurement before side effects; see
``repro_torch.run.hooks``): straggler → heartbeat → profiler → history →
logging → metrics → eval → checkpoint → preemption → user hooks.

One device-to-host transfer per step: loss and metrics are stacked on the
device and read back with a single copy; hooks get host floats.  Saves and
evals add their own transfers, on the steps they run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional, Sequence, Type

import torch

from repro_torch.run import hooks as hooks_lib
from repro_torch.run.data import EVAL_SEED_OFFSET, make_batch_iter
from repro_torch.run.program import StepProgram, build_step_program
from repro_torch.run.spec import RunSpec
from repro_torch.train.fault import RETRIABLE


@dataclasses.dataclass
class RunContext:
    """What hooks see: the spec, the program, the live (params, opt_state)
    after the most recent step, and the dispatch surface."""

    spec: RunSpec
    program: StepProgram
    params: Any
    opt_state: Any
    log: Callable[[str], None]
    hooks: tuple
    ckpt_manager: Any = None
    start_step: int = 0

    def dispatch_eval(self, step: int, metrics: dict) -> None:
        for h in self.hooks:
            h.on_eval(self, step, metrics)


@dataclasses.dataclass
class RunResult:
    params: Any
    opt_state: Any
    history: dict
    start_step: int
    program: StepProgram
    hooks: tuple

    def find_hook(self, cls: Type) -> Optional[hooks_lib.Hook]:
        for h in self.hooks:
            if isinstance(h, cls):
                return h
        return None


def _default_hooks(spec: RunSpec, *, eval_iter, eval_factory, ckpt_manager,
                   log_fn, user_hooks) -> tuple:
    """The standard pipeline; a user hook of the same class replaces the
    default instance (so e.g. a caller-owned StragglerMonitor keeps
    accumulating across runs)."""
    user = tuple(user_hooks)

    def absent(cls):
        return not any(isinstance(h, cls) for h in user)

    out = []
    if absent(hooks_lib.StragglerHook):
        out.append(hooks_lib.StragglerHook())
    if spec.fault.heartbeat_timeout_s > 0 and absent(hooks_lib.HeartbeatHook):
        out.append(hooks_lib.HeartbeatHook(spec.fault.heartbeat_timeout_s))
    if spec.profile.dir and absent(hooks_lib.ProfilerHook):
        out.append(hooks_lib.ProfilerHook(spec.profile.dir,
                                          start=spec.profile.start,
                                          steps=spec.profile.steps))
    if absent(hooks_lib.HistoryHook):
        out.append(hooks_lib.HistoryHook())
    if spec.log_every and absent(hooks_lib.LoggingHook):
        out.append(hooks_lib.LoggingHook(spec.log_every, log_fn,
                                         total=spec.steps.total))
    if spec.metrics_path and absent(hooks_lib.MetricsHook):
        out.append(hooks_lib.MetricsHook(spec.metrics_path))
    if spec.eval.every and absent(hooks_lib.EvalHook):
        if eval_iter is not None:
            out.append(hooks_lib.EvalHook(eval_iter, spec.eval.every,
                                          spec.eval.n_batches))
        elif eval_factory is not None:
            out.append(hooks_lib.EvalHook(every=spec.eval.every,
                                          n_batches=spec.eval.n_batches,
                                          iter_factory=eval_factory))
    if (ckpt_manager is not None and spec.checkpoint.every
            and absent(hooks_lib.CheckpointHook)):
        out.append(hooks_lib.CheckpointHook(ckpt_manager,
                                            spec.checkpoint.every))
    if spec.fault.preempt and ckpt_manager is not None:
        # after CheckpointHook: a preemption boundary that coincides with
        # a scheduled save reuses it.  Lazy import — the fleet layer
        # builds on repro_torch.run, not the other way around.
        from repro_torch.fleet.preempt import PreemptionHook
        if absent(PreemptionHook):
            out.append(PreemptionHook(ckpt_manager))
    return tuple(out) + user


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Numpy batch → tensors on ``device``.  For a CUDA device the copy goes
    through pinned memory and does not block the host."""
    out = {}
    for name, x in batch.items():
        t = torch.from_numpy(x)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t
    return out


def to_host(loss, metrics: dict) -> tuple:
    """The ONE device→host transfer of a step: every 0-d observable in one
    stacked tensor, one copy."""
    names = sorted(metrics)
    flat = torch.stack([loss.to(torch.float32)]
                       + [metrics[n].to(torch.float32) for n in names])
    vals = flat.cpu().tolist()
    return vals[0], dict(zip(names, vals[1:]))


def run(spec: RunSpec, *, arch=None, program: Optional[StepProgram] = None,
        hooks: Sequence[hooks_lib.Hook] = (), params=None, opt_state=None,
        batch_iter: Optional[Iterator[dict]] = None, eval_iter=None,
        ckpt_manager=None, start_step: int = 0, groups=None, device="cuda",
        log_fn: Callable[[str], None] = print) -> RunResult:
    """Drive one run end-to-end.  Overrides (all optional):

    ``arch``       an Arch instance for ad-hoc configs (else registry);
    ``program``    a prebuilt StepProgram (else ``build_step_program``);
    ``params`` / ``opt_state``  warm starts, updated **in place**
                   (opt_state defaults to a fresh ``opt.init(params)``);
    ``batch_iter`` / ``eval_iter``  injected streams of numpy batches (else
                   built from ``spec.data``, the eval stream seed-offset);
    ``ckpt_manager``  a CheckpointManager (else built from
                   ``spec.checkpoint.dir``); resume restores the latest
                   complete step into the live tensors and fast-forwards
                   the data stream;
    ``hooks``      appended after the default pipeline (same-class user
                   hooks replace the default instance);
    ``start_step`` begin mid-schedule without a checkpoint;
    ``device``     where the run lives: the card by default, and the call
                   raises if there is none; pass ``"cpu"`` for the CPU.

    A transient device error in a step (``torch.AcceleratorError``) restores
    the latest checkpoint and replays from it, up to ``spec.fault.retries``
    times; a sticky CUDA error kills the context, so the restore raises and
    the run must be resumed by a new process.
    """
    if program is None:
        program = build_step_program(spec, arch, groups=groups, device=device)
    device = program.device
    arch = program.arch

    if params is None:
        params, opt_state = program.init(spec.seed)
    elif opt_state is None:
        opt_state = program.opt.init(params)

    ck = spec.checkpoint
    if ckpt_manager is None and ck.dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        ckpt_manager = CheckpointManager(ck.dir, keep_last=ck.keep_last,
                                         gc_incomplete=ck.gc_incomplete)
    if (ckpt_manager is not None and ck.resume
            and ckpt_manager.latest_step() is not None):
        # into the live tensors: the device holds one copy of the model,
        # and the caller's ``params`` stays the run's params
        start_step, _ = ckpt_manager.restore_into((params, opt_state))
        log_fn(f"resumed from step {start_step}")

    own_batch_iter = batch_iter is None
    if batch_iter is None:
        batch_iter = make_batch_iter(spec, arch, start_step)
    eval_factory = None
    if eval_iter is None and spec.eval.every and spec.data is not None:
        # The default held-out stream is a pure function of how many eval
        # batches the run has consumed, so EvalHook can fast-forward on
        # resume and rewind on fault recovery (deterministic eval curve).
        def eval_factory(start_batch, _spec=spec, _arch=arch):
            return make_batch_iter(_spec, _arch, start_batch,
                                   seed_offset=EVAL_SEED_OFFSET)

    pipeline = _default_hooks(spec, eval_iter=eval_iter,
                              eval_factory=eval_factory,
                              ckpt_manager=ckpt_manager, log_fn=log_fn,
                              user_hooks=hooks)
    ctx = RunContext(spec=spec, program=program, params=params,
                     opt_state=opt_state, log=log_fn, hooks=pipeline,
                     ckpt_manager=ckpt_manager, start_step=start_step)

    # Transient-failure policy: the step updates (params, opt_state) in
    # place, so a failed call may have half-applied its update — re-invoking
    # with the same arguments cannot reproduce the uninterrupted run.
    # Recovery goes through the checkpoint: restore the latest complete step
    # into the live tensors, rewind the (stateless, step-keyed) data stream,
    # and resume the loop from there.  Without a checkpoint — or with a
    # caller-injected iterator we cannot rewind — the error propagates.
    # Hooks re-observe the re-executed steps, so the history is the
    # truthful training record.
    failures = 0
    try:
        # on_run_start inside the try: if a hook raises here, earlier hooks
        # that already started (watchdog threads, async writers) still get
        # their on_exit.
        for h in pipeline:
            h.on_run_start(ctx)
        t_last = time.time()
        step = start_step
        while step < spec.steps.total:
            batch = batch_to_device(next(batch_iter), device)
            hp = program.hparams_fn(step + 1)
            try:
                ctx.params, ctx.opt_state, loss, metrics = program.step(
                    ctx.params, ctx.opt_state, batch, hp)
            except RETRIABLE as e:
                failures += 1
                if ckpt_manager is not None:
                    ckpt_manager.wait()  # drain any in-flight async save
                # Every stream must rewind for recovery to reproduce the
                # uninterrupted run: caller-injected train or eval
                # iterators cannot, so the error propagates instead of
                # silently diverging the curves.
                rewindable_eval = all(
                    h.iter_factory is not None for h in pipeline
                    if isinstance(h, hooks_lib.EvalHook) and h.every)
                recoverable = (failures <= spec.fault.retries
                               and own_batch_iter and rewindable_eval
                               and ckpt_manager is not None
                               and ckpt_manager.latest_step() is not None)
                if not recoverable:
                    raise
                # Deterministic (jitterless) exponential backoff before the
                # restore: attempt n waits base * 2^(n-1), capped.
                delay = 0.0
                if spec.fault.retry_backoff_s > 0:
                    delay = min(
                        spec.fault.retry_backoff_s * 2.0 ** (failures - 1),
                        spec.fault.retry_backoff_max_s)
                    time.sleep(delay)
                restored, _ = ckpt_manager.restore_into(
                    (ctx.params, ctx.opt_state))
                log_fn(f"step {step} failed ({type(e).__name__}); "
                       f"restored step {restored} "
                       f"(attempt {failures}/{spec.fault.retries})")
                failed_at, step = step, restored
                batch_iter = make_batch_iter(spec, arch, restored)
                for h in pipeline:
                    h.on_recover(ctx, restored)
                # after on_recover: the truncation must not eat the event
                mh = hooks_lib.find_metrics_hook(pipeline)
                if mh is not None:
                    mh.annotate("recover", restored, attempt=failures,
                                failed_step=failed_at, backoff_s=delay)
                t_last = time.time()
                continue
            loss_h, metrics_h = to_host(loss, metrics)
            now = time.time()
            ev = hooks_lib.StepEvent(step=step, loss=loss_h,
                                     metrics=metrics_h, hparams=hp,
                                     dt=now - t_last)
            t_last = now
            for h in pipeline:
                h.on_step_end(ctx, ev)
            step += 1
    finally:
        for h in pipeline:
            h.on_exit(ctx)

    hist = None
    for h in pipeline:
        if isinstance(h, hooks_lib.HistoryHook):
            hist = h.history
            break
    return RunResult(params=ctx.params, opt_state=ctx.opt_state,
                     history=hist if hist is not None else {},
                     start_step=start_step, program=program, hooks=pipeline)
