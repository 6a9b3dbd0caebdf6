"""``run(spec)`` — the one entrypoint for training (PyTorch).

Counterpart of ``repro.run.runner``: assembles arch + :class:`StepProgram` +
data + hook pipeline from a :class:`RunSpec` and drives the plain loop.  The
sentinel, retry, checkpoint and elastic branches of the reference's loop
belong to later slices; a spec that asks for them raises
``NotImplementedError`` (``program.check_ported``).

Default hook order: history → logging → user hooks (a user hook of the same
class replaces the default instance).

One device-to-host transfer per step: loss and metrics are stacked on the
device and read back with a single copy; hooks get host floats.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional, Sequence, Type

import torch

from repro_torch.run import hooks as hooks_lib
from repro_torch.run.data import make_batch_iter
from repro_torch.run.program import StepProgram, build_step_program
from repro_torch.run.spec import RunSpec


@dataclasses.dataclass
class RunContext:
    """What hooks see: the spec, the program, the live (params, opt_state)
    after the most recent step, and the log function."""

    spec: RunSpec
    program: StepProgram
    params: Any
    opt_state: Any
    log: Callable[[str], None]
    hooks: tuple
    start_step: int = 0


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


def _default_hooks(spec: RunSpec, *, log_fn, user_hooks) -> tuple:
    user = tuple(user_hooks)

    def absent(cls):
        return not any(isinstance(h, cls) for h in user)

    out = []
    if absent(hooks_lib.HistoryHook):
        out.append(hooks_lib.HistoryHook())
    if spec.log_every and absent(hooks_lib.LoggingHook):
        out.append(hooks_lib.LoggingHook(spec.log_every, log_fn,
                                         total=spec.steps.total))
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
        batch_iter: Optional[Iterator[dict]] = None, start_step: int = 0,
        groups=None, device="cuda",
        log_fn: Callable[[str], None] = print) -> RunResult:
    """Drive one run end-to-end.  Overrides (all optional):

    ``arch``       an Arch instance for ad-hoc configs (else registry);
    ``program``    a prebuilt StepProgram (else ``build_step_program``);
    ``params`` / ``opt_state``  warm starts, updated **in place**
                   (opt_state defaults to a fresh ``opt.init(params)``);
    ``batch_iter`` an injected stream of numpy batches (else built from
                   ``spec.data``);
    ``hooks``      appended after the default pipeline (same-class user
                   hooks replace the default instance);
    ``start_step`` begin mid-schedule;
    ``device``     where the run lives: the card by default, and the call
                   raises if there is none; pass ``"cpu"`` for the CPU.
    """
    if program is None:
        program = build_step_program(spec, arch, groups=groups, device=device)
    device = program.device
    arch = program.arch

    if params is None:
        params, opt_state = program.init(spec.seed)
    elif opt_state is None:
        opt_state = program.opt.init(params)

    if batch_iter is None:
        batch_iter = make_batch_iter(spec, arch, start_step)

    pipeline = _default_hooks(spec, log_fn=log_fn, user_hooks=hooks)
    ctx = RunContext(spec=spec, program=program, params=params,
                     opt_state=opt_state, log=log_fn, hooks=pipeline,
                     start_step=start_step)
    try:
        # on_run_start inside the try: if a hook raises here, earlier hooks
        # that already started still get their on_exit.
        for h in pipeline:
            h.on_run_start(ctx)
        t_last = time.time()
        for step in range(start_step, spec.steps.total):
            batch = batch_to_device(next(batch_iter), device)
            hp = program.hparams_fn(step + 1)
            ctx.params, ctx.opt_state, loss, metrics = program.step(
                ctx.params, ctx.opt_state, batch, hp)
            loss_h, metrics_h = to_host(loss, metrics)
            now = time.time()
            ev = hooks_lib.StepEvent(step=step, loss=loss_h,
                                     metrics=metrics_h, hparams=hp,
                                     dt=now - t_last)
            t_last = now
            for h in pipeline:
                h.on_step_end(ctx, ev)
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
