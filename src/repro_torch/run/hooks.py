"""The hook pipeline: checkpoint, eval, logging, fault, profiling and
history capture as ordered callbacks on a five-event protocol.

Counterpart of ``repro.run.hooks``.  Events, dispatched in hook-list order
by ``repro_torch.run.runner.run``:

  ``on_run_start(ctx)``                 once, after init/restore, before
                                        the first step;
  ``on_step_end(ctx, ev)``              after every completed step, with a
                                        :class:`StepEvent`;
  ``on_eval(ctx, step, metrics)``       whenever an evaluation ran
                                        (emitted by :class:`EvalHook` via
                                        ``ctx.dispatch_eval`` — every hook
                                        sees it);
  ``on_recover(ctx, restored_step)``    fault recovery rewound the run to
                                        ``restored_step``: hooks that
                                        accumulate per-step state discard
                                        entries at/after it, or they
                                        double-count the re-executed steps;
  ``on_exit(ctx)``                      once, after the last step (also on
                                        the exception path), for draining
                                        async work.

Hooks are host-side only: they see host scalars and never read a device
value themselves.  The default pipeline order (straggler → heartbeat →
profiler → history → logging → metrics → eval → checkpoint → preemption)
puts measurement before side effects: a checkpoint at step N always
contains exactly the state whose metrics step N's hooks observed.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from repro_torch.telemetry.schema import header_record, jsonify
from repro_torch.train.fault import Heartbeat, StragglerMonitor


@dataclasses.dataclass
class StepEvent:
    """What ``on_step_end`` sees: the 0-based step index, **host** scalars
    (loss, metrics dict, hparams dict — the runner performs ONE bundled
    device-to-host transfer per step and converts to Python floats before
    dispatch), and the host wall-clock seconds since the previous step."""

    step: int
    loss: Any
    metrics: Any
    hparams: dict
    dt: float


class Hook:
    """Base class: every event defaults to a no-op, so hooks implement
    only what they observe."""

    def on_run_start(self, ctx) -> None:
        pass

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        pass

    def on_eval(self, ctx, step: int, metrics: dict) -> None:
        pass

    def on_recover(self, ctx, restored_step: int) -> None:
        """Fault recovery rewound the run to ``restored_step``; hooks that
        accumulate per-step state discard everything at or after it so the
        final record matches an uninterrupted run."""
        pass

    def on_exit(self, ctx) -> None:
        pass


class HistoryHook(Hook):
    """Captures the training curve, in the reference's history dict."""

    def __init__(self):
        self.history = {"step": [], "loss": [], "accuracy": [], "lr": [],
                        "eval_loss": [], "eval_step": []}

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        self.history["step"].append(ev.step)
        self.history["loss"].append(ev.loss)
        self.history["accuracy"].append(ev.metrics["accuracy"])
        self.history["lr"].append(ev.hparams["lr"])

    def on_eval(self, ctx, step: int, metrics: dict) -> None:
        self.history["eval_loss"].append(metrics["loss"])
        self.history["eval_step"].append(step)

    def on_recover(self, ctx, restored_step: int) -> None:
        h = self.history
        keep = sum(1 for s in h["step"] if s < restored_step)
        for k in ("step", "loss", "accuracy", "lr"):
            del h[k][keep:]
        keep_ev = sum(1 for s in h["eval_step"] if s < restored_step)
        for k in ("eval_loss", "eval_step"):
            del h[k][keep_ev:]


class LoggingHook(Hook):
    def __init__(self, every: int, log_fn: Callable[[str], None] = print,
                 total: Optional[int] = None):
        self.every = every
        self.log = log_fn
        self.total = total

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        last = self.total is not None and ev.step == self.total - 1
        if self.every and (ev.step % self.every == 0 or last):
            self.log(f"step {ev.step:5d} loss {ev.loss:.4f} "
                     f"acc {ev.metrics['accuracy']:.3f} "
                     f"lr {ev.hparams['lr']:.2e} "
                     f"({ev.dt*1e3:.0f} ms)")

    def on_eval(self, ctx, step: int, metrics: dict) -> None:
        self.log(f"  eval loss {metrics['loss']:.4f} "
                 f"ppl {metrics['ppl']:.2f} acc {metrics['accuracy']:.3f}")


class MetricsHook(Hook):
    """JSONL metrics exporter: one record per observed step — step, loss,
    lr, wall dt, real-token throughput (tokens/s from the step's
    ``ntokens`` metric) and padding efficiency (real tokens / slot tokens).
    Honors the rewind contract like :class:`HistoryHook`: ``on_recover``
    drops step-keyed records at/after the restored step and rewrites the
    file, so the JSONL always reads as the uninterrupted run's record.  The
    same contract extends across *process* restarts: a resumed run
    (``ctx.start_step > 0``) keeps the existing records before the restored
    step and truncates the re-executed tail, so one metrics file carries
    the whole history of a preempted-and-resumed run.

    Besides per-step records, the stream carries *event* records
    (``{"event": kind, "step": N, ...}``): heartbeat stalls, straggler
    steps, recoveries and preemptions annotate themselves here via
    :meth:`annotate` (thread-safe; the heartbeat watchdog fires from its own
    thread).

    The file is a schema-v1 stream (``repro_torch.telemetry.schema``): it
    opens with a ``{"schema": 1, "stream": "train"}`` header, which is
    never stored in ``records``; legacy headerless files still resume
    cleanly.  When the run's ObservabilitySpec is enabled, the
    optimizer-health values arriving in ``ev.metrics["opt_health"]``
    (already host values — they rode the runner's one transfer) are
    recorded as ``probe`` records at the spec's cadence; the sentinel's
    verdicts become ``anomaly`` records (:meth:`record_anomaly`)."""

    def __init__(self, path, every: int = 1):
        self.path = str(path)
        self.every = max(1, int(every))
        self.records: list = []
        self._slot_tokens: Optional[int] = None
        self._fh = None
        self._lock = threading.Lock()

    def _rewrite(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self.path, "w")
        self._fh.write(json.dumps(header_record("train")) + "\n")
        for r in self.records:
            self._fh.write(json.dumps(r) + "\n")
        self._fh.flush()

    def on_run_start(self, ctx) -> None:
        d = ctx.spec.data
        if d is not None:
            self._slot_tokens = d.global_batch * d.seq_len
        p = Path(self.path)
        parent = p.parent
        if str(parent) not in ("", "."):
            parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            self.records = []
            if ctx.start_step > 0 and p.exists():
                # cross-process resume: keep the pre-restore record,
                # truncate the tail the resumed run re-executes
                for line in p.read_text().splitlines():
                    try:
                        r = json.loads(line)
                    except ValueError:  # crash-truncated last line
                        continue
                    if "schema" in r:
                        continue   # header: re-emitted by _rewrite
                    if r.get("step", ctx.start_step) < ctx.start_step:
                        self.records.append(r)
            self._rewrite()

    def _append(self, rec: dict) -> None:
        with self._lock:
            self.records.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()

    def annotate(self, kind: str, step: int, **payload) -> None:
        """Append an event record (heartbeat stalls, straggler steps,
        recoveries, preemption) to the JSONL stream."""
        self._append({"event": kind, "step": int(step), **payload})

    def record_anomaly(self, step: int, reason: str, **payload) -> None:
        """Append an ``anomaly`` record (schema kind ``anomaly``, marker =
        the detection reason); it rides the same rewind contract as every
        step-keyed record."""
        self._append(jsonify(
            {"anomaly": reason, "step": int(step), **payload}))

    def _record_probes(self, ctx, step: int, health) -> None:
        """Record the step's optimizer-health dict (already host-side) as
        probe records at the ObservabilitySpec cadence."""
        ospec = getattr(ctx.spec, "observe", None)
        if ospec is None or not ospec.enabled:
            return
        if step % ospec.optimizer_every == 0:
            self._append(jsonify(
                {"probe": "opt_health", "step": step,
                 "group_ratio": health.get("group_ratio", {}),
                 "eff_lr": health.get("eff_lr", {})}))
        factored = health.get("factored")
        if factored and step % ospec.resolved_factored_every() == 0:
            self._append(jsonify(
                {"probe": "factored", "step": step, **factored}))

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        health = (ev.metrics.get("opt_health")
                  if isinstance(ev.metrics, dict) else None)
        if health is not None:
            self._record_probes(ctx, ev.step, health)
        if ev.step % self.every:
            return
        ntok = ev.metrics.get("ntokens", 0.0)
        rec = {"step": ev.step, "loss": ev.loss,
               "lr": ev.hparams["lr"], "dt_s": ev.dt,
               "ntokens": ntok,
               "tokens_per_s": (ntok / ev.dt) if ev.dt > 0 else 0.0}
        if self._slot_tokens:
            rec["padding_efficiency"] = ntok / self._slot_tokens
        self._append(rec)

    def on_recover(self, ctx, restored_step: int) -> None:
        # Step-keyed records rewind (the replay re-emits them); ``event``
        # records are the host-side incident log — replay never re-emits
        # those, so truncating them would erase real faults.
        with self._lock:
            self.records = [r for r in self.records
                            if "event" in r
                            or r.get("step", restored_step) < restored_step]
            self._rewrite()

    def on_exit(self, ctx) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def find_metrics_hook(hooks) -> Optional["MetricsHook"]:
    """The pipeline's MetricsHook, if any (liveness hooks route their
    signals into its JSONL stream)."""
    for h in hooks:
        if isinstance(h, MetricsHook):
            return h
    return None


class EvalHook(Hook):
    """Runs held-out eval every ``every`` steps and broadcasts the result
    to the whole pipeline via ``ctx.dispatch_eval``.

    Two stream modes: a plain ``eval_iter`` (caller-owned; cannot be
    rewound across resume/recovery), or an ``iter_factory(start_batch)`` —
    the default pipeline's mode — which makes the eval stream a pure
    function of how many evals the run has completed, so a resumed or
    fault-recovered run consumes exactly the batches the uninterrupted run
    would have."""

    def __init__(self, eval_iter=None, every: int = 0, n_batches: int = 4,
                 *, iter_factory=None):
        if (eval_iter is None) == (iter_factory is None):
            raise ValueError("pass exactly one of eval_iter / iter_factory")
        self.eval_iter = eval_iter
        self.iter_factory = iter_factory
        self.every = every
        self.n_batches = n_batches

    def _rewind(self, step: int) -> None:
        if self.iter_factory is None or not self.every:
            return
        consumed = (step // self.every) * self.n_batches
        self.eval_iter = self.iter_factory(consumed)

    def on_run_start(self, ctx) -> None:
        self._rewind(ctx.start_step)

    def on_recover(self, ctx, restored_step: int) -> None:
        self._rewind(restored_step)

    @torch.no_grad()
    def evaluate(self, ctx) -> dict:
        """Mean loss, perplexity and accuracy over ``n_batches`` batches;
        no autograd graph, one device-to-host transfer."""
        from repro_torch.run.runner import batch_to_device
        loss_fn = ctx.program.loss_fn
        losses, accs = [], []
        for _ in range(self.n_batches):
            batch = batch_to_device(next(self.eval_iter), ctx.program.device)
            loss, metrics = loss_fn(ctx.params, batch)
            losses.append(loss.to(torch.float32))
            accs.append(metrics["accuracy"].to(torch.float32))
        vals = torch.stack(losses + accs).cpu().tolist()
        tot = sum(vals[:self.n_batches]) / self.n_batches
        return {"loss": tot, "ppl": math.exp(tot),
                "accuracy": sum(vals[self.n_batches:]) / self.n_batches}

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        if self.every and (ev.step + 1) % self.every == 0:
            ctx.dispatch_eval(ev.step, self.evaluate(ctx))


class CheckpointHook(Hook):
    """Checkpoint save every ``every`` steps; drains on exit.  The saved
    tree is ``(params, opt_state)`` with the data step recorded so resume
    is exactly deterministic, and the sentinel monitor's state (counters,
    quarantine, device-state snapshot) under ``extra["sentinel"]`` when the
    run has one."""

    def __init__(self, manager, every: int):
        self.manager = manager
        self.every = every

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        if self.every and (ev.step + 1) % self.every == 0:
            extra = {"data_step": ev.step + 1}
            if getattr(ctx, "sentinel", None) is not None:
                # monitor counters + device-state snapshot: a resumed run
                # rebuilds the sentinel's cross-step memory bitwise
                extra["sentinel"] = ctx.sentinel.to_extra()
            self.manager.save(ev.step + 1, (ctx.params, ctx.opt_state),
                              extra=extra)

    def on_exit(self, ctx) -> None:
        self.manager.wait()


class HeartbeatHook(Hook):
    """Watchdog: marks the run wedged if steps stop completing.  A stall
    is annotated into the MetricsHook JSONL stream (``{"event":
    "heartbeat_stall", ...}``) when the pipeline has one."""

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self._on_stall = on_stall
        self.heartbeat: Optional[Heartbeat] = None
        self._last_step = 0

    def on_run_start(self, ctx) -> None:
        self._last_step = ctx.start_step
        metrics = find_metrics_hook(ctx.hooks)
        # not ctx itself: ctx holds the hooks, so a closure over it would
        # be a cycle keeping the run's params alive until the cyclic GC
        log = ctx.log

        def fire():
            # annotate runs from the watchdog thread — MetricsHook locks
            if metrics is not None:
                metrics.annotate("heartbeat_stall", self._last_step,
                                 timeout_s=self.timeout_s)
            if self._on_stall is not None:
                self._on_stall()
            else:
                log("HEARTBEAT STALL")

        self.heartbeat = Heartbeat(self.timeout_s, on_stall=fire)
        self.heartbeat.start()

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        self._last_step = ev.step
        if self.heartbeat is not None:
            self.heartbeat.beat()

    def on_exit(self, ctx) -> None:
        if self.heartbeat is not None:
            self.heartbeat.stop()


class StragglerHook(Hook):
    """Feeds per-step wall time into a :class:`StragglerMonitor` (EMA
    outlier detection).  Flagged steps are annotated into the MetricsHook
    JSONL stream (``{"event": "straggler", ...}``) when the pipeline has
    one."""

    def __init__(self, monitor: Optional[StragglerMonitor] = None):
        self.monitor = monitor if monitor is not None else StragglerMonitor()

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        if self.monitor.observe(ev.step, ev.dt):
            metrics = find_metrics_hook(ctx.hooks)
            if metrics is not None:
                _, dt, ema = self.monitor.events[-1]
                metrics.annotate("straggler", ev.step, dt_s=dt, ema_s=ema)


class TimingHook(Hook):
    """Wall-clock accounting: total run seconds, mean us/step, and each
    step's seconds (``ev.dt`` ends at the step's one host transfer, which
    waits for the device, so it is the step's real time)."""

    def __init__(self):
        self.t0 = None
        self.wall_s = 0.0
        self.n_steps = 0
        self.step_s: list = []

    def on_run_start(self, ctx) -> None:
        self.t0 = time.time()

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        self.n_steps += 1
        self.step_s.append(ev.dt)

    def on_exit(self, ctx) -> None:
        if self.t0 is not None:
            self.wall_s = time.time() - self.t0

    @property
    def us_per_step(self) -> float:
        return self.wall_s / max(self.n_steps, 1) * 1e6


class ProfilerHook(Hook):
    """``torch.profiler`` trace for a configurable step window.

    Traces steps ``[start, start + steps)`` (0-based) — host ops, and the
    device's kernels when the run is on the card — and exports a Chrome
    trace into ``dir`` (``trace.<pid>.<ns>.json``, its path in
    ``trace_path``).  The directory gets a ``profile.runspec.json`` sidecar
    stamping the RunSpec that produced it.  The default window skips step
    0, which carries the first-call costs.

    Resume/recovery contract: a run restored *past* the window does not
    re-trace (the artifact belongs to the steps that already executed); a
    fault recovery while tracing stops the trace and keeps what was
    captured.  ``on_exit`` stops a still-active trace on any exit path, so
    a preempted run leaves a readable artifact.  A profiler that cannot
    start is logged and the run carries on untraced."""

    def __init__(self, dir, start: int = 1, steps: int = 2):
        self.dir = str(dir)
        self.start = int(start)
        self.steps = int(steps)
        self.active = False
        self.done = False
        self.trace_path: Optional[str] = None
        self._prof = None

    def _begin(self, ctx) -> None:
        try:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if ctx.program.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self.active = True
        except Exception as e:  # profiler backend unavailable: degrade
            ctx.log(f"profiler disabled: {type(e).__name__}: {e}")
            self._prof = None
            self.done = True

    def _end(self, ctx) -> None:
        if not self.active:
            return
        try:
            self._prof.stop()
            name = f"trace.{os.getpid()}.{time.time_ns()}.json"
            path = Path(self.dir) / name
            self._prof.export_chrome_trace(str(path))
            self.trace_path = str(path)
        except Exception as e:
            ctx.log(f"profiler stop failed: {type(e).__name__}: {e}")
        self._prof = None
        self.active = False
        self.done = True

    def on_run_start(self, ctx) -> None:
        out = Path(self.dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile.runspec.json").write_text(ctx.spec.to_json(indent=1))
        if ctx.start_step > self.start:
            self.done = True       # window already executed pre-resume
        elif ctx.start_step == self.start:
            self._begin(ctx)

    def on_step_end(self, ctx, ev: StepEvent) -> None:
        if self.done:
            return
        if self.active and ev.step + 1 >= self.start + self.steps:
            self._end(ctx)
        elif not self.active and ev.step + 1 == self.start:
            self._begin(ctx)

    def on_recover(self, ctx, restored_step: int) -> None:
        self._end(ctx)

    def on_exit(self, ctx) -> None:
        self._end(ctx)
