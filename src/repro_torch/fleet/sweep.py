"""Sweep driver (PyTorch): fan one base RunSpec across declarative
overrides.  A copy of ``repro.fleet.sweep`` over the port's ``run``,
``fleet.preempt`` and ``telemetry.schema`` (host logic).

A sweep is data: a base :class:`~repro_torch.run.spec.RunSpec` plus a list
of override dicts (dotted spec paths → values, e.g.
``{"opt.lr": 3e-3, "opt.name": "lomo"}``), or a grid expanded into one.
Each member becomes a fully materialized RunSpec under its own directory:

  sweep_dir/
    report.json                 # merged, ranked (written/refreshed last)
    00_opt.lr=0.001/
      spec.json                 # the member's exact RunSpec (replayable)
      ckpt/                     # member checkpoints (+ preempt marker)
      metrics.jsonl             # MetricsHook stream (throughput+liveness)
      history.json              # HistoryHook curves
      DONE.json                 # completion marker → re-invokes skip it
    01_.../

Fleet properties, all inherited from the run layer:

  * **crash isolation** — members run sequentially in-process (failures
    recorded, sweep continues) or as subprocesses (``mode="subprocess"``,
    bounded by ``parallel``) where a member death cannot touch the driver;
  * **individual resumability** — member specs force ``resume=True`` +
    ``gc_incomplete=True``; re-invoking the sweep skips DONE members and
    resumes killed/preempted ones from their last complete checkpoint
    (preemption = child exit :data:`~repro_torch.fleet.preempt.
    PREEMPTED_EXIT_CODE`);
  * **one report** — :func:`build_report` merges every member's
    HistoryHook/MetricsHook outputs (final/best loss, eval curve minimum,
    mean real-token throughput, straggler/stall event counts) into one
    JSON ranked by objective.

Members run where ``device`` says — the card by default, ``"cpu"`` on
request — in process (``run(..., device=)``) and in a subprocess member
(``--device``), whose child imports the same ``repro_torch`` as this
process.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

from repro_torch.run.spec import CheckpointSpec, RunSpec

DONE_MARKER = "DONE.json"


# --------------------------------------------------------------------------
# Declarative overrides
# --------------------------------------------------------------------------

def expand_grid(grid: Mapping[str, Sequence[Any]]) -> list[dict]:
    """Cartesian product of ``{dotted.path: [values...]}`` → override
    dicts, in deterministic (sorted-key, given-value-order) order."""
    keys = sorted(grid)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(grid[k] for k in keys))]


def apply_overrides(spec: RunSpec, overrides: Mapping[str, Any]) -> RunSpec:
    """Rebuild ``spec`` with each dotted path replaced — pure dataclass
    surgery, so an unknown field fails loudly with its full path."""
    for path in sorted(overrides):
        spec = _replace_path(spec, path.split("."), overrides[path], path)
    return spec


def _replace_path(obj, parts, value, full_path):
    if not dataclasses.is_dataclass(obj):
        raise ValueError(f"override {full_path!r}: {type(obj).__name__} "
                         "is not a spec node")
    name = parts[0]
    if not any(f.name == name for f in dataclasses.fields(obj)):
        raise ValueError(
            f"override {full_path!r}: {type(obj).__name__} has no field "
            f"{name!r} (fields: "
            f"{[f.name for f in dataclasses.fields(obj)]})")
    if len(parts) == 1:
        return dataclasses.replace(obj, **{name: value})
    return dataclasses.replace(
        obj, **{name: _replace_path(getattr(obj, name), parts[1:], value,
                                    full_path)})


def member_name(index: int, overrides: Mapping[str, Any]) -> str:
    """Deterministic, filesystem-safe member id: ``00_opt.lr=0.001``."""
    slug = "-".join(f"{k}={overrides[k]}" for k in sorted(overrides))
    slug = "".join(c if c.isalnum() or c in ".=-_" else "_" for c in slug)
    return f"{index:02d}_{slug[:80]}" if slug else f"{index:02d}_base"


@dataclasses.dataclass(frozen=True)
class SweepMember:
    name: str
    overrides: dict
    spec: RunSpec
    dir: Path

    @property
    def done_marker(self) -> Path:
        return self.dir / DONE_MARKER


def materialize(base: RunSpec, variants: Sequence[Mapping[str, Any]],
                sweep_dir) -> list[SweepMember]:
    """Expand variants into fully-specified member RunSpecs: per-member
    checkpoint dir (resume + gc_incomplete forced on), metrics stream,
    spec.json written for replay."""
    sweep_dir = Path(sweep_dir)
    members = []
    for i, ov in enumerate(variants):
        name = member_name(i, ov)
        mdir = sweep_dir / name
        spec = apply_overrides(base, ov)
        every = spec.checkpoint.every or max(1, spec.steps.total // 4)
        spec = dataclasses.replace(
            spec,
            checkpoint=CheckpointSpec(dir=str(mdir / "ckpt"), every=every,
                                      resume=True,
                                      keep_last=spec.checkpoint.keep_last,
                                      gc_incomplete=True),
            metrics_path=str(mdir / "metrics.jsonl"))
        mdir.mkdir(parents=True, exist_ok=True)
        (mdir / "spec.json").write_text(spec.to_json(indent=1))
        members.append(SweepMember(name=name, overrides=dict(ov),
                                   spec=spec, dir=mdir))
    return members


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------

def _write_done(member: SweepMember, history: dict) -> None:
    (member.dir / "history.json").write_text(json.dumps(history))
    final = history.get("loss", [])
    member.done_marker.write_text(json.dumps(
        {"name": member.name, "steps": member.spec.steps.total,
         "final_loss": final[-1] if final else None}))


def _run_member_inproc(member: SweepMember, *, log_fn, member_hooks,
                       run_kwargs, device) -> str:
    """One member in this process; returns its status.  Any exception is
    contained (crash isolation) — only KeyboardInterrupt and the chaos
    harness's SimulatedKill propagate, so tests can kill a member
    mid-sweep exactly like a process death."""
    from repro_torch.fleet.preempt import Preempted
    from repro_torch.run.runner import run
    hooks = tuple(member_hooks(member)) if member_hooks else ()
    try:
        res = run(member.spec, hooks=hooks, log_fn=log_fn,
                  **{"device": device, **(run_kwargs or {})})
    except Preempted as e:
        log_fn(f"[{member.name}] preempted at step {e.step} (resumable)")
        return "preempted"
    except KeyboardInterrupt:
        raise
    except Exception as e:
        (member.dir / "error.txt").write_text(
            f"{type(e).__name__}: {e}\n")
        log_fn(f"[{member.name}] failed: {type(e).__name__}: {e}")
        return "failed"
    _write_done(member, res.history)
    return "done"


def _child_env() -> dict:
    """This environment with the directory holding ``repro_torch`` first on
    ``PYTHONPATH``, so a subprocess member imports the package this process
    runs."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _run_members_subprocess(todo: list[SweepMember], *, parallel: int,
                            extra_args: Sequence[str], log_fn,
                            device) -> dict:
    """Crash-isolated members: each is ``python -m repro_torch.launch.train
    --spec <member>/spec.json --device <device>``, at most ``parallel`` in
    flight."""
    from repro_torch.fleet.preempt import PREEMPTED_EXIT_CODE
    statuses: dict[str, str] = {}
    pending = list(todo)
    live: list[tuple[SweepMember, subprocess.Popen, Any]] = []
    env = _child_env()
    while pending or live:
        while pending and len(live) < max(1, parallel):
            m = pending.pop(0)
            log = open(m.dir / "stdout.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.train",
                   "--spec", str(m.dir / "spec.json"),
                   "--history-out", str(m.dir / "history.json"),
                   "--device", str(device), *extra_args]
            live.append((m, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env), log))
            log_fn(f"[{m.name}] launched (pid "
                   f"{live[-1][1].pid}, {len(live)} in flight)")
        still = []
        for m, proc, log in live:
            rc = proc.poll()
            if rc is None:
                still.append((m, proc, log))
                continue
            log.close()
            if rc == 0:
                hist_file = m.dir / "history.json"
                hist = (json.loads(hist_file.read_text())
                        if hist_file.exists() else {})
                _write_done(m, hist)
                statuses[m.name] = "done"
            elif rc == PREEMPTED_EXIT_CODE:
                statuses[m.name] = "preempted"
            else:
                statuses[m.name] = "failed"
            log_fn(f"[{m.name}] exit {rc} → {statuses[m.name]}")
        live = still
        if live:
            time.sleep(0.05)
    return statuses


def run_sweep(base: RunSpec, variants: Sequence[Mapping[str, Any]],
              sweep_dir, *, mode: str = "inproc", parallel: int = 1,
              extra_args: Sequence[str] = (), member_hooks=None,
              run_kwargs: Optional[dict] = None, objective: str = "loss",
              device="cuda", log_fn=print) -> dict:
    """Drive the sweep to (partial) completion and write the merged
    report.  Idempotent: re-invoke after any crash/preemption and DONE
    members are skipped while the rest resume from their checkpoints.

    ``member_hooks(member) -> hooks`` (inproc only) injects per-member
    hooks — the chaos tests' kill switch; ``run_kwargs`` forwards to
    ``run()`` (e.g. ``arch=`` for ad-hoc archs); ``extra_args`` appends
    to the subprocess command line; ``device`` is where every member runs
    (the card by default; ``"cpu"`` asks for the CPU)."""
    assert mode in ("inproc", "subprocess"), mode
    sweep_dir = Path(sweep_dir)
    members = materialize(base, variants, sweep_dir)

    statuses: dict[str, str] = {}
    todo = []
    for m in members:
        if m.done_marker.exists():
            statuses[m.name] = "done"
            log_fn(f"[{m.name}] already done, skipping")
        else:
            todo.append(m)

    if mode == "inproc":
        for m in todo:
            log_fn(f"[{m.name}] running ({len(statuses)+1}/{len(members)})")
            statuses[m.name] = _run_member_inproc(
                m, log_fn=log_fn, member_hooks=member_hooks,
                run_kwargs=run_kwargs, device=device)
    else:
        statuses.update(_run_members_subprocess(
            todo, parallel=parallel, extra_args=extra_args, log_fn=log_fn,
            device=device))

    report = build_report(base, members, statuses, objective=objective)
    (sweep_dir / "report.json").write_text(json.dumps(report, indent=1,
                                                      sort_keys=True))
    return report


# --------------------------------------------------------------------------
# Report
# --------------------------------------------------------------------------

def _member_stats(member: SweepMember) -> dict:
    """Merge one member's HistoryHook + MetricsHook artifacts."""
    stats: dict[str, Any] = {}
    hist_file = member.dir / "history.json"
    if hist_file.exists():
        h = json.loads(hist_file.read_text())
        if h.get("loss"):
            stats["final_loss"] = h["loss"][-1]
            stats["best_loss"] = min(h["loss"])
        if h.get("eval_loss"):
            stats["best_eval_loss"] = min(h["eval_loss"])
    metrics = member.dir / "metrics.jsonl"
    if metrics.exists():
        # versioned-stream aware: the lenient reader skips the schema
        # header and truncated tails; classify() keeps probe / gauge
        # records out of the step statistics
        from repro_torch.telemetry.schema import classify, iter_data_records
        steps, tps, events, last_loss = [], [], {}, None
        anomalies = 0
        for r in iter_data_records(metrics.read_text().splitlines()):
            kind = classify(r)
            if kind == "event":
                events[r["event"]] = events.get(r["event"], 0) + 1
            elif kind == "anomaly":
                anomalies += 1
            elif kind == "step":
                steps.append(r["step"])
                last_loss = r.get("loss", last_loss)
                if r.get("tokens_per_s"):
                    tps.append(r["tokens_per_s"])
        if steps:
            stats["steps_done"] = max(steps) + 1
            # partial runs (killed/preempted) have no history.json yet;
            # the metrics stream still gives a best-effort loss
            stats.setdefault("final_loss", last_loss)
        if tps[1:]:     # drop the first (warm-up) step's throughput
            stats["mean_tokens_per_s"] = sum(tps[1:]) / len(tps[1:])
        if events:
            stats["events"] = events
        if anomalies:
            stats["anomalies"] = anomalies
    return stats


def build_report(base: RunSpec, members: Sequence[SweepMember],
                 statuses: Mapping[str, str], *,
                 objective: str = "loss") -> dict:
    """The one merged sweep artifact: per-member stats + a ranking of
    completed members by ``objective`` ("loss" → final_loss ascending,
    "eval_loss" → best_eval_loss ascending)."""
    key = {"loss": "final_loss", "eval_loss": "best_eval_loss"}[objective]
    rows = []
    for m in members:
        rows.append({"name": m.name, "overrides": m.overrides,
                     "status": statuses.get(m.name, "pending"),
                     **_member_stats(m)})
    ranked = sorted(
        (r for r in rows if r["status"] == "done" and r.get(key) is not None),
        key=lambda r: r[key])
    return {"objective": key,
            "n_members": len(rows),
            "n_done": sum(1 for r in rows if r["status"] == "done"),
            "ranking": [r["name"] for r in ranked],
            "best": (ranked[0] if ranked else None),
            "members": rows,
            "base_spec": base.to_dict()}
