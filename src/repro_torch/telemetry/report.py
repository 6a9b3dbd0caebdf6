"""``python -m repro_torch.telemetry.report`` — merge telemetry streams into
one ranked summary (text or JSON).  A copy of
``repro.telemetry.report``, over the port's own reader.

Reads any number of schema-v1 (or legacy, headerless) JSONL streams —
a training run's MetricsHook file, a serve engine's gauge stream, a
roofline benchmark's kernel stream — and merges them into a single
summary: training curve endpoints and throughput, optimizer-probe
families with their latest values, serve pool/queue/time-split state,
and kernel launches ranked by measured wall time.

Reproduction contract (asserted for the JAX package by
``tests/telemetry/test_report.py``, for the port by
``tests/test_torch_run_hooks.py``):
the summary's ``final_loss``, ``tokens_per_s.final`` and
``pool_utilization.final`` are the recorded stream values **verbatim** —
no re-derivation, no rounding — so the report is bitwise-faithful to the
run it summarizes, and its output on a fixed stream is golden-stable.

    PYTHONPATH=src python -m repro_torch.telemetry.report out/metrics.jsonl \
        [serve.jsonl ...] [--json] [--out report.json] [--chrome-trace t.json]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.telemetry.schema import TelemetryStream, read_stream


def _mean(xs: list) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def _summarize_train(streams: Sequence[TelemetryStream]) -> Optional[dict]:
    steps, events, probes, anomalies = [], {}, {}, {}
    anomaly_last = None
    for st in streams:
        steps.extend(st.steps())
        for r in st.events():
            events[r["event"]] = events.get(r["event"], 0) + 1
        for r in st.anomalies():
            anomalies[r["anomaly"]] = anomalies.get(r["anomaly"], 0) + 1
            anomaly_last = r["step"]
        for r in st.probes():
            fam = probes.setdefault(r["probe"], {"records": 0})
            fam["records"] += 1
            fam["last_step"] = r["step"]
            fam["last"] = {k: v for k, v in r.items()
                           if k not in ("probe", "step")}
    if not steps and not probes and not events and not anomalies:
        return None
    out: dict = {"steps": len(steps)}
    if steps:
        steps.sort(key=lambda r: r["step"])
        last = steps[-1]
        out["first_step"] = steps[0]["step"]
        out["last_step"] = last["step"]
        # verbatim stream values — the bitwise reproduction contract
        out["final_loss"] = last.get("loss")
        losses = [r["loss"] for r in steps if r.get("loss") is not None]
        out["min_loss"] = min(losses) if losses else None
        tps = [r["tokens_per_s"] for r in steps
               if r.get("tokens_per_s") is not None]
        out["tokens_per_s"] = {
            "final": tps[-1] if tps else None,
            # drop the compile step, as BENCH_step_time does
            "mean_after_first": _mean(tps[1:]),
        }
        pe = [r["padding_efficiency"] for r in steps
              if r.get("padding_efficiency") is not None]
        if pe:
            out["padding_efficiency"] = {"final": pe[-1], "mean": _mean(pe)}
    if events:
        out["events"] = dict(sorted(events.items()))
    if anomalies:
        out["anomalies"] = {"records": sum(anomalies.values()),
                            "by_reason": dict(sorted(anomalies.items())),
                            "last_step": anomaly_last}
    if probes:
        out["probes"] = dict(sorted(probes.items()))
    return out


def _summarize_serve(streams: Sequence[TelemetryStream]) -> Optional[dict]:
    gauges = []
    for st in streams:
        gauges.extend(st.gauges())
    if not gauges:
        return None
    gauges.sort(key=lambda r: r["t_s"])
    last = gauges[-1]
    util = [r["pool_util"] for r in gauges if "pool_util" in r]
    out = {
        "samples": len(gauges),
        "pool_utilization": {
            "final": util[-1] if util else None,   # verbatim — bitwise
            "max": max(util) if util else None,
            "mean": _mean(util),
        },
        "queue_depth_max": max((r.get("queue_depth", 0) for r in gauges),
                               default=0),
        "running_max": max((r.get("running", 0) for r in gauges),
                           default=0),
    }
    for key in ("admitted", "preempted", "finished", "evicted_pages",
                "timed_out", "prefill_s", "decode_s", "chunks"):
        if key in last:
            out[key] = last[key]
    if out.get("prefill_s") is not None and out.get("decode_s") is not None:
        tot = out["prefill_s"] + out["decode_s"]
        out["prefill_frac"] = out["prefill_s"] / tot if tot > 0 else None
    return out


def _summarize_kernels(streams: Sequence[TelemetryStream]) -> Optional[dict]:
    rows = []
    for st in streams:
        rows.extend(st.kernels())
    if not rows:
        return None
    # ranked: measured launches by wall time desc, analytic rows after
    rows.sort(key=lambda r: (-float(r.get("wall_us", -1.0)),
                             r["kernel"], json.dumps(r.get("shape", {}),
                                                     sort_keys=True)))
    return {"launches": len(rows), "ranked": rows}


def summarize(streams: Sequence[TelemetryStream]) -> dict:
    """Merge parsed streams into the one summary dict."""
    out: dict = {
        "schema_versions": sorted({st.schema for st in streams}),
        "streams": [st.path or "<memory>" for st in streams],
    }
    for key, fn in (("train", _summarize_train),
                    ("serve", _summarize_serve),
                    ("kernels", _summarize_kernels)):
        section = fn(streams)
        if section is not None:
            out[key] = section
    return out


# --------------------------------------------------------------------------
# Text rendering (golden-stable: fixed ordering, repr for verbatim values)
# --------------------------------------------------------------------------

def _fmt(x) -> str:
    """Derived quantities: short, stable formatting."""
    if x is None:
        return "-"
    if isinstance(x, float):
        return f"{x:.6g}"
    return str(x)


def render_text(summary: dict) -> str:
    lines = [f"telemetry report — streams: {len(summary['streams'])} "
             f"(schema {', '.join(map(str, summary['schema_versions']))})"]
    tr = summary.get("train")
    if tr:
        lines.append("")
        lines.append(f"train: {tr['steps']} steps")
        if "final_loss" in tr:
            lines.append(f"  steps {tr['first_step']}..{tr['last_step']}  "
                         f"final_loss {tr['final_loss']!r}  "
                         f"min_loss {_fmt(tr['min_loss'])}")
            tps = tr["tokens_per_s"]
            lines.append(f"  tokens_per_s final {tps['final']!r}  "
                         f"mean[1:] {_fmt(tps['mean_after_first'])}")
            if "padding_efficiency" in tr:
                pe = tr["padding_efficiency"]
                lines.append(f"  padding_efficiency final "
                             f"{_fmt(pe['final'])}  mean {_fmt(pe['mean'])}")
        for name, count in (tr.get("events") or {}).items():
            lines.append(f"  event {name}: {count}")
        an = tr.get("anomalies")
        if an:
            reasons = "  ".join(f"{k} {v}" for k, v in
                                an["by_reason"].items())
            lines.append(f"  anomalies: {an['records']} ({reasons}), "
                         f"last @ step {an['last_step']}")
        for name, fam in (tr.get("probes") or {}).items():
            lines.append(f"  probe {name}: {fam['records']} records, "
                         f"last @ step {fam['last_step']}")
    sv = summary.get("serve")
    if sv:
        lines.append("")
        pu = sv["pool_utilization"]
        lines.append(f"serve: {sv['samples']} gauge samples")
        lines.append(f"  pool_utilization final {pu['final']!r}  "
                     f"max {_fmt(pu['max'])}  mean {_fmt(pu['mean'])}")
        lines.append(f"  queue_depth_max {sv['queue_depth_max']}  "
                     f"running_max {sv['running_max']}")
        counters = [f"{k} {sv[k]}" for k in
                    ("admitted", "preempted", "finished", "evicted_pages",
                     "timed_out")
                    if k in sv]
        if counters:
            lines.append("  " + "  ".join(counters))
        if sv.get("prefill_frac") is not None:
            lines.append(f"  time split: prefill {_fmt(sv['prefill_s'])}s "
                         f"/ decode {_fmt(sv['decode_s'])}s "
                         f"(prefill_frac {_fmt(sv['prefill_frac'])})")
    kn = summary.get("kernels")
    if kn:
        lines.append("")
        lines.append(f"kernels: {kn['launches']} launches (ranked)")
        for r in kn["ranked"]:
            wall = (f"{float(r['wall_us']):.1f} us"
                    if "wall_us" in r else "analytic")
            frac = (f"  {100 * float(r['frac_of_peak']):.1f}% of peak"
                    if "frac_of_peak" in r else "")
            lines.append(
                f"  {r['kernel']:<24} {wall:>12}  "
                f"{float(r['flops']) / 1e6:10.3f} MFLOP  "
                f"{float(r['bytes']) / 1e6:10.3f} MB  "
                f"AI {float(r.get('intensity', 0.0)):.2f}{frac}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("streams", nargs="+", help="telemetry JSONL stream(s)")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of text")
    ap.add_argument("--out", default=None,
                    help="also write the JSON summary to this path")
    ap.add_argument("--chrome-trace", default=None,
                    help="also export a Chrome-trace/Perfetto JSON of the "
                         "first stream")
    ap.add_argument("--lenient", action="store_true",
                    help="skip malformed lines instead of failing")
    args = ap.parse_args(argv)

    streams = [read_stream(p, strict=not args.lenient)
               for p in args.streams]
    summary = summarize(streams)
    if args.out:
        Path(args.out).write_text(
            json.dumps(summary, indent=1, sort_keys=True) + "\n")
    if args.chrome_trace:
        from repro_torch.telemetry.trace import write_chrome_trace
        write_chrome_trace(streams[0], args.chrome_trace)
    text = (json.dumps(summary, indent=1, sort_keys=True)
            if args.json else render_text(summary))
    sys.stdout.write(text if text.endswith("\n") else text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
