"""Chrome-trace / Perfetto exporter for telemetry streams.  A copy of
``repro.telemetry.trace``.

Converts a schema-v1 :class:`~repro_torch.telemetry.schema.TelemetryStream`
into the Trace Event JSON format (``chrome://tracing`` / Perfetto's
legacy loader): step records become duration events on a ``train`` track
(dur = the step's host wall ``dt_s``), probe and event records become
instant events at their step's end, serve gauges become counter tracks
(pool utilization / queue depth plotted over time), and kernel records
become duration events on a ``kernels`` track when they carry a measured
``wall_us``.

Timebases: train tracks place events on the cumulative step clock
(Σ dt_s); serve tracks use the gauge records' own ``t_s``.  Both are
microseconds in the output, as the format requires.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.telemetry.schema import TelemetryStream, jsonify

# stable pid per producer family → stable track grouping in the UI
_PIDS = {"train": 1, "serve": 2, "kernel": 3}

_GAUGE_COUNTERS = ("pool_util", "queue_depth", "running",
                   "block_table_occupancy")


def _ev(name, ph, ts, pid, tid, **kw) -> dict:
    out = {"name": name, "ph": ph, "ts": ts, "pid": pid, "tid": tid}
    out.update(kw)
    return out


def chrome_trace(stream: TelemetryStream) -> dict:
    """Render one stream as a Trace Event JSON object."""
    events = []
    fam = (stream.header or {}).get("stream", "train")
    pid = _PIDS.get(fam, 9)
    events.append(_ev("process_name", "M", 0, pid, 0,
                      args={"name": f"repro/{fam}"}))

    # ---- train: steps on the cumulative step clock -------------------
    t_us = 0.0
    step_end_us = {}
    for rec in stream.steps():
        dur = float(rec.get("dt_s", 0.0)) * 1e6
        args = {k: v for k, v in rec.items() if k not in ("step", "dt_s")}
        events.append(_ev(f"step", "X", t_us, pid, 0, dur=dur,
                          args=jsonify({"step": rec["step"], **args})))
        t_us += dur
        step_end_us[rec["step"]] = t_us
    for kind, track in (("probe", 1), ("event", 2)):
        for rec in stream.of_kind(kind):
            ts = step_end_us.get(rec["step"], t_us)
            events.append(_ev(f"{kind}:{rec[kind]}", "i", ts, pid, track,
                              s="t", args=jsonify(rec)))

    # ---- serve: counter tracks on the gauge clock --------------------
    for rec in stream.gauges():
        ts = float(rec["t_s"]) * 1e6
        for key in _GAUGE_COUNTERS:
            if key in rec:
                events.append(_ev(key, "C", ts, pid, 0,
                                  args={key: rec[key]}))

    # ---- kernels: measured launches as duration events ---------------
    k_us = 0.0
    for rec in stream.kernels():
        dur = float(rec.get("wall_us", 0.0))
        events.append(_ev(rec["kernel"], "X", k_us, pid, 0, dur=dur,
                          args=jsonify({k: v for k, v in rec.items()
                                        if k != "kernel"})))
        k_us += dur
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(stream: TelemetryStream, path) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(chrome_trace(stream), indent=1) + "\n")
    return p
