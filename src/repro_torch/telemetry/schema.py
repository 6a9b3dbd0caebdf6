"""Telemetry stream schema v1 — one versioned JSONL format for train,
serve, and kernel telemetry.  A copy of ``repro.telemetry.schema`` (the
port imports nothing of ``repro``), reader half included, so the port
validates and summarizes its own streams.

A *stream* is a JSONL file.  Version-1 streams open with a **header
record** ``{"schema": 1, "stream": ...}``; every later line is a data
record of exactly one kind, discriminated by its marker key:

  ================  ==========================  =========================
  kind              marker                      required fields
  ================  ==========================  =========================
  ``header``        ``schema``                  ``schema`` (int >= 1)
  ``step``          none of the below           ``step``
  ``event``         ``event``                   ``event``, ``step``
  ``probe``         ``probe``                   ``probe``, ``step``
  ``gauge``         ``gauge``                   ``gauge``, ``t_s``
  ``kernel``        ``kernel``                  ``kernel``, ``flops``,
                                                ``bytes``
  ``anomaly``       ``anomaly``                 ``anomaly``, ``step``
  ================  ==========================  =========================

``step`` records are the pre-v1 MetricsHook format unchanged (step, loss,
lr, dt_s, ntokens, tokens_per_s, ...); ``event`` records are the
liveness annotations.  v1 *adds* probe / gauge / kernel kinds and the
header — a legacy stream (no header) is schema 0 and still reads
cleanly, which is the back-compat contract ``tests/run`` asserts.

The reader is validating: :func:`read_stream` classifies every record,
raises :class:`SchemaError` on a record that claims a kind but misses its
required fields or on a header from the future, and (non-strict mode)
skips crash-truncated trailing lines exactly like the resume path in
``run.hooks.MetricsHook``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Iterable, Iterator, Optional

SCHEMA_VERSION = 1

# record kind -> (marker key, required fields)
_KINDS = {
    "event": ("event", ("event", "step")),
    "probe": ("probe", ("probe", "step")),
    "gauge": ("gauge", ("gauge", "t_s")),
    "kernel": ("kernel", ("kernel", "flops", "bytes")),
    # training-sentinel verdicts: marker value is the detection reason
    # ("nonfinite" | "spike" | "trust"), step is where it fired
    "anomaly": ("anomaly", ("anomaly", "step")),
}


class SchemaError(ValueError):
    """A telemetry record (or stream) violates the v1 schema."""


def header_record(stream: str, **meta) -> dict:
    """The version-1 stream opener.  ``stream`` names the producer family
    ("train", "serve", "kernel", ...); ``meta`` rides along verbatim."""
    return {"schema": SCHEMA_VERSION, "stream": stream, **meta}


def classify(rec: dict) -> str:
    """Record kind by marker key (no validation): header | event | probe |
    gauge | kernel | anomaly | step."""
    if "schema" in rec:
        return "header"
    for kind, (marker, _) in _KINDS.items():
        if marker in rec:
            return kind
    return "step"


def validate_record(rec: Any) -> str:
    """Validate one record against the v1 schema; returns its kind."""
    if not isinstance(rec, dict):
        raise SchemaError(f"record is {type(rec).__name__}, not an object")
    kind = classify(rec)
    if kind == "header":
        v = rec["schema"]
        if not isinstance(v, int) or v < 1:
            raise SchemaError(f"header schema={v!r} is not a version >= 1")
        if v > SCHEMA_VERSION:
            raise SchemaError(
                f"stream schema v{v} is newer than this reader "
                f"(v{SCHEMA_VERSION}) — refusing to guess at its records")
        return kind
    if kind == "step":
        if "step" not in rec:
            raise SchemaError(f"step record without 'step': {rec!r}")
        return kind
    _, required = _KINDS[kind]
    missing = [k for k in required if k not in rec]
    if missing:
        raise SchemaError(f"{kind} record missing {missing}: {rec!r}")
    return kind


def jsonify(x):
    """Host metric values -> JSON scalars/lists: numpy arrays via
    ``tolist``, 0-d values via ``float``; dicts/lists recurse.  Values are
    host-side by the StepEvent contract — this is formatting, not a sync."""
    if isinstance(x, dict):
        return {k: jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonify(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "ndim") and x.ndim == 0:
        return float(x)
    return x


@dataclasses.dataclass
class TelemetryStream:
    """A parsed stream: schema version (0 = legacy, headerless), the
    header (None for legacy), and records classified by kind."""

    path: Optional[str]
    schema: int
    header: Optional[dict]
    records: list            # [(kind, record), ...] in file order

    def of_kind(self, kind: str, family: Optional[str] = None) -> list:
        marker = _KINDS.get(kind, (None,))[0]
        return [r for k, r in self.records
                if k == kind and (family is None or r.get(marker) == family)]

    def steps(self) -> list:
        return self.of_kind("step")

    def events(self, family: Optional[str] = None) -> list:
        return self.of_kind("event", family)

    def probes(self, family: Optional[str] = None) -> list:
        return self.of_kind("probe", family)

    def gauges(self, family: Optional[str] = None) -> list:
        return self.of_kind("gauge", family)

    def kernels(self) -> list:
        return self.of_kind("kernel")

    def anomalies(self, family: Optional[str] = None) -> list:
        """Sentinel anomaly records, optionally filtered by reason."""
        return self.of_kind("anomaly", family)


def parse_records(lines: Iterable[str], *, strict: bool = True,
                  path: Optional[str] = None) -> TelemetryStream:
    """Classify + validate an iterable of JSONL lines into a
    :class:`TelemetryStream`.  Non-strict mode skips unparseable lines
    (crash-truncated tails) instead of raising."""
    schema, header = 0, None
    records: list = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if strict:
                raise SchemaError(
                    f"{path or '<stream>'}:{i + 1}: not valid JSON")
            continue
        kind = validate_record(rec)
        if kind == "header":
            if header is not None and strict:
                raise SchemaError(
                    f"{path or '<stream>'}:{i + 1}: duplicate header")
            schema, header = rec["schema"], rec
            continue
        records.append((kind, rec))
    return TelemetryStream(path=path, schema=schema, header=header,
                           records=records)


def read_stream(path, *, strict: bool = True) -> TelemetryStream:
    """Read + validate one JSONL telemetry stream (legacy or v1)."""
    p = Path(path)
    return parse_records(p.read_text().splitlines(), strict=strict,
                         path=str(p))


def iter_data_records(lines: Iterable[str]) -> Iterator[dict]:
    """Lenient record iterator for consumers that only want data records
    (headers and broken lines skipped) — the ``find_metrics_hook``-
    consumer back-compat surface: works on legacy and v1 streams alike."""
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict) or "schema" in rec:
            continue
        yield rec


# --------------------------------------------------------------------------
# Committed-benchmark (BENCH_*.json) validation
# --------------------------------------------------------------------------

# Required top-level keys per committed baseline; every BENCH file must at
# minimum be a non-empty JSON object.  CI runs validate_bench_dir over
# benchmarks/ so a half-written or hand-edited baseline fails fast.
BENCH_REQUIRED = {
    "BENCH_roofline": ("backend", "peak", "kernels"),
    "BENCH_serve": ("config", "paged", "legacy", "pool_utilization"),
    "BENCH_step_time": (),
    "BENCH_sweep": (),
    "BENCH_packing": (),
}


def validate_bench(path) -> dict:
    """Validate one committed ``BENCH_*.json``; returns the payload."""
    p = Path(path)
    try:
        payload = json.loads(p.read_text())
    except ValueError as e:
        raise SchemaError(f"{p.name}: not valid JSON ({e})")
    if not isinstance(payload, dict) or not payload:
        raise SchemaError(f"{p.name}: expected a non-empty JSON object")
    required = BENCH_REQUIRED.get(p.stem, ())
    missing = [k for k in required if k not in payload]
    if missing:
        raise SchemaError(f"{p.name}: missing required keys {missing}")
    if p.stem == "BENCH_roofline":
        for row in payload["kernels"]:
            for k in ("kernel", "flops", "bytes", "wall_us"):
                if k not in row:
                    raise SchemaError(
                        f"{p.name}: kernel row missing {k!r}: {row!r}")
    return payload


def validate_bench_dir(bench_dir) -> list:
    """Validate every committed BENCH_*.json under ``bench_dir``; returns
    the validated file names (CI fails on the first SchemaError)."""
    names = []
    for p in sorted(Path(bench_dir).glob("BENCH_*.json")):
        validate_bench(p)
        names.append(p.name)
    return names


def main(argv=None) -> int:
    """``python -m repro_torch.telemetry.schema DIR`` validates every
    BENCH_*.json in DIR."""
    import argparse
    ap = argparse.ArgumentParser(
        description="validate committed BENCH_*.json baselines")
    ap.add_argument("bench_dir", help="directory holding BENCH_*.json")
    args = ap.parse_args(argv)
    names = validate_bench_dir(args.bench_dir)
    print(f"schema-validated {len(names)} committed benchmarks: "
          f"{', '.join(names) or '(none)'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
