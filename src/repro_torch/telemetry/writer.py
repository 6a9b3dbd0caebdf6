"""Append-only JSONL telemetry writer — the one producer-side path into
a schema-v1 stream (DESIGN.md §"Telemetry v1").  A copy of
``repro.telemetry.writer``.

Producers (MetricsHook, ServeTelemetry, the roofline benchmark) share
the same write discipline the PR 6 MetricsHook established: line-
buffered appends, flush per record so a crash loses at most the
partially-written tail line (which the non-strict reader skips), and a
header written exactly once per file — re-opening an existing stream
for resume fast-forwards past the header instead of duplicating it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import json

from repro_torch.telemetry.schema import header_record, jsonify


class TelemetryWriter:
    """Appends v1 records to one JSONL stream file.

    ``stream`` names the producer family for the header ("train",
    "serve", "kernel").  On open: a missing/empty file gets a fresh
    header; a non-empty file is assumed mid-stream (resume) and is
    appended to as-is — stream-level rewind (dropping records from a
    rolled-back step) stays the owner's job, as in MetricsHook.
    """

    def __init__(self, path, *, stream: str, **meta):
        self.path = Path(path)
        self.stream = stream
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fresh = not (self.path.exists() and self.path.stat().st_size > 0)
        self._f = open(self.path, "a", buffering=1)
        if fresh:
            self.write(header_record(stream, **meta))

    def write(self, rec: dict) -> None:
        self._f.write(json.dumps(jsonify(rec)) + "\n")
        self._f.flush()

    # -- typed record helpers ------------------------------------------
    def probe(self, family: str, step: int, **payload) -> None:
        self.write({"probe": family, "step": int(step), **payload})

    def gauge(self, family: str, t_s: float, **payload) -> None:
        self.write({"gauge": family, "t_s": float(t_s), **payload})

    def kernel(self, name: str, *, flops: float, bytes: float,
               **payload) -> None:
        self.write({"kernel": name, "flops": float(flops),
                    "bytes": float(bytes), **payload})

    def event(self, name: str, step: int, **payload) -> None:
        self.write({"event": name, "step": int(step), **payload})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "TelemetryWriter":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
