"""Telemetry stream schema v1, the producer's half: the version, the header
record and the value formatting a writer needs.

Copied from ``repro.telemetry.schema`` (the port imports nothing of
``repro``).  A stream the port writes is read and validated by the JAX
package's ``repro.telemetry.read_stream``; the reader, the report CLI and the
committed-benchmark validation are not ported.
"""
from __future__ import annotations

SCHEMA_VERSION = 1


def header_record(stream: str, **meta) -> dict:
    """The version-1 stream opener.  ``stream`` names the producer family
    ("train", "serve", "kernel", ...); ``meta`` rides along verbatim."""
    return {"schema": SCHEMA_VERSION, "stream": stream, **meta}


def jsonify(x):
    """Host metric values -> JSON scalars/lists: arrays and tensors via
    ``tolist``, 0-d values via ``float``; dicts/lists recurse.  Values are
    host-side by contract — this is formatting, not a sync."""
    if isinstance(x, dict):
        return {k: jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonify(v) for v in x]
    if hasattr(x, "tolist"):
        return x.tolist()
    if hasattr(x, "ndim") and x.ndim == 0:
        return float(x)
    return x
