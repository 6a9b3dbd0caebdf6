"""Committed-baseline support for the port's repro-lint.  Counterpart of
``repro.analysis.baseline``, in the same format: a baseline either
package writes, the other reads.

A baseline entry grandfathers ONE existing finding, identified by
``(rule, path suffix, context qualname, stripped line text)`` — line
numbers are deliberately absent so unrelated edits above a finding don't
invalidate the baseline.  Every entry MUST carry a non-empty
``justification``; entries that no longer match any live finding are
*stale* and fail the lint run (the baseline can only shrink silently,
never rot).

Format (the port's own file, ``.repro-torch-lint-baseline.json`` at the
repo root; the reference's is ``.repro-lint-baseline.json``)::

    {
      "version": 1,
      "entries": [
        {
          "rule": "T2",
          "path": "src/repro_torch/serve/engine.py",
          "context": "PagedEngine._run_chunk",
          "line_text": "host = torch.cat([...]).cpu()",
          "justification": "the ONE sanctioned per-chunk sync"
        }
      ]
    }
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, List, Sequence, Tuple

from repro_torch.analysis.core import Finding

BASELINE_NAME = ".repro-torch-lint-baseline.json"
_VERSION = 1


class BaselineError(ValueError):
    """Malformed baseline file (bad schema, missing justification)."""


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str        # posix path suffix, matched against finding paths
    context: str
    line_text: str
    justification: str

    def matches(self, finding: Finding) -> bool:
        key = finding.key()
        return (self.rule == key[0]
                and _suffix_match(self.path, key[1])
                and self.context == key[2]
                and self.line_text == key[3])


def _suffix_match(entry_path: str, finding_path: str) -> bool:
    e = entry_path.strip("/").split("/")
    f = finding_path.strip("/").split("/")
    return len(e) <= len(f) and f[-len(e):] == e


def load(path: pathlib.Path) -> List[BaselineEntry]:
    """Parse and validate a baseline file. Raises BaselineError."""
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise BaselineError(f"{path}: not valid JSON: {e}") from e
    if not isinstance(data, dict) or data.get("version") != _VERSION:
        raise BaselineError(
            f"{path}: expected {{'version': {_VERSION}, 'entries': [..]}}")
    entries = []
    for i, raw in enumerate(data.get("entries", [])):
        missing = [k for k in ("rule", "path", "context", "line_text",
                               "justification") if k not in raw]
        if missing:
            raise BaselineError(
                f"{path}: entry {i} missing {missing}")
        if not str(raw["justification"]).strip():
            raise BaselineError(
                f"{path}: entry {i} ({raw['rule']} {raw['path']}) has an "
                "empty justification — every baselined finding must say "
                "why it is allowed to stay")
        entries.append(BaselineEntry(
            rule=str(raw["rule"]), path=str(raw["path"]),
            context=str(raw["context"]), line_text=str(raw["line_text"]),
            justification=str(raw["justification"])))
    return entries


def save(path: pathlib.Path, findings: Iterable[Finding]) -> None:
    """Write a baseline grandfathering ``findings``; justifications are
    stamped TODO so a human must edit each one before committing."""
    entries = []
    for f in sorted(findings, key=lambda f: f.key()):
        entries.append({
            "rule": f.rule, "path": f.key()[1], "context": f.context,
            "line_text": f.line_text,
            "justification": "TODO: justify or fix",
        })
    path.write_text(json.dumps(
        {"version": _VERSION, "entries": entries}, indent=2) + "\n")


def apply(findings: Sequence[Finding],
          entries: Sequence[BaselineEntry],
          ) -> Tuple[List[Finding], List[BaselineEntry]]:
    """Split findings into (new, stale-entries).

    Each entry may absorb any number of matching findings (a suffix path
    can cover a file moved between fixture roots); an entry that absorbs
    none is stale and must be deleted from the baseline.
    """
    used = [False] * len(entries)
    new: List[Finding] = []
    for f in findings:
        absorbed = False
        for i, e in enumerate(entries):
            if e.matches(f):
                used[i] = True
                absorbed = True
        if not absorbed:
            new.append(f)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return new, stale
