"""The port's repro-lint CLI.  Counterpart of ``repro.analysis.lint``.

    python -m repro_torch.analysis.lint [paths...] [--format text|json]
                                        [--baseline FILE | --no-baseline]
                                        [--rules T2,R7,...]
                                        [--write-baseline] [--list-rules]

Exit codes: 0 clean (all findings baselined-with-justification),
1 findings (new findings, or stale baseline entries), 2 usage/config
error (unreadable path, malformed baseline).

Paths default to ``src/repro_torch``; the baseline to the nearest
``.repro-torch-lint-baseline.json`` above the first path.  Directories are walked for ``*.py``; files
named ``test_*.py``/``conftest.py`` or under a ``tests``/``fixtures``
directory are treated as test code (relaxes T4's module-level check and R7)
but are still analyzed when explicitly listed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.core import Finding, analyze_module
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

_TEST_DIRS = {"tests", "fixtures"}


def _is_test_path(path: pathlib.Path) -> bool:
    if path.name.startswith("test_") or path.name == "conftest.py":
        return True
    return any(part in _TEST_DIRS for part in path.parts)


def collect_files(paths: Sequence[str]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.is_file():
            out.append(p)
        else:
            raise FileNotFoundError(raw)
    # dedupe, keep order
    seen = set()
    uniq = []
    for p in out:
        key = p.resolve()
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    return uniq


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[str]] = None,
               ) -> List[Finding]:
    """Run the analyzer over ``paths`` and return raw findings
    (suppression comments already applied, baseline NOT applied)."""
    active = list(ALL_RULES)
    if rules:
        unknown = [r for r in rules if r not in RULES_BY_ID]
        if unknown:
            raise KeyError(f"unknown rule id(s): {unknown}; "
                           f"have {sorted(RULES_BY_ID)}")
        active = [RULES_BY_ID[r] for r in rules]
    findings: List[Finding] = []
    for path in collect_files(paths):
        try:
            source = path.read_text()
        except (OSError, UnicodeDecodeError) as e:
            raise FileNotFoundError(f"{path}: {e}") from e
        findings.extend(analyze_module(
            str(path), source, rules=active,
            is_test=_is_test_path(path)))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _format_text(findings: Sequence[Finding],
                 stale: Sequence[baseline_mod.BaselineEntry]) -> str:
    lines = []
    for f in findings:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} "
                     f"[{f.context or '<module>'}] {f.message}")
        lines.append(f"    {f.line_text}")
    for e in stale:
        lines.append(f"{e.path}: stale baseline entry ({e.rule} in "
                     f"{e.context or '<module>'}: {e.line_text!r}) — the "
                     "finding is gone; delete the entry")
    if findings or stale:
        lines.append("")
        lines.append(f"repro-lint: {len(findings)} new finding(s), "
                     f"{len(stale)} stale baseline entr(y/ies)")
    else:
        lines.append("repro-lint: clean")
    return "\n".join(lines)


def _format_json(findings: Sequence[Finding],
                 stale: Sequence[baseline_mod.BaselineEntry]) -> str:
    return json.dumps({
        "findings": [
            {"rule": f.rule, "path": f.key()[1], "line": f.line,
             "col": f.col, "context": f.context, "message": f.message,
             "line_text": f.line_text}
            for f in findings
        ],
        "stale_baseline": [
            {"rule": e.rule, "path": e.path, "context": e.context,
             "line_text": e.line_text}
            for e in stale
        ],
    }, indent=2)


def _find_default_baseline(paths: Sequence[str]) -> Optional[pathlib.Path]:
    """Nearest .repro-torch-lint-baseline.json at or above the first lint
    path (so the CLI works from any cwd inside the repo)."""
    start = pathlib.Path(paths[0] if paths else ".").resolve()
    if start.is_file():
        start = start.parent
    for cand in [start, *start.parents]:
        p = cand / baseline_mod.BASELINE_NAME
        if p.is_file():
            return p
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repro-lint for the PyTorch/CUDA port: invariant "
                    "checks for the step, hook, engine and kernel stack")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: src/repro_torch)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: nearest "
                         f"{baseline_mod.BASELINE_NAME} above the first "
                         "path)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline file "
                         "(justifications stamped TODO) and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        print("R1  (no counterpart: the port traces nothing, so nothing "
              "can retrace)")
        for r in ALL_RULES:
            print(f"{r.id}  {r.title:24s} (reference {r.counterpart}) "
                  f"{r.invariant}")
        return 0

    paths = args.paths or ["src/repro_torch"]
    rules = args.rules.split(",") if args.rules else None
    try:
        findings = lint_paths(paths, rules=rules)
    except (FileNotFoundError, KeyError, SyntaxError) as e:
        print(f"repro-lint: error: {e}", file=sys.stderr)
        return 2

    baseline_path: Optional[pathlib.Path] = None
    entries: List[baseline_mod.BaselineEntry] = []
    if not args.no_baseline:
        baseline_path = (pathlib.Path(args.baseline) if args.baseline
                         else _find_default_baseline(paths))
        if args.baseline and not baseline_path.is_file() \
                and not args.write_baseline:
            print(f"repro-lint: error: baseline {baseline_path} not "
                  "found", file=sys.stderr)
            return 2
        if baseline_path is not None and baseline_path.is_file() \
                and not args.write_baseline:
            try:
                entries = baseline_mod.load(baseline_path)
            except baseline_mod.BaselineError as e:
                print(f"repro-lint: error: {e}", file=sys.stderr)
                return 2

    if args.write_baseline:
        target = baseline_path or pathlib.Path(baseline_mod.BASELINE_NAME)
        baseline_mod.save(target, findings)
        print(f"repro-lint: wrote {len(findings)} entr(y/ies) to "
              f"{target} — edit the TODO justifications before "
              "committing")
        return 0

    new, stale = baseline_mod.apply(findings, entries)
    out = (_format_json if args.format == "json" else _format_text)(
        new, stale)
    print(out)
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
