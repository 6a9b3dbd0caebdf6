"""The port's repro-lint (``repro_torch/analysis``) against the reference's
(``repro.analysis``): R6 and R7 give the same findings, field for field,
on the reference's fixtures, on ``src/repro_torch`` and on ``src/repro``;
the baseline file one package writes the other reads the same; each
torch-form rule (T2–T5) fires on its positive fixture
(``tests/torch_lint_fixtures/``, which pytest does not collect) and stays
quiet on its negative one; the CLI's exit codes, suppressions on the line
and on the line above, and the port's tree linted clean against its own
baseline.  Pure AST: nothing is imported from the linted code."""
import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import baseline as ref_baseline
from repro.analysis.core import Finding as RefFinding
from repro.analysis.lint import lint_paths as ref_lint_paths
from repro_torch.analysis import analyze_module, baseline
from repro_torch.analysis.core import Finding
from repro_torch.analysis.lint import lint_paths, main
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "analysis" / "fixtures"
FIXTURES = REPO / "tests" / "torch_lint_fixtures"
T_RULES = ("T2", "T3", "T4", "T5")


def _fixture(rule_id: str, kind: str) -> Path:
    sub = "kernels/" if rule_id == "T4" else ""
    return FIXTURES / f"{sub}{rule_id.lower()}_{kind}.py"


def _run(rule_id: str, path: Path) -> list:
    # is_test=False: fixtures live under tests/ but model production code
    return analyze_module(str(path), path.read_text(),
                          rules=[RULES_BY_ID[rule_id]], is_test=False)


def _fields(findings) -> list:
    return [dataclasses.asdict(f) for f in findings]


# ---------------------------------------------------------------------
# R6 / R7: the reference's findings, field for field
# ---------------------------------------------------------------------

def test_r6_r7_equal_reference_on_its_fixtures():
    """Each of the reference's R6/R7 fixtures, as production code (the
    reference's rule tests' mode) and through ``lint_paths`` (test code)."""
    from repro.analysis.core import analyze_module as ref_analyze
    from repro.analysis.rules import RULES_BY_ID as REF_RULES
    paths = sorted(REF_FIXTURES.glob("r6_*.py")) + sorted(
        REF_FIXTURES.glob("r7_*.py"))
    assert len(paths) == 4
    n = 0
    for p in paths:
        for rid in ("R6", "R7"):
            got = _run(rid, p)
            want = ref_analyze(str(p), p.read_text(), rules=[REF_RULES[rid]],
                               is_test=False)
            assert _fields(got) == _fields(want), (p.name, rid)
            n += len(got)
    assert n >= 8
    assert _fields(lint_paths([str(p) for p in paths], rules=["R6", "R7"])) \
        == _fields(ref_lint_paths([str(p) for p in paths],
                                  rules=["R6", "R7"]))


@pytest.mark.parametrize("tree", ["src/repro_torch", "src/repro"])
def test_r6_r7_equal_reference_on_both_packages(tree):
    got = lint_paths([str(REPO / tree)], rules=["R6", "R7"])
    want = ref_lint_paths([str(REPO / tree)], rules=["R6", "R7"])
    assert _fields(got) == _fields(want)


# ---------------------------------------------------------------------
# the torch-form rules on their fixtures
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rule_id", T_RULES)
def test_t_rule_fires_on_positive_fixture(rule_id):
    findings = _run(rule_id, _fixture(rule_id, "pos"))
    assert findings, f"{rule_id} found nothing in its positive fixture"
    assert all(f.rule == rule_id for f in findings)
    # each marked line of the fixture, and nothing else
    src = _fixture(rule_id, "pos").read_text().splitlines()
    marked = {i for i, line in enumerate(src, 1)
              if f"# {rule_id}:" in line}
    assert {f.line for f in findings} == marked


@pytest.mark.parametrize("rule_id", T_RULES)
def test_t_rule_quiet_on_negative_fixture(rule_id):
    findings = _run(rule_id, _fixture(rule_id, "neg"))
    assert findings == [], "; ".join(f.format() for f in findings)


def test_rule_ids_and_counterparts():
    assert [r.id for r in ALL_RULES] == ["T2", "T3", "T4", "T5", "R6", "R7"]
    assert [r.counterpart for r in ALL_RULES] == ["R2", "R3", "R4", "R5",
                                                  "R6", "R7"]
    assert len(RULES_BY_ID) == len(ALL_RULES)


def test_t2_covers_all_three_hot_contexts():
    contexts = {f.context for f in _run("T2", _fixture("T2", "pos"))}
    assert {"CollectHook.on_step_end", "make_train_step.train_step",
            "build_step_program.one_step", "ToyEngine._run_chunk"} <= contexts


def test_t4_covers_its_three_kinds():
    msgs = [f.message for f in _run("T4", _fixture("T4", "pos"))]
    assert sum("except handler" in m for m in msgs) == 1
    assert sum("may be on the card" in m for m in msgs) == 1
    assert sum("floor division" in m for m in msgs) == 2
    assert sum("module level" in m for m in msgs) == 2


def test_t2_sees_the_engines_sanctioned_sync():
    """``PagedEngine._run_chunk``'s one read a chunk is what T2 finds in
    the engine once its suppression comment is taken away."""
    path = REPO / "src" / "repro_torch" / "serve" / "engine.py"
    src = path.read_text()
    assert "repro-lint: disable=T2" in src
    bare = src.replace("repro-lint: disable=T2", "(suppression removed)")
    found = analyze_module(str(path), bare, rules=[RULES_BY_ID["T2"]])
    assert [(f.context, f.message.split("(")[0]) for f in found] == [
        ("PagedEngine._run_chunk", ".cpu")]


# ---------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------

_HOT = ("import torch\n"
        "def make_step():\n"
        "    def step(x):\n"
        "{body}"
        "    return step\n")


@pytest.mark.parametrize("body,n", [
    ("        return x.item()\n", 1),
    ("        return x.item()  # repro-lint: disable=T2\n", 0),
    ("        # repro-lint: disable=T2 — the one read\n"
     "        return x.item()\n", 0),
    ("        y = 1  # repro-lint: disable=T2\n"
     "        return x.item()\n", 1),
    ("        return x.item()  # repro-lint: disable=T5\n", 1),
    ("        return x.item()  # repro-lint: disable=t2,T5\n", 0),
], ids=["none", "on-line", "line-above", "code-above", "other-rule",
        "lower-list"])
def test_suppressions_on_the_line_and_above(body, n):
    found = analyze_module("hot.py", _HOT.format(body=body),
                           rules=[RULES_BY_ID["T2"]])
    assert len(found) == n


# ---------------------------------------------------------------------
# the baseline file: one format for both packages
# ---------------------------------------------------------------------

def _finding(cls, **kw):
    base = dict(rule="T2", path="src/repro_torch/serve/engine.py", line=9,
                col=0, message="m", context="PagedEngine._run_chunk",
                line_text="host = x.cpu()")
    base.update(kw)
    return cls(**base)


def _entries(entries) -> list:
    return [(e.rule, e.path, e.context, e.line_text, e.justification)
            for e in entries]


def test_baseline_written_by_either_package_reads_the_same(tmp_path):
    kw = [dict(), dict(rule="R7", context="<module>", line_text="except:")]
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    baseline.save(port, [_finding(Finding, **k) for k in kw])
    ref_baseline.save(ref, [_finding(RefFinding, **k) for k in kw])
    assert port.read_text() == ref.read_text()
    assert _entries(baseline.load(ref)) == _entries(ref_baseline.load(port))
    data = json.loads(port.read_text())
    data["entries"][0]["justification"] = "the one read a chunk"
    port.write_text(json.dumps(data))
    entries = baseline.load(port)
    assert _entries(entries) == _entries(ref_baseline.load(port))
    f = _finding(Finding, line=99)
    new, stale = baseline.apply([f], entries)
    ref_new, ref_stale = ref_baseline.apply([_finding(RefFinding, line=99)],
                                            ref_baseline.load(port))
    assert (len(new), len(stale)) == (len(ref_new), len(ref_stale)) == (0, 1)
    data["entries"][1]["justification"] = " "
    port.write_text(json.dumps(data))
    for mod in (baseline, ref_baseline):
        with pytest.raises(mod.BaselineError, match="justification"):
            mod.load(port)


def test_port_tree_lints_clean_against_its_baseline():
    """No silent drift: linting ``src/repro_torch`` with the port's rules
    reproduces ``.repro-torch-lint-baseline.json`` — no new findings, no
    stale entries."""
    findings = lint_paths([str(REPO / "src" / "repro_torch")])
    entries = baseline.load(REPO / baseline.BASELINE_NAME)
    new, stale = baseline.apply(findings, entries)
    assert new == [], "\n".join(f.format() for f in new)
    assert stale == [], repr(stale)
    assert baseline.BASELINE_NAME != ref_baseline.BASELINE_NAME


def test_analysis_imports_neither_jax_nor_repro():
    for path in (REPO / "src" / "repro_torch" / "analysis").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, n)


# ---------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------

_DIRTY = _HOT.format(body="        return float(x.sum())\n")
_CLEAN = _HOT.format(body="        return x.sum()\n")


def test_cli_exit_codes(tmp_path, capsys):
    ok, bad = tmp_path / "ok.py", tmp_path / "bad.py"
    ok.write_text(_CLEAN)
    bad.write_text(_DIRTY)
    assert main([str(ok), "--no-baseline"]) == 0
    assert "clean" in capsys.readouterr().out
    assert main([str(bad), "--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert "bad.py:4" in out and "T2" in out
    assert main([str(bad), "--no-baseline", "--format", "json"]) == 1
    data = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in data["findings"]] == ["T2"]
    assert main([str(bad), "--no-baseline", "--rules", "T5"]) == 0
    assert main([str(tmp_path / "nope.py"), "--no-baseline"]) == 2
    assert main([str(ok), "--no-baseline", "--rules", "R1"]) == 2
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(r in listed for r in ("R1", *T_RULES, "R6", "R7"))


def test_cli_baseline_roundtrip_and_stale(tmp_path, capsys):
    bad, bl = tmp_path / "bad.py", tmp_path / "bl.json"
    bad.write_text(_DIRTY)
    assert main([str(bad), "--baseline", str(bl), "--write-baseline"]) == 0
    data = json.loads(bl.read_text())
    data["entries"][0]["justification"] = "known, tracked elsewhere"
    bl.write_text(json.dumps(data))
    assert main([str(bad), "--baseline", str(bl)]) == 0
    bad.write_text(_CLEAN)
    capsys.readouterr()
    assert main([str(bad), "--baseline", str(bl)]) == 1
    assert "stale" in capsys.readouterr().out
    data["entries"][0]["justification"] = ""
    bl.write_text(json.dumps(data))
    assert main([str(bad), "--baseline", str(bl)]) == 2
    assert "justification" in capsys.readouterr().err


def test_module_cli_on_the_port_exits_zero():
    """``python -m repro_torch.analysis.lint src/repro_torch`` from the
    repository root: the default baseline found, exit 0."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                          "src/repro_torch"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "repro-lint: clean" in res.stdout
