"""PyTorch port vs the JAX reference: the sweep driver
(``fleet/sweep.py``, ``launch/sweep.py``).

The cases of ``tests/fleet/test_sweep.py`` held against the reference's
functions: the same grids, override surgery and errors, member names, member
specs (``spec.json`` byte for byte but for the directories), DONE skips and
reports (the reference's ``build_report`` over the port's member
directories gives the port's ranking).  In-process members on the CPU
(report and idempotence, a member killed mid-sweep resuming from its
checkpoint, a failed member contained), one subprocess sweep with
``--device cpu``, and the launcher.  Smoke config of h2o-danube-1.8b."""
import json
from pathlib import Path

import pytest

from repro.data.pipeline import DataConfig as RefDataConfig
from repro.fleet import sweep as ref_sweep
from repro.run import spec as ref_spec
from repro_torch.data.pipeline import DataConfig
from repro_torch.fleet import KillAtHook, SimulatedKill
from repro_torch.fleet import sweep
from repro_torch.run import spec as port_spec

VARIANTS = [{"opt.lr": 1e-3}, {"opt.lr": 3e-3},
            {"opt.name": "adamw", "opt.lr": 2e-4}]
QUIET = dict(log_fn=lambda s: None)


def fleet_specs(*, total=6, every=None, seq=32, batch=8):
    """The reference tests' ``fleet_spec`` in both packages."""
    out = []
    for m, data in ((ref_spec, RefDataConfig), (port_spec, DataConfig)):
        kw = {}
        if every is not None:
            kw["checkpoint"] = m.CheckpointSpec(every=every)
        out.append(m.RunSpec(
            model=m.ModelSpec(arch="h2o-danube-1.8b", smoke=True),
            data=data(vocab=0, seq_len=seq, global_batch=batch),
            opt=m.OptSpec(name="adalomo", lr=1e-3, schedule="constant"),
            steps=m.StepSpec(total=total), log_every=0, **kw))
    return out


# --------------------------------------------------------------------------
# Declarative overrides (pure)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [
    {"opt.lr": [1e-3, 3e-3], "seed": [0, 1]},
    {"steps.total": [4], "opt.name": ["lomo", "adalomo"], "seed": [2, 1]},
    {}])
def test_expand_grid_matches_reference(grid):
    assert sweep.expand_grid(grid) == ref_sweep.expand_grid(grid)


def test_apply_overrides_matches_reference():
    ref_base, base = fleet_specs()
    ov = {"opt.lr": 9e-4, "steps.total": 11, "seed": 7,
          "data.seq_len": 16}
    out = sweep.apply_overrides(base, ov)
    assert out.to_json() == ref_sweep.apply_overrides(ref_base, ov).to_json()
    assert (out.opt.lr, out.steps.total, out.seed) == (9e-4, 11, 7)
    assert (base.opt.lr, base.steps.total) == (1e-3, 6)
    assert port_spec.RunSpec.from_json(out.to_json()) == out


@pytest.mark.parametrize("ov,match", [({"opt.bogus": 1}, "opt.bogus"),
                                      ({"seed.deeper": 1}, "not a spec node")])
def test_apply_overrides_errors_match_reference(ov, match):
    ref_base, base = fleet_specs()
    with pytest.raises(ValueError, match=match) as got:
        sweep.apply_overrides(base, ov)
    with pytest.raises(ValueError) as want:
        ref_sweep.apply_overrides(ref_base, ov)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("index,ov", [
    (0, {"opt.lr": 0.001}), (3, {}), (1, {"model/arch": "a b"}),
    (12, {"opt.name": "adamw", "opt.lr": 2e-4}), (5, {"x": "y" * 200})])
def test_member_name_matches_reference(index, ov):
    got = sweep.member_name(index, ov)
    assert got == ref_sweep.member_name(index, ov)
    assert "/" not in got and " " not in got


def test_materialize_matches_reference(tmp_path):
    """Same names and, but for the member directories, the same spec.json
    bytes; every member resumable, with its own checkpoint dir and
    metrics stream, and spec.json replaying to the member's spec."""
    ref_base, base = fleet_specs()
    want = ref_sweep.materialize(ref_base, VARIANTS, tmp_path / "ref")
    got = sweep.materialize(base, VARIANTS, tmp_path / "port")
    assert [m.name for m in got] == [m.name for m in want] == [
        "00_opt.lr=0.001", "01_opt.lr=0.003",
        "02_opt.lr=0.0002-opt.name=adamw"]
    for g, w in zip(got, want):
        text = (g.dir / "spec.json").read_text()
        assert text.replace(str(tmp_path / "port"), "D") == (
            w.dir / "spec.json").read_text().replace(str(tmp_path / "ref"),
                                                     "D")
        ck = g.spec.checkpoint
        assert ck.resume and ck.gc_incomplete and ck.every == 1
        assert ck.dir == str(g.dir / "ckpt")
        assert g.spec.metrics_path == str(g.dir / "metrics.jsonl")
        assert port_spec.RunSpec.from_json(text) == g.spec


def _fake_member_dirs(members) -> dict:
    """Histories and metrics streams of a finished, a partial (killed: no
    history) and a failed member, with events, a probe and an anomaly."""
    header = json.dumps({"schema": 1, "stream": "train"})
    for i, m in enumerate(members):
        steps = [{"step": s, "loss": 3.0 - 0.1 * s - 0.05 * i,
                  "tokens_per_s": 100.0 + s + i} for s in range(4)]
        recs = [header] + [json.dumps(r) for r in steps] + [
            json.dumps({"event": "straggler", "step": 2}),
            json.dumps({"probe": "update_ratio", "step": 1, "x": 1.0}),
            json.dumps({"anomaly": "spike", "step": 3}), "{broken"]
        (m.dir / "metrics.jsonl").write_text("\n".join(recs) + "\n")
        if i != 1:
            (m.dir / "history.json").write_text(json.dumps(
                {"loss": [r["loss"] for r in steps],
                 "eval_loss": [2.5 - 0.2 * i, 2.4 - 0.1 * i]}))
    return {members[0].name: "done", members[1].name: "preempted",
            members[2].name: "done"}


@pytest.mark.parametrize("objective", ["loss", "eval_loss"])
def test_build_report_matches_reference(tmp_path, objective):
    ref_base, base = fleet_specs()
    got_m = sweep.materialize(base, VARIANTS, tmp_path / "sw")
    want_m = ref_sweep.materialize(ref_base, VARIANTS, tmp_path / "sw")
    statuses = _fake_member_dirs(got_m)
    got = sweep.build_report(base, got_m, statuses, objective=objective)
    want = ref_sweep.build_report(ref_base, want_m, statuses,
                                  objective=objective)
    assert got == want
    assert got["ranking"] and got["n_done"] == 2


def test_done_members_skip_like_reference(tmp_path):
    """Members whose DONE marker exists are skipped by both drivers, with the
    same log lines and the same report written."""
    ref_base, base = fleet_specs()
    statuses = _fake_member_dirs(sweep.materialize(base, VARIANTS,
                                                   tmp_path / "sw"))
    for m in sweep.materialize(base, VARIANTS, tmp_path / "sw"):
        m.done_marker.write_text(json.dumps({"name": m.name}))
    assert statuses
    got_logs, want_logs = [], []
    got = sweep.run_sweep(base, VARIANTS, tmp_path / "sw",
                          log_fn=got_logs.append, device="cpu")
    got_disk = (tmp_path / "sw" / "report.json").read_text()
    want = ref_sweep.run_sweep(ref_base, VARIANTS, tmp_path / "sw",
                               log_fn=want_logs.append)
    assert got_logs == want_logs
    assert sum("skipping" in line for line in got_logs) == 3
    assert got == want
    assert got_disk == (tmp_path / "sw" / "report.json").read_text()


# --------------------------------------------------------------------------
# Execution on the CPU
# --------------------------------------------------------------------------

def test_inproc_sweep_report_and_idempotence(tmp_path):
    ref_base, base = fleet_specs(total=4, every=2)
    report = sweep.run_sweep(base, VARIANTS, tmp_path / "sw", device="cpu",
                             **QUIET)
    assert report["n_members"] == 3 and report["n_done"] == 3
    assert report["objective"] == "final_loss"
    rows = {r["name"]: r for r in report["members"]}
    losses = [rows[n]["final_loss"] for n in report["ranking"]]
    assert set(report["ranking"]) == set(rows) and losses == sorted(losses)
    assert report["best"]["name"] == report["ranking"][0]
    for r in rows.values():
        assert r["status"] == "done" and r["steps_done"] == 4
        assert "best_loss" in r and r["mean_tokens_per_s"] > 0
    on_disk = json.loads((tmp_path / "sw" / "report.json").read_text())
    assert on_disk["ranking"] == report["ranking"]
    assert on_disk["base_spec"] == base.to_dict() == ref_base.to_dict()
    # the reference's report over the port's member directories: the same
    want = ref_sweep.build_report(
        ref_base, ref_sweep.materialize(ref_base, VARIANTS, tmp_path / "sw"),
        {n: "done" for n in rows})
    assert want == report
    logs = []
    report2 = sweep.run_sweep(base, VARIANTS, tmp_path / "sw", device="cpu",
                              log_fn=logs.append)
    assert report2["ranking"] == report["ranking"]
    assert sum("skipping" in line for line in logs) == 3


def test_crash_mid_sweep_resumes_only_unfinished(tmp_path):
    """Member 01 dies at step boundary 3 (after its step-2 checkpoint);
    re-invoking skips member 00 and resumes 01 from step 2."""
    _, base = fleet_specs(total=6, every=2)
    sweep_dir = tmp_path / "sw"

    def kill_member_1(member):
        return (KillAtHook(3),) if member.name.startswith("01_") else ()

    with pytest.raises(SimulatedKill):
        sweep.run_sweep(base, VARIANTS, sweep_dir, member_hooks=kill_member_1,
                        device="cpu", **QUIET)
    names = [m.name for m in sweep.materialize(base, VARIANTS, sweep_dir)]
    assert (sweep_dir / names[0] / "DONE.json").exists()
    assert not (sweep_dir / names[1] / "DONE.json").exists()
    from repro_torch.checkpoint.manager import CheckpointManager
    assert CheckpointManager(sweep_dir / names[1] / "ckpt").latest_step() == 2
    logs = []
    report = sweep.run_sweep(base, VARIANTS, sweep_dir, device="cpu",
                             log_fn=logs.append)
    assert report["n_done"] == 3
    assert sum("skipping" in line for line in logs) == 1
    assert any("resumed from step 2" in line for line in logs)
    recs = [json.loads(line) for line in
            (sweep_dir / names[1] / "metrics.jsonl").open() if line.strip()]
    data = [r for r in recs if "schema" not in r and "event" not in r]
    assert [r["step"] for r in data] == list(range(6))
    hist = json.loads((sweep_dir / names[1] / "history.json").read_text())
    assert len(hist["loss"]) == 6 - 2


def test_failed_member_is_contained(tmp_path):
    _, base = fleet_specs(total=2)
    report = sweep.run_sweep(base, [{"opt.lr": 1e-3},
                                    {"opt.name": "no-such-optimizer"}],
                             tmp_path / "sw", device="cpu", **QUIET)
    rows = {r["name"]: r for r in report["members"]}
    assert sorted(r["status"] for r in rows.values()) == ["done", "failed"]
    failed = next(r for r in rows.values() if r["status"] == "failed")
    assert (tmp_path / "sw" / failed["name"] / "error.txt").exists()
    assert failed["name"] not in report["ranking"]


def test_subprocess_sweep_on_cpu(tmp_path):
    """Two members as ``python -m repro_torch.launch.train --spec ...
    --device cpu`` children, two in flight: both done, histories written by
    the children, and a second call skips both."""
    _, base = fleet_specs(total=2, seq=16, batch=2)
    variants = [{"opt.lr": 1e-3}, {"opt.name": "lomo", "opt.lr": 1e-2}]
    logs = []
    report = sweep.run_sweep(base, variants, tmp_path / "sw",
                             mode="subprocess", parallel=2, device="cpu",
                             log_fn=logs.append)
    for m in sweep.materialize(base, variants, tmp_path / "sw"):
        assert "final loss" in (m.dir / "stdout.log").read_text()
    assert report["n_done"] == 2, logs
    assert sum("launched" in line for line in logs) == 2
    assert all(len(json.loads((tmp_path / "sw" / n / "history.json")
                              .read_text())["loss"]) == 2
               for n in report["ranking"])
    logs = []
    again = sweep.run_sweep(base, variants, tmp_path / "sw",
                            mode="subprocess", device="cpu",
                            log_fn=logs.append)
    assert sum("skipping" in line for line in logs) == 2
    assert again["ranking"] == report["ranking"]


def test_launcher(tmp_path, capsys):
    """``python -m repro_torch.launch.sweep`` on the CPU: a grid of two
    in-process members ranked in the printout; --virtual-devices reaches
    each subprocess member's launcher; --grid and --variants are
    exclusive."""
    from repro_torch.launch.sweep import main
    _, base = fleet_specs(total=2, seq=16, batch=2)
    spec_file = tmp_path / "base.json"
    spec_file.write_text(base.to_json())
    args = ["--base", str(spec_file), "--dir", str(tmp_path / "sw"),
            "--grid", json.dumps({"opt.lr": [1e-3, 3e-3]})]
    main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "sweep: 2/2 members done" in out and "#2 " in out
    assert Path(tmp_path / "sw" / "report.json").exists()
    # --virtual-devices reaches every member's launcher command line
    import repro_torch.fleet.sweep as fleet_sweep
    cmds = []

    class Member:
        def __init__(self, cmd, **kw):
            cmds.append(cmd)
            self.pid = 0

        def poll(self):
            return 1

    real = fleet_sweep.subprocess.Popen
    fleet_sweep.subprocess.Popen = Member
    try:
        with pytest.raises(SystemExit):
            main(["--base", str(spec_file), "--dir", str(tmp_path / "vd"),
                  "--grid", json.dumps({"opt.lr": [1e-3, 3e-3]}),
                  "--subprocess", "--virtual-devices", "4", "--device",
                  "cpu"])
    finally:
        fleet_sweep.subprocess.Popen = real
    assert len(cmds) == 2
    for cmd in cmds:
        assert "repro_torch.launch.train" in cmd
        assert cmd[cmd.index("--virtual-devices") + 1] == "4"
    variants = tmp_path / "v.json"
    variants.write_text(json.dumps(VARIANTS))
    with pytest.raises(SystemExit, match="exactly one"):
        main(args + ["--variants", str(variants), "--device", "cpu"])
