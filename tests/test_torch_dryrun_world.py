"""The dry run against a live run of the same spec: one world of two
``gloo`` ranks (``_torch_elastic_worker.run_world``) runs one fused
AdaLomo step of danube's smoke config on (2,) and then on (1, 2), and each
rank traces its own rank of the same spec on the meta device
(``launch/dryrun.py::trace_train``).  On each rank the dry plan equals the
live run: the collectives call for call (kind, operand shape, dtype, mesh
axes), their ``STATS`` (``staged_bytes`` apart: gloo stages nothing of a
CPU tensor), the K1/K2 launches (the live run's plain updates counted as
the kernel entries the card's path takes for them) and the resting bytes
(the rank's real shards)."""
import json

import pytest

from _torch_elastic_worker import run_world

DANUBE = "h2o-danube-1.8b"
MESHES = {"2": (2,), "1x2": (1, 2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dry_world")
    cases = [{"kind": "dry_vs_live", "arch": DANUBE, "shape": list(shape),
              "out": str(d / name)} for name, shape in MESHES.items()]
    run_world(2, str(d / "store"), cases)
    return {(name, r): json.loads(open(d / f"{name}.rank{r}.json").read())
            for name in MESHES for r in range(2)}


def _calls(log):
    return [(c["kind"], c["shape"], c["dtype"], c["axes"]) for c in log]


CASES = [(m, r) for m in MESHES for r in range(2)]


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_collectives_equal_live_call_for_call(world, mesh, rank):
    got = world[mesh, rank]
    assert got["live"]["log"]
    assert _calls(got["dry"]["log"]) == _calls(got["live"]["log"])
    assert [c["wire_bytes"] for c in got["dry"]["log"]] == \
        [c["wire_bytes"] for c in got["live"]["log"]]


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_stats_equal_live(world, mesh, rank):
    got = world[mesh, rank]
    live, dry = dict(got["live"]["stats"]), dict(got["dry"]["stats"])
    live.pop("staged_bytes")
    assert dry.pop("staged_bytes") == 0
    assert dry == live and live["calls"] > 0


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_launches_equal_live(world, mesh, rank):
    got = world[mesh, rank]
    assert got["dry"]["launches"] == got["live"]["launches"]
    assert got["live"]["launches"].get("adalomo_stats_partial", 0) > 0


@pytest.mark.parametrize("mesh,rank", CASES)
def test_dry_resting_equals_real_shards(world, mesh, rank):
    got = world[mesh, rank]
    assert got["dry"]["resting"] == got["live"]["resting"] > 0
