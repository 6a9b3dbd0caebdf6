"""Re-run the cost model over saved dry-run traces (no re-tracing).
Counterpart of ``repro.launch.reanalyze``: reads each cell's
``.ops.json.gz`` and ``.coll.json.gz`` and rewrites its JSON's cost keys
with ``op_analysis.cost_of``.

  PYTHONPATH=src python -m repro_torch.launch.reanalyze [artifact dir]
"""
import gzip
import json
import sys
from pathlib import Path

from repro_torch.launch.dryrun import ARTIFACT_DIR
from repro_torch.launch.op_analysis import cost_of


def reanalyze(jpath: Path) -> dict:
    """The cell ``jpath``'s JSON with its cost keys recomputed from its
    saved traces (written back)."""
    with gzip.open(jpath.with_suffix(".ops.json.gz"), "rt") as f:
        ops = json.load(f)
    with gzip.open(jpath.with_suffix(".coll.json.gz"), "rt") as f:
        log = json.load(f)
    d = json.loads(jpath.read_text())
    c = cost_of(ops["ops"], ops["launches"], log)
    d["collectives"] = c["collectives"]
    d["flops_per_device"] = c["flops"]
    d["dot_flops_per_device"] = c["dot_flops"]
    d["hbm_bytes_per_device"] = c["bytes"]
    d["transcendentals_per_device"] = c["transcendentals"]
    jpath.write_text(json.dumps(d, indent=1))
    return d


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    adir = Path(argv[0]) if argv else ARTIFACT_DIR
    for jpath in sorted(adir.glob("*.json")):
        if jpath.name.endswith(".runspec.json"):
            continue
        if not jpath.with_suffix(".ops.json.gz").exists():
            print(f"skip {jpath.name} (no trace)")
            continue
        d = reanalyze(jpath)
        print(f"reanalyzed {jpath.name}: "
              f"flops/dev={d['flops_per_device']:.3e}")


if __name__ == "__main__":
    main()
