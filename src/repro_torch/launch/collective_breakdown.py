"""Per-shape collective breakdown of a dry-run cell: which tensors make the
wire bytes.  Counterpart of ``repro.launch.collective_breakdown``, over the
collectives' log the dry run saves (``.coll.json.gz``) in place of HLO.

  PYTHONPATH=src python -m repro_torch.launch.collective_breakdown \\
      runs/dryrun_torch/qwen3-32b__train_4k__single.coll.json.gz
"""
from __future__ import annotations

import gzip
import json
import sys
from collections import defaultdict


def breakdown(log: list, top: int = 18) -> list:
    """``[(wire bytes, count, (kind, shape, axes, caller))]``, the rows of
    the log summed by key, largest first, the first ``top``."""
    agg = defaultdict(lambda: [0, 0])
    for rec in log:
        sig = f"{rec['dtype']}[{'x'.join(map(str, rec['shape']))}]"
        key = (rec["kind"], sig, ",".join(rec["axes"]) or "?", rec["tag"])
        agg[key][0] += rec["wire_bytes"]
        agg[key][1] += 1
    rows = sorted(((v[0], v[1], k) for k, v in agg.items()), reverse=True)
    return rows[:top]


def load(path: str) -> list:
    with gzip.open(path, "rt") as f:
        return json.load(f)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    log = load(argv[0])
    rows = breakdown(log, top=len(log))
    total = sum(r[0] for r in rows)
    print(f"{'wire GB':>9} {'count':>6}  kind            operand"
          f"             axes        op")
    for wire, n, (kind, sig, axes, tag) in rows[:18]:
        print(f"{wire/1e9:9.3f} {n:6d}  {kind:<15} {sig:<19} {axes:<11} "
              f"{tag}")
    print(f"({len(rows)} rows, total {total/1e9:.3f} GB wire)")


if __name__ == "__main__":
    main()
