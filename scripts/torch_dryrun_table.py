"""Print the dry run's cells as a markdown table: a rank's resting bytes,
its init and step peaks, FLOPs and HBM bytes a device, collective wire
bytes, and the three roofline terms at the H100's spec-sheet rates
(``repro_torch/launch/dryrun.py``; nothing is measured on a card).

  PYTHONPATH=src python scripts/torch_dryrun_table.py \\
      [--dir runs/dryrun_torch] [--shape train_4k] [--mesh single]

Reads the cells' JSON that ``python -m repro_torch.launch.dryrun`` wrote.
"""
import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import ARTIFACT_DIR, roofline_terms
from repro_torch.models.registry import ARCH_IDS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ARTIFACT_DIR))
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    print("| config | resting GB | init peak GB | step peak GB | TFLOP "
          "a device | HBM GB a device | wire GB | compute s | memory s | "
          "collective s | trace s |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for arch_id in ARCH_IDS:
        path = Path(args.dir) / f"{arch_id}__{args.shape}__{args.mesh}.json"
        if not path.exists():
            print(f"| {arch_id} | not traced |")
            continue
        res = json.loads(path.read_text())
        mem, t = res["memory"], roofline_terms(res)
        print(f"| {arch_id} | {mem['resting_bytes'] / 1e9:.3f} | "
              f"{mem['init_peak_bytes'] / 1e9:.2f} | "
              f"{mem['step_peak_bytes'] / 1e9:.2f} | "
              f"{res['flops_per_device'] / 1e12:.1f} | "
              f"{res['hbm_bytes_per_device'] / 1e9:.1f} | "
              f"{res['collectives']['total_wire_bytes'] / 1e9:.2f} | "
              f"{t['compute_s']:.3f} | {t['memory_s']:.3f} | "
              f"{t['collective_s']:.3f} | {res['trace_s']} |")


if __name__ == "__main__":
    main()
