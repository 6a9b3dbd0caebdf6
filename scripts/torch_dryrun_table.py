"""Print the dry run's cells as a markdown table: a rank's resting bytes,
its init and step peaks, FLOPs and HBM bytes a device, collective wire
bytes, and the three roofline terms at the H100's spec-sheet rates
(``repro_torch/launch/dryrun.py``; nothing is measured on a card).

  PYTHONPATH=src python scripts/torch_dryrun_table.py \\
      [--dir runs/dryrun_torch] [--shape train_4k] [--mesh single]
  PYTHONPATH=src python scripts/torch_dryrun_table.py --against \\
      runs/dryrun_torch_baseline
  PYTHONPATH=src python scripts/torch_dryrun_table.py --serving \\
      [--mesh single]

Reads the cells' JSON that ``python -m repro_torch.launch.dryrun`` wrote
(``--baseline`` for the second directory).  ``--against DIR``: each cell
beside the same cell in ``DIR`` (the optimized plan against the baseline
plan): a rank's resting bytes, its step peak, the collectives' wire bytes
and the HBM bytes a device, and the memory and collective terms.
``--serving``: every family's serving cells on ``--mesh``, one rank's
trace each, beside the same cell traced on one device (``--mesh one``)
divided by the mesh's size: the resting bytes (params, a decode cell's
cache), the bytes held when the step starts (the batch too), the step
peak, FLOPs, HBM bytes and the collectives' wire bytes a device, and K4's
launches (the rank's partial entry plus its whole-ring entry, whisper's
cross cache where the model axis does not divide the frames; the device's
whole-ring entry).
"""
import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import ARTIFACT_DIR, roofline_terms
from repro_torch.models.registry import ARCH_IDS, get_arch


def _cell(d, arch_id, args, shape=None, mesh=None):
    path = Path(d) / (f"{arch_id}__{shape or args.shape}__"
                      f"{mesh or args.mesh}.json")
    return json.loads(path.read_text()) if path.exists() else None


def serving(args) -> None:
    """The serving cells, a rank's on ``--mesh`` beside the one-device
    cell over the mesh's size (module docstring)."""
    print("| config | cell | resting GB | held GB | step peak GB | TFLOP a "
          "device | HBM GB a device | wire GB a device | K4 launches |")
    print("|---|---|---|---|---|---|---|---|---|")
    for arch_id in ARCH_IDS:
        for shape in get_arch(arch_id, smoke=True).supported_cells():
            if shape == "train_4k":
                continue
            a = _cell(args.dir, arch_id, args, shape)
            one = _cell(args.dir, arch_id, args, shape, "one")
            if a is None or one is None:
                print(f"| {arch_id} | {shape} | not traced |")
                continue
            n = a["n_chips"]
            cols = [(a["memory"]["resting_bytes"],
                     one["memory"]["resting_bytes"], 1e9, 3),
                    (a["memory"]["argument_bytes"],
                     one["memory"]["argument_bytes"], 1e9, 3),
                    (a["memory"]["step_peak_bytes"],
                     one["memory"]["step_peak_bytes"], 1e9, 2),
                    (a["flops_per_device"], one["flops_per_device"], 1e12,
                     3),
                    (a["hbm_bytes_per_device"], one["hbm_bytes_per_device"],
                     1e9, 2)]
            k4 = a["kernel_launches"]
            print(f"| {arch_id} | {shape} | " + " | ".join(
                f"{x / s:.{d}f} / {y / n / s:.{d}f}" for x, y, s, d in cols)
                + f" | {a['collectives']['total_wire_bytes'] / 1e9:.2f} | "
                f"{k4.get('decode_attention_partial', 0)}+"
                f"{k4.get('decode_attention', 0)} / "
                f"{one['kernel_launches'].get('decode_attention', 0)} |")


def compare(args) -> None:
    """Each cell of ``--dir`` beside the same cell of ``--against``."""
    print("| config | resting GB | step peak GB | wire GB | HBM GB a "
          "device | memory s | collective s |")
    print("|---|---|---|---|---|---|---|")
    for arch_id in ARCH_IDS:
        a, b = (_cell(d, arch_id, args) for d in (args.dir, args.against))
        if a is None or b is None:
            print(f"| {arch_id} | not traced |")
            continue
        ta, tb = roofline_terms(a), roofline_terms(b)
        cols = [(a["memory"]["resting_bytes"], b["memory"]["resting_bytes"],
                 1e9, 3),
                (a["memory"]["step_peak_bytes"],
                 b["memory"]["step_peak_bytes"], 1e9, 2),
                (a["collectives"]["total_wire_bytes"],
                 b["collectives"]["total_wire_bytes"], 1e9, 2),
                (a["hbm_bytes_per_device"], b["hbm_bytes_per_device"], 1e9,
                 1),
                (ta["memory_s"], tb["memory_s"], 1, 3),
                (ta["collective_s"], tb["collective_s"], 1, 3)]
        print(f"| {arch_id} | " + " | ".join(
            f"{x / s:.{n}f} / {y / s:.{n}f}" for x, y, s, n in cols) + " |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=str(ARTIFACT_DIR))
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--against", default=None,
                    help="a second artifact directory to set beside --dir")
    ap.add_argument("--serving", action="store_true",
                    help="the serving cells, a rank's beside the "
                         "one-device cell over the mesh's size")
    args = ap.parse_args(argv)
    if args.against:
        compare(args)
        return
    if args.serving:
        serving(args)
        return
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
