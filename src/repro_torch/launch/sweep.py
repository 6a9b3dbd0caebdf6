"""Sweep launcher (PyTorch) — fan a base RunSpec across declarative
overrides.  The flags of the reference's launcher (``repro.launch.sweep``),
plus ``--device``.

  # lr grid, sequential in-process members, on the card:
  PYTHONPATH=src python -m repro_torch.launch.sweep --base spec.json \
      --dir out/sweep --grid '{"opt.lr": [1e-3, 3e-3], "seed": [0, 1]}'

  # optimizer ablation as crash-isolated subprocesses, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.sweep --base spec.json \
      --dir out/ablate --variants variants.json --subprocess --device cpu

``variants.json`` is a list of override dicts (dotted spec paths):
``[{"opt.name": "lomo", "opt.lr": 1e-2}, {"opt.lr": 1e-3}, ...]``.

Re-invoking the same command is always safe: DONE members are skipped,
killed or preempted members resume from their last complete checkpoint.
The merged, ranked report lands in ``<dir>/report.json``.
``--virtual-devices N`` reaches every member's ``repro_torch.launch.train``
command line (with ``--device cpu``, N gloo ranks a member), so a sweep of
sharded members runs with ``--subprocess``; the spec's ``mesh.shape`` (or
N on the data axis) is each member's mesh.
"""
import os


def _load_variants(args) -> list:
    import json
    if (args.grid is None) == (args.variants is None):
        raise SystemExit("pass exactly one of --grid / --variants")
    from repro_torch.fleet.sweep import expand_grid
    if args.grid:
        text = args.grid
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        return expand_grid(json.loads(text))
    with open(args.variants) as f:
        variants = json.load(f)
    if not isinstance(variants, list):
        raise SystemExit("--variants file must hold a JSON list of "
                         "override dicts")
    return variants


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base", required=True,
                    help="base RunSpec JSON file")
    ap.add_argument("--dir", required=True,
                    help="sweep directory (members + report.json)")
    ap.add_argument("--grid", default=None,
                    help="JSON {dotted.path: [values...]} expanded as a "
                         "cartesian product (or @file.json)")
    ap.add_argument("--variants", default=None,
                    help="JSON file: explicit list of override dicts")
    ap.add_argument("--subprocess", action="store_true",
                    help="run members as crash-isolated subprocesses "
                         "(default: sequential in-process)")
    ap.add_argument("--parallel", type=int, default=1,
                    help="max subprocess members in flight")
    ap.add_argument("--objective", default="loss",
                    choices=["loss", "eval_loss"],
                    help="ranking key for the report")
    ap.add_argument("--virtual-devices", type=int, default=None,
                    help="passed to every member's launcher (subprocess "
                         "members): that many gloo ranks a member on the "
                         "host with --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="where every member runs: cuda (default; fails "
                         "without a card), cuda:N, or cpu")
    args = ap.parse_args(argv)
    extra = (["--virtual-devices", str(args.virtual_devices)]
             if args.virtual_devices else [])
    if extra and not args.subprocess:
        raise SystemExit("--virtual-devices spawns ranks a member: run the "
                         "members with --subprocess")

    variants = _load_variants(args)
    with open(args.base) as f:
        from repro_torch.run.spec import RunSpec
        base = RunSpec.from_json(f.read())

    from repro_torch.fleet.sweep import run_sweep
    report = run_sweep(base, variants, args.dir,
                       mode="subprocess" if args.subprocess else "inproc",
                       parallel=args.parallel, objective=args.objective,
                       extra_args=extra, device=args.device)

    done, n = report["n_done"], report["n_members"]
    print(f"\nsweep: {done}/{n} members done; report: "
          f"{os.path.join(args.dir, 'report.json')}")
    for rank, name in enumerate(report["ranking"], 1):
        row = next(r for r in report["members"] if r["name"] == name)
        print(f"  #{rank} {name}  {report['objective']}="
              f"{row[report['objective']]:.4f}  "
              f"overrides={json.dumps(row['overrides'])}")
    if done < n:
        print("  (re-invoke the same command to resume unfinished members)")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
