"""Training launcher (PyTorch) — RunSpec parsing + ``run()``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --smoke --steps 100 --optimizer adalomo --batch 8 --seq 128

  PYTHONPATH=src python -m repro_torch.launch.train --spec runspec.json

Runs on the card; ``--device cpu`` asks for the CPU.  The flags are the
reference launcher's (``repro.launch.train``), so one command line or spec
file drives both packages; a flag of a layer that is not ported yet raises
``NotImplementedError``.
"""


def main(argv=None):
    import argparse
    import json

    from repro_torch.run import run
    from repro_torch.run.spec import RunSpec, add_cli_args, from_cli_args

    ap = argparse.ArgumentParser(description=__doc__)
    add_cli_args(ap)
    ap.add_argument("--spec", default=None,
                    help="RunSpec JSON file (overrides the other flags)")
    ap.add_argument("--history-out", default=None,
                    help="write the training history JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where to run: cuda (default; fails without a "
                         "card), cuda:N, or cpu")
    args = ap.parse_args(argv)

    if args.spec:
        with open(args.spec) as f:
            spec = RunSpec.from_json(f.read())
    else:
        spec = from_cli_args(args)

    result = run(spec, device=args.device)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(result.history, f)
    if result.history.get("loss"):
        print(f"final loss {result.history['loss'][-1]:.4f}")


if __name__ == "__main__":
    main()
