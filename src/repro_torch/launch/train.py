"""Training launcher (PyTorch) — RunSpec parsing + ``run()``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --smoke --steps 100 --optimizer adalomo --batch 8 --seq 128

  PYTHONPATH=src python -m repro_torch.launch.train --spec runspec.json

Runs on the card; ``--device cpu`` asks for the CPU.  The flags are the
reference launcher's (``repro.launch.train``), so one command line or spec
file drives both packages; a flag of a layer that is not ported yet raises
``NotImplementedError``.

A run with ``--ckpt-dir D`` that is sent SIGTERM or SIGINT checkpoints at the
next step boundary and exits 75 (``PREEMPTED_EXIT_CODE``); the same command
with ``--resume`` continues it.
"""


def main(argv=None):
    import argparse
    import json

    from repro_torch.fleet.preempt import PREEMPTED_EXIT_CODE, Preempted
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

    try:
        result = run(spec, device=args.device)
    except Preempted as e:
        # resumable by re-invoking with --resume
        print(f"preempted: checkpointed at step {e.step}; exiting "
              f"{PREEMPTED_EXIT_CODE} (resumable)")
        raise SystemExit(PREEMPTED_EXIT_CODE)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(result.history, f)
    if result.history.get("loss"):
        print(f"final loss {result.history['loss'][-1]:.4f}")
    else:
        # --resume found the run already at total_steps: a no-op resume
        print(f"nothing to do: resumed at step {result.start_step} of "
              f"{spec.steps.total}")


if __name__ == "__main__":
    main()
