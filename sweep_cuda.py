#!/usr/bin/env python3
"""Sweep command of the PyTorch port, the twin of ``sweep.py``: ``run``,
``parse`` and ``migrate``, with its flags. Runs go to the card; records
go to ``results_cuda/`` by default, never to ``results/`` (the TPU's
ledger, which ``run`` and ``parse`` refuse).

Examples::

    python3 sweep_cuda.py run --set small
    python3 sweep_cuda.py run --baseline --results results_cuda
    python3 sweep_cuda.py parse --results results_cuda
    python3 sweep_cuda.py migrate --results results_cuda --rename old=new
"""

import argparse

RESULTS = "results_cuda"


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run")
    pr.add_argument("--results", type=str, default=RESULTS)
    pr.add_argument("--set", type=str, default="small", dest="set_name")
    pr.add_argument("--baseline", action="store_true",
                    help="run the BASELINE.md tracked configs")
    pr.add_argument("--retry_failed", action="store_true")
    pr.add_argument("--dry_run", action="store_true")
    pr.add_argument("--repeat", type=int, default=3)
    pr.add_argument("--data_root", type=str, default=None)

    pp = sub.add_parser("parse")
    pp.add_argument("--results", type=str, default=RESULTS)
    pp.add_argument("--out", type=str, default=None)

    pm = sub.add_parser("migrate")
    pm.add_argument("--results", type=str, default=RESULTS)
    pm.add_argument("--rename", type=str, nargs="+", default=[],
                    help="old-token=new-token pairs applied to file names")

    args = p.parse_args(argv)

    if args.cmd == "run":
        from pygim_tpu_torch.bench import Experiment, run_experiments
        from pygim_tpu_torch.bench.configs import (
            BASELINE_EXPERIMENTS,
            sweep_space,
        )
        from pygim_tpu_torch.utils.logging import make_logger

        if args.baseline:
            exps = BASELINE_EXPERIMENTS
        else:
            exps = [
                Experiment(repeat=args.repeat, **pt)
                for pt in sweep_space(args.set_name)
            ]
        logger = make_logger("pygim_tpu_torch.sweep")
        results = run_experiments(
            exps, args.results, retry_failed=args.retry_failed,
            dry_run=args.dry_run, logger=logger, data_root=args.data_root,
            device=device,
        )
        logger.info("completed %d runs", len(results))
    elif args.cmd == "parse":
        from pathlib import Path

        from pygim_tpu_torch.bench import results_to_csv

        if not Path(args.results).is_dir():
            p.error(f"results directory not found: {args.results}")
        print(results_to_csv(args.results, args.out))
    elif args.cmd == "migrate":
        # rename ledger files under a change of the frozen names
        from pathlib import Path

        pairs = [r.split("=", 1) for r in args.rename]
        for f in Path(args.results).glob("*.*"):
            new = f.name
            for old, newtok in pairs:
                new = new.replace(old, newtok)
            if new != f.name:
                f.rename(f.with_name(new))
                print(f"{f.name} -> {new}")


if __name__ == "__main__":
    main()
