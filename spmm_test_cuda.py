#!/usr/bin/env python3
"""SpMM micro-benchmark of the PyTorch port on one CUDA card, the twin
of ``spmm_test.py``: the same flags and defaults, the same ``[DATA]``
lines. ``--version spmm|grande|spmv`` prepare the ``ell`` operand over
the reference's 2D mesh (``pygim_tpu_torch/compat.py``) where it needs
more than one device and no more than the visible cards, and on one card
otherwise (an ``sp_parts × ds_parts`` above the visible cards prints the
reference's ``[WARN] ... running single-chip``); ``--version cpu`` runs
the oracle.
Every ``--data_type`` of the reference runs: ``bfloat16`` through
K-tail's bf16-row mode, ``int64`` as int32 (the reference with x64
off), ``float64`` as float32. ``--tune`` runs the autotuner
(``pygim_tpu_torch/tune``) over a device budget of ``sp_parts ×
ds_parts`` capped by the visible devices (the cards; on the CPU, as
many copies of the CPU as ``compat.visible_devices`` counts), prints
``[DATA]tuned_plan`` and ``[DATA]tuned_constants`` and runs its pick:
one card, or a ``2d`` or ``halo`` plan over those devices, whose
``[DATA]layout`` line names its mesh. ``--lib_path`` and ``--nr_dpus`` are
accepted and ignored. Runs on the card; ``main(argv, device="cpu")``
runs the plain versions on the CPU (the tests).

    python3 spmm_test_cuda.py --dataset ogbn-arxiv
"""

import argparse


def get_args(argv=None):
    from pygim_tpu_torch.compat import normalize_data_type

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", type=str, default="pubmed")
    p.add_argument("--version", type=str, default="spmm",
                   choices=["spmm", "grande", "spmv", "cpu"])
    p.add_argument("--sp_format", type=str, default="coo",
                   choices=["csr", "coo"])
    p.add_argument("--data_type", type=normalize_data_type, default="int32")
    p.add_argument("--sp_parts", type=int, default=1)
    p.add_argument("--ds_parts", type=int, default=1)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--tune", action="store_true")
    p.add_argument("--balance", type=str, default="nnz", choices=["nnz", "row"])
    p.add_argument("--data_root", "--datadir", type=str, default=None)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lib_path", type=str, default=None)
    p.add_argument("--nr_dpus", type=int, default=None)
    return p.parse_args(argv)


def tune(args, graph, device):
    """``--tune``: the autotuner's pick for ``graph`` at ``--hidden_size``
    over a budget of ``sp_parts × ds_parts`` devices capped by the
    visible devices (the reference's budget), its plan and constants
    printed as ``[DATA]`` lines. Returns the result and the devices a
    mesh pick spans (None on CUDA: the visible cards; on the CPU, copies
    of it, as ``compat.prepare_for_version`` lays a CPU mesh)."""
    import torch

    from pygim_tpu_torch import compat
    from pygim_tpu_torch.tune import autotune

    nd = min(max(1, args.sp_parts * args.ds_parts),
             compat.visible_devices(device))
    dev = torch.device(device)
    devices = None if dev.type == "cuda" else [dev] * nd
    tuned = autotune(graph, args.hidden_size, n_devices=nd,
                     layouts=("single", "2d", "halo"), device=device,
                     devices=devices)
    print(f"[DATA]tuned_plan: {tuned.plan.describe()}")
    print(f"[DATA]tuned_constants: {tuned.constants}")
    return tuned, devices


def main(argv=None, *, device="cuda"):
    args = get_args(argv)
    print(args)

    from pygim_tpu_torch.bench.runners import run_spmm_benchmark
    from pygim_tpu_torch.compat import prepare_for_version
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops.spmm import SpmmConfig
    from pygim_tpu_torch.tune import prepare_tuned

    kw = {} if args.data_root is None else {"root": args.data_root}
    try:
        ds = load_dataset(args.dataset, **kw)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")

    cfg = None
    tuned = devices = None
    if args.version != "cpu":
        cfg = SpmmConfig(
            backend="ell", format=args.sp_format, balance=args.balance,
            hidden_hint=args.hidden_size,
        )
        if args.tune:
            tuned, devices = tune(args, ds.graph, device)
            cfg = tuned.config

    def prepare_fn(graph, config):
        if tuned is not None:
            return prepare_tuned(graph, tuned, device=device,
                                 devices=devices)
        return prepare_for_version(
            args.version, graph, hidden_size=args.hidden_size,
            sp_parts=args.sp_parts, ds_parts=args.ds_parts,
            sp_format=args.sp_format, config=config, device=device,
        )

    dtype = args.data_type if args.data_type != "float64" else "float32"
    return run_spmm_benchmark(
        ds, hidden=args.hidden_size, dtype=dtype, config=cfg,
        repeat=args.repeat, prepare_fn=prepare_fn, device=device,
    )


if __name__ == "__main__":
    main()
