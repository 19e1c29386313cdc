#!/usr/bin/env python3
"""End-to-end GNN inference of the PyTorch port on one CUDA card, the
twin of ``inference.py``: the same flags and defaults, the same
``[DATA]`` lines. AmazonProducts is cut to its partition 1 of ~500k-node
parts, as the reference does. ``--version spmm|grande|spmv`` prepare the
``ell`` operand over the reference's 2D mesh where it needs more than one
device and no more than the visible cards (the quantized aggregate then
takes the round trip around the mesh product), and on one card otherwise
(an ``sp_parts × ds_parts`` above the visible cards prints the
reference's ``[WARN] ... running single-chip``); ``--version cpu``
aggregates through the oracle in float. ``--data_type bfloat16`` casts
the aggregate's payload to bf16 and ``int64`` quantizes as int32 (the
reference with x64 off), both through the unfused round trip, as the
reference. ``--tune`` runs the autotuner as ``spmm_test_cuda.py``
does (a device budget of ``sp_parts × ds_parts`` capped by the visible
devices; ``[DATA]tuned_plan`` and ``[DATA]tuned_constants``) and runs
its pick, on one card or over a mesh of those devices. Runs on the
card; ``main(argv, device="cpu")`` runs the plain versions on the CPU
(the tests).

    python3 inference_cuda.py --dataset ogbn-arxiv
"""

import argparse

from spmm_test_cuda import tune


def get_args(argv=None):
    from pygim_tpu_torch.compat import normalize_data_type

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", type=str, default="pubmed")
    p.add_argument("--model", type=str, default="gcn",
                   choices=["gcn", "sage", "gin"])
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--version", type=str, default="grande",
                   choices=["spmm", "grande", "spmv", "cpu"])
    p.add_argument("--sp_format", type=str, default="csr",
                   choices=["csr", "coo"])
    p.add_argument("--data_type", type=normalize_data_type, default="int32")
    p.add_argument("--sp_parts", type=int, default=2)
    p.add_argument("--ds_parts", type=int, default=16)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--tune", action="store_true")
    p.add_argument("--data_root", "--datadir", type=str, default=None)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lib_path", type=str, default=None)
    p.add_argument("--nr_dpus", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    args = get_args(argv)
    print(args)

    from pygim_tpu_torch.bench.runners import run_inference_benchmark
    from pygim_tpu_torch.compat import prepare_for_version
    from pygim_tpu_torch.data import cluster_partition, load_dataset
    from pygim_tpu_torch.ops.spmm import SpmmConfig
    from pygim_tpu_torch.tune import prepare_tuned

    kw = {} if args.data_root is None else {"root": args.data_root}
    try:
        ds = load_dataset(args.dataset, **kw)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    if args.dataset == "amazonproducts":
        ds = cluster_partition(ds, part_size=500_000, part_idx=1)

    cfg = None
    tuned = devices = None
    agg_dtype = None if args.data_type in ("float32", "float64") \
        else args.data_type
    if args.version == "cpu":
        agg_dtype = None
    else:
        cfg = SpmmConfig(backend="ell", format=args.sp_format,
                         hidden_hint=args.hidden_size)
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

    return run_inference_benchmark(
        ds, model=args.model, num_layers=args.num_layers,
        hidden=args.hidden_size, agg_dtype=agg_dtype, config=cfg,
        repeat=args.repeat, prepare_fn=prepare_fn, device=device,
    )


if __name__ == "__main__":
    main()
