#!/usr/bin/env python3
"""Full-graph GNN training of the PyTorch port on one CUDA card, the twin
of ``train.py``: the same flags and defaults, the same ``[DATA]`` lines
plus ``[DATA]device``. Cross-entropy on the train mask, Adam, BatchNorm
running-statistic merges and dropout 0.5, an evaluation forward every 10
epochs and at the last, and a checkpoint where ``--checkpoint`` names a
directory (the model's and the optimizer's state). On the ``ell`` and
``hybrid`` backends the aggregate's backward runs the hand kernels on
the prepared transpose; ``--backend hybrid`` builds
``SpmmConfig(backend="hybrid")``, whose default core is the graph's own
dtype (a square f32 core at 4 GiB on a float graph: K-f32 forward and
backward). ``--sp_parts × --ds_parts`` above one trains over the 2D
mesh (``parallel/spmm_2d.py``, its backward on the mesh's prepared Aᵀ):
on the card over the visible cards (fewer raise ``ValueError``, as
``train.py`` on one chip), on the CPU over copies of the CPU device.
Runs on the card; ``main(argv, device="cpu")`` runs the plain versions
on the CPU (the tests).

    python3 train_cuda.py --dataset planted-20000-240000-8 --epochs 10
"""

import argparse
import time


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", type=str, default="pubmed")
    p.add_argument("--model", type=str, default="gcn",
                   choices=["gcn", "sage", "gin"])
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--sp_parts", type=int, default=1)
    p.add_argument("--ds_parts", type=int, default=1)
    p.add_argument("--backend", type=str, default="ell")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None, *, device="cuda"):
    args = get_args(argv)
    print(args)

    import numpy as np
    import torch

    from pygim_tpu_torch.bench.runners import device_name
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.nn.train import (
        make_eval_step,
        make_train_step_threaded,
    )
    from pygim_tpu_torch.ops.spmm import (
        PreparedAggregate,
        SpmmConfig,
        prepare_spmm,
        runs_kernels,
    )
    from pygim_tpu_torch.utils.metrics import data_print

    kw = {} if args.data_root is None else {"root": args.data_root}
    try:
        ds = load_dataset(args.dataset, **kw)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    cfg = SpmmConfig(backend=args.backend)
    n_mesh = args.sp_parts * args.ds_parts
    if n_mesh > 1:
        from pygim_tpu_torch.parallel import make_mesh, prepare_spmm_2d

        dev = torch.device(device)
        mesh = make_mesh(args.sp_parts, args.ds_parts,
                         None if dev.type == "cuda" else [dev] * n_mesh)
        prep = prepare_spmm_2d(ds.graph, mesh, cfg)
        device = mesh.devices[0][0]
    else:
        prep = prepare_spmm(ds.graph, cfg, device=device)
    if runs_kernels(prep):
        prep.transpose(ds.graph)  # the backward's operand, before the clock
    data_print("device", device_name(device))

    model = make_gnn(args.seed, args.model, ds.x.shape[1], args.hidden_size,
                     ds.num_classes, num_layers=args.num_layers,
                     device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
    step, dev = make_train_step_threaded(model, prep, optimizer)
    evaluate = make_eval_step(model, PreparedAggregate(prep))

    x = torch.as_tensor(ds.x, dtype=torch.float32).to(device)
    labels = torch.as_tensor(ds.y.astype(np.int64)).to(device)
    train_mask = torch.as_tensor(ds.train_mask.astype(np.float32)).to(device)
    test_mask = torch.as_tensor(ds.test_mask.astype(np.float32)).to(device)

    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed * 100003 + epoch)
        loss = step(x, labels, train_mask, gen, dev)
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            acc, _ = evaluate(x, labels, test_mask)
            data_print("epoch", epoch)
            data_print("train_loss", float(loss))
            data_print("test_acc", float(acc))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    data_print("train_time(ms)", (time.perf_counter() - t0) * 1e3)

    if args.checkpoint:
        from pygim_tpu_torch.nn.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, model, step=args.epochs,
                        extra={"opt_state": optimizer})
        data_print("checkpoint", args.checkpoint)


if __name__ == "__main__":
    main()
