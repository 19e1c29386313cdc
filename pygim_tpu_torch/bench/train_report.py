"""GCN training at reddit scale, layer by layer, on one card.

    python3 -m pygim_tpu_torch.bench.train_report

No options: the reddit-sim stand-in (N = 232,965, 114.6M stored edges),
the stair int8 hybrid at 8 GiB (the headline's operand) with its
transpose for the backward, a 2-layer GCN at hidden 256. It prints (on
stderr) the card, the prepare phases of A and of Aᵀ and their device
bytes, ``run_training_benchmark`` over ``EPOCHS`` epochs without the
oracle arm, its steps split into forward, backward and Adam (CUDA
events, the launches of each phase by kernel name), a device profile of
one step by kernel family (``bench/report.py:kernel_family``: ``K-bn``
for the BatchNorm blocks' kernels beside ``torch`` for the unfused
passes left), and the peak card and host memory; its last stdout line is
the report as JSON.
"""

from __future__ import annotations

import json
import resource
import sys
import time

import torch

HIDDEN = 256
EPOCHS = 5


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def config():
    """The headline's operand: stair int8 at 8 GiB."""
    from pygim_tpu_torch.ops.spmm import SpmmConfig

    return SpmmConfig(backend="hybrid", format="csr", hybrid_shape="stair",
                      hybrid_dtype="int8", hybrid_core_bytes=8 << 30)


def main(dataset: str = "reddit") -> dict:
    from pygim_tpu_torch.bench.report import profile_calls
    from pygim_tpu_torch.bench.runners import (
        run_training_benchmark,
        train_inputs,
    )
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.nn.train import make_train_step
    from pygim_tpu_torch.ops.spmm import PreparedAggregate, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line
    from pygim_tpu_torch.utils.metrics import DataReporter

    dev = torch.device("cuda")
    res = {"card": card_line()}
    log(f"card: {res['card']}")
    ds = load_dataset(dataset)
    torch.cuda.reset_peak_memory_stats(dev)
    prep = {}
    for name, build in (("A", lambda: prepare_spmm(ds.graph, config())),
                        ("Aᵀ", lambda: prep["A"].transpose(ds.graph))):
        t0 = time.time()
        prep[name] = build()
        res[f"prepare {name}"] = dict(
            s=time.time() - t0, bytes=prep[name].device_bytes,
            bands=prep[name].stair, tables=prep[name].ell_meta,
            phases_ms={k: v * 1e3
                       for k, v in prep[name].prepare_timer.acc.items()})
        log(f"prepare {name}: {res[f'prepare {name}']}")

    rep = DataReporter(echo=False)
    res["training"] = run_training_benchmark(
        ds, hidden=HIDDEN, config=config(), epochs=EPOCHS, parity=False,
        reporter=rep, prepare_fn=lambda g, c: prep["A"])
    log(f"run_training_benchmark, {EPOCHS} epochs: {res['training']}")
    model = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes)
    step = make_train_step(model, PreparedAggregate(prep["A"]),
                           torch.optim.Adam(model.parameters(), lr=1e-2))
    inputs = train_inputs(ds, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    res["profile"] = profile_calls(lambda: step(*inputs, gen),
                                   "training step", out=sys.stderr)
    res["peak_card_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["peak_host_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    log(f"peak card memory {res['peak_card_gb']} GB, peak host RSS "
        f"{res['peak_host_rss_gib']:.2f} GiB")
    print(json.dumps(res, default=str))
    return res


if __name__ == "__main__":
    main()
