"""Scaling benchmark: edges/s on one device against the halo layout over N,
the twin of ``pygim_tpu/bench/scaling.py``.

``run_scaling_benchmark`` times the product (or, with ``model``, the
whole inference forward) at each device count: one device runs the
single-card operand, N the halo layout (``parallel/halo.py``) over the
first N of ``devices``. It reports ``edges_per_s_n{N}``,
``scaling_efficiency_n{N} = edges_per_s(N) / (N · edges_per_s(1))``, and
for each halo count the partition's cut (``halo_request_rows_n{N}``) and
the padded receive buffer (``halo_buffer_rows_n{N}``).

``devices=None`` means the visible cards; ``["cuda:0"] * 8`` is the
counterpart of XLA's forced host device count: a virtual mesh, every
shard's work on one card. ``virtual_mesh`` is reported true where a
device repeats (or is not a card): such a run checks every shard's
kernels at its shard shapes and measures no scaling.
"""

from __future__ import annotations

import gc
from typing import Optional, Sequence

import numpy as np
import torch

from pygim_tpu_torch.data import GraphDataset
from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
from pygim_tpu_torch.parallel.halo import make_node_mesh, prepare_spmm_halo
from pygim_tpu_torch.parallel.mesh import is_virtual, visible_cards
from pygim_tpu_torch.utils.metrics import DataReporter
from pygim_tpu_torch.utils.timers import device_time


def run_scaling_benchmark(
    ds: GraphDataset,
    device_counts: Optional[Sequence[int]] = None,
    *,
    hidden: int = 256,
    exchange: str = "all_to_all",
    config: Optional[SpmmConfig] = None,
    repeat: int = 3,
    reporter: Optional[DataReporter] = None,
    model: Optional[str] = None,
    num_layers: int = 2,
    agg_dtype: Optional[str] = None,
    order: Optional[str] = None,
    devices: Optional[Sequence] = None,
) -> dict:
    """``model=None`` times the product at each count; ``model="gcn"``,
    ``"sage"`` or ``"gin"`` times the inference forward of that model
    (``agg_dtype`` its aggregation) instead, counting ``num_layers``
    products a forward. Counts default to those of 1, 2, 4, ..., 32 that
    ``devices`` hold. Each count's operand is freed before the next."""
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops.spmm import PreparedAggregate

    rep = reporter or DataReporter()
    devices = (visible_cards() if devices is None
               else [torch.device(d) for d in devices])
    if not devices:
        raise ValueError("run_scaling_benchmark: no device")
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    rep.report("virtual_mesh",
               is_virtual(devices[:max(device_counts, default=1)]))
    first = devices[0]
    rng = np.random.default_rng(0)
    graph = ds.graph
    if model is None:
        x = torch.from_numpy(
            rng.standard_normal((graph.nrows, hidden)).astype(np.float32))
    else:
        x = torch.as_tensor(ds.x, dtype=torch.float32)
    x = x.to(first)
    base_eps = None
    for n in device_counts:
        if n == 1:
            prep = prepare_spmm(graph, config or SpmmConfig(backend="ell"),
                                device=first)
        else:
            prep = prepare_spmm_halo(graph, make_node_mesh(n, devices),
                                     config, exchange=exchange, order=order)
            rep.report(f"halo_request_rows_n{n}", prep.request_rows)
            rep.report(f"halo_buffer_rows_n{n}", prep.halo_k)
        if model is None:
            dt = device_time(prep.mul, x, iters=repeat)
            eps = graph.nnz / dt
        else:
            gnn = make_gnn(0, model, ds.x.shape[1], hidden, ds.num_classes,
                           num_layers=num_layers, agg_dtype=agg_dtype,
                           device=first)
            agg = PreparedAggregate(prep, prep.dev_arrays)

            def fwd(a, gnn=gnn, agg=agg):
                with torch.inference_mode():
                    return gnn(a, agg)

            dt = device_time(fwd, x, iters=repeat)
            eps = graph.nnz * num_layers / dt
        rep.report(f"edges_per_s_n{n}", eps)
        if n == 1:
            base_eps = eps
        elif base_eps:
            rep.report(f"scaling_efficiency_n{n}", eps / (n * base_eps))
        del prep
        gc.collect()
        if first.type == "cuda":
            torch.cuda.empty_cache()
    return rep.means()
