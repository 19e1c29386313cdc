"""Benchmark bodies — counterparts of ``pygim_tpu/bench/runners.py``.

Both report through the ``[DATA]`` protocol under the reference's key
names (``pim_time_spmm(ms)``, ``prepare_pim_time(ms)``,
``infer_time(ms)``, ``test_acc``, ...). Times come from
:func:`~pygim_tpu_torch.utils.timers.device_time` on the device the
operands live on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.data import GraphDataset
from pygim_tpu_torch.nn.models import make_gnn
from pygim_tpu_torch.ops.spmm import PreparedAggregate, SpmmConfig, prepare_spmm
from pygim_tpu_torch.utils.metrics import DataReporter
from pygim_tpu_torch.utils.timers import device_time


def default_config() -> SpmmConfig:
    """The configuration a runner prepares when given none: the
    reference's ``SpmmConfig()`` (``pygim_tpu/bench/runners.py:73, 211``),
    the ``blocked`` backend. A caller that wants the hybrid passes its
    config."""
    return SpmmConfig()


def spmm_model_bytes(nnz: int, nrows: int, hidden: int, dtype_bytes: int = 4):
    """Standard SpMM traffic model: per-edge index+value stream, one dense
    row read per edge (no reuse credit), one output write per row."""
    return nnz * (4 + dtype_bytes) + nnz * hidden * dtype_bytes \
        + nrows * hidden * dtype_bytes


def _prepare(graph, config, prepare_fn, device, rep):
    t0 = time.perf_counter()
    if prepare_fn is not None:
        prep = prepare_fn(graph, config)
    else:
        prep = prepare_spmm(graph, config or default_config(), device=device)
    rep.report("prepare_pim_time(ms)", (time.perf_counter() - t0) * 1e3)
    for ph, sec in getattr(
        getattr(prep, "prepare_timer", None), "acc", {}
    ).items():
        rep.report(f"prepare_{ph}_time(ms)", sec * 1e3)
    rep.report("layout", "single-chip")
    return prep


def device_name(device) -> str:
    """The name of ``device`` for the ``[DATA]device`` line: the card's
    name, or ``cpu``; no line of the port reads as a TPU entry."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


_PAYLOAD_DTYPES = ("float32", "int8", "int16", "int32")


def _cast_graph(graph, dtype: str):
    """The graph with its values in the payload's dtype, as the
    reference's ``_cast_graph`` (integer payloads, integer weights)."""
    want = np.dtype(dtype)
    if graph.vals.dtype == want:
        return graph
    return dataclasses.replace(graph, vals=graph.vals.astype(want))


def run_spmm_benchmark(
    ds: GraphDataset,
    *,
    hidden: int = 256,
    dtype: str = "float32",
    config: Optional[SpmmConfig] = None,
    repeat: int = 3,
    verify: bool = True,
    reporter: Optional[DataReporter] = None,
    prepare_fn=None,
    phases: bool = False,
    device="cuda",
) -> dict:
    """SpMM micro-benchmark: times the prepared product, checks it on
    sampled rows against a float64 CSR product and, where the one-shot
    oracle is affordable (``nnz · H <= 2^27``), times it as
    ``ref_time(ms)``. ``dtype`` is the payload: float32 (normal
    features), or int8, int16, int32 (integer features in [-10, 10] and
    the graph's values cast to the dtype, as the reference).
    ``prepare_fn(graph, config) -> prep`` overrides the default prepare;
    ``phases`` adds :meth:`PreparedSpmm.phase_times`."""
    if dtype not in _PAYLOAD_DTYPES:
        raise NotImplementedError(
            f"dtype {dtype!r}: the port's payloads are {_PAYLOAD_DTYPES} "
            "(bfloat16 and int64 are not ported)"
        )
    rep = reporter or DataReporter()
    rep.report("data_source", "synthetic" if ds.synthetic else "real")
    rep.report("device", device_name(device))
    rng = np.random.default_rng(0)
    graph = ds.graph
    if dtype.startswith("int"):
        x_np = rng.integers(-10, 11, (graph.ncols, hidden))
    else:
        x_np = rng.standard_normal((graph.ncols, hidden))
    x = torch.as_tensor(x_np, dtype=getattr(torch, dtype)).to(device)
    graph = _cast_graph(graph, dtype)
    prep = _prepare(graph, config, prepare_fn, device, rep)
    # the sparse operand moved to the device inside prepare; runs never
    # re-copy it
    rep.report("load_sparse_time(ms)", 0.0)

    dt = device_time(prep.mul, x, iters=repeat)
    itemsize = x.element_size()
    rep.report("pim_time_spmm(ms)", dt * 1e3)
    if phases:
        for k, v in prep.phase_times(x, iters=repeat).items():
            if k != "mul_time(ms)":
                rep.report(k, v)
    rep.report("spmm_effective_GBps",
               spmm_model_bytes(graph.nnz, graph.nrows, hidden, itemsize)
               / dt / 1e9)
    rep.report("edges_per_s", graph.nnz / dt)
    nnz_unique = int(getattr(prep, "nnz", graph.nnz))
    rep.report(
        "spmm_effective_GBps_unique",
        spmm_model_bytes(nnz_unique, graph.nrows, hidden, itemsize)
        / dt / 1e9,
    )
    if verify:
        # the hybrid's int8 core rounds a float payload to bf16: rtol 1e-2,
        # the reference's bar for a reduced-precision core; elsewhere (an
        # integer payload, the ell and oracle backends) rtol 1e-4
        cfg = getattr(prep, "config", None)
        loose = (cfg is not None and cfg.backend == "hybrid"
                 and x.dtype == torch.float32)
        ok = _verify_against_oracle(graph, prep, x, rng,
                                    rtol=1e-2 if loose else 1e-4)
        rep.report("verify", "OK" if ok else "ERROR")
        if not ok:
            raise AssertionError("SpMM backend mismatch vs oracle")
    if graph.nnz * hidden <= 2 ** 27:
        oracle = prepare_spmm(graph, SpmmConfig(backend="oracle"),
                              device=device)
        rep.report("ref_time(ms)",
                   device_time(oracle.mul, x, iters=repeat) * 1e3)
    return rep.means()


def _verify_against_oracle(
    graph, prep, x, rng, rows_to_check: int = 256, rtol: float = 1e-4
):
    """Spot-check ``prep.mul(x)`` against a NumPy float64 CSR product on
    sampled rows (cheap at any graph size)."""
    csr = graph.to_csr()
    out = prep.mul(x).cpu().numpy()
    xs = x.cpu().numpy()
    rows = rng.choice(csr.nrows, min(rows_to_check, csr.nrows), replace=False)
    for r in rows:
        e0, e1 = int(csr.rowptr[r]), int(csr.rowptr[r + 1])
        ref = (
            xs[csr.colind[e0:e1]].astype(np.float64)
            * csr.vals[e0:e1, None].astype(np.float64)
        ).sum(axis=0)
        got = out[r].astype(np.float64)
        tol = 10 * rtol * max(1.0, np.abs(ref).max())
        if not np.allclose(got, ref, atol=tol, rtol=rtol):
            return False
    return True


def run_inference_benchmark(
    ds: GraphDataset,
    *,
    model: str = "gcn",
    num_layers: int = 2,
    hidden: int = 256,
    agg_dtype: Optional[str] = "int32",
    config: Optional[SpmmConfig] = None,
    repeat: int = 1,
    reporter: Optional[DataReporter] = None,
    seed: int = 0,
    prepare_fn=None,
    validate: bool = False,
    device="cuda",
) -> dict:
    """End-to-end GNN inference: ``infer_time(ms)`` of the model forward
    and the test accuracy of the (untrained) model. ``agg_dtype`` defaults
    to int32-quantized aggregation, as the reference's; int8 and int16
    quantize too, and ``None`` aggregates the float payload. With
    ``config=None`` the operand is the reference's default configuration
    (:func:`default_config`). ``validate`` adds the per-layer sampled
    check of every aggregate (``bench/validate.py``), which reports
    ``agg{i}_max_rel_err`` and ``validate`` and raises ``AssertionError``
    when a row fails."""
    rep = reporter or DataReporter()
    rep.report("data_source", "synthetic" if ds.synthetic else "real")
    rep.report("device", device_name(device))
    graph = ds.graph
    x = torch.as_tensor(ds.x, dtype=torch.float32).to(device)
    prep = _prepare(graph, config, prepare_fn, device, rep)
    gnn = make_gnn(seed, model, ds.x.shape[1], hidden, ds.num_classes,
                   num_layers=num_layers, agg_dtype=agg_dtype, device=device)
    agg = PreparedAggregate(prep)

    @torch.inference_mode()
    def fwd(x):
        return gnn(x, agg)

    dt = device_time(fwd, x, iters=repeat)
    rep.report("infer_time(ms)", dt * 1e3)
    rep.report("edges_per_s", graph.nnz * num_layers / dt)
    logits = fwd(x).cpu().numpy()
    rep.report("test_acc", evaluate_predictions(ds, logits))
    del logits
    if validate:
        from pygim_tpu_torch.bench.validate import (
            JittedAggregate,
            validate_inference_sampled,
        )

        if not validate_inference_sampled(graph, gnn, x, JittedAggregate(prep),
                                          reporter=rep):
            raise AssertionError("per-layer validation failed")
    return rep.means()


def evaluate_predictions(ds: GraphDataset, logits: np.ndarray) -> float:
    """Accuracy on the test split."""
    mask = ds.test_mask
    if not mask.any():
        return 0.0
    if getattr(ds, "metric", "acc") != "acc":
        raise NotImplementedError(
            f"metric {ds.metric!r}: only accuracy is ported so far"
        )
    return float((logits[mask].argmax(-1) == ds.y[mask]).mean())
