"""Benchmark bodies — counterparts of ``pygim_tpu/bench/runners.py``.

They report through the ``[DATA]`` protocol under the reference's key
names (``pim_time_spmm(ms)``, ``prepare_pim_time(ms)``,
``infer_time(ms)``, ``train_time(ms)``, ``test_acc``, ...). SpMM and
inference times come from
:func:`~pygim_tpu_torch.utils.timers.device_time` on the device the
operands live on; ``train_time(ms)`` is the host clock around each
training epoch, synchronised at its end, summed.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.data import GraphDataset
from pygim_tpu_torch.nn.models import make_gnn
from pygim_tpu_torch.ops.spmm import (
    PreparedAggregate,
    SpmmConfig,
    prepare_spmm,
    runs_kernels,
)
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


def _prepare(graph, config, prepare_fn, device, rep, mesh=None):
    """The operand: ``prepare_fn(graph, config)`` where given, else over
    ``mesh`` where given (``parallel/spmm_2d.py``, or ``parallel/halo.py``
    for a node line), else on ``device``;
    its prepare time, host phases and ``layout``."""
    t0 = time.perf_counter()
    if prepare_fn is not None:
        prep = prepare_fn(graph, config)
    elif mesh is not None:
        from pygim_tpu_torch.parallel import (
            NodeMesh,
            prepare_spmm_2d,
            prepare_spmm_halo,
        )

        prepare_mesh = (prepare_spmm_halo if isinstance(mesh, NodeMesh)
                        else prepare_spmm_2d)
        prep = prepare_mesh(graph, mesh, config or default_config())
    else:
        prep = prepare_spmm(graph, config or default_config(), device=device)
    rep.report("prepare_pim_time(ms)", (time.perf_counter() - t0) * 1e3)
    for ph, sec in getattr(
        getattr(prep, "prepare_timer", None), "acc", {}
    ).items():
        rep.report(f"prepare_{ph}_time(ms)", sec * 1e3)
    from pygim_tpu_torch.compat import describe_layout

    rep.report("layout", describe_layout(prep))
    return prep


def device_name(device) -> str:
    """The name of ``device`` for the ``[DATA]device`` line: the card's
    name, or ``cpu``; no line of the port reads as a TPU entry."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


_PAYLOAD_DTYPES = ("float32", "bfloat16", "int8", "int16", "int32", "int64")


def _cast_graph(graph, dtype: str):
    """The graph with its values in the payload's dtype, as the
    reference's ``_cast_graph`` (integer payloads, integer weights; a
    bfloat16 payload keeps float32 weights on the host,
    ``pygim_tpu/bench/runners.py:147-150``)."""
    want = np.dtype(dtype if dtype != "bfloat16" else "float32")
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
    mesh=None,
) -> dict:
    """SpMM micro-benchmark: times the prepared product, checks it on
    sampled rows against a float64 CSR product and, where the one-shot
    oracle is affordable (``nnz · H <= 2^27``), times it as
    ``ref_time(ms)``. ``dtype`` is the payload: float32 or bfloat16
    (normal features), or int8, int16, int32, int64 (integer features in
    [-10, 10] and the graph's values cast to the dtype, as the
    reference).
    ``prepare_fn(graph, config) -> prep`` overrides the default prepare;
    ``mesh`` (``parallel/mesh.py:make_mesh``) prepares over a 2D mesh,
    whose product comes back on the mesh's first device; ``phases`` adds
    the operand's ``phase_times``."""
    if dtype not in _PAYLOAD_DTYPES:
        raise ValueError(
            f"dtype {dtype!r}: the payloads are {_PAYLOAD_DTYPES}")
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
    prep = _prepare(graph, config, prepare_fn, device, rep, mesh)
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
        # a reduced-precision core computes a float payload in bf16: a bf16
        # core, and an int8 or int4 core fed floats; rtol 1e-2, the
        # reference's bar for it (pygim_tpu/bench/runners.py:118-134);
        # elsewhere (an integer payload on an integer core, an f32 core,
        # the ell and oracle backends) rtol 1e-4
        cfg = getattr(prep, "config", None)
        loose = (cfg is not None and cfg.backend == "hybrid" and (
            cfg.hybrid_dtype == "bfloat16"
            or (cfg.hybrid_dtype in ("int8", "int4")
                and x.is_floating_point())))
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
    xs = (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
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
    mesh=None,
) -> dict:
    """End-to-end GNN inference: ``infer_time(ms)`` of the model forward
    and the test accuracy of the (untrained) model. ``agg_dtype`` defaults
    to int32-quantized aggregation, as the reference's; int8 and int16
    quantize too, and ``None`` aggregates the float payload. With
    ``config=None`` the operand is the reference's default configuration
    (:func:`default_config`). ``validate`` adds the per-layer sampled
    check of every aggregate (``bench/validate.py``), which reports
    ``agg{i}_max_rel_err`` and ``validate`` and raises ``AssertionError``
    when a row fails. ``mesh`` prepares over a 2D mesh (the model and x
    on ``device``, the mesh's first device); its aggregate does not fuse
    the quantization, so an integer ``agg_dtype`` takes the quantize
    round trip around the mesh product."""
    rep = reporter or DataReporter()
    rep.report("data_source", "synthetic" if ds.synthetic else "real")
    rep.report("device", device_name(device))
    graph = ds.graph
    x = torch.as_tensor(ds.x, dtype=torch.float32).to(device)
    prep = _prepare(graph, config, prepare_fn, device, rep, mesh)
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


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_inputs(ds: GraphDataset, device) -> tuple:
    """Features (float32), labels (int64) and the float train mask of
    ``ds`` on ``device``."""
    return (torch.as_tensor(ds.x, dtype=torch.float32).to(device),
            torch.as_tensor(ds.y.astype(np.int64)).to(device),
            torch.as_tensor(ds.train_mask.astype(np.float32)).to(device))


def run_training_benchmark(
    ds: GraphDataset,
    *,
    model: str = "gcn",
    num_layers: int = 2,
    hidden: int = 256,
    config: Optional[SpmmConfig] = None,
    epochs: int = 50,
    lr: float = 1e-2,
    seed: int = 0,
    reporter: Optional[DataReporter] = None,
    prepare_fn=None,
    parity: bool = True,
    acc_tol: float = 0.01,
    oracle_chunk: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> dict:
    """Trained-accuracy parity (``pygim_tpu/bench/runners.py:262-391``):
    train the same initialisation with the same dropout seeds (``seed ·
    100003 + epoch``) twice, through the backend under test and through
    the oracle (chunked by ``oracle_chunk`` edges), then require

    * test metrics within ``acc_tol`` (``acc_delta``), and
    * the trained model's per-layer activations under both aggregates
      within ``validate_model``'s bar: 1e-2 on a hybrid with a rounded
      core (bf16, int8, int4 cells), 1e-4 elsewhere (``validate``).

    Reports ``train_time(ms)`` (all epochs, each synchronised),
    ``first_epoch_time(ms)``, ``epoch_time(ms)`` (the median epoch),
    ``train_loss``, ``test_acc``,
    ``oracle_train_loss``, ``oracle_test_acc``, ``acc_delta``,
    ``layer{i}_max_err`` and ``validate``, and the device bytes of the
    operand and, on a kernel backend or a mesh, of its prepared transpose
    (``operand_bytes``, ``transpose_bytes``), which is prepared before the
    epochs are timed (``prepare_transpose_time(ms)``). A ``mesh`` (the 2D
    :class:`~pygim_tpu_torch.parallel.Mesh` or a node line,
    :class:`~pygim_tpu_torch.parallel.NodeMesh`, whose operand is the
    halo layout's) trains over it, its backward on the mesh's own Aᵀ;
    ``device`` is then the mesh's first device. Each of the
    backend's steps is split into its phases
    (:class:`~pygim_tpu_torch.nn.train.StepSplit`), reported as
    ``forward_ms``, ``backward_ms`` and ``adam_ms`` (medians, the first
    epoch apart) and ``step_launches`` (the last step's, by phase). With
    ``config=None`` the operand is the reference's default
    configuration."""
    from pygim_tpu_torch.bench.validate import JittedAggregate, validate_model
    from pygim_tpu_torch.nn.models import gnn_apply
    from pygim_tpu_torch.nn.train import StepSplit, make_train_step

    rep = reporter or DataReporter()
    rep.report("data_source", "synthetic" if ds.synthetic else "real")
    rep.report("device", device_name(device))
    graph = ds.graph
    x, labels, train_mask = train_inputs(ds, device)
    prep = _prepare(graph, config, prepare_fn, device, rep, mesh)
    cfg = getattr(prep, "config", None)
    kernels = hasattr(prep, "transpose") and runs_kernels(prep)
    if kernels:
        # the backward's operand, prepared before the clock starts
        t0 = time.perf_counter()
        prep.transpose(graph)
        rep.report("prepare_transpose_time(ms)",
                   (time.perf_counter() - t0) * 1e3)
    init = make_gnn(seed, model, ds.x.shape[1], hidden, ds.num_classes,
                    num_layers=num_layers, device=device)

    def train(prep_, times=None, split=None):
        gnn = copy.deepcopy(init)
        opt = torch.optim.Adam(gnn.parameters(), lr=lr)
        step = make_train_step(gnn, PreparedAggregate(prep_), opt, split)
        loss = None
        for epoch in range(epochs):
            t0 = time.perf_counter()
            gen = torch.Generator(device=device)
            gen.manual_seed(seed * 100_003 + epoch)
            loss = step(x, labels, train_mask, gen)
            if times is not None:
                _synchronize(device)
                times.append((time.perf_counter() - t0) * 1e3)
        return gnn.eval(), float(loss)

    def test_metric(gnn, aggregate):
        with torch.no_grad():
            logits = gnn_apply(gnn, x, aggregate, training=False)
        return evaluate_predictions(ds, logits.cpu().numpy())

    times = []
    phases = StepSplit()
    gnn, loss = train(prep, times, phases)
    rep.report("train_time(ms)", sum(times))
    if times:
        # the first epoch warms up (cuBLAS, the kernels' plans at H)
        rep.report("first_epoch_time(ms)", times[0])
        rep.report("epoch_time(ms)", float(np.median(times)))
    for p in StepSplit.PHASES:
        if phases.ms[p]:
            rep.report(f"{p}_ms", float(np.median(phases.ms[p][1:]
                                                  or phases.ms[p])))
    rep.report("step_launches", phases.launches)
    rep.report("train_loss", loss)
    acc = test_metric(gnn, PreparedAggregate(prep))
    rep.report("test_acc", acc)
    if hasattr(prep, "device_bytes"):
        rep.report("operand_bytes", prep.device_bytes)
    if kernels:
        rep.report("transpose_bytes", prep.transpose().device_bytes)

    if parity:
        oracle = prepare_spmm(
            graph, SpmmConfig(backend="oracle", oracle_edge_chunk=oracle_chunk),
            device=device)
        gnn_o, loss_o = train(oracle)
        rep.report("oracle_train_loss", loss_o)
        acc_o = test_metric(gnn_o, PreparedAggregate(oracle))
        rep.report("oracle_test_acc", acc_o)
        rep.report("acc_delta", abs(acc - acc_o))
        loose = cfg is not None and cfg.backend == "hybrid" and (
            cfg.hybrid_dtype in ("bfloat16", "int8", "int4"))
        tol = 1e-2 if loose else 1e-4
        ok = validate_model(gnn, x, JittedAggregate(prep), oracle.mul,
                            reporter=rep, rtol=tol, atol=tol)
        if not ok:
            raise AssertionError(
                "trained-model per-layer validation failed vs oracle")
        if abs(acc - acc_o) > acc_tol:
            raise AssertionError(
                f"trained accuracy diverged: backend {acc:.4f} vs oracle "
                f"{acc_o:.4f} (tol {acc_tol})")
    return rep.means()


def roc_auc_micro(y: np.ndarray, scores: np.ndarray) -> float:
    """Micro-averaged ROC-AUC of ``scores`` (n, C) against the one-hot
    matrix of ``y``, as ``sklearn.metrics.roc_auc_score(onehot, scores,
    average="micro")``: the Mann-Whitney statistic over the raveled
    matrices, tied scores given their average rank. 0.0 where one class
    of the raveled labels is absent (sklearn raises there, and the
    reference returns 0.0)."""
    truth = np.eye(scores.shape[1], dtype=bool)[y].ravel()
    s = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = int(truth.sum())
    n_neg = truth.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    order = np.argsort(s, kind="stable")
    sorted_s = s[order]
    cuts = np.flatnonzero(sorted_s[1:] != sorted_s[:-1]) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [s.size]])
    ranks = np.empty(s.size, dtype=np.float64)
    ranks[order] = np.repeat((starts + ends + 1) / 2.0, ends - starts)
    u = ranks[truth].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def f1_micro(y: np.ndarray, pred: np.ndarray) -> float:
    """Micro-averaged F1 of single-label predictions,
    ``sklearn.metrics.f1_score(y, pred, average="micro")``: 2·TP / (2·TP
    + FP + FN) summed over classes, where each miss is one FP and one
    FN."""
    tp = int((pred == y).sum())
    miss = y.size - tp
    return float(2 * tp / (2 * tp + 2 * miss)) if y.size else 0.0


def evaluate_predictions(ds: GraphDataset, logits: np.ndarray) -> float:
    """Task metric on the test split (the reference's
    ``evaluate_predictions``): accuracy, or the dataset's ``rocauc``
    (:func:`roc_auc_micro`) or ``f1`` (:func:`f1_micro`), in NumPy."""
    mask = ds.test_mask
    if not mask.any():
        return 0.0
    y, lg = ds.y[mask], logits[mask]
    metric = getattr(ds, "metric", "acc")
    if metric == "rocauc":
        return roc_auc_micro(y, lg)
    if metric == "f1":
        return f1_micro(y, lg.argmax(-1))
    return float((lg.argmax(-1) == y).mean())
