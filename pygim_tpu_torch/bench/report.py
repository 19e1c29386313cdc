"""Tracked config 4 at full size, reported layer by layer.

    python3 -m pygim_tpu_torch.bench.report

Config 4 is the reference's int8-quantized 2-layer GCN on ogbn-products
(``pygim_tpu/bench/configs.py``): a square int4 hub-core at 6 GiB, int8
aggregation, hidden 256, validated. The report loads the dataset,
prepares the operand (its host phases, the peak host RSS), describes it
(:func:`operand_info`: the core's bands, its coverage, the tail's tables,
the schedules' balance and the kernels' least times on this operand),
runs ``run_inference_benchmark`` with the per-layer sampled check
(``[DATA]`` lines: ``infer_time(ms)``, ``edges_per_s``, ``validate``), a
float32 SpMM on the same operand (its sampled-row check and
``phase_times``: K-core and K-tail each alone) and, on the card, a
per-kernel device profile of one forward (:func:`profile_forward`), and
ends with the launches of the timed calls and the peak card memory.
Progress and the descriptions go to stderr, each line with the elapsed
seconds; the last line of stdout is the whole report as JSON.
"""

from __future__ import annotations

import json
import resource
import sys
import time

import torch

from pygim_tpu_torch.utils.timers import device_time

_T0 = time.time()


def log(*a) -> None:
    print(f"[{time.time() - _T0:8.1f}s]", *a, file=sys.stderr, flush=True)


def operand_info(prep, hidden: int, dev, limbs=None) -> dict:
    """A hybrid operand's shape: its core's bands, the tail's edges (the
    nonzero slots of the ELL tables) and step-table shapes, the core's
    share of the merged edges; on the card also the balance of K-core's
    tile schedule and (``limbs``) of K-int's cluster schedule at this
    width, and the least times of one K-core, K-int and K-tail call on
    this operand (``utils/device.py``): on a bf16 core K-core's bf16 mode
    and K-f32 (its int16 and int32 payloads), on an f32 core K-f32
    alone."""
    from pygim_tpu_torch.ops import core_dot, core_int
    from pygim_tpu_torch.ops.ell_tail import real_entries
    from pygim_tpu_torch.utils.device import (
        core_bound,
        f32_bound,
        int_bound,
        peaks,
        tail_bound,
    )

    tables = prep.ell_tables(prep.dev_arrays)
    rows, cols, _vals = real_entries(tables)
    tail = int(rows.numel())
    bcsr_edges = prep.bcsr_edges if prep.has_bcsr else 0
    info = dict(
        bands=prep.stair, core_dtype=getattr(prep, "core_dtype", None),
        tail_edges=tail, tail_tables=[[*c.shape, d] for c, _v, _r, d in tables],
        core_coverage=(prep.nnz - tail - bcsr_edges) / max(1, prep.nnz),
    )
    if prep.has_bcsr:
        info.update(bcsr_kind=prep.bcsr_kind,
                    bcsr_tiles=list(prep.dev_arrays["tiles"].shape),
                    bcsr_edges=bcsr_edges,
                    bcsr_coverage=bcsr_edges / max(1, prep.nnz))
    if dev.type != "cuda":
        return info
    pk = peaks(torch.cuda.get_device_name(dev))
    n_rows, n_cols = (int(torch.unique(t).numel()) for t in (rows, cols))
    del rows, cols
    info["tail_bound_ms"] = tail_bound(tail, n_cols, n_rows, hidden, pk)
    info["tail_int8_bound_ms"] = tail_bound(tail, n_cols, n_rows, hidden, pk,
                                            itemsize=1)
    if prep.stair:
        bands = prep.stair
        shapes = [(hi - lo, w) for lo, hi, w in bands]
        if prep.core_dtype in ("float32", "float64"):
            # K-f32 on f32 cells (a float64 core's are f32 too)
            info["core_bound_ms"] = f32_bound(shapes, hidden, pk, 4.0)
            return info
        mode = {"int8": core_dot.INT8, "int4": core_dot.PACKED,
                "bfloat16": core_dot.BF16}[prep.core_dtype]
        cell = core_dot.MODE_CELL_BYTES[mode]
        counts = core_dot.max_clusters(dev, mode)
        info["schedule_balance"] = core_dot.schedule_balance(
            bands, -(-hidden // 8) * 8, counts, cell_bytes=cell)
        info["schedule_split"] = core_dot.schedule_split(
            bands, -(-hidden // 8) * 8, counts, cell_bytes=cell)
        info["core_bound_ms"] = core_bound(shapes, hidden, pk, cell)
        if prep.core_dtype == "bfloat16":
            # an int16 or int32 payload on bf16 cells: K-f32
            info["f32_bound_ms"] = f32_bound(shapes, hidden, pk, cell)
            return info
        if limbs:
            info["int_limbs"] = limbs
            info["int_schedule_balance"] = core_int.cluster_balance(
                bands, hidden, limbs, core_int.max_clusters(
                    limbs, dev, packed=prep.core_dtype == "int4"))
            info["int_bound_ms"] = int_bound(shapes, hidden, limbs, pk, cell)
    return info


def square_core_calls(prep, hidden: int, dev, iters: int = 5) -> dict:
    """K-core's and K-int's (one limb) time alone on the operand's square
    core (its one band, at width ``hidden``), beside the PyTorch call that
    computes the same product on the band widened in memory:
    ``torch.matmul`` on bf16 cells, ``torch._int_mm`` on int8 cells; ms
    a call (CUDA events), with each kernel's split and schedule balance.
    The widened band is built in row blocks and freed before the next."""
    from pygim_tpu_torch.ops import core_dot, core_int

    (lo, hi, w), = prep.stair
    r = hi - lo
    band = prep.dev_arrays["core"]
    rows = prep.dev_arrays["core_nodes"][lo:hi]
    stair = [(0, r, w)]
    g = torch.Generator(device=dev).manual_seed(0)
    out = torch.zeros(prep.nrows, hidden, device=dev)
    packed = core_dot.is_packed([band])

    def widened(dtype):
        cells = torch.empty(r, w, dtype=dtype, device=dev)
        for r0 in range(0, r, 8192):
            cells[r0:r0 + 8192] = core_dot.band_cells(band[r0:r0 + 8192])
        return cells

    def ms(fn):
        return device_time(fn, iters=iters) * 1e3

    res = {"shape": [r, w, hidden]}
    xc = torch.randn(w, hidden, generator=g, device=dev).to(torch.bfloat16)
    plans = core_dot.core_plans([band], stair, hidden)
    res["K-core_ms"] = ms(lambda: core_dot.core_bands_scatter_add(
        [band], xc, rows, stair, out, plans=plans))
    res["K-core_split"] = [p.split for p in plans]
    res["K-core_balance"] = core_dot.schedule_balance(
        stair, hidden, core_dot.max_clusters(dev, packed))
    cells = widened(torch.bfloat16)
    res["matmul_bf16_ms"] = ms(lambda: torch.matmul(cells, xc))
    del cells, plans
    torch.cuda.empty_cache()
    xq = torch.randint(-16, 17, (w, hidden), generator=g, device=dev).to(
        torch.int8)
    plans = core_int.core_int_plans([band], stair, hidden, 1)
    xct = core_int.limb_split(xq, 1, -(-hidden // 64) * 64, -(-w // 16) * 16)
    res["K-int_ms"] = ms(lambda: core_int.core_int_launch(
        [band], xct, rows, stair, out, plans))
    res["K-int_split"] = [p.split for p in plans]
    res["K-int_balance"] = core_int.cluster_balance(
        stair, hidden, 1, core_int.max_clusters(1, dev, packed))
    cells = widened(torch.int8)
    res["int_mm_ms"] = ms(lambda: torch._int_mm(cells, xq))
    del cells, plans, xct, out
    torch.cuda.empty_cache()
    return res


def kernel_family(name: str) -> str:
    """The family of a device kernel by its name: ``"torch"`` for
    PyTorch's own kernels (elementwise, reductions, copies, fills,
    gathers: the unfused passes), ``"gemm"`` for cuBLAS's matrix products,
    ``"K-bn"`` for the training block's kernels (``csrc/bn_train.cu``:
    BatchNorm, ReLU and dropout, forward and backward), ``"hand"`` for this
    package's other kernels (``csrc/``) and anything else."""
    if "at::native" in name or "at_cuda_detail" in name:
        return "torch"
    if "bn_train::" in name:
        return "K-bn"
    if any(k in name.lower() for k in ("gemm", "cutlass", "xmma")):
        return "gemm"
    return "hand"


def profile_calls(fn, what: str, iters: int = 5, out=None) -> dict:
    """Device time by kernel for one call of ``fn`` (torch.profiler over
    ``iters`` calls), and the device's busy share of its wall time;
    printed (to ``out``, default stdout) and returned as ``{"wall_ms",
    "busy_ms", "families", "kernels": [(ms, launches, name)]}`` per call
    (``families``: ms by :func:`kernel_family` over every kernel, the top
    25 kernels alone in ``kernels``). ``fn`` returns a tensor of its
    result, so ``device_time`` times it on the card."""
    from torch.profiler import ProfilerActivity, profile

    out = out or sys.stdout
    wall_ms = device_time(fn, iters=iters) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device kernels only: a host op (aten::mm, ...) carries its kernels'
    # time as well, and only host ops have host time of their own
    evs = [e for e in prof.key_averages()
           if dev_us(e) > 0 and e.self_cpu_time_total == 0]
    busy_ms = sum(dev_us(e) for e in evs) / iters / 1e3
    print(f"profile: {what} {wall_ms:.4f} ms wall, {busy_ms:.4f} ms device "
          f"busy ({100 * busy_ms / wall_ms:.1f}%)", file=out, flush=True)
    families = {}
    for e in evs:
        fam = kernel_family(e.key)
        families[fam] = families.get(fam, 0.0) + dev_us(e) / iters / 1e3
    print(f"profile: {what} by family (ms): "
          f"{ {k: round(v, 4) for k, v in sorted(families.items())} }",
          file=out, flush=True)
    kernels = []
    for e in sorted(evs, key=dev_us, reverse=True)[:25]:
        kernels.append((dev_us(e) / iters / 1e3, e.count // iters, e.key))
        print(f"profile: {kernels[-1][0]:9.4f} ms  {kernels[-1][1]:4d}x  "
              f"{e.key[:90]}", file=out, flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, families=families,
                kernels=kernels)


def profile_forward(gnn, x, agg, iters: int = 5, out=None) -> dict:
    """:func:`profile_calls` of one inference forward."""

    def fwd():
        with torch.inference_mode():
            return gnn(x, agg)

    return profile_calls(fwd, "forward", iters=iters, out=out)


HIDDEN = 256
REPEAT = 10
AGG_DTYPE = "int8"


def config():
    """Config 4's operand: hybrid, the default square shape, int4 cells
    in a 6 GiB core."""
    from pygim_tpu_torch.ops.spmm import SpmmConfig

    return SpmmConfig(backend="hybrid", format="csr", hybrid_dtype="int4",
                      hybrid_core_bytes=6 << 30)


def main(dataset: str = "ogbn-products", device="cuda") -> dict:
    """Config 4 on ``dataset`` on ``device`` (the tests run a small graph
    on the CPU, where the profile is left out); returns the report."""
    from pygim_tpu_torch.bench.runners import (
        run_inference_benchmark,
        run_spmm_benchmark,
    )
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.core_int import QUANT_LIMBS
    from pygim_tpu_torch.ops.spmm import PreparedAggregate, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line
    from pygim_tpu_torch.utils.metrics import DataReporter

    dev = torch.device(device)
    res = {}
    if dev.type == "cuda":
        res["card"] = card_line()
        log(f"card: {res['card']}")
    t0 = time.time()
    ds = load_dataset(dataset)
    res["load_s"] = time.time() - t0
    log(f"dataset {dataset}: N={ds.graph.nrows} E={ds.graph.nnz} "
        f"F={ds.x.shape[1]} classes={ds.num_classes}, {res['load_s']:.1f} s")
    cfg = config()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    prep = prepare_spmm(ds.graph, cfg, device=dev)
    res["prepare_s"] = time.time() - t0
    res["prepare_phases_ms"] = {k: v * 1e3
                                for k, v in prep.prepare_timer.acc.items()}
    res["peak_host_rss_gib_after_prepare"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    log(f"prepare {res['prepare_s']:.1f} s (k={prep.hybrid_k_eff}, merged "
        f"{prep.nnz} edges), phases (ms) {res['prepare_phases_ms']}, peak "
        f"host RSS {res['peak_host_rss_gib_after_prepare']:.2f} GiB")
    res["operand"] = operand_info(prep, HIDDEN, dev, QUANT_LIMBS[AGG_DTYPE])
    log(f"operand: {res['operand']}")

    rep = DataReporter(echo=True)
    reuse = lambda g, c: prep  # noqa: E731 — the operand prepared above
    reset_launch_counts()
    res["inference"] = run_inference_benchmark(
        ds, hidden=HIDDEN, agg_dtype=AGG_DTYPE, config=cfg, repeat=REPEAT,
        reporter=rep, prepare_fn=reuse, validate=True, device=dev)
    res["inference_launches"] = launch_counts()
    log(f"inference launches (timed, checked and validated forwards): "
        f"{res['inference_launches']}")
    reset_launch_counts()
    res["spmm"] = run_spmm_benchmark(
        ds, hidden=HIDDEN, dtype="float32", config=cfg, repeat=REPEAT,
        reporter=rep, prepare_fn=reuse, phases=True, device=dev)
    res["spmm_launches"] = launch_counts()
    log(f"spmm launches: {res['spmm_launches']}")
    if dev.type == "cuda":
        gnn = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                       num_layers=2, agg_dtype=AGG_DTYPE, device=dev)
        x = torch.as_tensor(ds.x, dtype=torch.float32).to(dev)
        res["profile"] = profile_forward(gnn, x, PreparedAggregate(prep),
                                         out=sys.stderr)
        del gnn, x
    if dev.type == "cuda":
        res["peak_card_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["peak_host_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    log(f"peak card memory {res.get('peak_card_gb')} GB, peak host RSS "
        f"{res['peak_host_rss_gib']:.2f} GiB")
    if dev.type == "cuda" and len(prep.stair) == 1:
        res["square_core_calls"] = square_core_calls(prep, HIDDEN, dev)
        log(f"square core, kernels and library calls: "
            f"{res['square_core_calls']}")
    print(json.dumps(res, default=str))
    return res


if __name__ == "__main__":
    main()
