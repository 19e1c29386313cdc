#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one CUDA card, the twin of
``bench.py``: prints ONE JSON line ``{"metric", "value", "unit",
"vs_baseline", "spmm_effective_GBps_unique", "device"}`` as the last
line of stdout.

Metric: single-card SpMM effective bandwidth on the Reddit-shaped graph
(CSR, float32, hidden 256), in the reference's traffic model
(``bench/runners.py:spmm_model_bytes``: edge streams, one dense-row read
per edge, the output write), credited with the raw stored edges
(``value``) and with the merged ones (``spmm_effective_GBps_unique``).
``vs_baseline`` is ``value`` over 70% of the card's HBM peak:
``PYGIM_BENCH_HBM_GBPS`` where set, else the table of
``pygim_tpu_torch/utils/device.py`` by the card's name (an unknown card
raises). ``device`` names the card, so no line of this script reads as
one of ``bench.py``'s.

The environment pins of ``bench.py``: ``PYGIM_BENCH_DATASET`` (default
``reddit``), ``_HIDDEN`` (256), ``_BACKEND`` (``hybrid``),
``_CORE_DTYPE`` / ``_CORE_BYTES`` / ``_CORE_SHAPE`` (any of them pins one
candidate), ``_MEASURE_TOP`` (1), ``_ITERS`` (5) and ``_DEADLINE_S``
(1500). Candidates go in ``bench.py``'s order, stair int8 at 8 GiB
first; the square int8, int4 and bf16 candidates run too (a graph whose
values are not integers keeps only the bf16 ones, as ``bench.py``). A
configuration the port refuses (``NotImplementedError``) is skipped with
a line on stderr; an out-of-memory error on the card moves to the next;
any other error fails the run with no JSON line. After timing, 256
sampled rows of the product are checked against float64 (rtol 1e-2: the
core rounds a float payload to bf16); a mismatch fails the run too.

Progress goes to stderr: the core's bands (a square core: its one band),
the tail's edges and tables, the core's coverage, K-core's schedule
balance, the least times of K-core and K-tail on this operand
(``pygim_tpu_torch/bench/report.py:operand_info``), the prepare phases,
the kernels' launches in the timed calls, ``phase_times``, peak host and
card memory, and the card's name and power limit.

    python3 bench_cuda.py
"""

import json
import os
import resource
import sys
import time

TARGET_FRACTION = 0.70


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def candidates():
    """``bench.py``'s candidate list and how many of them to measure."""
    env_dt = os.environ.get("PYGIM_BENCH_CORE_DTYPE")
    env_b = os.environ.get("PYGIM_BENCH_CORE_BYTES")
    env_shape = os.environ.get("PYGIM_BENCH_CORE_SHAPE")
    if env_dt or env_b or env_shape:
        return [(env_dt or "int8", int(env_b or (12 << 30)),
                 env_shape or "square")], 1
    return [
        ("int8", 8 << 30, "stair"),
        ("int8", 12 << 30, "stair"),
        ("int8", 12 << 30, "square"),
        ("int4", 8 << 30, "square"),
        ("bfloat16", 12 << 30, "square"),
        ("bfloat16", 8 << 30, "square"),
        ("bfloat16", 4 << 30, "square"),
    ], int(os.environ.get("PYGIM_BENCH_MEASURE_TOP", 1))


def hbm_peak_gbps(card: str) -> float:
    env = os.environ.get("PYGIM_BENCH_HBM_GBPS")
    if env:
        return float(env)
    from pygim_tpu_torch.utils.device import peaks

    return peaks(card)[0] / 1e9


def main(*, device="cuda") -> dict:
    """Run the benchmark on ``device`` and print its line. Returns the
    line, the measured candidate's prepared operand (``prep``) and
    config, the payload ``x``, the graph, the time and the stderr
    records."""
    import numpy as np
    import torch

    from pygim_tpu_torch.bench.report import operand_info
    from pygim_tpu_torch.bench.runners import (
        _verify_against_oracle,
        spmm_model_bytes,
    )
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line
    from pygim_tpu_torch.utils.timers import device_time

    dataset = os.environ.get("PYGIM_BENCH_DATASET", "reddit")
    hidden = int(os.environ.get("PYGIM_BENCH_HIDDEN", 256))
    t_start = time.time()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("bench_cuda: no CUDA device")
        card = torch.cuda.get_device_name(dev)
        log(f"card: {card_line()}")
    else:
        card = dev.type
    target = TARGET_FRACTION * hbm_peak_gbps(card)

    log(f"loading {dataset} ...")
    ds = load_dataset(dataset)
    graph = ds.graph
    log(f"graph: N={graph.nrows} E={graph.nnz} "
        f"({'synthetic' if ds.synthetic else 'real'})  "
        f"[{time.time() - t_start:.1f}s]")

    backend = os.environ.get("PYGIM_BENCH_BACKEND", "hybrid")
    attempts, measure_top = candidates()
    sample = graph.vals[:: max(1, graph.vals.size // 4096)]
    if not np.all(sample == np.round(sample)):
        attempts = [(d, b, s) for d, b, s in attempts
                    if d not in ("int4", "int8")] \
            or [("bfloat16", 12 << 30, "square")]
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((graph.ncols, hidden)),
                        dtype=torch.float32).to(dev)
    iters = int(os.environ.get("PYGIM_BENCH_ITERS", 5))

    # once one candidate is measured, start no other past the deadline
    deadline = t_start + float(os.environ.get("PYGIM_BENCH_DEADLINE_S", 1500))
    dt = best = None
    measured = 0
    for core_dtype, budget, shape in attempts:
        if dt is not None and time.time() > deadline:
            log(f"deadline ({time.time() - t_start:.0f}s elapsed): "
                "reporting the best measured candidate")
            break
        what = f"{core_dtype} {shape} core at {budget / (1 << 30):g} GiB"
        cfg = SpmmConfig(
            backend=backend, format="csr", hybrid_core_bytes=budget,
            hybrid_dtype=core_dtype or None, hybrid_shape=shape,
        )
        try:
            cfg.check_supported()
        except NotImplementedError as e:
            log(f"{what}: skipped, not ported ({e})")
            continue
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            t0 = time.time()
            prep = prepare_spmm(graph, cfg, device=dev)
            prep_s = time.time() - t0
            reset_launch_counts()
            dt_i = device_time(prep.mul, x, iters=iters)
            launches = launch_counts()
        except torch.cuda.OutOfMemoryError as e:
            log(f"{what}: out of card memory ({e}); trying the next one")
            torch.cuda.empty_cache()
            continue
        phases = {k: v * 1e3 for k, v in getattr(
            getattr(prep, "prepare_timer", None), "acc", {}).items()}
        log(f"{what}: prepare {prep_s:.1f} s, phases (ms) {phases}")
        log(f"{what}: {dt_i * 1e3:.4f} ms per SpMM; launches in the timed "
            f"calls {json.dumps(launches)}")
        measured += 1
        if dt is None or dt_i < dt:
            dt = dt_i
            best = dict(prep=prep, config=cfg, prepare_s=prep_s,
                        phases=phases, launches=launches)
        del prep  # the best one stays in `best`
        if measured >= measure_top:
            break
    if dt is None:
        raise RuntimeError("bench_cuda: no candidate could be measured")
    prep = best["prep"]

    best["describe"] = operand_info(prep, hidden, dev)
    log(f"operand: {best['describe']}")
    best["phase_times"] = prep.phase_times(x, iters=iters)
    log(f"phase_times (ms): {best['phase_times']}")
    best["peak_card_bytes"] = (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None)
    best["peak_host_rss_kib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    log(f"peak card memory {best['peak_card_bytes']} bytes; peak host RSS "
        f"{best['peak_host_rss_kib']} KiB")
    if not _verify_against_oracle(graph, prep, x, rng, rtol=1e-2):
        raise AssertionError("bench_cuda: sampled rows differ from the "
                             "float64 product")
    log("verify: OK (256 sampled rows against float64, rtol 1e-2)")

    gbps = spmm_model_bytes(graph.nnz, graph.nrows, hidden, 4) / dt / 1e9
    gbps_unique = spmm_model_bytes(prep.nnz, graph.nrows, hidden, 4) \
        / dt / 1e9
    log(f"effective {gbps:.1f} GB/s (unique-edge credit {gbps_unique:.1f}); "
        f"target {target:.0f} GB/s ({TARGET_FRACTION * 100:.0f}% of "
        f"{target / TARGET_FRACTION:.0f})  [{time.time() - t_start:.1f}s]")
    line = {
        "metric": f"spmm_effective_bandwidth_{dataset}_csr_f32_h{hidden}",
        "value": round(gbps, 2),
        "unit": "GB/s",
        "vs_baseline": round(gbps / target, 4),
        "spmm_effective_GBps_unique": round(gbps_unique, 2),
        "device": card,
    }
    print(json.dumps(line), flush=True)
    return dict(best, line=line, x=x, graph=graph, ms=dt * 1e3)


if __name__ == "__main__":
    main()
