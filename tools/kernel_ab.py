#!/usr/bin/env python3
"""Time the hub-core kernels of two checkouts on one card, in turns.

    python3 tools/kernel_ab.py --parent DIR [--full]

``DIR`` is an unpacked checkout of the parent commit (``git archive``);
the change is the checkout this script lies in. The script runs one
child process a turn, parent, change, change, parent, each importing
``pygim_tpu_torch`` from its own tree (so each builds its own kernels),
and prints every turn's JSON line, then each kernel's median time a
tree and the ratio change / parent.

A turn prepares the smoke operands of ``chip_smoke.py`` (the ogbn-arxiv
stand-in at a 256 MiB core budget, H 256: the stair int8 and square int4
cores, the bf16 square and stair cores, and the f32 square, the graph's
own dtype) and times, with CUDA events, each kernel on all bands of its
operand in one call: K-core int8 (stair), K-core int4 (square), K-core
bf16 (square, stair) and K-f32 (the f32 square with an f32 payload; the
bf16 square with the int32 forward's payload range), each checked against
its plain version first. The change's turns also time K-core at each
of its schedules, forced (stream-K, split 0; whole tiles, split 1), K-f32
on the f32 square at H 41, and the library calls (``torch.matmul`` per
band; f32 ``torch.matmul`` with ``index_add_``).

``--full`` times the full-size reddit-sim operands instead, a turn for
the change and then one for the parent, sharing one prepare cache: the
bf16 stair at 8 GiB (one SpMM and K-core on its bands) and the reference's
default hybrid core, an f32 square at 4 GiB (one SpMM with its 256-row
float64 check, K-f32 on its core), in both turns; in the change's turn
also the bf16 square at 12 GiB (K-core bf16 beside ``torch.matmul`` at
its shape, and the 2-layer GCN forward at hidden 256 with the per-layer
validation), K-core bf16 on the bf16 square and stair at each schedule,
forced (the readings stream-K's margin over whole tiles is set from),
and the library call at the f32 square, at H 256 and 41.

``--clocks`` (the change alone) runs K-core bf16 on the smoke bf16
square at split 1 and at stream-K, each back to back for about 3 s, with
the SM clock and power draw sampled by ``nvidia-smi`` beside it.

Every number names the card and its power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REL_TOL = 1e-5
H = 256
SMOKE = "ogbn-arxiv"
SMOKE_BYTES = 256 << 20
SMOKE_CORES = {
    "stair int8": dict(hybrid_shape="stair", hybrid_dtype="int8"),
    "square int4": dict(hybrid_shape="square", hybrid_dtype="int4"),
    "bf16 square": dict(hybrid_shape="square", hybrid_dtype="bfloat16"),
    "bf16 stair": dict(hybrid_shape="stair", hybrid_dtype="bfloat16"),
    "f32 square": dict(hybrid_shape="square", hybrid_dtype=None),
}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call: CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def close(name, got, want, mag) -> float:
    """``|got - want| <= REL_TOL · mag`` everywhere, all finite; the
    largest error."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    if (err > REL_TOL * mag + 1e-30).any():
        raise AssertionError(f"{name}: off by {float(err.max())}")
    return float(err.max())


def bands_of(prep) -> list:
    d = prep.dev_arrays
    if "core" in d:
        return [d["core"]]
    return [d[f"stair{b}"] for b in range(len(prep.stair))]


def gathered(x, prep, dtype):
    """``x[core_nodes[:max w]]`` zero-padded to the widest band, in
    ``dtype``."""
    import torch

    cn = prep.dev_arrays["core_nodes"]
    w_max = max(w for *_, w in prep.stair)
    xc = x.index_select(0, cn[:w_max]).to(dtype)
    return torch.nn.functional.pad(xc, (0, 0, 0, w_max - xc.shape[0]))


def time_core(prep, x, split=None, check=True, iters=20):
    """K-core on all bands of ``prep`` (plans at ``split``, the default
    schedule where None): ms a call, after a check against the plain
    version."""
    import torch

    from pygim_tpu_torch.ops import core_dot

    bands, cn = bands_of(prep), prep.dev_arrays["core_nodes"]
    xc = gathered(x, prep, torch.bfloat16)
    z = torch.zeros_like(x)
    kw = {} if split is None else {"split": split}
    plans = core_dot.core_plans(bands, prep.stair, x.shape[1], **kw)
    if check:
        got = core_dot.core_bands_scatter_add(bands, xc, cn, prep.stair,
                                              z.clone(), plans=plans)
        want = core_dot.core_bands_plain(bands, xc, cn, prep.stair, z.clone())
        mag = core_dot.core_bands_plain(
            [core_dot.band_cells(b).abs() for b in bands], xc.abs(), cn,
            prep.stair, z.clone())
        close("K-core", got, want, mag)
        del got, want, mag
    ms = cuda_ms(lambda: core_dot.core_bands_scatter_add(
        bands, xc, cn, prep.stair, z, plans=plans), iters=iters)
    return ms, [p.split for p in plans]


def time_f32(prep, xc, check=True, iters=10):
    """K-f32 on all bands of ``prep`` with payload ``xc``: ms a call,
    after a check against the plain version."""
    import torch

    from pygim_tpu_torch.ops import core_f32

    bands, cn = bands_of(prep), prep.dev_arrays["core_nodes"]
    z = torch.zeros(prep.nrows, xc.shape[1], device=xc.device)
    plans = core_f32.core_f32_plans(bands, prep.stair, xc.shape[1])
    if check:
        got = core_f32.core_f32_scatter_add(bands, xc, cn, prep.stair,
                                            z.clone(), plans=plans)
        want = core_f32.core_f32_plain(bands, xc, cn, prep.stair, z.clone())
        mag = core_f32.core_f32_plain([b.abs() for b in bands], xc.abs(), cn,
                                      prep.stair, z.clone())
        close("K-f32", got, want, mag)
        del got, want, mag
    return cuda_ms(lambda: core_f32.core_f32_scatter_add(
        bands, xc, cn, prep.stair, z, plans=plans), iters=iters)


def library_bf16(prep, x) -> float:
    """One ``torch.matmul`` a band, bf16 cells × bf16 ``xc``."""
    import torch

    bands = bands_of(prep)
    xc = gathered(x, prep, torch.bfloat16)
    xws = [xc[:w].contiguous() for *_, w in prep.stair]

    def run():
        for a, b in zip(bands, xws):
            torch.matmul(a, b)

    return cuda_ms(run)


def library_f32(prep, xc) -> float:
    """f32 ``torch.matmul`` (TF32 off) of the one square band and the
    payload widened to f32, then ``index_add_`` into the output rows."""
    import torch

    (lo, hi, w), = prep.stair
    a32, x32 = bands_of(prep)[0].float(), xc[:w].float()
    rows = prep.dev_arrays["core_nodes"][lo:hi]
    z = torch.zeros(prep.nrows, xc.shape[1], device=xc.device)
    return cuda_ms(lambda: z.index_add_(0, rows, torch.matmul(a32, x32)),
                   iters=10)


def smoke_turn(change: bool) -> dict:
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    ds = load_dataset(SMOKE)
    preps = {k: prepare_spmm(ds.graph, SpmmConfig(
        backend="hybrid", hybrid_core_bytes=SMOKE_BYTES, **kw),
        device="cuda") for k, kw in SMOKE_CORES.items()}
    g = torch.Generator().manual_seed(0)
    x = torch.randn(ds.graph.nrows, H, generator=g).cuda()
    ms, split = {}, {}
    for name, key in (("K-core int8 stair", "stair int8"),
                      ("K-core int4 square", "square int4"),
                      ("K-core bf16 square", "bf16 square"),
                      ("K-core bf16 stair", "bf16 stair")):
        ms[name], split[name] = time_core(preps[key], x)
    fsq = preps["f32 square"]
    ms["K-f32 f32 square"] = time_f32(fsq, gathered(x, fsq, torch.float32))
    bsq = preps["bf16 square"]
    w = bsq.stair[0][2]
    xq = torch.randint(-(1 << 19), 1 << 19, (w, H), generator=g,
                       dtype=torch.int32).cuda()
    ms["K-f32 bf16 square int32"] = time_f32(bsq, xq)
    out = {"ms": ms, "split": split}
    if change:
        forced = {}
        for name, key in (("K-core int4 square", "square int4"),
                          ("K-core int8 stair", "stair int8"),
                          ("K-core bf16 square", "bf16 square"),
                          ("K-core bf16 stair", "bf16 stair")):
            for s in (0, 1):
                forced[f"{name} split {s}"] = time_core(preps[key], x, s)[0]
        out["forced_ms"] = forced
        x41 = x[:, :41].contiguous()
        out["K-f32 f32 square H 41"] = dict(
            ms=time_f32(fsq, gathered(x41, fsq, torch.float32)),
            library_ms=library_f32(fsq, gathered(x41, fsq, torch.float32)))
        out["library_ms"] = {
            "K-core bf16 square": library_bf16(bsq, x),
            "K-core bf16 stair": library_bf16(preps["bf16 stair"], x),
            "K-f32 f32 square": library_f32(fsq, gathered(x, fsq,
                                                          torch.float32)),
            "K-f32 bf16 square int32": library_f32(bsq, xq)}
    return out


def full_turn(change: bool) -> dict:
    import torch

    from pygim_tpu_torch.bench.runners import (
        _verify_against_oracle,
        run_inference_benchmark,
    )
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import spmm
    from pygim_tpu_torch.utils.metrics import DataReporter
    from pygim_tpu_torch.utils.timers import device_time

    import numpy as np

    ds = load_dataset("reddit")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((ds.graph.ncols, H)),
                        dtype=torch.float32).cuda()
    out = {}

    def prepare(**kw):
        t0 = time.time()
        p = spmm.prepare_spmm(ds.graph, spmm.SpmmConfig(
            backend="hybrid", format="csr", **kw), device="cuda")
        return p, time.time() - t0

    if change:
        # config 1 and 2's bf16 point: the 12 GiB square, not cached
        cached = spmm.CACHED_DEVICES
        spmm.CACHED_DEVICES = ()
        p, secs = prepare(hybrid_shape="square", hybrid_dtype="bfloat16",
                          hybrid_core_bytes=12 << 30)
        spmm.CACHED_DEVICES = cached
        ms, split = time_core(p, x, check=False, iters=10)
        forced = [(s, time_core(p, x, s, check=False, iters=10)[0])
                  for s in (0, 1, 1, 0)]
        rep = DataReporter()
        run_inference_benchmark(ds, model="gcn", num_layers=2, hidden=H,
                                agg_dtype=None, config=p.config, repeat=10,
                                reporter=rep, prepare_fn=lambda g, c: p,
                                validate=True)
        out["bf16 square 12 GiB"] = dict(
            stair=p.stair, prepare_s=secs, core_ms=ms, split=split,
            forced_ms=forced,
            library_ms=library_bf16(p, x),
            spmm_ms=device_time(p.mul, x, iters=5) * 1e3,
            infer_ms=rep.records["infer_time(ms)"][-1],
            validate=rep.records["validate"][-1],
            agg_max_rel_err=[rep.records[f"agg{i}_max_rel_err"][-1]
                             for i in (0, 1)])
        del p
        torch.cuda.empty_cache()
    p, secs = prepare(hybrid_shape="stair", hybrid_dtype="bfloat16",
                      hybrid_core_bytes=8 << 30)
    ms, split = time_core(p, x, check=False, iters=10)
    out["bf16 stair 8 GiB"] = dict(
        stair=p.stair, prepare_s=secs, core_ms=ms, split=split,
        forced_ms=([(s, time_core(p, x, s, check=False, iters=10)[0])
                    for s in (0, 1, 1, 0)] if change else None),
        spmm_ms=device_time(p.mul, x, iters=5) * 1e3,
        verify=_verify_against_oracle(ds.graph, p, x, rng, rtol=1e-2))
    del p
    torch.cuda.empty_cache()
    # the reference's default hybrid: SpmmConfig(backend="hybrid") on a
    # float graph, an f32 square at 4 GiB
    p, secs = prepare(hybrid_core_bytes=4 << 30, hybrid_shape="square",
                      hybrid_dtype=None)
    xc = gathered(x, p, torch.float32)
    out["f32 square 4 GiB"] = dict(
        stair=p.stair, prepare_s=secs,
        core_ms=time_f32(p, xc, check=False, iters=5),
        spmm_ms=device_time(p.mul, x, iters=5) * 1e3,
        verify=_verify_against_oracle(ds.graph, p, x, rng, rtol=1e-4))
    if change:
        out["f32 square 4 GiB"]["library_ms"] = library_f32(p, xc)
        # a 41-class GCN's second aggregate on the same core: odd H
        x41 = gathered(x[:, :41].contiguous(), p, torch.float32)
        out["f32 square 4 GiB"]["h41"] = dict(
            ms=time_f32(p, x41, check=False, iters=5),
            library_ms=library_f32(p, x41))
    return out


def clocks_turn() -> dict:
    """K-core bf16 on the smoke bf16 square at split 1 (90 blocks) and at
    stream-K (132), each launched back to back for about 3 s while
    ``nvidia-smi`` samples the SM clock and the power draw: ms a call and
    the samples' medians."""
    import threading

    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import core_dot
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    ds = load_dataset(SMOKE)
    prep = prepare_spmm(ds.graph, SpmmConfig(
        backend="hybrid", hybrid_core_bytes=SMOKE_BYTES,
        **SMOKE_CORES["bf16 square"]), device="cuda")
    x = torch.randn(ds.graph.nrows, H,
                    generator=torch.Generator().manual_seed(0)).cuda()
    bands, cn = bands_of(prep), prep.dev_arrays["core_nodes"]
    xc = gathered(x, prep, torch.bfloat16)
    z = torch.zeros_like(x)
    out = {}
    for split in (1, core_dot.STREAM, 1, core_dot.STREAM):
        plans = core_dot.core_plans(bands, prep.stair, H, split=split)
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                r = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=30)
                samples.append([float(v) for v in r.stdout.split(",")])
                time.sleep(0.1)

        th = threading.Thread(target=sample)
        th.start()
        n = max(1, int(3.0 / (cuda_ms(lambda: core_dot.core_bands_scatter_add(
            bands, xc, cn, prep.stair, z, plans=plans)) * 1e-3)))
        ms = cuda_ms(lambda: core_dot.core_bands_scatter_add(
            bands, xc, cn, prep.stair, z, plans=plans), iters=n)
        stop.set()
        th.join()
        out.setdefault(f"split {split}", []).append(dict(
            ms=ms, calls=n, grid=plans[0].grid,
            sm_mhz=statistics.median(s[0] for s in samples),
            power_w=statistics.median(s[1] for s in samples)))
    return out


def child(tree: str, change: bool, full: bool, clocks: bool = False) -> None:
    sys.path.insert(0, tree)
    import pygim_tpu_torch
    import torch

    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.utils.device import card_line

    where = Path(pygim_tpu_torch.__file__).resolve()
    if not str(where).startswith(str(Path(tree).resolve())):
        raise RuntimeError(f"imported {where}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    built = time.perf_counter() - t0
    if change:  # the compiler's report of each kernel (-Xptxas -v)
        for name in ("core_dot", "core_f32"):
            log = _build.BUILD_DIR / f"{name}.log"
            kernel = ""
            for line in log.read_text().splitlines() if log.exists() else ():
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1][:60]
                elif any(k in line for k in ("registers", "spill",
                                             "serialized")):
                    print(f"ptxas {name} {kernel}: {line.strip()}",
                          file=sys.stderr)
    if clocks:
        res = {"clocks": clocks_turn()}
    else:
        res = full_turn(change) if full else smoke_turn(change)
    print(json.dumps({"tree": tree, "change": change, "card": card_line(),
                      "build_s": built, **res}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--child")
    ap.add_argument("--change", action="store_true")
    ap.add_argument("--clocks", action="store_true")
    a = ap.parse_args()
    if a.child:
        child(a.child, a.change, a.full)
        return 0
    if a.clocks:  # the change alone, in this process
        child(str(HERE), True, False, clocks=True)
        return 0
    env = dict(os.environ)
    env.setdefault("PYGIM_TPU_TORCH_DATA", tempfile.mkdtemp(prefix="ab_"))
    order = ((True, False) if a.full
             else (False, True, True, False))
    runs = []
    for change in order:
        tree = str(HERE) if change else str(Path(a.parent).resolve())
        cmd = [sys.executable, __file__, "--parent", a.parent, "--child",
               tree, *(["--change"] if change else []),
               *(["--full"] if a.full else [])]
        t0 = time.time()
        res = subprocess.run(cmd, env=env, capture_output=True, text=True)
        print(f"turn {'change' if change else 'parent'}: exit "
              f"{res.returncode} in {time.time() - t0:.1f} s", flush=True)
        if res.returncode:
            print(res.stdout[-4000:], res.stderr[-8000:], flush=True)
            continue
        for line in res.stderr.splitlines():
            if "ptxas" in line or "spill" in line:
                print(line)
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    if not a.full and runs:
        table = {}
        for r in runs:
            for k, v in r["ms"].items():
                table.setdefault(k, {}).setdefault(
                    "change" if r["change"] else "parent", []).append(v)
        for k, v in table.items():
            med = {t: statistics.median(ms) for t, ms in v.items()}
            ratio = (med["change"] / med["parent"]
                     if len(med) == 2 else None)
            print(json.dumps({"kernel": k, **v, "median": med,
                              "change_over_parent": ratio}))
    return 0 if len(runs) == len(order) else 1


if __name__ == "__main__":
    sys.exit(main())
