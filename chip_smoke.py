#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``pygim_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``pygim_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main path's shapes and at
ragged shapes, and times both beside a PyTorch library call and the
card's bound: K-core on the widest band, on all bands in one launch and
on a 32768 × 65536 scale band drawn on the card; K-int (equal to its
plain version, ``torch.equal``) on ragged shapes, ragged cluster cases,
an int32 wraparound case, the smoke bands at one to four limbs and the
scale band at one, three and four; K-tail over the smoke configuration's
ELL tables in one launch and over the whole of a reddit-sized R-MAT
graph's tables (the scale-tables phase); K-tail-quant on integer rows
(int8, int16, int32) and rounded rows, ragged, unaligned and on
half-step ties, over the smoke and the scale tables, and an
identity-table sweep of its rounding (every value within 4 ulps of each
half step, and 2^24 random ones, held equal to ``torch.round(v /
safe)`` for seven divisors, two of them the int32 forward's own). The
int4 modes of K-core and K-int (nibble-packed bands): ragged packed
bands with every nibble value, at one to four limbs; the square int4
core of the smoke graph, whose tiles split their contraction across a
cluster (K-int) or across stream-K spans (K-core; the split and its
schedule balance checked, and two K-core
launches held bit-identical); and a 32768 × 65536-cell int4 scale band
(1 GiB packed, whole contractions) on sampled rows. Both kernels again
on ragged shapes, int8 and int4 bands: K-int with every tile split in 2
and 4 chunks, forced, at one to four limbs, and K-core on each of its two
schedules, whole tiles and stream-K, forced. It checks
``prep.mul`` against ``mul_plain`` at widths the kernels' tiles do not
divide, then drives the three main paths, each with the launch counts
set to 0 before it and read after it — 2-layer GCN inference at hidden
256, on the ogbn-arxiv stand-in, through ``run_inference_benchmark`` and
``run_spmm_benchmark`` — on the stair-int8 hybrid first with a float
payload (K-core, K-tail), then with int32 aggregation and an int32 SpMM
(K-int, K-tail-quant), then tracked config 4's model, the int8 GCN, on a
square int4 core with per-layer sampled validation (K-int int4,
K-tail-quant) and a float32 SpMM on it (K-core int4). It runs the SpMM
on the runners' default configuration (the blocked backend), holds the
forwards' logits against the same forwards through the plain versions,
and runs the flagship forward step, ``pygim_tpu_torch/entry.py:entry()``,
on the card against the same step on the CPU.

Then the paths of the entry scripts, on the same stand-in: the ``ell``
backend (``mul`` on f32 and int32 rows and the fused int32
``mul_quantized`` against their plain versions, one K-tail launch per
SpMM, counted), the ``oracle`` backend (against the hybrid's plain
product, and an int32 GCN forward through its unfused quantize round
trip against the same forward on the hybrid), ``phase_times`` of the
hybrid and ell operands, the prepare cache (built, then loaded: equal
tables and products), and the entry scripts themselves, each in a
process of its own with a deadline: ``bench_cuda.py`` (its JSON line,
its sampled-row check, and K-core and K-tail launched in its timed
calls), ``spmm_test_cuda.py`` at its defaults and with ``--version
cpu``, and ``inference_cuda.py``. Every phase runs in a fresh prepare
and dataset cache (a temporary ``PYGIM_TPU_TORCH_DATA``, removed at the
end), never the user's.

Then this slice's cores, on the same stand-in at the same budget: the
bf16 square (k 11,520) and stair cores and the reference's default
hybrid core, the graph's own dtype (an f32 square, k 8,192). K-core's
bf16 mode (its stream-K schedule forced on ragged bands and a ragged
stair, two launches bit-identical, and chosen by the host model on both
smoke cores), K-f32 on both of its routes on the tensor cores (3xTF32
on f32 cells, payload limbs on bf16 cells; at any H, odd H included)
and K-tail's bf16-row mode are held against their plain versions at
ragged shapes and at these cores, and timed; K-f32's limbs are swept on
integer bf16 × int16 and int32 sums up to and across 2^24, dense and
sparse bands (short sums of large payloads, which reach every limb),
bit-equal to the f32 dot below. Then their main paths run, each counted: GCN forwards
(float on all three, int32 and int8 on the bf16 square) and SpMMs
(float32, a float32 SpMM at H 41 on the f32 square, a bfloat16 payload
on the bf16 square and on the stair int8 core, int64 on the bf16
square), the forwards' logits and the float SpMMs against the plain
versions. The entry scripts also run a bf16 square candidate of
``bench_cuda.py``, ``spmm_test_cuda.py --data_type bfloat16`` and
``inference_cuda.py --data_type int64``.

Then the training path: the smoke operand's transpose is prepared,
and ``torch.autograd.grad`` of ``(A @ x) · w`` through the kernels
(``SpmmFunction``: K-core and K-tail on Aᵀ, their launches counted
inside the backward, every plain version made to raise there) is held
against ``Aᵀ @ w`` through the plain versions and against the raw
edges' exact transpose; GCN, GIN and SAGE at hidden 256 train through
the kernels and through the plain versions (autograd through
``mul_plain`` on A), each twice, and through two negative controls (the
graph cut at each aggregate; a backward on A instead of Aᵀ): every
parameter's gradient of one step, the losses of 3 Adam steps, the
trained model's activations, and a step split into forward, backward and
Adam; ``train_cuda.py`` runs in a process of its own, and
``run_training_benchmark`` trains each conv on ``ell`` and the stair
int8 hybrid against the oracle on a learnable planted graph. On the bf16
and f32 square cores one GCN step's gradients are held to the plain
versions' (both negative controls must fail), ``train_cuda.py --backend
hybrid`` trains 10 epochs on its default f32 core, and
``run_training_benchmark`` trains the GCN on the bf16 square.

Its last three lines are the ``kernels`` JSON object (each kernel with
its split and schedule balance where it has a tile schedule, and K-core
and K-tail with their launches in one training step), the card's
name and power limit (``nvidia-smi``), and ``{"ok": true, "device":
...}``.
Any failure raises and exits non-zero before those lines. Without a
CUDA card, or without the package beside it, it exits non-zero.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of
one inference forward of each path and of one GCN training step by
kernel, and the device's busy share. ``python3 chip_smoke.py
--train-sweep`` runs only the readings the training checks' bars were
set from (``train_sweep``), and checks nothing.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

DATASET = "ogbn-arxiv"
HIDDEN = 256
CORE_BYTES = 256 << 20

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


def check_close(name, got, want, mag, rel):
    """|got - want| <= rel * mag elementwise (mag: the sum of absolute
    terms behind each element), and everything finite."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > rel * mag + 1e-30
    if bad.any():
        i = int(torch.argmax((err - rel * mag).flatten()))
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off; worst abs err "
            f"{float(err.flatten()[i])} vs allowed "
            f"{float((rel * mag).flatten()[i])}"
        )
    return float(err.max())


# Kernel vs plain: every int8 x bf16 product is exact, and both sides sum
# in f32 in different orders (tensor-core k16 groups and a tiled loop vs
# cuBLAS f32; per-run sums and atomics vs index_add_). A sum of K terms in
# f32 errs by at most ~K * 2^-24 of the sum of |terms| in the worst case
# and ~2^-24 * sqrt(K) typically; 1e-5 of the sum of |terms| covers the
# typical case with a wide margin at K <= 10^4 and still catches a wrong
# index or a lost tile, which err by O(1) of it.
REL_TOL = 1e-5


SCALE_BAND = (32768, 65536)  # int8 rows × width: 2 GiB, the 8 GiB core's class


def core_checks(prep, x, results, scale_band=SCALE_BAND):
    import torch

    from pygim_tpu_torch.ops import core_dot
    from pygim_tpu_torch.utils.device import core_bound

    dev = x.device
    h = x.shape[1]
    g = torch.Generator(device="cpu").manual_seed(1)
    # ragged shapes inside the kernel's contract: rows not a multiple of
    # 64, widths multiples of 16 but not of the 64-deep stage, w > r, H
    # not a multiple of the 256-column tile, and H > 256
    for r, w, hh in ((37, 208, 24), (300, 1280, 256), (129, 4112, 136),
                     (1936, 2048, 40), (500, 768, 384)):
        band = torch.randint(-128, 128, (r, w), generator=g,
                             dtype=torch.int8).to(dev)
        xc = torch.randn(w + 5, hh, generator=g).to(dev, torch.bfloat16)
        rows = torch.randperm(3 * r, generator=g)[:r].to(dev, torch.int32)
        out0 = torch.randn(3 * r, hh, generator=g).to(dev)
        got = core_dot.core_band_scatter_add(band, xc, rows, out0.clone())
        want = core_dot.core_band_plain(band, xc, rows, out0.clone())
        mag = out0.abs().index_add(
            0, rows, band.float().abs() @ xc[:w].float().abs())
        check_close(f"K-core ragged {(r, w, hh)}", got, want, mag, REL_TOL)
    # every band of the prepared operand alone, then all in one launch
    d = prep.dev_arrays
    cn = d["core_nodes"]
    xc = x.index_select(0, cn).to(torch.bfloat16)
    bands = [d[f"stair{b}"] for b in range(len(prep.stair))]
    err = 0.0
    for b, (lo, hi, w) in enumerate(prep.stair):
        band = bands[b]
        z = torch.zeros_like(x)
        got = core_dot.core_band_scatter_add(band, xc, cn[lo:hi], z.clone())
        want = core_dot.core_band_plain(band, xc, cn[lo:hi], z.clone())
        mag = z.index_add(0, cn[lo:hi],
                          band.float().abs() @ xc[:w].float().abs())
        err = max(err, check_close(f"K-core band {b} {(hi - lo, w)}",
                                   got, want, mag, REL_TOL))
        del got, want, mag
    z = torch.zeros_like(x)
    got = core_dot.core_bands_scatter_add(bands, xc, cn, prep.stair, z.clone())
    want = core_dot.core_bands_plain(bands, xc, cn, prep.stair, z.clone())
    mag = core_dot.core_bands_plain([t.abs() for t in bands], xc.abs(), cn,
                                    prep.stair, z.clone())
    err = max(err, check_close("K-core all bands, one launch", got, want,
                               mag, REL_TOL))
    del got, want, mag

    # the widest band alone (the per-band yardstick)
    b = max(range(len(prep.stair)),
            key=lambda i: (prep.stair[i][1] - prep.stair[i][0]) * prep.stair[i][2])
    lo, hi, w = prep.stair[b]
    band, rows = bands[b], cn[lo:hi]
    r = hi - lo
    one = ([band], xc, rows, [(0, r, w)], z)
    plans = core_dot.core_plans([band], [(0, r, w)], h)
    ms = cuda_ms(lambda: core_dot.core_bands_scatter_add(*one, plans=plans))
    plain_ms = cuda_ms(lambda: core_dot.core_band_plain(band, xc, rows, z),
                       iters=5)
    band16 = band.to(torch.bfloat16)
    xw = xc[:w].contiguous()
    library_ms = cuda_ms(lambda: torch.matmul(band16, xw))
    del band16, xw
    bound_ms, bound_by = core_bound([(r, w)], h, results["peaks"])
    results["K-core widest band"] = dict(
        shape=[r, w, h], ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, tflops=2 * r * w * h / ms * 1e-9,
    )

    # all bands of one SpMM in one launch: K-core's time per SpMM
    shapes = [(hi - lo, w) for lo, hi, w in prep.stair]
    plans = core_dot.core_plans(bands, prep.stair, h)
    ms = cuda_ms(lambda: core_dot.core_bands_scatter_add(
        bands, xc, cn, prep.stair, z, plans=plans))
    plain_ms = cuda_ms(lambda: core_dot.core_bands_plain(
        bands, xc, cn, prep.stair, z), iters=5)
    bands16 = [t.to(torch.bfloat16) for t in bands]
    xws = [xc[:w].contiguous() for _r, w in shapes]

    def library():
        for a, bb in zip(bands16, xws):
            torch.matmul(a, bb)

    library_ms = cuda_ms(library)
    del bands16, xws, z
    bound_ms, bound_by = core_bound(shapes, h, results["peaks"])
    ops = sum(2 * r * w * h for r, w in shapes)
    results["K-core"] = dict(
        bands=len(shapes), max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=ops / ms * 1e-9, split=[p.split for p in plans],
        schedule_balance=core_dot.schedule_balance(
            prep.stair, h, core_dot.max_clusters(dev, False)),
    )
    torch.cuda.empty_cache()

    # a scale band: the shape class of the 8 GiB staircase core, drawn on
    # the card; checked against the plain version on sampled rows
    r, w = scale_band
    gc = torch.Generator(device=dev).manual_seed(4)
    band = torch.randint(-128, 128, (r, w), generator=gc, dtype=torch.int8,
                         device=dev)
    xb = torch.randn(w, h, generator=gc, device=dev).to(torch.bfloat16)
    rows = torch.randperm(r, generator=gc, device=dev).to(torch.int32)
    out = torch.zeros(r, h, device=dev)
    core_dot.core_band_scatter_add(band, xb, rows, out)
    sel = torch.randperm(r, generator=gc, device=dev)[:256]
    want = band[sel].float() @ xb.float()
    mag = band[sel].float().abs() @ xb.float().abs()
    serr = check_close(f"K-core scale band {scale_band} (256 sampled rows)",
                       out[rows[sel].long()], want, mag, REL_TOL)
    one = ([band], xb, rows, [(0, r, w)], out)
    plans = core_dot.core_plans([band], [(0, r, w)], h)
    ms = cuda_ms(lambda: core_dot.core_bands_scatter_add(*one, plans=plans),
                 iters=10)
    band16 = band.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(band16, xb), iters=10)
    del band16, band, out, one, plans
    torch.cuda.empty_cache()
    bound_ms, bound_by = core_bound([(r, w)], h, results["peaks"])
    results["K-core scale band"] = dict(
        shape=[r, w, h], max_abs_err=serr, ms=ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        tflops=2 * r * w * h / ms * 1e-9,
    )


# The payload range of each K-int limb count: int8 (raw), the int16
# quantized range |q| <= 2^9, the int32 quantized range |q| <= 2^19, and
# any int32 (raw)
INT_RANGES = {1: ("int8", 1 << 7), 2: ("int16", 1 << 9),
              3: ("int32", 1 << 19), 4: ("int32", 1 << 31)}


def int_payload(rows, h, limbs, gen, dev):
    """Integers of K-int's ``limbs`` range, of its dtype, drawn on the CPU."""
    import torch

    dtype, m = INT_RANGES[limbs]
    q = torch.randint(-m, m, (rows, h), generator=gen, dtype=torch.int64)
    return q.to(getattr(torch, dtype)).to(dev)


def int_equal(name, got, want):
    """K-int against its plain version: every product is exact, and both
    add each f32-converted sum once into out, so the two are equal;
    returns the max abs difference (0 when they are)."""
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        bad = (got != want).sum()
        raise AssertionError(f"{name}: {int(bad)} elements differ, max abs "
                             f"diff {err}")
    return err


def int_stair(shapes, gen, dev):
    """Random int8 bands of ``shapes`` ``(r, w)`` stacked into one stair,
    with distinct output rows spread over three times as many."""
    import torch

    stair, lo = [], 0
    for r, w in shapes:
        stair.append((lo, lo + r, w))
        lo += r
    bands = [torch.randint(-128, 128, (r, w), generator=gen,
                           dtype=torch.int8).to(dev) for r, w in shapes]
    rows = torch.randperm(3 * lo, generator=gen)[:lo].to(dev, torch.int32)
    return bands, stair, rows


def int_cluster_checks(gen, dev):
    """K-int's clusters on ragged work, against the plain version
    (``torch.equal``): one band of an odd count of 128-row tiles and eight
    ragged bands in one launch, at H 41, 100 and 256, three limbs (single
    blocks) and four (clusters of two row tiles, so an odd row-tile count
    leaves a partner with no rows)."""
    import torch

    from pygim_tpu_torch.ops import core_int

    cases = {"one band, 3 row tiles": [(293, 1296)],
             "eight bands": [(421, 208), (37, 64), (155 * 128 - 40, 96),
                             (15 * 128, 512), (8, 16), (177 * 128 - 1, 256),
                             (129, 4112), (640, 768)]}
    n = 0
    for name, shapes in cases.items():
        bands, stair, rows = int_stair(shapes, gen, dev)
        w_max = max(w for _r, w in shapes)
        for hh in (41, 100, 256):
            for limbs in (3, 4):
                xc = int_payload(w_max, hh, limbs, gen, dev)
                z = torch.zeros(rows.numel() * 3, hh, device=dev)
                want = core_int.core_int_plain(bands, xc, rows, stair,
                                               z.clone())
                got = core_int.core_int_scatter_add(bands, xc, rows, stair,
                                                    z.clone(), limbs)
                int_equal(f"K-int {name} H={hh} L={limbs}", got, want)
                n += 1
    return n


def int_checks(prep, x, results, scale_band=SCALE_BAND):
    """K-int against its plain version (``torch.equal``) on ragged shapes,
    ragged cluster cases, an int32 wraparound case and the smoke bands at
    every limb count, and on the scale band at one, three and four limbs;
    times each on the smoke bands beside the bound, the plain version and,
    at one limb, ``torch._int_mm``."""
    import torch

    from pygim_tpu_torch.ops import core_int
    from pygim_tpu_torch.utils.device import int_bound

    dev = x.device
    h = x.shape[1]
    g = torch.Generator(device="cpu").manual_seed(8)
    # ragged: rows not a multiple of 64, widths not of the 64-deep stage,
    # H not a multiple of the tile (41, 1100) or of 4, and H > 256
    for r, w, hh, limbs in ((37, 208, 41, 1), (300, 1280, 256, 2),
                            (129, 4112, 1100, 3), (500, 768, 64, 4),
                            (200, 512, 41, 3), (64, 96, 1100, 4),
                            (130, 256, 37, 2), (96, 2048, 300, 1)):
        band = torch.randint(-128, 128, (r, w), generator=g,
                             dtype=torch.int8).to(dev)
        xc = int_payload(w + 5, hh, limbs, g, dev)
        rows = torch.randperm(3 * r, generator=g)[:r].to(dev, torch.int32)
        z = torch.zeros(3 * r, hh, device=dev)
        got = core_int.core_int_scatter_add([band], xc, rows, [(0, r, w)],
                                            z.clone(), limbs)
        want = core_int.core_int_plain([band], xc, rows, [(0, r, w)],
                                       z.clone())
        int_equal(f"K-int ragged {(r, w, hh)} L={limbs}", got, want)
    n_cluster = int_cluster_checks(g, dev)
    print(f"K-int ragged cluster cases: {n_cluster} equal", flush=True)
    # int32 wraparound: a dense band of 127s times payloads near the top
    # of each range; every sum overflows int32
    for limbs, q in ((3, (1 << 19) - 3), (4, (1 << 31) - 7)):
        r, w, hh = 96, 4096, 72
        band = torch.full((r, w), 127, dtype=torch.int8, device=dev)
        xc = torch.full((w, hh), q, dtype=torch.int32, device=dev)
        xc[::3] = -q
        rows = torch.arange(r, dtype=torch.int32, device=dev)
        z = torch.zeros(r, hh, device=dev)
        got = core_int.core_int_scatter_add([band], xc, rows, [(0, r, w)],
                                            z.clone(), limbs)
        want = core_int.core_int_plain([band], xc, rows, [(0, r, w)],
                                       z.clone())
        int_equal(f"K-int wraparound L={limbs}", got, want)
        exact = 127 * q * (w - 2 * len(range(0, w, 3)))
        if exact == ((exact + (1 << 31)) % (1 << 32)) - (1 << 31):
            raise AssertionError("wraparound case does not overflow")

    # the smoke bands, every limb count, one launch each
    d = prep.dev_arrays
    cn = d["core_nodes"]
    bands = [d[f"stair{b}"] for b in range(len(prep.stair))]
    shapes = [(hi - lo, w) for lo, hi, w in prep.stair]
    w_max = max(w for _r, w in shapes)
    h_pad, k_pad = -(-h // 64) * 64, -(-w_max // 16) * 16
    z = torch.zeros_like(x)  # the timed calls' output
    per_l = {}
    for limbs in (1, 2, 3, 4):
        xc = int_payload(w_max, h, limbs, g, dev)
        got = core_int.core_int_scatter_add(bands, xc, cn, prep.stair,
                                            torch.zeros_like(x), limbs)
        want = core_int.core_int_plain(bands, xc, cn, prep.stair,
                                       torch.zeros_like(x))
        err = int_equal(f"K-int all bands L={limbs}", got, want)
        del got, want
        plans = core_int.core_int_plans(bands, prep.stair, h, limbs)
        xct = core_int.limb_split(xc, limbs, h_pad, k_pad)
        ms = cuda_ms(lambda: core_int.core_int_launch(
            bands, xct, cn, prep.stair, z, plans))
        split_ms = cuda_ms(lambda: core_int.limb_split(xc, limbs, h_pad,
                                                       k_pad))
        plain_ms = cuda_ms(lambda: core_int.core_int_plain(
            bands, xc, cn, prep.stair, z), iters=3, warmup=1)
        library_ms = None
        if limbs == 1:
            xw = [xc[:w].contiguous() for _r, w in shapes]

            def library():  # _int_mm takes more than 16 rows
                for a, b in zip(bands, xw):
                    if a.shape[0] > 16:
                        torch._int_mm(a, b)

            library_ms = cuda_ms(library)
            del xw
        bound_ms, bound_by = int_bound(shapes, h, limbs, results["peaks"])
        per_l[limbs] = dict(
            max_abs_err=err, ms=ms, split_ms=split_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            tops=limbs * sum(2 * r * w * h for r, w in shapes) / ms * 1e-9,
        )
    # the main path's K-int is the int32 quantized aggregate: three limbs
    counts = core_int.max_clusters(3, dev)
    results["K-int"] = dict(
        per_l[3], limbs=per_l,
        split=[p.split for p in core_int.core_int_plans(bands, prep.stair, h,
                                                        3)],
        schedule_balance=core_int.cluster_balance(prep.stair, h, 3, counts))
    del z
    torch.cuda.empty_cache()

    # the scale band at one, three and four limbs, sampled rows held equal
    r, w = scale_band
    gc = torch.Generator(device=dev).manual_seed(9)
    band = torch.randint(-128, 128, (r, w), generator=gc, dtype=torch.int8,
                         device=dev)
    rows = torch.randperm(r, generator=gc, device=dev).to(torch.int32)
    sel = torch.randperm(r, generator=gc, device=dev)[:256]
    scale = {}
    for limbs in (1, 3, 4):
        xb = int_payload(w, h, limbs, g, dev)
        out = torch.zeros(r, h, device=dev)
        core_int.core_int_scatter_add([band], xb, rows, [(0, r, w)], out,
                                      limbs)
        want = core_int.core_band_int_plain(
            band[sel], xb, torch.arange(256, dtype=torch.int32, device=dev),
            torch.zeros(256, h, device=dev))
        int_equal(f"K-int scale band {scale_band} L={limbs} (256 sampled "
                  "rows)", out[rows[sel].long()], want)
        plans = core_int.core_int_plans([band], [(0, r, w)], h, limbs)
        xct = core_int.limb_split(xb, limbs, h_pad, -(-w // 16) * 16)
        ms = cuda_ms(lambda: core_int.core_int_launch(
            [band], xct, rows, [(0, r, w)], out, plans), iters=10)
        library_ms = None
        if limbs == 1:
            library_ms = cuda_ms(lambda: torch._int_mm(band, xb), iters=10)
        bound_ms, bound_by = int_bound([(r, w)], h, limbs, results["peaks"])
        scale[limbs] = dict(ms=ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, share_of_bound=bound_ms / ms,
                            tops=limbs * 2 * r * w * h / ms * 1e-9)
        del xb, out, xct, plans
    del band
    torch.cuda.empty_cache()
    results["K-int scale band"] = dict(shape=[r, w, h], limbs=scale)


def packed_band(r, w, gen, dev):
    """A random int4 band of r rows and w cells, nibble-packed (uint8 (r,
    w // 2)), drawn on the CPU; its first bytes run through 0..255, so
    every nibble value -8..7 sits in both halves."""
    import torch

    band = torch.randint(0, 256, (r, w // 2), generator=gen,
                         dtype=torch.uint8)
    n = min(256, band.numel())
    band.view(-1)[:n] = torch.arange(n, dtype=torch.uint8)
    return band.to(dev)


def int4_checks(prep4, x, results, scale_band=SCALE_BAND):
    """K-core's and K-int's int4 modes (nibble-packed bands) against their
    plain versions: ragged packed bands (rows not a multiple of the tile,
    widths a multiple of 32 but not of the 64-deep stage, every nibble
    value) at one to four limbs; the square int4 core of the smoke graph
    (``prep4``: the one band (0, k, k)) in both, K-int at one to four
    limbs; and an int4 scale band of ``scale_band`` cells (1 GiB packed)
    on sampled rows. K-int is held with ``torch.equal``, K-core within
    REL_TOL of the sum of |terms|. Times on the square core: K-core (float
    payload) and K-int at one limb (the int8 aggregate of the int8 GCN),
    beside the bound, the plain version and the library call on the band
    widened in memory (bf16 ``torch.matmul``, int8 ``torch._int_mm``)."""
    import torch

    from pygim_tpu_torch.ops import core_dot, core_int
    from pygim_tpu_torch.utils.device import core_bound, int_bound

    dev = x.device
    h = x.shape[1]
    g = torch.Generator(device="cpu").manual_seed(12)
    for r, w, hh in ((37, 224, 24), (300, 1312, 256), (129, 4128, 136),
                     (1936, 2048, 40), (500, 800, 384), (64, 32, 8)):
        band = packed_band(r, w, g, dev)
        xc = torch.randn(w + 5, hh, generator=g).to(dev, torch.bfloat16)
        rows = torch.randperm(3 * r, generator=g)[:r].to(dev, torch.int32)
        out0 = torch.randn(3 * r, hh, generator=g).to(dev)
        got = core_dot.core_band_scatter_add(band, xc, rows, out0.clone())
        want = core_dot.core_band_plain(band, xc, rows, out0.clone())
        mag = out0.abs().index_add(
            0, rows, core_dot.band_cells(band).float().abs()
            @ xc[:w].float().abs())
        check_close(f"K-core int4 ragged {(r, w, hh)}", got, want, mag,
                    REL_TOL)
    for limbs in (1, 2, 3, 4):
        for r, w, hh in ((37, 224, 41), (300, 1312, 256), (129, 4128, 100),
                         (500, 800, 64), (290, 96, 1100)):
            band = packed_band(r, w, g, dev)
            xc = int_payload(w + 5, hh, limbs, g, dev)
            rows = torch.randperm(3 * r, generator=g)[:r].to(dev, torch.int32)
            z = torch.zeros(3 * r, hh, device=dev)
            got = core_int.core_int_scatter_add([band], xc, rows, [(0, r, w)],
                                                z.clone(), limbs)
            want = core_int.core_int_plain([band], xc, rows, [(0, r, w)],
                                           z.clone())
            int_equal(f"K-int int4 ragged {(r, w, hh)} L={limbs}", got, want)

    # a packed band that breaks the int4 width rule (w % 32) raises on
    # the card in both wrappers: no fallback to the plain version (CPU
    # tensors, in a rehearsal, take the plain version by design)
    band = packed_band(64, 48, g, dev)
    rows = torch.arange(64, dtype=torch.int32, device=dev)
    for name, call in (
            ("K-core", lambda: core_dot.core_band_scatter_add(
                band, torch.zeros(48, 8, dtype=torch.bfloat16, device=dev),
                rows, torch.zeros(64, 8, device=dev))),
            ("K-int", lambda: core_int.core_int_scatter_add(
                [band], torch.zeros(48, 8, dtype=torch.int8, device=dev),
                rows, [(0, 64, 48)], torch.zeros(64, 8, device=dev), 1))):
        if dev.type != "cuda":
            break
        try:
            call()
        except ValueError as e:
            print(f"{name} int4, width 48: raises ({e})", flush=True)
        else:
            raise AssertionError(f"{name} took a packed band of width 48")

    # the square int4 core of the smoke graph: one band (0, k, k)
    d = prep4.dev_arrays
    cn = d["core_nodes"]
    band = d["core"]
    (lo, r, w), = [(lo, hi - lo, w) for lo, hi, w in prep4.stair]
    stair, rows = [(0, r, w)], cn[:r]
    xc = x.index_select(0, cn[:w]).to(torch.bfloat16)
    z = torch.zeros_like(x)
    got = core_dot.core_bands_scatter_add([band], xc, rows, stair, z.clone())
    want = core_dot.core_bands_plain([band], xc, rows, stair, z.clone())
    cells = core_dot.band_cells(band)
    mag = z.index_add(0, rows, cells.float().abs() @ xc.float().abs())
    err = check_close(f"K-core int4 square core {(r, w)}", got, want, mag,
                      REL_TOL)
    del got, want, mag
    plans = core_dot.core_plans([band], stair, h)
    # a split tile is reduced in a fixed order: two launches, equal bits
    again = core_dot.core_bands_scatter_add([band], xc, rows, stair,
                                            z.clone(), plans=plans)
    if not torch.equal(again, core_dot.core_bands_scatter_add(
            [band], xc, rows, stair, z.clone(), plans=plans)):
        raise AssertionError("K-core int4 square core: two launches differ")
    del again
    print(f"K-core int4 square core, split {[p.split for p in plans]}: two "
          "launches bit-identical; clusters the card runs a split: K-core "
          f"{core_dot.max_clusters(dev, True)}, K-int one limb "
          f"{core_int.max_clusters(1, dev, packed=True)}", flush=True)
    ms = cuda_ms(lambda: core_dot.core_bands_scatter_add(
        [band], xc, rows, stair, z, plans=plans))
    plain_ms = cuda_ms(lambda: core_dot.core_bands_plain(
        [band], xc, rows, stair, z), iters=3, warmup=1)
    wide = cells.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(wide, xc))
    del wide
    bound_ms, bound_by = core_bound([(r, w)], h, results["peaks"], 0.5)
    results["K-core int4"] = dict(
        shape=[r, w, h], max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=2 * r * w * h / ms * 1e-9, split=[p.split for p in plans],
        schedule_balance=core_dot.schedule_balance(
            stair, h, core_dot.max_clusters(dev, True)))
    h_pad, k_pad = -(-h // 64) * 64, -(-w // 16) * 16
    per_l = {}
    for limbs in (1, 2, 3, 4):
        xq = int_payload(w, h, limbs, g, dev)
        got = core_int.core_int_scatter_add([band], xq, rows, stair,
                                            torch.zeros_like(x), limbs)
        want = core_int.core_int_plain([band], xq, rows, stair,
                                       torch.zeros_like(x))
        err = int_equal(f"K-int int4 square core L={limbs}", got, want)
        del got, want
        plans = core_int.core_int_plans([band], stair, h, limbs)
        xct = core_int.limb_split(xq, limbs, h_pad, k_pad)
        per_l[limbs] = dict(max_abs_err=err, ms=cuda_ms(
            lambda: core_int.core_int_launch([band], xct, rows, stair, z,
                                             plans)),
            split=[p.split for p in plans])
        if limbs == 1:
            per_l[1]["plain_ms"] = cuda_ms(lambda: core_int.core_int_plain(
                [band], xq, rows, stair, z), iters=3, warmup=1)
            per_l[1]["library_ms"] = cuda_ms(lambda: torch._int_mm(cells, xq))
        per_l[limbs]["bound_ms"], per_l[limbs]["bound_by"] = int_bound(
            [(r, w)], h, limbs, results["peaks"], 0.5)
        per_l[limbs]["tops"] = limbs * 2 * r * w * h / per_l[limbs]["ms"] \
            * 1e-9
        del xct, plans
    # config 4's aggregate is int8: one limb
    results["K-int int4"] = dict(
        per_l[1], shape=[r, w, h], limbs=per_l,
        schedule_balance=core_int.cluster_balance(
            stair, h, 1, core_int.max_clusters(1, dev, packed=True)))
    for k in ("K-core int4", "K-int int4"):
        if results[k]["split"] == [1] or results[k]["schedule_balance"] > 1.15:
            raise AssertionError(
                f"{k} on the square core: split {results[k]['split']}, "
                f"balance {results[k]['schedule_balance']} (want a split, "
                "or stream-K's split 0, and at most 1.15)")
    del cells, z, xc
    torch.cuda.empty_cache()

    # an int4 scale band, sampled rows
    r, w = scale_band
    gc = torch.Generator(device=dev).manual_seed(13)
    band = torch.randint(0, 256, (r, w // 2), generator=gc, dtype=torch.uint8,
                         device=dev)
    rows = torch.randperm(r, generator=gc, device=dev).to(torch.int32)
    sel = torch.randperm(r, generator=gc, device=dev)[:256]
    stair = [(0, r, w)]
    xb = torch.randn(w, h, generator=gc, device=dev).to(torch.bfloat16)
    out = torch.zeros(r, h, device=dev)
    core_dot.core_bands_scatter_add([band], xb, rows, stair, out)
    cells = core_dot.band_cells(band[sel])
    serr = check_close(f"K-core int4 scale band {scale_band} (256 sampled "
                       "rows)", out[rows[sel].long()],
                       cells.float() @ xb.float(),
                       cells.float().abs() @ xb.float().abs(), REL_TOL)
    plans = core_dot.core_plans([band], stair, h)
    if [p.split for p in plans] != [1]:
        raise AssertionError(f"the int4 scale band split its contraction: "
                             f"{[p.split for p in plans]}")
    scale = {"K-core": dict(
        max_abs_err=serr, ms=cuda_ms(lambda: core_dot.core_bands_scatter_add(
            [band], xb, rows, stair, out, plans=plans), iters=10),
        bound=core_bound([(r, w)], h, results["peaks"], 0.5))}
    scale["K-core"]["tflops"] = 2 * r * w * h / scale["K-core"]["ms"] * 1e-9
    del xb, plans
    for limbs in (1, 3, 4):
        xq = int_payload(w, h, limbs, g, dev)
        want = core_int.core_band_int_plain(
            band[sel], xq, torch.arange(256, dtype=torch.int32, device=dev),
            torch.zeros(256, h, device=dev))
        out.zero_()
        core_int.core_int_scatter_add([band], xq, rows, stair, out, limbs)
        int_equal(f"K-int int4 scale band {scale_band} L={limbs} (256 "
                  "sampled rows)", out[rows[sel].long()], want)
        plans = core_int.core_int_plans([band], stair, h, limbs)
        if [p.split for p in plans] != [1]:
            raise AssertionError(f"the int4 scale band split its "
                                 f"contraction at {limbs} limbs")
        xct = core_int.limb_split(xq, limbs, h_pad, -(-w // 16) * 16)
        ms = cuda_ms(lambda: core_int.core_int_launch(
            [band], xct, rows, stair, out, plans), iters=10)
        scale[f"K-int L={limbs}"] = dict(
            ms=ms, bound=int_bound([(r, w)], h, limbs, results["peaks"], 0.5),
            tops=limbs * 2 * r * w * h / ms * 1e-9)
        del xq, xct, plans
    del band, out
    torch.cuda.empty_cache()
    results["int4 scale band"] = dict(shape=[r, w, h], **scale)


def split_band(r, w, packed, gen, dev):
    """A random int8 band, or a packed int4 one (every nibble value)."""
    import torch

    if packed:
        return packed_band(r, w, gen, dev)
    return torch.randint(-128, 128, (r, w), generator=gen,
                         dtype=torch.int8).to(dev)


def split_checks(dev, results):
    """K-core on each of its schedules, forced (whole tiles, split 1, and
    stream-K, split 0, each tile cut across spans wherever they end), and
    K-int with every tile's contraction split across the blocks of a
    cluster (forced: ``split`` 2 and 4), int8 and int4 bands, against
    their plain versions: ragged shapes (rows below one 128-row tile and
    not a multiple of it, widths not a multiple of split × 64, so the
    last chunk ends in a ragged stage), K-core at H 8, 136 and 264, K-int
    at one and two limbs at H 8, 136 and 1100 (three and four limbs,
    which never split, on the same shapes whole), shapes of many tiles a
    cluster (the hand-over barriers' phases across tiles), a stair of
    several bands, and an int32 wraparound at two limbs. K-core within
    REL_TOL of the sum of |terms|, K-int ``torch.equal``."""
    import torch

    from pygim_tpu_torch.ops import core_dot, core_int

    g = torch.Generator(device="cpu").manual_seed(21)
    n = 0
    shapes = ((37, 1312, 8), (100, 4128, 136), (300, 800, 264),
              (129, 288, 136), (4000, 1312, 264))
    for packed in (False, True):
        for split in core_dot.SCHEDULES:
            for r, w, hh in shapes:
                band = split_band(r, w, packed, g, dev)
                xc = torch.randn(w + 5, hh, generator=g).to(dev,
                                                           torch.bfloat16)
                rows = torch.randperm(3 * r, generator=g)[:r].to(
                    dev, torch.int32)
                out0 = torch.randn(3 * r, hh, generator=g).to(dev)
                stair = [(0, r, w)]
                plans = core_dot.core_plans([band], stair, hh, split=split)
                got = core_dot.core_bands_scatter_add(
                    [band], xc, rows, stair, out0.clone(), plans=plans)
                want = core_dot.core_band_plain(band, xc, rows, out0.clone())
                mag = out0.abs().index_add(
                    0, rows, core_dot.band_cells(band).float().abs()
                    @ xc[:w].float().abs())
                check_close(f"K-core {'int4' if packed else 'int8'} split "
                            f"{split} {(r, w, hh)}", got, want, mag, REL_TOL)
                n += 1
        for split in (2, 4):  # K-int's cluster splits
            for limbs in (1, 2, 3, 4):
                for r, w, hh in ((37, 1312, 8), (100, 4128, 136),
                                 (300, 800, 1100), (4000, 800, 1100)):
                    band = split_band(r, w, packed, g, dev)
                    xq = int_payload(w + 5, hh, limbs, g, dev)
                    rows = torch.randperm(3 * r, generator=g)[:r].to(
                        dev, torch.int32)
                    z = torch.zeros(3 * r, hh, device=dev)
                    stair = [(0, r, w)]
                    plans = core_int.core_int_plans(
                        [band], stair, hh, limbs,
                        split=split if split in core_int.splits(limbs) else 1)
                    got = core_int.core_int_scatter_add(
                        [band], xq, rows, stair, z.clone(), limbs, plans)
                    want = core_int.core_int_plain([band], xq, rows, stair,
                                                   z.clone())
                    int_equal(f"K-int {'int4' if packed else 'int8'} split "
                              f"{plans[0].split} {(r, w, hh)} L={limbs}", got,
                              want)
                    n += 1
        # several bands in one launch: K-core on each schedule, K-int with
        # each tile split in two
        shp = [(421, 1312), (37, 256), (1300, 2080), (8, 128)]
        bands = [split_band(r, w, packed, g, dev) for r, w in shp]
        stair, lo = [], 0
        for r, w in shp:
            stair.append((lo, lo + r, w))
            lo += r
        rows = torch.randperm(3 * lo, generator=g)[:lo].to(dev, torch.int32)
        xc = torch.randn(2080, 136, generator=g).to(dev, torch.bfloat16)
        z = torch.zeros(3 * lo, 136, device=dev)
        want = core_dot.core_bands_plain(bands, xc, rows, stair, z.clone())
        mag = core_dot.core_bands_plain(
            [core_dot.band_cells(t).abs() for t in bands], xc.abs(), rows,
            stair, z.clone())
        for split in core_dot.SCHEDULES:
            plans = core_dot.core_plans(bands, stair, 136, split=split)
            got = core_dot.core_bands_scatter_add(bands, xc, rows, stair,
                                                  z.clone(), plans=plans)
            check_close(f"K-core {'int4' if packed else 'int8'} split "
                        f"{split}, {len(shp)} bands", got, want, mag, REL_TOL)
            n += 1
        xq = int_payload(2080, 136, 1, g, dev)
        plans = core_int.core_int_plans(bands, stair, 136, 1, split=2)
        got = core_int.core_int_scatter_add(bands, xq, rows, stair,
                                            z.clone(), 1, plans)
        int_equal(f"K-int {'int4' if packed else 'int8'} split 2, "
                  f"{len(shp)} bands", got, core_int.core_int_plain(
                      bands, xq, rows, stair, z.clone()))
        n += 1
    # int32 wraparound in every chunk and in total: two limbs hold payloads
    # up to 32639, and 127 · 32639 · 4096 passes 2^31 many times over
    r, w, hh = 96, 4096, 72
    band = torch.full((r, w), 127, dtype=torch.int8, device=dev)
    xq = torch.full((w, hh), 32639, dtype=torch.int32, device=dev)
    xq[::3] = -32639
    rows = torch.arange(r, dtype=torch.int32, device=dev)
    z = torch.zeros(r, hh, device=dev)
    for split in (2, 4):
        plans = core_int.core_int_plans([band], [(0, r, w)], hh, 2,
                                        split=split)
        int_equal(f"K-int split {split} wraparound L=2",
                  core_int.core_int_scatter_add(
                      [band], xq, rows, [(0, r, w)], z.clone(), 2, plans),
                  core_int.core_int_plain([band], xq, rows, [(0, r, w)],
                                          z.clone()))
        n += 1
    results["split checks"] = n
    torch.cuda.empty_cache()


SCALE_GRAPH = "rmat-232965-8000000"  # reddit's node count, 8M stored edges


def ragged_tables(seed: int = 5):
    """Multi-degree ELL tables (the port's planner, small steps) of a
    graph with ragged rows, a hub row that the K-tail plan cuts across
    units, the last row real right before the pad rows, and zero-valued
    real edges (some in the middle of a virtual row, some at its end)."""
    import numpy as np

    from pygim_tpu_torch.core.graph import CooGraph
    from pygim_tpu_torch.ops.spmm import (
        SpmmConfig,
        _plan_ell_tables,
        ell_step_tables,
    )

    rng = np.random.default_rng(seed)
    n = 700
    deg = rng.zipf(1.7, n).clip(1, 80)
    deg[7] = 1500      # hub row
    deg[n - 1] = 5     # last row, real
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[rng.random(rows.size) < 0.05] = 0.0
    csr = CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n).to_csr()
    tabs = _plan_ell_tables(csr, SpmmConfig(block_nnz_budget=2048))
    return n, [(*ell_step_tables(t.cols, t.vals, t.vrow_to_row, chunk),
                t.degree) for chunk, t in tabs]


def tail_to(tables, dev):
    import torch

    return [(*(torch.from_numpy(a).to(dev) for a in (c, v, r)), d)
            for c, v, r, d in tables]


def tail_close(name, x, tables, got, out0, safe=None):
    """``got`` (tables added into ``out0``) against the plain version, in
    x's payload mode (``safe``: rounded to ``round(x / safe)``)."""
    import torch

    from pygim_tpu_torch.ops import ell_tail

    want = ell_tail.ell_tables_plain(x, tables, out0.clone(), safe)
    q = x.float() if safe is None else torch.round(x / safe)
    mag = ell_tail.ell_tables_plain(
        q.abs(), [(c, v.abs(), r, d) for c, v, r, d in tables], out0.abs())
    return check_close(name, got, want, mag, REL_TOL)


def tail_bound(tables, h, peaks_, itemsize=4):
    """Least time of one grouped K-tail call (``utils/device.tail_bound``)
    and beside it the per-slot model, where every stored slot reads its x
    row from HBM. Also the library yardstick's matrix: the real entries
    as one CSR (cuSPARSE through torch.sparse.mm)."""
    import torch

    from pygim_tpu_torch.ops.ell_tail import real_entries
    from pygim_tpu_torch.utils.device import tail_bound as bound

    rows_t, cols_t, vals_t = real_entries(tables)
    slots = sum(c.numel() for c, _v, _r, _d in tables)
    vrows = sum(r.numel() for _c, _v, r, _d in tables)
    nnz = int(rows_t.numel())
    u_cols = int(torch.unique(cols_t).numel())
    u_rows = int(torch.unique(rows_t).numel())
    hbm = peaks_[0]
    bound_ms, bound_by = bound(nnz, u_cols, u_rows, h, peaks_, itemsize)
    return dict(
        bound_ms=bound_ms, bound_by=bound_by,
        bound_slot_ms=(slots * (8 + itemsize * h) + vrows * 4 * h) / hbm
        * 1e3,
        nnz=nnz, slots=slots, vrows=vrows, unique_cols=u_cols,
        unique_rows=u_rows,
    ), (rows_t, cols_t, vals_t)


def off_aligned(t):
    """A contiguous copy of ``t`` at a storage offset of one float, so its
    address is not 16-byte aligned."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def tail_checks(prep, x, results):
    import torch

    from pygim_tpu_torch.ops import ell_tail

    dev = x.device
    g = torch.Generator(device="cpu").manual_seed(2)
    # ragged: any H (not a multiple of 4, not of 128, above one slab), a
    # hub row split across units, row N - 1 next to the pad rows, zero
    # weights; all tables in one call, and each table alone. H 41 and the
    # unaligned case take the register path (a), the rest the bulk copy
    n, host = ragged_tables()
    tables = tail_to(host, dev)
    plan = ell_tail.tail_plan(tables)
    if not plan.units[:, 3].any():
        raise AssertionError("ragged tables: no hub run split across units")
    for h in (36, 41, 256, 1100):
        xs = torch.randn(n, h, generator=g).to(dev)
        out0 = torch.randn(n, h, generator=g).to(dev)
        got = ell_tail.ell_tables_add(xs, tables, out0.clone(), plan=plan)
        tail_close(f"K-tail ragged H={h}", xs, tables, got, out0)
        for i, (c, v, r, d) in enumerate(tables):
            got = ell_tail.ell_tail_add(xs, c, v, r, d, out0.clone())
            tail_close(f"K-tail ragged H={h} table {i}", xs, [(c, v, r, d)],
                       got, out0)
    # H % 4 == 0, but x and out off 16-byte alignment
    xs = off_aligned(torch.randn(n, 256, generator=g).to(dev))
    out0 = torch.randn(n, 256, generator=g).to(dev)
    got = ell_tail.ell_tables_add(xs, tables, off_aligned(out0), plan=plan)
    tail_close("K-tail ragged H=256 unaligned", xs, tables, got, out0)

    # the smoke tables, one grouped call
    tables = prep.ell_tables(prep.dev_arrays)
    plan = ell_tail.tail_plan(tables)
    z = torch.zeros_like(x)
    got = ell_tail.ell_tables_add(x, tables, z.clone(), plan=plan)
    err = tail_close("K-tail tables, one launch", x, tables, got, z)
    del got
    ms = cuda_ms(lambda: ell_tail.ell_tables_add(x, tables, z, plan=plan))
    plain_ms = cuda_ms(lambda: ell_tail.ell_tables_plain(x, tables, z),
                       iters=5)
    bound, (rows_t, cols_t, vals_t) = tail_bound(tables, x.shape[1],
                                                 results["peaks"])
    n = x.shape[0]
    a = torch.sparse_coo_tensor(torch.stack([rows_t, cols_t]), vals_t,
                                (n, n)).coalesce().to_sparse_csr()
    library_ms = cuda_ms(lambda: torch.sparse.mm(a, x))
    results["K-tail"] = dict(
        tables=[[int(c.shape[0]), int(c.shape[1]) // dg, dg]
                for c, _v, _r, dg in tables],
        units=plan.n_units, split_units=int(plan.units[:, 3].sum()),
        real_vrows=plan.n_real, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound,
    )


# K-tail-quant's payload modes as the timed phases run them: f32 rows
# rounded in the kernel (the int32 aggregate's tail), and the rows rounded
# beforehand to each integer dtype's grid
PAYLOAD_MODES = ("rounded", "int8", "int16", "int32")


def payload_mode(x, mode):
    """``(xq, kw, rounded)``: K-tail-quant's payload in ``mode`` from f32
    rows ``x``, the keywords of ``ell_tables_add`` for it, and the same
    values rounded, as f32 (the library call's input)."""
    import torch

    from pygim_tpu_torch.quant import quant_scale

    _scale, safe = quant_scale(x, "int32" if mode == "rounded" else mode)
    rounded = torch.round(x / safe)
    if mode == "rounded":
        return x, {"safe": safe}, rounded
    return rounded.to(getattr(torch, mode)), {}, rounded


def tail_quant_checks(prep, x, results):
    """K-tail-quant against its plain version: integer rows (mode (ii))
    and rounded f32 rows (mode (iii)) on the ragged tables at ragged and
    unaligned widths, with half-step ties; then the smoke tables in every
    payload mode (rounded f32 rows, int8, int16 and int32 rows of the
    features rounded to each dtype's grid), timed beside the bound, the
    plain version and torch.sparse.mm on the rounded rows."""
    import torch

    from pygim_tpu_torch.ops import ell_tail
    from pygim_tpu_torch.quant import quant_scale

    dev = x.device
    g = torch.Generator(device="cpu").manual_seed(10)
    n, host = ragged_tables()
    tables = tail_to(host, dev)
    plan = ell_tail.tail_plan(tables)
    # integer rows: the bulk copy where a row is a multiple of 16 bytes
    # (int8 H 48, int16 H 40, int32 H 256), the register path elsewhere
    for dtype, m, h in ((torch.int8, 1 << 7, 48), (torch.int8, 1 << 7, 41),
                        (torch.int16, 1 << 15, 40), (torch.int16, 1 << 15, 36),
                        (torch.int32, 1 << 20, 256), (torch.int32, 1 << 20, 41)):
        xs = torch.randint(-m, m, (n, h), generator=g).to(dtype).to(dev)
        out0 = torch.randn(n, h, generator=g).to(dev)
        got = ell_tail.ell_tables_add(xs, tables, out0.clone(), plan=plan)
        tail_close(f"K-tail-quant ragged {dtype} H={h}", xs, tables, got,
                   out0)
    # rounded f32 rows
    for h in (36, 41, 256, 1100):
        xs = (torch.randn(n, h, generator=g) * 3).to(dev)
        _scale, safe = quant_scale(xs, "int32")
        out0 = torch.randn(n, h, generator=g).to(dev)
        got = ell_tail.ell_tables_add(xs, tables, out0.clone(), plan=plan,
                                      safe=safe)
        tail_close(f"K-tail-quant ragged rounded H={h}", xs, tables, got,
                   out0, safe)
    # H 256 at unaligned x and out: the register path
    xs = off_aligned((torch.randn(n, 256, generator=g) * 3).to(dev))
    _scale, safe = quant_scale(xs, "int32")
    out0 = torch.randn(n, 256, generator=g).to(dev)
    got = ell_tail.ell_tables_add(xs, tables, off_aligned(out0), plan=plan,
                                  safe=safe)
    tail_close("K-tail-quant ragged rounded H=256 unaligned", xs, tables, got,
               out0, safe)
    xs = off_aligned(torch.randint(-128, 128, (n, 256), generator=g,
                                   dtype=torch.int8).to(dev))
    got = ell_tail.ell_tables_add(xs, tables, off_aligned(out0), plan=plan)
    tail_close("K-tail-quant ragged int8 H=256 unaligned", xs, tables, got,
               out0)
    # half-step ties: x / safe = k + 1/2 exactly (safe a power of two),
    # which rounds half to even
    safe = torch.tensor(2.0 ** -10, device=dev)
    k = torch.randint(-6, 6, (n, 256), generator=g).float()
    xs = ((k + 0.5) * 2.0 ** -10).to(dev)
    out0 = torch.zeros(n, 256, device=dev)
    got = ell_tail.ell_tables_add(xs, tables, out0.clone(), plan=plan,
                                  safe=safe)
    tail_close("K-tail-quant half-step ties", xs, tables, got, out0, safe)

    # the smoke tables: rounded f32 rows (the int32 aggregate's tail) and
    # integer rows (the int8 aggregate's table, prep.mul on an int16 or
    # int32 payload), one grouped call each
    tables = prep.ell_tables(prep.dev_arrays)
    plan = ell_tail.tail_plan(tables)
    h = x.shape[1]
    z = torch.zeros_like(x)  # the timed calls' output
    bound, (rows_t, cols_t, vals_t) = tail_bound(tables, h, results["peaks"])
    a = torch.sparse_coo_tensor(torch.stack([rows_t, cols_t]), vals_t,
                                (x.shape[0],) * 2).coalesce().to_sparse_csr()
    res = {}
    for mode in PAYLOAD_MODES:
        xq, kw, rounded = payload_mode(x, mode)
        zero = torch.zeros_like(x)
        got = ell_tail.ell_tables_add(xq, tables, zero.clone(), plan=plan,
                                      **kw)
        err = tail_close(f"K-tail-quant tables, {mode}", xq, tables, got,
                         zero, kw.get("safe"))
        del got
        ms = cuda_ms(lambda: ell_tail.ell_tables_add(xq, tables, z, plan=plan,
                                                     **kw))
        plain_ms = cuda_ms(lambda: ell_tail.ell_tables_plain(
            xq, tables, z, kw.get("safe")), iters=5)
        library_ms = cuda_ms(lambda: torch.sparse.mm(a, rounded))
        b, _csr = tail_bound(tables, h, results["peaks"], xq.element_size())
        res[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=b["bound_ms"],
                         bound_by=b["bound_by"])
        del xq, rounded
    # the main path's K-tail-quant is the int32 aggregate's: rounded rows
    results["K-tail-quant"] = dict(
        res["rounded"], **{f"{m}_rows": res[m] for m in PAYLOAD_MODES[1:]})


def sweep_values(safe, h=256):
    """Every float within 4 ulps of each half step ``(k + 1/2) · safe``,
    |k| <= 2^19 + 1, then 2^24 random floats of every magnitude up to
    2^20 · safe (random bits under its own, random sign), laid out ``h``
    wide and zero-padded; ``safe`` a 0-dim f32 tensor on the card."""
    import torch

    dev = safe.device
    k = torch.arange(-(1 << 19) - 1, (1 << 19) + 2, device=dev,
                     dtype=torch.float64)
    c = ((k + 0.5) * safe.double()).float()  # the half steps, in f32
    ulps = torch.arange(-4, 5, device=dev, dtype=torch.int32)
    near = (c.view(torch.int32)[:, None] + ulps).view(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(13)
    top = int((safe * 2.0 ** 20).view(torch.int32))  # bits of 2^20 · safe
    mag = torch.randint(0, top + 1, (1 << 24,), generator=gen, device=dev,
                        dtype=torch.int32).view(torch.float32)
    sign = torch.randint(0, 2, (1 << 24,), generator=gen, device=dev) * 2 - 1
    v = torch.cat([near.reshape(-1), mag * sign])
    x = torch.zeros(-(-v.numel() // h) * h, device=dev)
    x[:v.numel()] = v
    return x.view(-1, h), v.numel()


def forward_safes(gnn, xf, prep):
    """The ``safe`` that each quantized aggregate of one forward of
    ``gnn`` on ``xf`` rounds with, in layer order."""
    import torch

    from pygim_tpu_torch.ops.spmm import PreparedAggregate
    from pygim_tpu_torch.quant import quant_scale

    safes = []

    class Recording(PreparedAggregate):
        def quantized(self, v, agg_dtype):
            safes.append(float(quant_scale(v, agg_dtype)[1]))
            return super().quantized(v, agg_dtype)

    with torch.inference_mode():
        gnn(xf, Recording(prep))
    return safes


def tail_quant_sweep(x, results, layer_safes):
    """K-tail-quant's rounding alone, element by element: one ELL table of
    one slot a row, weight 1, so the output is the kernel's ``round(v /
    safe)`` of each element of :func:`sweep_values`, held ``torch.equal``
    to ``torch.round(v / safe)`` on the bulk-copy path (aligned) and on
    the register path (x and out off 16-byte alignment). It runs for the
    smoke features' int32 safe, ``layer_safes`` (those of the int32
    forward's aggregates, :func:`forward_safes`), a power of two, an
    all-ones mantissa, 1.0, and a safe below the reciprocal route (the
    kernel's division route); any mismatch fails."""
    import torch

    from pygim_tpu_torch.ops import ell_tail
    from pygim_tpu_torch.quant import quant_scale

    dev = x.device
    safes = {"smoke x": float(quant_scale(x, "int32")[1]),
             **{f"int32 forward, layer {i + 1}": sv
                for i, sv in enumerate(layer_safes)},
             "2^-10": 2.0 ** -10,
             "0x1.fffffep-8": float.fromhex("0x1.fffffep-8"), "1.0": 1.0,
             "0x1.8p-110 (division route)": 1.5 * 2.0 ** -110}
    tables = plan = None
    res = {}
    for name, sv in safes.items():
        safe = torch.tensor(sv, dtype=torch.float32, device=dev)
        xs, n = sweep_values(safe)
        if plan is None:
            ids = torch.arange(xs.shape[0], dtype=torch.int32, device=dev)
            tables = [(ids[None], torch.ones(1, xs.shape[0], device=dev),
                       ids[None], 1)]
            plan = ell_tail.tail_plan(tables)
        want = torch.round(xs / safe)
        bad = 0
        for xi, out in ((xs, torch.zeros_like(xs)),
                        (off_aligned(xs), off_aligned(torch.zeros_like(xs)))):
            got = ell_tail.ell_tables_add(xi, tables, out, plan=plan,
                                          safe=safe)
            bad += int((got != want).sum())
            del got
        print(f"K-tail-quant identity sweep, safe {name} = {sv!r}: {n} "
              f"values x 2 paths, {bad} mismatches", flush=True)
        res[name] = bad
        if bad:
            raise AssertionError(f"K-tail-quant rounding: {bad} mismatches "
                                 f"at safe {name}")
        del xs, want
    del tables, plan
    torch.cuda.empty_cache()
    results["K-tail-quant identity sweep"] = res


def tail_scale(results, dev, h=256):
    """K-tail on the whole of a reddit-sized R-MAT graph's ELL tables at
    the default SpmmConfig (all edges in the tail): checked against the
    plain version, timed beside it, torch.sparse.mm and the bound; then
    K-tail-quant on the same tables in every payload mode."""
    import numpy as np
    import torch

    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import ell_tail
    from pygim_tpu_torch.ops.spmm import (
        SpmmConfig,
        _plan_ell_tables,
        ell_step_tables,
    )

    t0 = time.perf_counter()
    graph, _ = merge_duplicate_edges(load_dataset(SCALE_GRAPH).graph)
    host = [(*ell_step_tables(t.cols, t.vals, t.vrow_to_row, chunk), t.degree)
            for chunk, t in _plan_ell_tables(graph.to_csr(), SpmmConfig())]
    tables = tail_to(host, dev)
    plan = ell_tail.tail_plan(tables, host=[(v, r) for _c, v, r, _d in host])
    host_s = time.perf_counter() - t0
    n = graph.nrows
    gx = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(n, h, generator=gx, device=dev)
    z = torch.zeros_like(x)
    got = ell_tail.ell_tables_add(x, tables, z.clone(), plan=plan)
    err = tail_close(f"K-tail scale tables {SCALE_GRAPH}", x, tables, got, z)
    del got
    ms = cuda_ms(lambda: ell_tail.ell_tables_add(x, tables, z, plan=plan),
                 iters=10)
    plain_ms = cuda_ms(lambda: ell_tail.ell_tables_plain(x, tables, z),
                       iters=3, warmup=1)
    bound, (rows_t, cols_t, vals_t) = tail_bound(tables, h, results["peaks"])
    a = torch.sparse_coo_tensor(torch.stack([rows_t, cols_t]), vals_t,
                                (n, n)).coalesce().to_sparse_csr()
    del rows_t, cols_t, vals_t
    library_ms = cuda_ms(lambda: torch.sparse.mm(a, x), iters=10)
    results["K-tail scale tables"] = dict(
        graph=SCALE_GRAPH, h=h, host_s=host_s,
        tables=[[int(c.shape[0]), int(c.shape[1]) // dg, dg]
                for c, _v, _r, dg in tables],
        real_slots=int(sum(int(np.count_nonzero(v)) for _c, v, _r, _d in host)),
        units=plan.n_units, split_units=int(plan.units[:, 3].sum()),
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound,
    )
    quant = {}
    for mode in PAYLOAD_MODES:
        xq, kw, rounded = payload_mode(x, mode)
        zero = torch.zeros_like(x)
        got = ell_tail.ell_tables_add(xq, tables, zero.clone(), plan=plan,
                                      **kw)
        qerr = tail_close(f"K-tail-quant scale tables, {mode}", xq, tables,
                          got, zero, kw.get("safe"))
        del got
        qms = cuda_ms(lambda: ell_tail.ell_tables_add(xq, tables, z,
                                                      plan=plan, **kw),
                      iters=10)
        qlib = cuda_ms(lambda: torch.sparse.mm(a, rounded), iters=10)
        b, _csr = tail_bound(tables, h, results["peaks"], xq.element_size())
        quant[mode] = dict(max_abs_err=qerr, ms=qms, library_ms=qlib,
                           bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        del xq, rounded, zero
    results["K-tail-quant scale tables"] = quant
    del a, x, z, tables
    torch.cuda.empty_cache()


def mul_any_width(prep, results, widths=(41, 1100)):
    """``prep.mul`` (K-tail at H, K-core padded to a multiple of 8)
    against ``mul_plain`` (nothing padded) at widths the kernels' tiles
    do not divide."""
    import torch

    from pygim_tpu_torch.ops import core_dot, ell_tail

    d = prep.dev_arrays
    cn = d["core_nodes"]
    bands = [d[f"stair{b}"].float().abs() for b in range(len(prep.stair))]
    tables = [(c, v.abs(), r, dg) for c, v, r, dg in prep.ell_tables(d)]
    g = torch.Generator(device="cpu").manual_seed(7)
    errs = {}
    for h in widths:
        x = torch.randn(prep.ncols, h, generator=g).to(cn.device)
        got = prep.mul(x)
        want = prep.mul_plain(x)
        if got.shape != (prep.nrows, h):
            raise AssertionError(f"mul at H={h}: shape {tuple(got.shape)}")
        mag = ell_tail.ell_tables_plain(x.abs(), tables, torch.zeros_like(x))
        xc = x.index_select(0, cn).to(torch.bfloat16).abs()
        core_dot.core_bands_plain(bands, xc, cn, prep.stair, mag)
        errs[h] = check_close(f"mul at H={h}", got, want, mag, REL_TOL)
        del x, got, want, mag, xc
    results["mul any width"] = errs


class PlainAggregate:
    """The aggregate of ``prep`` through the plain versions: ``mul_plain``
    on A, whose PyTorch ops autograd follows (a backward independent of
    ``SpmmFunction`` and of the prepared Aᵀ), and the quantized hook on
    ``mul_quantized_plain``."""

    def __init__(self, prep):
        self.prep = prep

    def __call__(self, v):
        return self.prep.mul_plain(v)

    def quantized(self, v, agg_dtype):
        return self.prep.mul_quantized_plain(v, agg_dtype)


def logits_check(name, gnn, xf, prep, n_classes):
    """The forward through the kernels against the same forward through
    the plain versions: two layers of f32 reordering in the aggregates
    (and, with quantized aggregation, a flip of round(h / scale) by one
    step, 2^-19 of max|h| at int32, where a reordered sum lands on the
    other side of a half step), carried through the dense layers: 1e-4 of
    the logits' scale."""
    import torch

    from pygim_tpu_torch.ops.spmm import PreparedAggregate

    with torch.inference_mode():
        logits = gnn(xf, PreparedAggregate(prep))
        plain = gnn(xf, PlainAggregate(prep))
    if logits.shape != (prep.nrows, n_classes):
        raise AssertionError(f"{name} logits shape {tuple(logits.shape)}")
    scale = max(1.0, float(plain.abs().max()))
    lerr = float((logits - plain).abs().max())
    print(f"{name} logits: max abs err {lerr} of scale {scale}", flush=True)
    if not torch.isfinite(logits).all() or lerr > 1e-4 * scale:
        raise AssertionError(f"{name} logits differ from the plain forward: "
                             f"{lerr}")


def entry_check():
    """The flagship forward step (``pygim_tpu_torch/entry.py``: int32
    aggregation through ``prep.mul``, so K-tail on int32 rows and K-int at
    four limbs) on the card against the same step on the CPU (the plain
    versions), on seeded features; the bar is ``logits_check``'s."""
    import torch

    from pygim_tpu_torch import entry

    fwd, (x0,) = entry.entry()
    if x0.device.type != "cuda" or x0.any():
        raise AssertionError("entry(): the input is not a zero tensor on "
                             "the card")
    cpu_fwd, _ = entry.entry(device="cpu")
    xr = torch.randn(x0.shape, generator=torch.Generator().manual_seed(12))
    for name, x in (("zero", x0), ("seeded", xr)):
        got = fwd(x.cuda()).cpu()
        want = cpu_fwd(x.cpu())
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        print(f"entry(), {name} input: max abs err {err} of scale {scale}",
              flush=True)
        if got.shape != want.shape or not torch.isfinite(got).all() \
                or err > 1e-4 * scale:
            raise AssertionError(f"entry() on the card differs from the CPU: "
                                 f"{err}")


def ell_mag(prep, q):
    """The sum of |terms| behind each element of the ell operand's
    product with rows ``q``."""
    import torch

    from pygim_tpu_torch.ops import ell_tail

    tables = [(c, v.abs(), r, d)
              for c, v, r, d in prep.ell_tables(prep.dev_arrays)]
    return ell_tail.ell_tables_plain(
        q.float().abs(), tables,
        torch.zeros(prep.nrows, q.shape[1], device=q.device))


def ell_backend(graph, x, results, reps: int = 3):
    """The ``ell`` backend (the CLIs' default: the whole merged graph in
    K-tail): ``mul`` against ``mul_plain`` on f32 rows (REL_TOL of the sum
    of |terms|) and int32 rows (``torch.equal``: every integer sum stays
    under 2^24, so f32 sums are exact in any order), the fused int32
    ``mul_quantized`` against ``mul_quantized_plain`` (REL_TOL: its
    rounded rows reach 2^30, so f32 sums are not exact), each with one
    K-tail launch per SpMM. Returns the operand."""
    import torch

    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.quant import quant_scale

    t0 = time.perf_counter()
    prep = prepare_spmm(graph, SpmmConfig(backend="ell", hidden_hint=HIDDEN),
                        device=x.device)
    print(f"ell backend: prepare {time.perf_counter() - t0:.1f} s, tables "
          f"{prep.ell_meta}", flush=True)
    xi = torch.randint(-10, 11, x.shape, dtype=torch.int32,
                       generator=torch.Generator().manual_seed(3)).to(x.device)
    res = {}
    for name, xs, kind in (("f32", x, "K-tail"), ("int32", xi, "K-tail-quant")):
        reset_launch_counts()
        for _ in range(reps):
            got = prep.mul(xs)
        torch.cuda.synchronize()
        n = launch_counts()
        if n[kind] != reps or sum(n.values()) != reps:
            raise AssertionError(f"ell {name} mul: launches {n}, want "
                                 f"{reps} of {kind}")
        want = prep.mul_plain(xs)
        if name == "f32":
            res[name] = check_close("ell mul f32", got, want,
                                    ell_mag(prep, xs), REL_TOL)
        elif not torch.equal(got, want):
            raise AssertionError("ell mul int32 differs from mul_plain")
        else:
            res[name] = 0.0
    reset_launch_counts()
    for _ in range(reps):
        got = prep.mul_quantized(x, "int32")
    torch.cuda.synchronize()
    n = launch_counts()
    if n["K-tail-quant"] != reps or sum(n.values()) != reps:
        raise AssertionError(f"ell mul_quantized: launches {n}")
    want = prep.mul_quantized_plain(x, "int32")
    scale, safe = quant_scale(x, "int32")
    res["mul_quantized int32"] = check_close(
        "ell mul_quantized int32", got, want,
        ell_mag(prep, torch.round(x / safe)) * scale, REL_TOL)
    results["ell backend"] = res
    return prep


def oracle_backend(graph, x, hybrid, ds, results):
    """The ``oracle`` backend (raw edges, plain PyTorch ops): ``mul``
    against the hybrid's ``mul_plain`` (rel 1e-2 of the sum of |terms|:
    the int8 core rounds x to bf16), and an int32 GCN forward on it
    (quantize round trip around the oracle, as
    ``PreparedAggregate.quantized`` is None there) against the same
    forward on the hybrid (fused); ``logits_check``'s bar."""
    import torch

    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops.reference import spmm_coo_oracle
    from pygim_tpu_torch.ops.spmm import (
        PreparedAggregate,
        SpmmConfig,
        prepare_spmm,
    )

    dev = x.device
    prep = prepare_spmm(graph, SpmmConfig(backend="oracle"), device=dev)
    agg = PreparedAggregate(prep)
    if agg.quantized(x, "int32") is not None:
        raise AssertionError("the oracle fused the quantization")
    d = prep.dev_arrays
    mag = spmm_coo_oracle(d["rows"], d["cols"], d["vals"].abs(), x.abs(),
                          prep.nrows)
    err = check_close("oracle mul vs hybrid mul_plain", prep.mul(x),
                      hybrid.mul_plain(x), mag, 1e-2)
    gnn = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                   num_layers=2, agg_dtype="int32", device=dev)
    xf = torch.as_tensor(ds.x).to(dev)
    with torch.inference_mode():
        got = gnn(xf, agg)
        want = gnn(xf, PreparedAggregate(hybrid))
    scale = max(1.0, float(want.abs().max()))
    lerr = float((got - want).abs().max())
    print(f"oracle int32 GCN vs hybrid: max abs err {lerr} of scale {scale}",
          flush=True)
    if not torch.isfinite(got).all() or lerr > 1e-4 * scale:
        raise AssertionError(f"oracle int32 GCN differs from the hybrid's: "
                             f"{lerr}")
    results["oracle backend"] = dict(mul_err=err, gcn_err=lerr)


PHASE_KEYS = {"hybrid": {"mul_time(ms)", "gather_time(ms)", "tail_time(ms)",
                         "core_time(ms)"},
              "ell": {"mul_time(ms)", "gather_time(ms)", "tail_time(ms)"}}


def phase_times(preps, x, results):
    """``phase_times`` of the smoke operands: every key, each positive."""
    out = {}
    for name, prep in preps.items():
        t = prep.phase_times(x, iters=10)
        if set(t) != PHASE_KEYS[name] or not all(v > 0 for v in t.values()):
            raise AssertionError(f"{name} phase_times: {t}")
        print(f"phase_times, {name}: {t}", flush=True)
        out[name] = t
    results["phase_times"] = out


def caches(graph, cfg, x, results):
    """The hybrid prepare cache in a fresh directory: the first prepare
    builds and saves, the second loads; the device tables are equal
    (``torch.equal``), and so are the two products within REL_TOL of the
    sum of |terms| (K-tail adds a hub row's pieces with atomics, in no
    fixed order)."""
    import torch

    from pygim_tpu_torch.ops import core_dot, ell_tail
    from pygim_tpu_torch.ops.spmm import prepare_spmm

    root = os.environ["PYGIM_TPU_TORCH_DATA"]
    os.environ["PYGIM_TPU_TORCH_DATA"] = tempfile.mkdtemp(dir=root)
    try:
        preps, secs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            preps.append(prepare_spmm(graph, cfg, device=x.device))
            secs.append(time.perf_counter() - t0)
    finally:
        os.environ["PYGIM_TPU_TORCH_DATA"] = root
    cold, warm = (p.prepare_timer.acc for p in preps)
    if "cache_save" not in cold or "cache_load" not in warm \
            or "core_fill" in warm:
        raise AssertionError(f"prepare cache: phases {cold} then {warm}")
    a, b = (p.dev_arrays for p in preps)
    if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("prepare cache: the loaded tables differ")
    d = a
    bands = [d[f"stair{i}"].float().abs() for i in range(len(preps[0].stair))]
    mag = ell_tail.ell_tables_plain(
        x.abs(), [(c, v.abs(), r, dg)
                  for c, v, r, dg in preps[0].ell_tables(d)],
        torch.zeros_like(x))
    cn = d["core_nodes"]
    core_dot.core_bands_plain(bands, x.index_select(0, cn).to(
        torch.bfloat16).abs(), cn, preps[0].stair, mag)
    got, want = preps[1].mul(x), preps[0].mul(x)
    err = check_close("mul from the cached tables", got, want, mag, REL_TOL)
    print(f"caches: prepare {secs[0]:.2f} s cold (phases {cold}), "
          f"{secs[1]:.2f} s from the cache (phases {warm}); products "
          f"{'bit-equal' if torch.equal(got, want) else f'within {err}'}",
          flush=True)
    results["caches"] = dict(cold_s=secs[0], warm_s=secs[1], mul_err=err)


# (what, argv, extra environment): the port's entry scripts at their
# defaults on the smoke stand-in (pubmed, the CLIs' default dataset, for
# the oracle), each in a process of its own
ENTRY_POINTS = (
    ("bench_cuda", ["bench_cuda.py"],
     {"PYGIM_BENCH_DATASET": DATASET,
      "PYGIM_BENCH_CORE_BYTES": str(CORE_BYTES),
      "PYGIM_BENCH_CORE_SHAPE": "stair"}),
    ("spmm_test_cuda", ["spmm_test_cuda.py", "--dataset", DATASET], {}),
    ("spmm_test_cuda --version cpu", ["spmm_test_cuda.py", "--version",
                                      "cpu"], {}),
    ("inference_cuda", ["inference_cuda.py", "--dataset", DATASET], {}),
    ("bench_cuda bf16 square", ["bench_cuda.py"],
     {"PYGIM_BENCH_DATASET": DATASET,
      "PYGIM_BENCH_CORE_BYTES": str(CORE_BYTES),
      "PYGIM_BENCH_CORE_SHAPE": "square",
      "PYGIM_BENCH_CORE_DTYPE": "bfloat16"}),
    ("spmm_test_cuda --data_type bfloat16",
     ["spmm_test_cuda.py", "--dataset", DATASET, "--data_type", "bfloat16"],
     {}),
    ("inference_cuda --data_type int64",
     ["inference_cuda.py", "--dataset", DATASET, "--data_type", "int64"], {}),
)


def entry_points(results, timeout: int = 300):
    """Each entry script in a subprocess with a deadline; a failure, a
    missing ``verify: OK`` where it verifies, or (bench_cuda) a JSON line
    without every key or a main path that launched no K-core (its bf16
    mode on a bf16 core) or no K-tail fails the run."""
    out = {}
    for what, argv, env in ENTRY_POINTS:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *argv], capture_output=True,
                             text=True, timeout=timeout,
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             env=dict(os.environ, **env))
        secs = time.perf_counter() - t0
        tail = (res.stdout + res.stderr)[-3000:]
        if res.returncode != 0:
            raise AssertionError(f"{what}: exit {res.returncode}\n{tail}")
        lines = res.stdout.strip().splitlines()
        if what.startswith("bench_cuda"):
            line = json.loads(lines[-1])
            keys = {"metric", "value", "unit", "vs_baseline",
                    "spmm_effective_GBps_unique", "device"}
            launches = json.loads(re.search(
                r"launches in the timed calls (\{.*\})", res.stderr).group(1))
            core = ("K-core bf16" if env.get("PYGIM_BENCH_CORE_DTYPE")
                    == "bfloat16" else "K-core")
            if set(line) != keys or "verify: OK" not in res.stderr \
                    or launches[core] <= 0 or launches["K-tail"] <= 0:
                raise AssertionError(f"{what}: {line} {launches}\n{tail}")
            out[what] = dict(line=line, launches=launches)
        else:
            data = [ln for ln in lines if ln.startswith("[DATA]")]
            want = "[DATA]infer_time(ms)" if what.startswith(
                "inference_cuda") else "[DATA]verify: OK"
            if not any(ln.startswith(want) for ln in data) or not any(
                    ln.startswith("[DATA]device: ") for ln in data):
                raise AssertionError(f"{what}: no {want}\n{tail}")
            out[what] = [ln for ln in data if "time(ms)" in ln
                         or "verify" in ln or "device" in ln]
        print(f"entry point {what}: {secs:.1f} s {out[what]}", flush=True)
    results["entry points"] = out


# The training phase: the backward product on the smoke operand, a few
# steps of each conv at full width, and the training entry points on a
# learnable planted graph (a 20,000-node stand-in of train.py's pubmed
# run at its width: hidden 256, 2 layers, 8 classes)
TRAIN_GRAPH = "planted-20000-240000-8"
TRAIN_STEPS = 3
# the 3-step loss check's learning rate and bar, and the gradient check's
# bar, set from the readings of ``--train-sweep`` (PERF.md §6, H100): at
# lr 1e-3 the kernels drift at most 4.3e-4 from the plain versions and
# the plain versions 2.4e-4 from themselves, while the cut and
# untransposed controls drift 2.3e-3 to 1.3e-2 for every conv; at 3e-3 the
# untransposed GCN drifted only 2.9e-4, and at 3e-3 and 1e-2 the plain
# versions drifted from themselves by 1.3e-3 and 1.0e-3 (GIN). Gradients:
# kernels against plain at most 7.1e-3 of a leaf (SAGE), the controls 0.57
# or more
TRAIN_LR = 1e-3  # train.py's default
LOSS_BAR = 1e-3
GRAD_BAR = 2e-2
# a leaf whose largest |grad| is below GRAD_FLOOR of the model's largest
# is rounding noise (a bias right before a BatchNorm, 0 in exact
# arithmetic): its error is measured against that floor
GRAD_FLOOR = 1e-4
SWEEP_LRS = (1e-3, 3e-3, 1e-2)
CONVS = ("gcn", "gin", "sage")
CONTROLS = ("cut", "untransposed")


TRAIN_EPOCHS = 50  # run_training_benchmark's default


class CutAggregate:
    """A negative control: the kernels' product of a detached payload,
    the graph cut at every aggregate (what a kernel's raw-pointer write
    does to a gradient without ``SpmmFunction``)."""

    def __init__(self, prep):
        self.prep = prep

    def __call__(self, v):
        return self.prep.mul(v.detach())


def untransposed(prep):
    """A negative control: the kernels' product whose backward runs A
    where it must run Aᵀ (the smoke graph is directed)."""
    import torch

    class Untransposed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return prep.mul(x.contiguous())

        @staticmethod
        def backward(ctx, g):
            return prep.mul(g.contiguous())

    return Untransposed.apply


def training_arms(prep) -> dict:
    """The aggregates the training checks compare: the kernels, the plain
    versions (autograd through ``mul_plain`` on A), each run twice (the
    second run witnesses the run-to-run differences of each: K-tail's
    atomics, ``index_add_``'s), and the two negative controls the checks
    must reject."""
    from pygim_tpu_torch.ops.spmm import PreparedAggregate

    return {"kernels": PreparedAggregate(prep),
            "kernels again": PreparedAggregate(prep),
            "plain": PlainAggregate(prep), "plain again": PlainAggregate(prep),
            "cut": CutAggregate(prep), "untransposed": untransposed(prep)}


def leaf_grads(conv, ds, agg, inputs) -> dict:
    """Every parameter's gradient after one training forward (dropout
    0.5, generator seed 0) and backward of the masked loss from the seeded
    initialisation; a leaf no gradient reached has zeros."""
    import torch

    from pygim_tpu_torch.nn.models import gnn_apply, make_gnn
    from pygim_tpu_torch.nn.train import softmax_cross_entropy

    x, labels, mask = inputs
    model = make_gnn(0, conv, ds.x.shape[1], HIDDEN, ds.num_classes,
                     device=x.device)
    logits = gnn_apply(model, x, agg, training=True,
                       generator=torch.Generator(device=x.device)
                       .manual_seed(0))
    softmax_cross_entropy(logits, labels, mask).backward()
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in model.named_parameters()}


def leaf_errs(got: dict, want: dict) -> dict:
    """Per leaf, ``max |got - want|`` over ``max |want|`` (at least
    GRAD_FLOOR of the model's largest |grad|)."""
    top = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), GRAD_FLOOR * top)
            for k, w in want.items()}


def arm_losses(conv, ds, agg, inputs, lr, steps=TRAIN_STEPS):
    """``steps`` steps of ``make_train_step`` (Adam at ``lr``, dropout
    0.5 with generator seeds 0, 1, ...) from the seeded initialisation:
    (model, losses, launches)."""
    import torch

    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.nn.train import make_train_step
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts

    dev = inputs[0].device
    model = make_gnn(0, conv, ds.x.shape[1], HIDDEN, ds.num_classes,
                     device=dev)
    step = make_train_step(model, agg, torch.optim.Adam(
        model.parameters(), lr=lr))
    reset_launch_counts()
    losses = [float(step(*inputs, torch.Generator(device=dev).manual_seed(e)))
              for e in range(steps)]
    sync(dev)
    return model, losses, launch_counts()


def drift(losses, want) -> float:
    """The largest relative difference of two runs' per-step losses."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, want))


def _refuse_plain(*a, **k):
    raise AssertionError("a plain version ran inside the kernels' backward")


def backward_product(prep, graph, results, card):
    """``torch.autograd.grad`` of ``(A @ x) · w`` through the kernels
    (``SpmmFunction``: K-core and K-tail on the prepared Aᵀ) against ``Aᵀ
    @ w`` through the plain versions on the card, within REL_TOL of the
    sum of |terms| (both round ``w`` to bf16 at the core's rows), and
    against the raw edges' exact transpose within 2^-8 of it (one bf16
    rounding of a core term, 2^-9). The launches of the forward and of
    the backward are counted apart; every plain version is replaced by
    one that raises while the backward runs."""
    import torch

    from pygim_tpu_torch.ops import (
        core_dot,
        ell_tail,
        launch_counts,
        reset_launch_counts,
        spmm,
    )
    from pygim_tpu_torch.ops.reference import spmm_coo_oracle

    t0 = time.perf_counter()
    pt = prep.transpose(graph)
    print(f"prepare, Aᵀ: {time.perf_counter() - t0:.1f} s bands={pt.stair} "
          f"tables={pt.ell_meta}; device bytes A {prep.device_bytes}, "
          f"Aᵀ {pt.device_bytes}", flush=True)
    dev = prep.device
    g = torch.Generator().manual_seed(21)
    x = torch.randn(prep.ncols, HIDDEN, generator=g).to(dev).requires_grad_()
    w = torch.randn(prep.nrows, HIDDEN, generator=g).to(dev)
    reset_launch_counts()
    y = spmm.PreparedAggregate(prep)(x)
    sync(dev)
    fwd = launch_counts()
    # on the card no plain version may run (on the CPU the wrappers take
    # them: a rehearsal)
    saved = [(m, n, getattr(m, n)) for m, n in (
        (core_dot, "core_bands_plain"), (ell_tail, "ell_tables_plain"),
        (spmm, "core_bands_plain"), (spmm, "ell_tables_plain"))
        if dev.type == "cuda"]
    reset_launch_counts()
    try:
        for m, n, _f in saved:
            setattr(m, n, _refuse_plain)
        (got,) = torch.autograd.grad((y * w).sum(), x)
        sync(dev)
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    bwd = launch_counts()
    for k in ("K-core", "K-tail"):
        if fwd[k] <= 0 or bwd[k] <= 0:
            raise AssertionError(f"{k} launches: forward {fwd[k]}, backward "
                                 f"{bwd[k]}")
    del y
    want = pt.mul_plain(w)
    mag = pt.mul_plain(w.abs())
    err = check_close("backward Aᵀ w: kernels vs plain", got, want, mag,
                      REL_TOL)
    del want
    rows, cols, vals = (torch.as_tensor(a).to(dev)
                        for a in (graph.rows, graph.cols, graph.vals))
    exact = spmm_coo_oracle(cols, rows, vals, w, prep.ncols)
    mag = spmm_coo_oracle(cols, rows, vals.abs(), w.abs(), prep.ncols)
    xerr = check_close("backward Aᵀ w: kernels vs the exact transpose", got,
                       exact, mag, 2.0 ** -8)
    del exact, mag, got, rows, cols, vals
    xd = x.detach()
    res = dict(
        max_abs_err=err, exact_max_abs_err=xerr,
        launches={"forward": fwd, "backward": bwd},
        forward_ms=cuda_ms(lambda: prep.mul(xd)),
        backward_ms=cuda_ms(lambda: pt.mul(w)),
        backward_plain_ms=cuda_ms(lambda: pt.mul_plain(w), iters=3),
        bytes={"A": prep.device_bytes, "Aᵀ": pt.device_bytes},
    )
    results["backward product"] = res
    print(f"training, backward product (H {HIDDEN}): A x {res['forward_ms']:.4f}"
          f" ms, Aᵀ g {res['backward_ms']:.4f} ms (plain "
          f"{res['backward_plain_ms']:.4f}), max abs err {err} (exact "
          f"{xerr}); launches forward {fwd['K-core']} K-core "
          f"{fwd['K-tail']} K-tail, backward {bwd['K-core']} K-core "
          f"{bwd['K-tail']} K-tail ({card})", flush=True)
    torch.cuda.empty_cache()


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def train_steps(ds, prep, results, card):
    """The kernels' training against the plain versions on the card, for
    GCN, GIN and SAGE at hidden 256 (the arms of ``training_arms``):

    * gradients: one training forward and backward; every leaf of the
      kernels' within GRAD_BAR of the plain versions' (``leaf_errs``),
      which rounds the core's gradient to bf16 after its product, where
      K-core on Aᵀ rounds the cotangent before it (2^-9 relative a core
      term each way, carried through the batch statistics);
    * losses: TRAIN_STEPS steps of Adam at TRAIN_LR, per-step losses
      within LOSS_BAR relative. Adam moves every weight by about the
      learning rate whatever its gradient's size, so a rounding-sized
      difference that flips a near-zero gradient's sign moves a weight by
      twice the rate, and the losses of two runs of the same code drift
      apart: TRAIN_LR is the swept rate at which the honest runs stay
      inside the bar and both controls fail it;
    * each negative control must fail both checks, so neither can pass a
      cut or untransposed backward;
    * the kernel-trained model's per-layer activations through the
      kernels and through the plain versions within the hybrid's 1e-2
      (``validate_model``'s bar, ``1e-2 + 1e-2 · max|activation|``), and
      no kernel launched by the plain arms.

    Then the GCN's step split into forward, backward and Adam
    (``make_train_step``'s ``StepSplit``)."""
    import numpy as np
    import torch

    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.bench.validate import layer_activations
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.nn.train import StepSplit, make_train_step
    from pygim_tpu_torch.ops.spmm import PreparedAggregate

    dev = prep.device
    inputs = train_inputs(ds, dev)
    arms = training_arms(prep)
    out = {}
    for conv in CONVS:
        grads = {a: leaf_grads(conv, ds, agg, inputs)
                 for a, agg in arms.items()}
        errs = {a: leaf_errs(g, grads["plain"]) for a, g in grads.items()
                if a != "plain"}
        gerr = {a: max(e.values()) for a, e in errs.items()}
        worst = sorted(errs["kernels"].items(), key=lambda kv: -kv[1])[:3]
        del grads
        runs = {a: arm_losses(conv, ds, agg, inputs, TRAIN_LR)
                for a, agg in arms.items()}
        lp = runs["plain"][1]
        ldrift = {a: drift(r[1], lp) for a, r in runs.items() if a != "plain"}
        mk, lk, nk = runs["kernels"]
        print(f"training, {conv}: gradients, max leaf err against the plain "
              f"versions {gerr} (kernels' worst {worst}); {TRAIN_STEPS} "
              f"steps at lr {TRAIN_LR}: losses {lk} (plain {lp}), max rel "
              f"drift {ldrift}; launches {nk}", flush=True)
        if (gerr["kernels"] > GRAD_BAR or not np.isfinite(lk).all()
                or ldrift["kernels"] > LOSS_BAR):
            raise AssertionError(f"{conv}: kernels against plain, gradients "
                                 f"{gerr['kernels']} (bar {GRAD_BAR}), "
                                 f"losses {ldrift['kernels']} (bar "
                                 f"{LOSS_BAR})")
        for c in CONTROLS:
            if gerr[c] <= GRAD_BAR or ldrift[c] <= LOSS_BAR:
                raise AssertionError(f"{conv}: the {c} control passed "
                                     f"(gradients {gerr[c]}, losses "
                                     f"{ldrift[c]})")
        plain_n = {k: v for a in ("plain", "plain again")
                   for k, v in runs[a][2].items() if v}
        if nk["K-core"] <= 0 or nk["K-tail"] <= 0 or plain_n:
            raise AssertionError(f"{conv} steps: launches {nk}, plain "
                                 f"{plain_n}")
        # the kernel-trained model's activations through the kernels and
        # through the plain versions, at validate_model's bar
        acts = []
        for a, b in zip(layer_activations(mk, inputs[0], arms["kernels"]),
                        layer_activations(mk, inputs[0], arms["plain"])):
            err = float(np.abs(a - b).max())
            scale = max(1.0, float(np.abs(b).max()))
            if not np.isfinite(a).all() or err > 1e-2 + 1e-2 * scale:
                raise AssertionError(f"{conv} trained activations differ: "
                                     f"{err} of scale {scale}")
            acts.append((err, scale))
        out[conv] = dict(grad_err=gerr, grad_worst=worst, losses=lk,
                         plain_losses=lp, loss_drift=ldrift,
                         layer_max_err_scale=acts, launches=nk)
        print(f"training, {conv}: trained layers (max err, scale) {acts}",
              flush=True)
        del runs, mk
        torch.cuda.empty_cache()
    model = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                     device=dev)
    split = StepSplit()
    step = make_train_step(model, PreparedAggregate(prep), torch.optim.Adam(
        model.parameters(), lr=TRAIN_LR), split)
    for e in range(6):  # the first step warms up
        step(*inputs, torch.Generator(device=dev).manual_seed(e))
    ms = {p: float(np.mean(split.ms[p][1:])) for p in split.PHASES}
    out["gcn step"] = dict(ms=ms, launches=split.launches)
    print(f"training, gcn step at hidden {HIDDEN}: forward "
          f"{ms['forward']:.4f} ms, backward {ms['backward']:.4f} ms, Adam + "
          f"merge {ms['adam']:.4f} ms; launches forward "
          f"{split.launches['forward']}, backward "
          f"{split.launches['backward']} ({card})", flush=True)
    results["train steps"] = out


def train_sweep() -> int:
    """``--train-sweep``: the readings TRAIN_LR, LOSS_BAR and GRAD_BAR are
    set from, on the smoke operand: every leaf's gradient error of each
    arm against the plain versions, then each arm's loss drift at each
    rate of SWEEP_LRS. Prints them as JSON lines; checks nothing."""
    import torch

    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    _build.build()
    ds = load_dataset(DATASET)
    prep = prepare_spmm(ds.graph, SpmmConfig(
        backend="hybrid", hybrid_shape="stair", hybrid_dtype="int8",
        hybrid_core_bytes=CORE_BYTES), device="cuda")
    prep.transpose(ds.graph)
    inputs = train_inputs(ds, prep.device)
    arms = training_arms(prep)
    for conv in CONVS:
        grads = {a: leaf_grads(conv, ds, agg, inputs)
                 for a, agg in arms.items()}
        scale = {k: float(g.abs().max()) for k, g in grads["plain"].items()}
        errs = {a: leaf_errs(g, grads["plain"]) for a, g in grads.items()
                if a != "plain"}
        print(json.dumps({"conv": conv, "leaf_scale": scale,
                          "leaf_errs": errs}), flush=True)
        for lr in SWEEP_LRS:
            runs = {a: arm_losses(conv, ds, agg, inputs, lr)[1]
                    for a, agg in arms.items()}
            print(json.dumps({"conv": conv, "lr": lr, "losses": runs,
                              "drift": {a: drift(v, runs["plain"])
                                        for a, v in runs.items()}}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


def training_entry(results, card, timeout: int = 300, device="cuda"):
    """``train_cuda.py`` on TRAIN_GRAPH for 10 epochs at its other
    defaults (``ell``), in a process of its own with a deadline: its
    [DATA] lines parse and its loss falls. Then ``run_training_benchmark``
    of each conv on the same graph on ``ell`` and on the stair-int8
    hybrid (the smoke configuration): ``acc_delta`` against the oracle
    arm at most 0.01 on ``ell`` and 0.03 on the hybrid (the reference's
    ``acc_tol`` for a rounded core), ``validate`` OK, and K-core and
    K-tail launched in the hybrid's runs."""
    from pygim_tpu_torch.bench.runners import run_training_benchmark
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig
    from pygim_tpu_torch.utils.metrics import DataReporter, parse_data_lines

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "train_cuda.py", "--dataset", TRAIN_GRAPH,
         "--epochs", "10"], capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    tail = (res.stdout + res.stderr)[-3000:]
    if res.returncode != 0:
        raise AssertionError(f"train_cuda.py: exit {res.returncode}\n{tail}")
    got = parse_data_lines(res.stdout.splitlines())
    keys = ("epoch", "train_loss", "test_acc", "train_time(ms)", "device")
    if any(k not in got for k in keys) or got["epoch"] != [0.0, 9.0] \
            or not got["train_loss"][-1] < got["train_loss"][0]:
        raise AssertionError(f"train_cuda.py: {got}\n{tail}")
    out = {"train_cuda": {k: got[k] for k in keys}}
    print(f"training, train_cuda.py ({secs:.1f} s): "
          f"{out['train_cuda']} ({card})", flush=True)

    ds = load_dataset(TRAIN_GRAPH)
    hybrid = SpmmConfig(backend="hybrid", hybrid_shape="stair",
                        hybrid_dtype="int8", hybrid_core_bytes=CORE_BYTES)
    for name, cfg, tol in (("ell", SpmmConfig(backend="ell"), 0.01),
                           ("stair int8", hybrid, 0.03)):
        for conv in CONVS:
            rep = DataReporter()
            reset_launch_counts()
            means = run_training_benchmark(
                ds, model=conv, hidden=HIDDEN, config=cfg,
                epochs=TRAIN_EPOCHS, acc_tol=tol, reporter=rep,
                device=device)
            n = launch_counts()
            kernels = ("K-tail",) if name == "ell" else ("K-core", "K-tail")
            if means["acc_delta"] > tol or means["validate"] != "OK" \
                    or any(n[k] <= 0 for k in kernels):
                raise AssertionError(f"run_training_benchmark {conv} on "
                                     f"{name}: {means} launches {n}")
            keep = ("train_time(ms)", "first_epoch_time(ms)",
                    "epoch_time(ms)", "forward_ms", "backward_ms",
                    "adam_ms", "train_loss", "test_acc",
                    "oracle_test_acc", "acc_delta", "validate",
                    "operand_bytes", "transpose_bytes")
            out[f"{conv} {name}"] = {k: means[k] for k in keep}
            print(f"training, run_training_benchmark {conv} on {name}, "
                  f"{TRAIN_EPOCHS} epochs: {out[f'{conv} {name}']}, "
                  f"launches {n} ({card})", flush=True)
    results["training entry"] = out


def profile_train_step(ds, prep):
    """torch.profiler breakdown of one GCN training step at hidden 256
    through the kernels (``--profile``)."""
    import torch

    from pygim_tpu_torch.bench.report import profile_calls
    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.nn.train import make_train_step
    from pygim_tpu_torch.ops.spmm import PreparedAggregate

    inputs = train_inputs(ds, "cuda")
    model = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                     device="cuda")
    step = make_train_step(model, PreparedAggregate(prep),
                           torch.optim.Adam(model.parameters(), lr=TRAIN_LR))
    gen = torch.Generator(device="cuda").manual_seed(0)
    profile_calls(lambda: step(*inputs, gen), "training step")


# This slice's cores on the smoke stand-in at the smoke budget: the bf16
# core in both shapes, and the reference's default hybrid core
# (``hybrid_dtype=None``: the graph's own dtype, f32 cells on the
# stand-in's float graph)
FLOAT_CORES = {
    "bf16 square": dict(hybrid_shape="square", hybrid_dtype="bfloat16"),
    "f32 square": dict(hybrid_shape="square", hybrid_dtype=None),
    "bf16 stair": dict(hybrid_shape="stair", hybrid_dtype="bfloat16"),
}


def float_core_configs() -> dict:
    from pygim_tpu_torch.ops.spmm import SpmmConfig

    return {k: SpmmConfig(backend="hybrid", hybrid_core_bytes=CORE_BYTES,
                          **kw) for k, kw in FLOAT_CORES.items()}


def bands_of(prep) -> list:
    """The core's stored bands of a hybrid operand (a square: one)."""
    d = prep.dev_arrays
    if "core" in d:
        return [d["core"]]
    return [d[f"stair{b}"] for b in range(len(prep.stair))]


def product_mag(prep, x):
    """The sum of |terms| behind each element of ``prep``'s product with
    ``x`` (any payload; a core's payload at the precision its cells
    take)."""
    import torch

    from pygim_tpu_torch.ops import core_f32, ell_tail

    d = prep.dev_arrays
    tables = [(c, v.abs(), r, dg) for c, v, r, dg in prep.ell_tables(d)]
    mag = ell_tail.ell_tables_plain(
        x.float().abs(), tables,
        torch.zeros(prep.nrows, x.shape[1], device=x.device))
    if prep.stair:
        cn = d["core_nodes"]
        w_max = max(w for *_, w in prep.stair)
        xc = x.index_select(0, cn[:w_max]).float().abs()
        xc = torch.nn.functional.pad(xc, (0, 0, 0, w_max - xc.shape[0]))
        core_f32.core_f32_plain([b.float().abs() for b in bands_of(prep)],
                                xc, cn, prep.stair, mag)
    return mag


def blocked_bound(prep, h, peaks_):
    """Least time of one blocked SpMM (``ops/spmm.py:blocked_spmm``): the
    larger of its bytes over HBM (every block's real entries, a column
    index and a value each; each x row a block gathers, once a block; each
    output row written once) and its multiply-adds over the f32 rate."""
    import torch

    hbm, _bf16, f32, _int8 = peaks_
    d = prep.dev_arrays
    real = d["vals"] != 0
    rows_x = sum(int(torch.unique(c[m]).numel())
                 for c, m in zip(d["colind"], real))
    nnz = int(real.sum())
    nbytes = nnz * 8 + rows_x * h * 4 + prep.nrows * h * 4
    t_bytes, t_ops = nbytes / hbm * 1e3, 2 * nnz * h / f32 * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                entries=nnz, x_rows=rows_x)


def launch_totals(core_f32) -> dict:
    """K-f32's launch counters, by route."""
    return {"3xTF32": core_f32.launches, "limbs": core_f32.limb_launches}


def limb_sweep(dev, results):
    """K-f32's limb route on integer sums up to and across 2^24: bf16 cells
    of integer value in [-8, 8] × int16 and int32 payloads, column n of
    the payload drawn from [-m_n, m_n] with m_n from 1 up to 2^31 - 1 and
    2^15 - 1 (log-spaced), 4,096 terms a sum; a dense band, and a sparse
    one (about four nonzero cells a row), whose short sums of large
    payloads stay below 2^24 where the payload's top limb is not 0. Where
    the sum of |terms| of an element stays below 2^24 every partial sum
    is an integer below 2^24, so the reference's f32 dot
    (``core_f32_plain``) is exact: the kernel must equal it bit for bit
    there, whatever order the tensor cores' f32 accumulation takes;
    elsewhere within REL_TOL of the sum of |terms|. The dense band must
    reach both sides of 2^24, the sparse one elements below 2^24 whose
    terms reach the top limb (the third, 2^22-scaled, for int32; the
    second for int16)."""
    import torch

    from pygim_tpu_torch.ops import core_f32

    g = torch.Generator(device="cpu").manual_seed(17)
    r, w, hh = 512, 4096, 256
    out = {}
    for (pdt, top), layout in itertools.product(
            ((torch.int16, 15), (torch.int32, 31)), ("dense", "sparse")):
        cells = torch.randint(-8, 9, (r, w), generator=g)
        if layout == "sparse":
            cells *= torch.rand(r, w, generator=g) < 4 / w
        band = cells.to(dev, torch.bfloat16)
        m = torch.logspace(0, top * 0.30103, hh, dtype=torch.float64)
        m = m.clamp(max=(1 << top) - 1).round().to(torch.int64)
        xq = (torch.rand(w, hh, generator=g, dtype=torch.float64) * 2 - 1)
        xq = (xq * m).round().to(pdt)
        # elements with a term whose payload has a nonzero top limb
        top_limb = core_f32.limbs(xq, core_f32.n_parts(torch.bfloat16,
                                                       pdt))[-1] != 0
        upper = ((cells != 0).double() @ top_limb.double() > 0).to(dev)
        xq = xq.to(dev)
        rows = torch.arange(r, dtype=torch.int32, device=dev)
        z = torch.zeros(r, hh, device=dev)
        stair = [(0, r, w)]
        got = core_f32.core_f32_scatter_add([band], xq, rows, stair,
                                            z.clone())
        want = core_f32.core_f32_plain([band], xq, rows, stair, z.clone())
        mag = band.double().abs() @ xq.double().abs()
        below = mag < (1 << 24)
        name = f"limb sweep {pdt} {layout}"
        if layout == "dense" and (below.all() or not below.any()):
            raise AssertionError(f"{name}: 2^24 not crossed")
        if layout == "sparse" and not (below & upper).any():
            raise AssertionError(f"{name}: no sum below 2^24 reaches the "
                                 "top limb")
        diff = got != want
        if (diff & below).any():
            raise AssertionError(
                f"{name}: {int((diff & below).sum())} elements below 2^24 "
                "differ from the f32 dot")
        e = check_close(name, got, want, mag.float(), REL_TOL)
        out[f"{pdt} {layout}"] = dict(
            below=int(below.sum()), below_top_limb=int((below & upper).sum()),
            above=int((~below).sum()),
            unequal_above=int((diff & ~below).sum()), max_abs_err=e)
    print(f"K-f32 limb sweep: {out}", flush=True)
    results["limb sweep"] = out


def float_core_checks(preps, x, results):
    """This slice's kernels against their plain versions, then timed at
    the smoke cores beside the bound, the plain version and a PyTorch
    call:

    * K-core's bf16 mode: ragged bands (rows off 128, widths multiples of
      16 but not of the 64-deep stage, H off the 256-column tile and
      above it), as chosen and each schedule forced (whole tiles,
      stream-K); the bf16 square core (k 11,520, schedule as chosen, two
      launches bit-identical) and the bf16
      stair's bands in one launch;
    * K-f32: f32 and bf16 cells × f32, bf16, int8, int16 and int32
      payloads at ragged shapes (H 41 and 1100 as ``mul_any_width``, an
      unaligned ``out``), a band of a width TMA refuses raising, the bf16
      stair's bands with an int32 payload; the f32 square core (k 8,192)
      with an f32 payload, also at H 41, and the bf16 square with the
      int32 forward's payload range (|q| <= 2^19);
    * K-tail's bf16-row mode: the ragged tables at H 36 and 41 (register
      path), 256 and 1104 (bulk copy), 256 unaligned (register path), and
      the bf16 square's tables.

    Float products at ``check_close``'s REL_TOL of the sum of |terms|."""
    import torch

    from pygim_tpu_torch.ops import core_dot, core_f32, ell_tail
    from pygim_tpu_torch.utils.device import core_bound, f32_bound

    dev = x.device
    h = x.shape[1]
    pk = results["peaks"]
    g = torch.Generator(device="cpu").manual_seed(11)
    err = 0.0
    for r, w, hh in ((37, 208, 24), (300, 1280, 256), (129, 4112, 136),
                     (1936, 2048, 40), (500, 768, 384), (200, 1040, 1104)):
        band = torch.randn(r, w, generator=g).to(dev, torch.bfloat16)
        xc = torch.randn(w + 5, hh, generator=g).to(dev, torch.bfloat16)
        rows = torch.randperm(3 * r, generator=g)[:r].to(dev, torch.int32)
        out0 = torch.randn(3 * r, hh, generator=g).to(dev)
        want = core_dot.core_band_plain(band, xc, rows, out0.clone())
        mag = out0.abs().index_add(
            0, rows, band.float().abs() @ xc[:w].float().abs())
        stair = [(0, r, w)]
        for split in (None, *core_dot.SCHEDULES):
            plans = core_dot.core_plans([band], stair, hh, split=split)
            got = core_dot.core_bands_scatter_add([band], xc, rows, stair,
                                                  out0.clone(), plans=plans)
            err = max(err, check_close(
                f"K-core bf16 ragged {(r, w, hh)} split "
                f"{plans[0].split}", got, want, mag, REL_TOL))
            if split == core_dot.STREAM and not torch.equal(
                    got, core_dot.core_bands_scatter_add(
                        [band], xc, rows, stair, out0.clone(), plans=plans)):
                raise AssertionError(f"K-core bf16 ragged {(r, w, hh)} "
                                     "stream-K: two launches differ")
    # a ragged stair of bf16 bands, stream-K forced: tiles cut across spans
    shp = [(421, 5120), (37, 256), (1300, 2080), (8, 128), (176, 9984)]
    bands = [torch.randn(r, w, generator=g).to(dev, torch.bfloat16)
             for r, w in shp]
    stair, lo = [], 0
    for r, w in shp:
        stair.append((lo, lo + r, w))
        lo += r
    rows = torch.randperm(3 * lo, generator=g)[:lo].to(dev, torch.int32)
    xc = torch.randn(9984, 264, generator=g).to(dev, torch.bfloat16)
    z = torch.zeros(3 * lo, 264, device=dev)
    plans = core_dot.core_plans(bands, stair, 264, split=core_dot.STREAM)
    got = core_dot.core_bands_scatter_add(bands, xc, rows, stair, z.clone(),
                                          plans=plans)
    want = core_dot.core_bands_plain(bands, xc, rows, stair, z.clone())
    mag = core_dot.core_bands_plain([t.abs() for t in bands], xc.abs(), rows,
                                    stair, z.clone())
    err = max(err, check_close(f"K-core bf16 stream-K, {len(shp)} bands",
                               got, want, mag, REL_TOL))
    del bands, xc, z, got, want, mag, plans

    # the bf16 square core (one band, split as chosen), then the stair
    res = {}
    for name in ("bf16 square", "bf16 stair"):
        prep = preps[name]
        bands = bands_of(prep)
        cn = prep.dev_arrays["core_nodes"]
        w_max = max(w for *_, w in prep.stair)
        xc = x.index_select(0, cn[:w_max]).to(torch.bfloat16)
        xc = torch.nn.functional.pad(xc, (0, 0, 0, w_max - xc.shape[0]))
        z = torch.zeros_like(x)
        plans = core_dot.core_plans(bands, prep.stair, h)
        got = core_dot.core_bands_scatter_add(bands, xc, cn, prep.stair,
                                              z.clone(), plans=plans)
        again = core_dot.core_bands_scatter_add(bands, xc, cn, prep.stair,
                                                z.clone(), plans=plans)
        if not torch.equal(got, again):
            raise AssertionError(f"K-core bf16 {name}: two launches differ")
        want = core_dot.core_bands_plain(bands, xc, cn, prep.stair, z.clone())
        mag = core_dot.core_bands_plain([b.abs() for b in bands], xc.abs(),
                                        cn, prep.stair, z.clone())
        e = check_close(f"K-core bf16 {name}", got, want, mag, REL_TOL)
        del got, again, want, mag
        shapes = [(hi - lo, w) for lo, hi, w in prep.stair]
        ms = cuda_ms(lambda: core_dot.core_bands_scatter_add(
            bands, xc, cn, prep.stair, z, plans=plans))
        plain_ms = cuda_ms(lambda: core_dot.core_bands_plain(
            bands, xc, cn, prep.stair, z), iters=5)
        xws = [xc[:w].contiguous() for _r, w in shapes]

        def library():
            for a, bb in zip(bands, xws):
                torch.matmul(a, bb)

        library_ms = cuda_ms(library)
        bound_ms, bound_by = core_bound(shapes, h, pk, 2.0)
        counts = core_dot.max_clusters(dev, core_dot.BF16)
        res[name] = dict(
            shapes=shapes, max_abs_err=e, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            tflops=sum(2 * r * w * h for r, w in shapes) / ms * 1e-9,
            split=[p.split for p in plans], grid=[p.grid for p in plans],
            schedule_balance=core_dot.schedule_balance(
                prep.stair, h, counts, cell_bytes=2.0))
        del xws, z, plans
        torch.cuda.empty_cache()
    results["K-core bf16"] = dict(res["bf16 square"], ragged_max_abs_err=err,
                                  stair=res["bf16 stair"])

    # K-f32, ragged: every cell type and payload on both routes (3xTF32 on
    # f32 cells, limbs on bf16 cells), widths on TMA's rule, odd and even H,
    # an out whose rows are not 8-byte aligned (the element-wise epilogue)
    err = 0.0
    ranges = {torch.int8: 1 << 7, torch.int16: 1 << 15, torch.int32: 1 << 19}
    n0 = launch_totals(core_f32)
    for cell in (torch.float32, torch.bfloat16):
        q = core_f32.TC_WIDTH[cell]
        for pdt in (torch.float32, torch.bfloat16, torch.int8, torch.int16,
                    torch.int32):
            for r, w, hh, unaligned in (
                    (37, 50 * q, 41, False), (300, 1280, 256, False),
                    (129, 129 * q, 1100, False), (37, 200, 42, False),
                    (129, 520, 1102, False), (200, 4104, 8, False),
                    (129, 65 * q, 40, True)):
                band = torch.randn(r, w, generator=g).to(dev, cell)
                if pdt in ranges:
                    m = ranges[pdt]
                    xc = torch.randint(-m, m, (w + 3, hh), generator=g)
                else:
                    xc = torch.randn(w + 3, hh, generator=g)
                xc = xc.to(dev, pdt)
                rows = torch.randperm(3 * r, generator=g)[:r].to(dev,
                                                                 torch.int32)
                out0 = torch.randn(3 * r, hh, generator=g).to(dev)
                stair = [(0, r, w)]
                got = core_f32.core_f32_scatter_add(
                    [band], xc, rows, stair,
                    off_aligned(out0) if unaligned else out0.clone())
                want = core_f32.core_f32_plain([band], xc, rows, stair,
                                               out0.clone())
                mag = out0.abs().index_add(
                    0, rows, band.float().abs() @ xc[:w].float().abs())
                err = max(err, check_close(
                    f"K-f32 ragged {cell} x {pdt} {(r, w, hh)}"
                    f"{' unaligned' if unaligned else ''}", got, want, mag,
                    REL_TOL))
    n = launch_totals(core_f32)
    if not all(n[k] > n0[k] for k in n):
        raise AssertionError(f"K-f32 ragged: a route never ran ({n0} -> {n})")
    band = torch.randn(37, 203, generator=g).to(dev)
    try:
        core_f32.core_f32_scatter_add(
            [band], torch.randn(203, 41, device=dev),
            torch.arange(37, dtype=torch.int32, device=dev), [(0, 37, 203)],
            torch.zeros(37, 41, device=dev))
    except ValueError as e:
        print(f"K-f32, width 203: raises ({e})", flush=True)
    else:
        raise AssertionError("K-f32 took an f32 band of width 203")
    # the bf16 stair's bands, one launch, an int32 payload
    prep = preps["bf16 stair"]
    bands, cn = bands_of(prep), prep.dev_arrays["core_nodes"]
    w_max = max(w for *_, w in prep.stair)
    xq = torch.randint(-(1 << 19), 1 << 19, (w_max, h), generator=g,
                       dtype=torch.int32).to(dev)
    z = torch.zeros_like(x)
    got = core_f32.core_f32_scatter_add(bands, xq, cn, prep.stair, z.clone())
    want = core_f32.core_f32_plain(bands, xq, cn, prep.stair, z.clone())
    mag = core_f32.core_f32_plain([b.abs() for b in bands], xq.abs(), cn,
                                  prep.stair, z.clone())
    err = max(err, check_close("K-f32 bf16 stair, int32 payload", got, want,
                               mag, REL_TOL))
    del got, want, mag
    limb_sweep(dev, results)
    # timed: the f32 square with an f32 payload (3xTF32), the bf16 square
    # with the int32 forward's payload range (limbs), and the f32 square at
    # H 41 (a 41-class GCN's second aggregate: odd H)
    res = {}
    for name, key, xdt, hh in (("f32 square", "f32 square", torch.float32, h),
                               ("bf16 square", "bf16 square", torch.int32, h),
                               ("f32 square, H 41", "f32 square",
                                torch.float32, 41)):
        prep = preps[key]
        bands, cn = bands_of(prep), prep.dev_arrays["core_nodes"]
        (lo, hi, w), = prep.stair
        if xdt == torch.int32:
            xc = torch.randint(-(1 << 19), 1 << 19, (w, hh), generator=g,
                               dtype=torch.int32).to(dev)
        else:
            xc = torch.nn.functional.pad(
                x[:, :hh].index_select(0, cn[:w]),
                (0, 0, 0, w - min(w, cn.numel()))).contiguous()
        z = torch.zeros(x.shape[0], hh, device=dev)
        plans = core_f32.core_f32_plans(bands, prep.stair, hh)
        got = core_f32.core_f32_scatter_add(bands, xc, cn, prep.stair,
                                            z.clone(), plans=plans)
        want = core_f32.core_f32_plain(bands, xc, cn, prep.stair, z.clone())
        mag = core_f32.core_f32_plain([b.abs() for b in bands], xc.abs(), cn,
                                      prep.stair, z.clone())
        e = check_close(f"K-f32 {name}, {xdt} payload", got, want, mag,
                        REL_TOL)
        del got, want, mag
        ms = cuda_ms(lambda: core_f32.core_f32_scatter_add(
            bands, xc, cn, prep.stair, z, plans=plans), iters=10)
        plain_ms = cuda_ms(lambda: core_f32.core_f32_plain(
            bands, xc, cn, prep.stair, z), iters=5)
        # the yardstick: torch.matmul in f32 (TF32 off) and index_add_, on
        # operands widened to f32 beforehand
        a32, x32 = bands[0].float(), xc[:w].float()
        rows = cn[lo:hi]
        library_ms = cuda_ms(lambda: z.index_add_(0, rows, torch.matmul(
            a32, x32)), iters=10)
        del a32, x32
        cell = bands[0].element_size()
        products = core_f32.n_products(bands[0].dtype, xdt)
        bound_ms, bound_by = f32_bound([(hi - lo, w)], hh, pk, cell,
                                       xc.element_size(), products)
        ffma_ms, _ = f32_bound([(hi - lo, w)], hh, pk, cell,
                               xc.element_size(), None)
        ops = 2 * (hi - lo) * w * hh
        res[name] = dict(shape=[hi - lo, w, hh], payload=str(xdt),
                         products=products, max_abs_err=e, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         ffma_bound_ms=ffma_ms, tflops=ops / ms * 1e-9,
                         share_of_bound=bound_ms / ms)
        del z, xc, plans
        torch.cuda.empty_cache()
    results["K-f32"] = dict(res["f32 square"], ragged_max_abs_err=err,
                            h41=res["f32 square, H 41"])
    results["K-f32 limbs"] = dict(res["bf16 square"], ragged_max_abs_err=err,
                                  sweep=results.pop("limb sweep"))

    # K-tail's bf16 rows: ragged tables, then the bf16 square's tables
    n, host = ragged_tables()
    tables = tail_to(host, dev)
    plan = ell_tail.tail_plan(tables)
    for hh, unaligned in ((36, False), (41, False), (256, False),
                          (1104, False), (256, True)):
        xs = torch.randn(n, hh, generator=g).to(dev, torch.bfloat16)
        out0 = torch.randn(n, hh, generator=g).to(dev)
        if unaligned:
            xs = off_aligned(xs)
            got = ell_tail.ell_tables_add(xs, tables, off_aligned(out0),
                                          plan=plan)
        else:
            got = ell_tail.ell_tables_add(xs, tables, out0.clone(), plan=plan)
        tail_close(f"K-tail bf16 ragged H={hh}"
                   f"{' unaligned' if unaligned else ''}", xs, tables, got,
                   out0)
    prep = preps["bf16 square"]
    tables = prep.ell_tables(prep.dev_arrays)
    plan = ell_tail.tail_plan(tables)
    xb = x.to(torch.bfloat16)
    z = torch.zeros_like(x)
    got = ell_tail.ell_tables_add(xb, tables, z.clone(), plan=plan)
    e = tail_close("K-tail bf16 rows, bf16 square's tables", xb, tables, got,
                   z)
    del got
    ms = cuda_ms(lambda: ell_tail.ell_tables_add(xb, tables, z, plan=plan))
    plain_ms = cuda_ms(lambda: ell_tail.ell_tables_plain(xb, tables, z),
                       iters=5)
    bound, (rows_t, cols_t, vals_t) = tail_bound(tables, h, pk, itemsize=2)
    a = torch.sparse_coo_tensor(torch.stack([rows_t, cols_t]), vals_t,
                                (x.shape[0],) * 2).coalesce().to_sparse_csr()
    xw = xb.float()  # cuSPARSE on the rows widened beforehand
    library_ms = cuda_ms(lambda: torch.sparse.mm(a, xw))
    results["K-tail bf16"] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, **bound)
    del xw, a, z


# The float cores' main paths, each driven with the launch counts at 0
# just before it and read just after: (name, operand, [(runner, dtype,
# width)], the kernels it must launch). The runners are
# run_inference_benchmark (agg_dtype; 2-layer GCN at HIDDEN) and
# run_spmm_benchmark (payload dtype, at the width given). A SpMM at H 41
# (reddit's class count: a 2-layer GCN's second aggregate) on the f32
# square runs K-f32 at an odd H
FLOAT_PATHS = (
    ("bf16 stair, float", "bf16 stair",
     (("infer", None, HIDDEN), ("spmm", "float32", HIDDEN)),
     ("K-core bf16", "K-tail")),
    ("bf16 square, float", "bf16 square",
     (("infer", None, HIDDEN), ("spmm", "float32", HIDDEN)),
     ("K-core bf16", "K-tail")),
    ("bf16 square, int32", "bf16 square",
     (("infer", "int32", HIDDEN), ("spmm", "int32", HIDDEN)),
     ("K-f32 limbs", "K-tail-quant")),
    ("bf16 square, int8", "bf16 square",
     (("infer", "int8", HIDDEN),), ("K-core bf16", "K-tail-quant")),
    ("f32 square, float", "f32 square",
     (("infer", None, HIDDEN), ("spmm", "float32", HIDDEN)),
     ("K-f32", "K-tail")),
    ("f32 square, H 41", "f32 square",
     (("spmm", "float32", 41),), ("K-f32", "K-tail")),
    ("bf16 payload, stair int8", "stair int8",
     (("spmm", "bfloat16", HIDDEN),), ("K-core", "K-tail bf16")),
    ("bf16 payload, bf16 square", "bf16 square",
     (("spmm", "bfloat16", HIDDEN),), ("K-core bf16", "K-tail bf16")),
    ("int64 payload, bf16 square", "bf16 square",
     (("spmm", "int64", HIDDEN),), ("K-f32 limbs", "K-tail-quant")),
)
# the path whose count each new kernel's ``launches`` reports
FLOAT_PATH_OF = {"K-core bf16": "bf16 square, float",
                 "K-f32": "f32 square, float",
                 "K-f32 limbs": "bf16 square, int32",
                 "K-tail bf16": "bf16 payload, bf16 square"}


def float_core_paths(ds, preps, results, device="cuda"):
    """The float cores' main paths (FLOAT_PATHS) through the runners:
    2-layer GCN forwards at hidden 256 and SpMMs with their sampled-row
    check; every listed kernel must launch, every check pass. Then each
    forward's logits and each float SpMM against the plain versions
    (``logits_check``; the SpMM within REL_TOL of the sum of |terms|).
    Returns each path's launches."""
    import torch

    from pygim_tpu_torch.bench.runners import (
        run_inference_benchmark,
        run_spmm_benchmark,
    )
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.utils.metrics import DataReporter

    rep = DataReporter(echo=True)
    out = {}
    for name, key, runs, kernels in FLOAT_PATHS:
        prep = preps[key]
        reuse = lambda g, c, p=prep: p  # noqa: E731
        reset_launch_counts()
        for runner, dtype, width in runs:
            if runner == "infer":
                run_inference_benchmark(
                    ds, model="gcn", num_layers=2, hidden=width,
                    agg_dtype=dtype, config=prep.config, repeat=10,
                    reporter=rep, prepare_fn=reuse, device=device)
            else:
                run_spmm_benchmark(ds, hidden=width, dtype=dtype,
                                   config=prep.config, repeat=10,
                                   reporter=rep, prepare_fn=reuse,
                                   device=device)
                if rep.records["verify"][-1] != "OK":
                    raise AssertionError(f"{name}: {dtype} SpMM check failed")
        sync(device)
        n = launch_counts()
        print(f"main-path launches, {name}: {n}", flush=True)
        if any(n[k] <= 0 for k in kernels):
            raise AssertionError(f"{name}: launches {n}, want {kernels}")
        out[name] = n
    xf = torch.as_tensor(ds.x).to(device)
    x = torch.randn(ds.graph.nrows, HIDDEN,
                    generator=torch.Generator().manual_seed(12)).to(device)
    errs = {}
    for key, agg_dtypes in (("bf16 stair", (None,)),
                            ("bf16 square", (None, "int32", "int8")),
                            ("f32 square", (None,))):
        prep = preps[key]
        errs[f"{key} SpMM"] = check_close(
            f"{key} float SpMM vs plain", prep.mul(x), prep.mul_plain(x),
            product_mag(prep, x), REL_TOL)
        for agg_dtype in agg_dtypes:
            gnn = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                           num_layers=2, agg_dtype=agg_dtype, device=device)
            logits_check(f"{agg_dtype or 'float'} {key}", gnn, xf, prep,
                         ds.num_classes)
    results["float paths"] = dict(launches=out, spmm_err=errs)
    return out


def float_core_training(ds, preps, results, card):
    """One GCN training step at hidden 256 on the bf16 and f32 square
    cores, the aggregate's backward on each operand's prepared Aᵀ (K-core's
    bf16 mode or K-f32, and K-tail): every leaf's gradient within GRAD_BAR
    of autograd through ``mul_plain`` on A (``train_steps``' check), both
    negative controls off by more, and the core's kernel launched in the
    step."""
    import torch

    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts

    out = {}
    for key, kernel in (("bf16 square", "K-core bf16"),
                        ("f32 square", "K-f32")):
        prep = preps[key]
        t0 = time.perf_counter()
        prep.transpose(ds.graph)
        secs = time.perf_counter() - t0
        inputs = train_inputs(ds, prep.device)
        arms = training_arms(prep)
        grads, n = {}, None
        for a in ("kernels", "plain", *CONTROLS):
            reset_launch_counts()
            grads[a] = leaf_grads("gcn", ds, arms[a], inputs)
            sync(prep.device)
            if a == "kernels":
                n = launch_counts()
        errs = {a: max(leaf_errs(g, grads["plain"]).values())
                for a, g in grads.items() if a != "plain"}
        print(f"training, gcn step on the {key} core (Aᵀ prepared in "
              f"{secs:.1f} s): max leaf gradient err against the plain "
              f"versions {errs}; kernels' launches {n} ({card})", flush=True)
        if errs["kernels"] > GRAD_BAR or n[kernel] < 2 or n["K-tail"] < 2:
            raise AssertionError(f"{key} training step: gradients "
                                 f"{errs['kernels']} (bar {GRAD_BAR}), "
                                 f"launches {n}")
        for c in CONTROLS:
            if errs[c] <= GRAD_BAR:
                raise AssertionError(f"{key}: the {c} control passed "
                                     f"({errs[c]})")
        out[key] = dict(grad_err=errs, launches=n)
        del grads
        torch.cuda.empty_cache()
    results["float core training"] = out


def float_core_entry(results, card, timeout: int = 300, device="cuda"):
    """``train_cuda.py --backend hybrid`` (its default core: square f32
    at 4 GiB, k 20,000 on TRAIN_GRAPH) for 10 epochs at hidden 256, in a
    process of its own: the loss falls and the test accuracy passes 0.55.
    Then ``run_training_benchmark`` of the GCN on the bf16 square core
    at the smoke budget against the oracle arm (``acc_tol`` 0.03, the
    reference's for a bf16 core)."""
    from pygim_tpu_torch.bench.runners import run_training_benchmark
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.utils.metrics import DataReporter, parse_data_lines

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "train_cuda.py", "--dataset", TRAIN_GRAPH,
         "--epochs", "10", "--backend", "hybrid"], capture_output=True,
        text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    tail = (res.stdout + res.stderr)[-3000:]
    if res.returncode != 0:
        raise AssertionError(f"train_cuda.py --backend hybrid: exit "
                             f"{res.returncode}\n{tail}")
    got = parse_data_lines(res.stdout.splitlines())
    keys = ("epoch", "train_loss", "test_acc", "train_time(ms)", "device")
    if any(k not in got for k in keys) or got["epoch"] != [0.0, 9.0] \
            or not got["train_loss"][-1] < got["train_loss"][0] \
            or not got["test_acc"][-1] > 0.55:
        raise AssertionError(f"train_cuda.py --backend hybrid: {got}\n{tail}")
    out = {"train_cuda hybrid": {k: got[k] for k in keys}}
    print(f"training, train_cuda.py --backend hybrid ({secs:.1f} s): "
          f"{out['train_cuda hybrid']} ({card})", flush=True)
    ds = load_dataset(TRAIN_GRAPH)
    cfg = float_core_configs()["bf16 square"]
    reset_launch_counts()
    means = run_training_benchmark(ds, model="gcn", hidden=HIDDEN, config=cfg,
                                   epochs=TRAIN_EPOCHS, acc_tol=0.03,
                                   reporter=DataReporter(), device=device)
    n = launch_counts()
    if means["acc_delta"] > 0.03 or means["validate"] != "OK" \
            or n["K-core bf16"] <= 0 or n["K-tail"] <= 0:
        raise AssertionError(f"run_training_benchmark gcn on bf16 square: "
                             f"{means} launches {n}")
    keep = ("train_time(ms)", "first_epoch_time(ms)", "epoch_time(ms)",
            "forward_ms", "backward_ms", "adam_ms", "train_loss", "test_acc",
            "oracle_test_acc", "acc_delta", "validate", "operand_bytes",
            "transpose_bytes")
    out["gcn bf16 square"] = {k: means[k] for k in keep}
    print(f"training, run_training_benchmark gcn on bf16 square, "
          f"{TRAIN_EPOCHS} epochs: {out['gcn bf16 square']}, launches {n} "
          f"({card})", flush=True)
    results["float core entry"] = out


def main() -> int:
    """Run every phase in a fresh prepare and dataset cache, removed at
    the end: no phase reads the user's cache."""
    root = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["PYGIM_TPU_TORCH_DATA"] = root
    try:
        if "--train-sweep" in sys.argv[1:]:
            return train_sweep()
        return run()
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from pygim_tpu_torch.bench.runners import (
        run_inference_benchmark,
        run_spmm_benchmark,
    )
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops import (
        _build,
        launch_counts,
        reset_launch_counts,
    )
    from pygim_tpu_torch.ops.spmm import (
        PreparedAggregate,
        SpmmConfig,
        prepare_spmm,
    )
    from pygim_tpu_torch.utils.metrics import DataReporter

    from pygim_tpu_torch.utils.device import card_line, peaks

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    results = {"peaks": peaks(name)}

    t0 = time.perf_counter()
    took = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s {took}", flush=True)
    for n in _build.SIGNATURES:
        log = _build.BUILD_DIR / f"{n}.log"
        if log.exists():
            kernel = ""  # the entry function the next lines describe
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    symbol = line.split("'")[1]
                    m = re.search(r"[a-z][a-z_]*_kernel", symbol)
                    kernel = symbol[m.start() if m else 0:][:40]
                elif ("registers" in line or "spill" in line
                      or "serialized" in line):
                    print(f"ptxas {n} {kernel}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    ds = load_dataset(DATASET)
    cfg = SpmmConfig(backend="hybrid", hybrid_shape="stair",
                     hybrid_dtype="int8", hybrid_core_bytes=CORE_BYTES)
    prep = prepare_spmm(ds.graph, cfg, device="cuda")
    print(f"prepare: {time.perf_counter() - t0:.1f} s  N={prep.nrows} "
          f"stored={ds.graph.nnz} merged={prep.nnz} bands={prep.stair} "
          f"tables={prep.ell_meta}", flush=True)

    t0 = time.perf_counter()
    cfg4 = SpmmConfig(backend="hybrid", hybrid_shape="square",
                      hybrid_dtype="int4", hybrid_core_bytes=CORE_BYTES)
    prep4 = prepare_spmm(ds.graph, cfg4, device="cuda")
    print(f"prepare, square int4: {time.perf_counter() - t0:.1f} s  "
          f"k={prep4.hybrid_k_eff} bands={prep4.stair} "
          f"tables={prep4.ell_meta}", flush=True)
    fpreps = {}
    for key, fcfg in float_core_configs().items():
        t0 = time.perf_counter()
        fpreps[key] = prepare_spmm(ds.graph, fcfg, device="cuda")
        fp = fpreps[key]
        print(f"prepare, {key}: {time.perf_counter() - t0:.1f} s  "
              f"core {fp.core_dtype} k={fp.hybrid_k_eff} bands={fp.stair} "
              f"({fp.device_bytes} bytes) tables={fp.ell_meta}", flush=True)

    x = torch.randn(prep.nrows, HIDDEN,
                    generator=torch.Generator().manual_seed(0)).cuda()
    core_checks(prep, x, results)
    for k in ("K-core widest band", "K-core scale band", "K-core"):
        print(f"{k}: {results[k]}", flush=True)
    int_checks(prep, x, results)
    for k in ("K-int", "K-int scale band"):
        print(f"{k}: {results[k]}", flush=True)
    int4_checks(prep4, x, results)
    for k in ("K-core int4", "K-int int4", "int4 scale band"):
        print(f"{k}: {results[k]}", flush=True)
    split_checks(x.device, results)
    print(f"split checks: {results['split checks']} cases held", flush=True)
    tail_checks(prep, x, results)
    print(f"K-tail: {results['K-tail']}", flush=True)
    tail_quant_checks(prep, x, results)
    print(f"K-tail-quant: {results['K-tail-quant']}", flush=True)
    float_core_checks(fpreps, x, results)
    for k in ("K-core bf16", "K-f32", "K-f32 limbs", "K-tail bf16"):
        print(f"{k}: {results[k]}", flush=True)
    xf = torch.as_tensor(ds.x).cuda()
    gnns = {agg_dtype: make_gnn(0, "gcn", ds.x.shape[1], HIDDEN,
                                ds.num_classes, num_layers=2,
                                agg_dtype=agg_dtype, device="cuda")
            for agg_dtype in (None, "int32")}
    layer_safes = forward_safes(gnns["int32"], xf, prep)
    if len(layer_safes) != 2:
        raise AssertionError(f"the int32 forward rounded {len(layer_safes)} "
                             "aggregates, not 2")
    tail_quant_sweep(x, results, layer_safes)
    del x
    torch.cuda.empty_cache()
    mul_any_width(prep, results)
    print(f"mul any width, max abs err: {results['mul any width']}", flush=True)
    tail_scale(results, torch.device("cuda"))
    for k in ("K-tail scale tables", "K-tail-quant scale tables"):
        print(f"{k}: {results[k]}", flush=True)

    # the main paths, each counted: float aggregation, then int32
    # aggregation (the reference's default) with the int32 SpMM
    rep = DataReporter(echo=True)
    reuse = lambda g, c: prep  # noqa: E731 — the operand prepared above
    launches = {}
    for agg_dtype, spmm_dtype, kernels in (
            (None, "float32", ("K-core", "K-tail")),
            ("int32", "int32", ("K-int", "K-tail-quant"))):
        reset_launch_counts()
        run_inference_benchmark(
            ds, model="gcn", num_layers=2, hidden=HIDDEN, agg_dtype=agg_dtype,
            config=cfg, repeat=10, reporter=rep, prepare_fn=reuse,
            device="cuda",
        )
        run_spmm_benchmark(
            ds, hidden=HIDDEN, dtype=spmm_dtype, config=cfg, repeat=10,
            reporter=rep, prepare_fn=reuse, device="cuda",
        )
        torch.cuda.synchronize()
        n = launch_counts()
        print(f"main-path launches, {agg_dtype or 'float'} aggregation: "
              f"{n}", flush=True)
        for k in kernels:
            if n[k] <= 0:
                raise AssertionError(f"{k} was never launched on the "
                                     f"{agg_dtype or 'float'} main path")
            launches[k] = n[k]
        if rep.records["verify"][-1] != "OK":
            raise AssertionError(f"{spmm_dtype} SpMM sampled-row check failed")

    # the third main path: config 4's model, the int8 GCN, on a square
    # int4 core, validated per layer, and a float32 SpMM on the same
    # operand
    reuse4 = lambda g, c: prep4  # noqa: E731
    reset_launch_counts()
    run_inference_benchmark(
        ds, model="gcn", num_layers=2, hidden=HIDDEN, agg_dtype="int8",
        config=cfg4, repeat=10, reporter=rep, prepare_fn=reuse4,
        validate=True, device="cuda",
    )
    torch.cuda.synchronize()
    n_gcn = launch_counts()
    run_spmm_benchmark(
        ds, hidden=HIDDEN, dtype="float32", config=cfg4, repeat=10,
        reporter=rep, prepare_fn=reuse4, device="cuda",
    )
    torch.cuda.synchronize()
    n = launch_counts()
    print(f"main-path launches, int8 aggregation on the square int4 core: "
          f"{n_gcn}; with the float32 SpMM: {n}", flush=True)
    for k, got in (("K-int int4", n_gcn["K-int int4"]),
                   ("K-tail-quant", n_gcn["K-tail-quant"]),
                   ("K-core int4", n["K-core int4"] - n_gcn["K-core int4"])):
        if got <= 0:
            raise AssertionError(f"{k} was never launched on the square int4 "
                                 "main path")
    launches["K-int int4"] = n_gcn["K-int int4"]
    launches["K-core int4"] = n["K-core int4"] - n_gcn["K-core int4"]
    if rep.records["validate"][-1] != "OK":
        raise AssertionError("int8 GCN per-layer validation failed")
    if rep.records["verify"][-1] != "OK":
        raise AssertionError("square int4 SpMM sampled-row check failed")
    print(f"square int4 path: validate {rep.records['validate'][-1]}, "
          f"agg0/agg1 max rel err {rep.records['agg0_max_rel_err'][-1]} / "
          f"{rep.records['agg1_max_rel_err'][-1]}", flush=True)

    # the runners' default configuration: the blocked backend
    t0 = time.perf_counter()
    run_spmm_benchmark(ds, hidden=HIDDEN, repeat=3, reporter=rep,
                       device="cuda")
    if rep.records["verify"][-1] != "OK":
        raise AssertionError("blocked (default config) SpMM check failed")
    bound = blocked_bound(prepare_spmm(ds.graph, SpmmConfig(),
                                       device="cuda"), HIDDEN,
                          results["peaks"])
    print(f"blocked backend (config=None): verify OK, "
          f"{rep.records['pim_time_spmm(ms)'][-1]:.4f} ms a SpMM "
          f"({time.perf_counter() - t0:.1f} s); bound {bound}", flush=True)

    for agg_dtype, gnn in gnns.items():
        logits_check(agg_dtype or "float", gnn, xf, prep, ds.num_classes)
    gnn8 = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                    num_layers=2, agg_dtype="int8", device="cuda")
    logits_check("int8 square-int4", gnn8, xf, prep4, ds.num_classes)
    del gnn8, prep4
    torch.cuda.empty_cache()

    # this slice's main paths: the bf16 and f32 cores, the bf16 and int64
    # payloads
    float_launches = float_core_paths(ds, {**fpreps, "stair int8": prep},
                                      results)
    for k, path in FLOAT_PATH_OF.items():
        launches[k] = float_launches[path][k]

    entry_check()

    # this slice's paths: the ell and oracle backends, phase_times, the
    # prepare cache, and the entry scripts
    x = torch.randn(prep.nrows, HIDDEN,
                    generator=torch.Generator().manual_seed(4)).cuda()
    ell = ell_backend(ds.graph, x, results)
    print(f"ell backend, max abs err: {results['ell backend']}", flush=True)
    oracle_backend(ds.graph, x, prep, ds, results)
    print(f"oracle backend: {results['oracle backend']}", flush=True)
    phase_times({"hybrid": prep, "ell": ell}, x, results)
    del ell
    caches(ds.graph, cfg, x, results)
    del x
    torch.cuda.empty_cache()
    entry_points(results)

    # the training path: the backward product on the prepared Aᵀ, real
    # steps of each conv, then train_cuda.py and run_training_benchmark
    backward_product(prep, ds.graph, results, card)
    train_steps(ds, prep, results, card)
    training_entry(results, card)
    training = results["train steps"]["gcn step"]["launches"]
    float_core_training(ds, fpreps, results, card)
    float_core_entry(results, card)
    del fpreps

    if "--profile" in sys.argv[1:]:
        from pygim_tpu_torch.bench.report import profile_forward

        for agg_dtype, gnn in gnns.items():
            print(f"profile: {agg_dtype or 'float'} aggregation", flush=True)
            profile_forward(gnn, xf, PreparedAggregate(prep))
        profile_train_step(ds, prep)

    sources = {"K-core": ("cuda", "pygim_tpu_torch/csrc/core_dot.cu",
                          "pygim_tpu/ops/pallas_core.py:55"),
               "K-tail": ("cuda", "pygim_tpu_torch/csrc/ell_tail.cu",
                          "pygim_tpu/ops/spmm.py:481"),
               "K-int": ("cuda", "pygim_tpu_torch/csrc/core_int.cu",
                         "pygim_tpu/ops/spmm.py:520"),
               "K-tail-quant": ("cuda", "pygim_tpu_torch/csrc/ell_tail.cu",
                                "pygim_tpu/ops/spmm.py:452"),
               "K-core int4": ("cuda", "pygim_tpu_torch/csrc/core_dot.cu",
                               "pygim_tpu/ops/spmm.py:586"),
               "K-int int4": ("cuda", "pygim_tpu_torch/csrc/core_int.cu",
                              "pygim_tpu/ops/spmm.py:538"),
               "K-core bf16": ("cuda", "pygim_tpu_torch/csrc/core_dot.cu",
                               "pygim_tpu/ops/spmm.py:630"),
               "K-f32": ("cuda", "pygim_tpu_torch/csrc/core_f32.cu",
                         "pygim_tpu/ops/spmm.py:630"),
               "K-f32 limbs": ("cuda", "pygim_tpu_torch/csrc/core_f32.cu",
                               "pygim_tpu/ops/spmm.py:615"),
               "K-tail bf16": ("cuda", "pygim_tpu_torch/csrc/ell_tail.cu",
                               "pygim_tpu/ops/spmm.py:481")}
    kernels = []
    for k, (route, src, repl) in sources.items():
        res = results[k]
        kernels.append({
            "name": k, "route": route, "source": src, "replaces": repl,
            "launches": launches[k], "max_abs_err": res["max_abs_err"],
            "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["library_ms"],
            "schedule_balance": res.get("schedule_balance"),
            "split": res.get("split"),
            "train_step_launches": {
                part: training[part][k] for part in ("forward", "backward")
            } if k in ("K-core", "K-tail") else None,
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
