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
schedules, whole tiles and stream-K, forced. K-epi (the evaluation
forward's dequantize, bias, BatchNorm and ReLU in one pass) and K-quant
(max|x| with the scale, the integer table, K-int's limb payload written
from x) bit-equal to their plain versions at the smoke shape and at
ragged and misaligned ones, with NaN, ±inf, -0, all-zero inputs and
half-step ties, timed beside their bounds and a library call, and
counted in one fused forward of each main path's model (the
``epilogue_checks`` phase). It checks
``prep.mul`` against ``mul_plain`` at widths the kernels' tiles do not
divide, then drives the three main paths, each with the launch counts
set to 0 before it and read after it — 2-layer GCN inference at hidden
256, on the ogbn-arxiv stand-in, through ``run_inference_benchmark`` and
``run_spmm_benchmark`` — on the stair-int8 hybrid first with a float
payload (K-core, K-tail, K-epi), then with int32 aggregation and an int32
SpMM (K-int, K-tail-quant, K-epi, K-quant's max|x| and payload), then
tracked config 4's model, the int8 GCN, on a square int4 core with
per-layer sampled validation (K-int int4, K-tail-quant, K-epi, all three
of K-quant's entry points) and a float32 SpMM on it (K-core int4). It runs
the SpMM and the float and int32 forwards on the runners' default
configuration (the blocked backend: K-rows, K-epi, K-quant's max|x| and
table), holds the
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

Then the harness: ``run_experiments`` on the card over the small sweep
(tiny and small × blocked and ell × nnz and row), the stair int8 SpMM
with its phases on the stand-in and on its ``-uniq`` sibling, the int32
GCN with its per-layer check on the same core, a ``scaling`` point, and
training and spmm points on a mesh of more cards than are visible (each
leaves its ``.failed`` record with ``make_mesh``'s ``ValueError``), its launch counts set to 0 before it and read after it
(K-core, K-tail, K-int and K-tail-quant); a second sweep that skips
everything and launches nothing; ``results_to_csv``; the refusal of a
directory holding a copy of a TPU record; ``sweep_cuda.py run --baseline
--dry_run`` and ``sweep_cuda.py parse`` as processes. Then every
operand the harness ran a kernel on (the two stair cores, the sweep's
ell operands), prepared again, its product through the kernels held to
the plain versions on all rows. Then the real-format path: the stand-in written in OGB's raw layout, read back
through ``load_dataset``'s parsers and held to the stand-in, and the
float GCN on the parsed graph against the plain versions.

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

Then this slice's paths. K-bcsr alone against its plain version on
random tiers: every case, each on its tensor-core route (bf16 tiles
with a float32, bfloat16 or int8 payload or one rounded for int8 as
bf16; int16, int32 and payloads rounded for them as two or three bf16
parts; f32 tiles as 3xTF32) in both layouts at ragged tile rows (8 to
64) and widths (8 to 1100), with an ``out`` at an odd offset, bit-equal
on integer cells and payloads, on a single-tile tier, two launches
against each other, a NaN read by a pad on every float route, a hub panel that
its work plan splits into items, a row-kind tier that the plan reorders
panel-major, and the shapes it refuses. The three-tier hybrid on ``brmat-200000-4000000-256`` (a square
core at 64 MiB, tiles at 256 MiB: int8 core with bf16 tiles, Tr 16 panel
lp, Tr 16 row rcm, Tr 8 row rank; an f32 core with f32 tiles, Tr 16
panel lp), each counted, ``mul`` on five payloads and ``mul_quantized``
at int8 (bit-equal), int16 and int32 against the plain versions, with
``bcsr_time``, the captured edges and K-bcsr timed against its bound and
``torch.sparse.mm`` beside its plan's items, panels staged, adds, bands
and modelled bytes, and each of its other routes likewise, with its
launches on the counted products. A 1 GiB random tier at 2,000,000 nodes, both
layouts, timed the same way. The ``coo`` backend on the stand-in (a
float32 SpMM, the float GCN against the oracle backend's, GIN and SAGE
through ``run_experiments`` with ``validate``) and SDDMM against a
float64 dot, each timed beside a bytes bound and its library call
(``torch.sparse.mm`` on the same CSR, which the blocked backend's row
shares; ``torch.sparse.sampled_addmm`` on the same pattern). After the training path, one GCN step through a hybrid with
a tier, its gradients against the plain versions'.

Then the tuner (the ``tune`` phase, in the script's temporary tune
cache): ``measure_constants`` on the card (every constant finite and
positive, no efficiency above 1.05), the fitted ELL tail beside the
smoke tables' ``tail_time``, tracked config 3 (GIN and SAGE, ``tune=True``)
through ``run_experiments`` with their ``[DATA]device`` and ``tuned_*``
lines and the tuned forwards' logits against the plain versions, an
audit of the model-mode ranking on the stand-in (the top 5 and each
family's best: prepared, timed and held to ``mul_plain`` at the verify
tolerance, predicted against measured ms and bytes; the pick's time at
most 1.20 × the fastest audited) and one ``mode="measure"`` run. Then
the tuner over a budget of four devices (the ``tune mesh`` phase), on a
virtual mesh of the card, ``cuda:0`` four times, which checks every
shard's work and measures no scaling: the port's collectives timed and
fitted (``measure_ici_constants``: every ``bw`` and ``fixed_us`` with
the mesh's tag), the model-mode ranking with
``CardCostModel.for_topology`` (the best candidate of each layout with
its predicted ms, ``psum_bytes``, ``launches`` and ``device_bytes``),
the best 2d and halo candidates and the pick prepared by
``prepare_tuned`` (each product held to its plain version and to the
single card's, an int32 payload equal to both, its kernels counted
beside the statistics' launches, its virtual ms beside the predicted ms
and the card's peak-memory rise beside ``device_bytes``), and the float
passthrough (``mul_quantized(x, "float32")`` on the stair int8, square
int4, bf16 and f32 cores and an int8 core with a BCSR tier, counted, on
the float kernels only, held to its plain version within 1e-4 of the
output's largest magnitude and timed beside the float ``mul``).

Then the core↔tail interleave (the ``interleave`` phase): the
stand-in's square int8 and int4 cores prepared with
``PYGIM_HYBRID_INTERLEAVE`` unset and set; float32 SpMMs and the fused
int8 aggregate through the interleaved operand, each counted, the stream
of every launch read (the core on the operand's second stream, K-tail on
the caller's), held to the serial operand and to the plain versions
(float within REL_TOL of the sum of |terms|, int8 bit-equal), the int32
aggregate kept on one stream; serial and interleaved times, each kernel
alone, the pair's bound, and the interleaved call with the core's grid
capped at a half and a quarter of the resident blocks. Then the 2D mesh
(the ``mesh`` phase): virtual (2, 2), (4, 2) and (1, 8) meshes of the
card, each with ``ell`` and square int8, int4, bf16 and f32 cores at 64
MiB a shard, the (2, 2) one also with a BCSR tier and with
``scatter_output``; every operand multiplies a float32 and an int32
payload, counted (K-tail, K-tail-quant, K-core in each mode, K-int,
K-f32, K-bcsr at shard shapes), held to its plain version and to the
single-card operand of its configuration, and reports ``phase_times``
(``local_time``, ``psum_time``); then the float and int32 GCN forwards
over a (2, 2) mesh of f32 cores against the single-card ones. Then the
halo layout (the ``halo`` phase): virtual node meshes of 2, 4 and 8 on
the card, every exchange (``all_gather``, ``all_to_all``, ``ring``) with
``ell``, the int8, int4, bf16 and f32 slabs and the int8 slab with a
BCSR tier at nd 4 (``ell`` and the int8 slab at nd 2 and 8), and the
``rcm``, ``metis`` and ``auto`` orders at nd 4; every operand multiplies a
float32 and an int32 payload, counted, held to its plain version and to
the single-card operand, with ``phase_times`` and its exchange alone
beside the exchange's bytes bound at nd 4; then
``run_scaling_benchmark`` on ``cuda:0`` four times (``virtual_mesh``).
Then training over the meshes (``mesh train``): a (2, 2) 2D mesh and a
4-way halo, each of ``ell`` and an int8 square core, their transposes
prepared, the GCN's gradients and 3 Adam steps through the kernels held
to the plain versions' while both negative controls fail the gradient
check (the cut control the losses' too). Then
``entry.py:dryrun_multichip(8)``, the twin of ``__graft_entry__``'s.

The blocked and coo backends run K-rows (``csrc/seg_rows.cu``, one
launch over a backend's row-sorted tables). The runners' default path (a
float32 SpMM and the float and int32 GCN forwards with ``config=None``)
and the coo path (its SpMM, the GCN, GIN and SAGE) are counted. The
``rows_checks`` phase holds K-rows against its plain versions on the
stand-in's blocked and coo operands at H 256, 41 and 1100, with
bfloat16 and int32 payloads; on the stand-in's edges with integer
weights, int8, int16, int32 (the sums wrapping) and int64 payloads bit
for bit; on pads that land on a full block's last row and on coo's last
row, with a NaN in x[0]; on a zero-edge operand and a hub of 20,000
entries; and times each mode beside its plain version,
``torch.sparse.mm`` on the same merged CSR and its bound.
``rows_training`` holds one GCN step's gradients on each (the backward
on Aᵀ through K-rows) to the plain versions' while both controls fail,
and ``run_training_benchmark`` trains the GCN with ``config=None``.

The training step's BatchNorm → ReLU → dropout blocks run K-bn
(``csrc/bn_train.cu``: the batch statistics, one normalize–ReLU–dropout
pass with an in-kernel Philox mask, the backward's column sums and dz).
The ``bn_train_checks`` phase holds each kernel to its plain version at
the smoke shape, at N 1037 with H 41 and 256 and on a misaligned copy,
at dropout rates 0, 0.5 and 0.3: the forward and the mask bit for bit
(the forward also with NaN, ±inf and -0 inputs), the statistics (also
over chunk counts with empty chunks) and the backward's sums within 1e-5
of the sum of |terms|, dz within 1e-6 of it given the same sums; times
each beside its bound, its plain version and the library
(``torch.var_mean``; ``F.batch_norm(training=False)`` + ``torch.relu`` +
``F.dropout`` for the forward; the block beside the chain with the
batch's statistics and that chain's backward); holds one training
step's gradients of GCN, GIN and SAGE through K-bn to autograd through
the plain chain within GRAD_BAR while a backward with the ReLU's sign
dropped fails it; and counts one GCN step, each kernel three times. The
training checks' plain arms take the plain chain (:func:`bn_block`), and
the GCN step's split says each K-bn kernel ran three times in its phase.

Its last three lines are the ``kernels`` JSON object (each kernel with
its split and schedule balance where it has a tile schedule, K-core,
K-tail and the K-bn kernels with their launches in one training step,
and every kernel
with its launches in the harness phase), the card's
name and power limit (``nvidia-smi``), and ``{"ok": true, "device":
...}``.
Any failure raises and exits non-zero before those lines. Without a
CUDA card, or without the package beside it, it exits non-zero.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of
one inference forward of each path and of one GCN training step by
kernel, and the device's busy share. ``python3 chip_smoke.py
--train-sweep`` runs only the readings the training checks' bars were
set from (``train_sweep``), and checks nothing. ``python3 chip_smoke.py
--bcsr-full`` holds and times K-bcsr on the full-size three-tier tiers
and prints its time with its plan's bands forced off and on there
(``bcsr_full``; minutes of host prepare where the cache is cold);
``--bcsr-sweep`` prints the same readings on the smoke and random tiers
(``bcsr_band_sweep``): the readings ``ops/bcsr.py:L2_ADD_COST`` and the
plan's choice of bands are checked against. ``--interleave-full`` runs
tracked config 4 at full size with ``PYGIM_HYBRID_INTERLEAVE`` unset and
then set (``interleave_full``); ``--mesh-full`` runs reddit-sim's
2-layer GCN and a float32 SpMM on a (2, 2) virtual mesh of ``ell`` and
on one card (``mesh_full``). Both take minutes of host prepare where
the caches are cold. ``--mesh-cards``, on a machine with four or more
cards, runs the ``mesh`` phase over the cards themselves
(``mesh_cards``); ``--halo-cards`` the ``halo`` phase likewise
(``halo_cards``), and ``--tune-cards`` measure-mode ``autotune`` over
four cards with the ``tune mesh`` audit and the pick within 1.20 × the
fastest audited (``tune_cards``). ``--halo-full`` runs tracked config
5's four entries on a virtual node mesh of eight on one card
(``halo_full``: edges/s and the halo's request and buffer rows; no
scaling measured) and a model-mode ``autotune`` at a budget of eight on
its graph beside them. ``--rows-full`` runs the runners' default
(``blocked`` on K-rows) on reddit-sim: the plan's readings, K-rows
beside ``rows_bound`` and ``torch.sparse.mm``, ``pim_time_spmm`` and
the float and int32 forwards, then the host's µs of each step of a
K-rows wrapper call on a small operand (``rows_full``; minutes of
dataset synthesis and host prepare where the cache is cold).
"""

from __future__ import annotations

import contextlib
import dataclasses
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
        # the hook the evaluation forward takes (``quantized`` asks it too)
        def quantized_raw(self, v, agg_dtype):
            safes.append(float(quant_scale(v, agg_dtype)[1]))
            return super().quantized_raw(v, agg_dtype)

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


def mul_mag(prep, x):
    """The sum of |terms| behind each element of ``prep``'s product with
    ``x`` (f32 sums of |A| |x|): its tail tables and, on a hybrid, its
    core bands."""
    import torch

    from pygim_tpu_torch.ops import ell_tail

    d = prep.dev_arrays
    xa = x.float().abs()
    tables = [(c, v.abs(), r, dg) for c, v, r, dg in prep.ell_tables(d)]
    mag = ell_tail.ell_tables_plain(
        xa, tables, torch.zeros(prep.nrows, x.shape[1], device=x.device))
    if prep.stair:
        cn = d["core_nodes"]
        w_max = max(w for *_, w in prep.stair)
        xc = xa.index_select(0, cn[:w_max])
        xc = torch.nn.functional.pad(xc, (0, 0, 0, w_max - xc.shape[0]))
        for b, (lo, hi, w) in enumerate(prep.stair):
            mag.index_add_(0, cn[lo:hi].long(),
                           d[f"stair{b}"].float().abs() @ xc[:w])
    return mag


def mul_any_width(prep, results, widths=(41, 1100)):
    """``prep.mul`` (K-tail at H, K-core padded to a multiple of 8)
    against ``mul_plain`` (nothing padded) at widths the kernels' tiles
    do not divide."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(7)
    errs = {}
    for h in widths:
        x = torch.randn(prep.ncols, h, generator=g).to(prep.device)
        got = prep.mul(x)
        want = prep.mul_plain(x)
        if got.shape != (prep.nrows, h):
            raise AssertionError(f"mul at H={h}: shape {tuple(got.shape)}")
        errs[h] = check_close(f"mul at H={h}", got, want, mul_mag(prep, x),
                              REL_TOL)
        del x, got, want
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


def plain_bn_block(layer, z, rate, generator, momentum=0.1):
    """The training block through the plain chain, which autograd follows:
    ``batchnorm_train_apply``, ``torch.relu``, ``dropout`` (the mask of
    the same key as K-bn's, from the same generator state)."""
    import torch

    from pygim_tpu_torch.nn.layers import batchnorm_train_apply, dropout

    y, stats = batchnorm_train_apply(layer.scale, layer.bias, layer.mean,
                                     layer.var, z, layer.eps, momentum)
    return dropout(torch.relu(y), rate, generator, True), stats


def no_relu_sign_block(layer, z, rate, generator, momentum=0.1):
    """A negative control: the plain chain whose backward drops the ReLU's
    sign (the forward value is the ReLU's, the gradient passes
    everywhere)."""
    import torch

    from pygim_tpu_torch.nn.layers import batchnorm_train_apply, dropout

    y, stats = batchnorm_train_apply(layer.scale, layer.bias, layer.mean,
                                     layer.var, z, layer.eps, momentum)
    return dropout(y + (torch.relu(y) - y).detach(), rate, generator,
                   True), stats


def plain_block_of(agg):
    """The plain chain for a :class:`PlainAggregate` (the plain arms run
    no kernel), else None (K-bn)."""
    return plain_bn_block if isinstance(agg, PlainAggregate) else None


@contextlib.contextmanager
def bn_block(fn):
    """``with bn_block(fn):`` the training forward's BatchNorm → ReLU →
    dropout blocks run ``fn`` (``nn/models.py``'s
    ``bn_relu_dropout_train``, patched here); None leaves K-bn."""
    from pygim_tpu_torch.nn import models

    saved = models.bn_relu_dropout_train
    if fn is not None:
        models.bn_relu_dropout_train = fn
    try:
        yield
    finally:
        models.bn_relu_dropout_train = saved


def plain_forward(gnn, xf, prep):
    """``gnn``'s evaluation forward through the plain versions alone:
    :class:`PlainAggregate` and each stage as separate PyTorch ops
    (``nn/models.py:forward_stem`` / ``forward_block`` unfused), so no
    kernel runs where the aggregate's hook fuses the quantization."""
    from pygim_tpu_torch.nn.models import forward_block, forward_stem

    agg = PlainAggregate(prep)
    h = forward_stem(gnn, xf, fused=False)
    for i in range(len(gnn.convs)):
        h = forward_block(gnn, i, h, agg, fused=False)
    return gnn.ln2(h)


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
        plain = plain_forward(gnn, xf, prep)
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
    K-tail launch per SpMM (and, for the quantized one, one K-quant
    max|x| and nothing else). Returns the operand."""
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
    # K-tail-quant and K-quant's max|x| ("K-quant" counts it again)
    if (n["K-tail-quant"] != reps or n["K-quant abs_max"] != reps
            or sum(n.values()) != 3 * reps):
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
# bar, set from the readings of ``--train-sweep`` and of the same arms
# over 3 to 10 steps (PERF.md §6, H100). With dropout's masks from
# Philox keys (K-bn), at lr 1e-3 and 3 steps the kernels drift at most
# 1.6e-4 from the plain versions (GIN; 6e-5 GCN, 3e-5 SAGE; six kernel
# runs each) and the cut control 6.4e-3 or more, so the loss check holds
# the kernels and must catch the cut control with a margin of six either
# way. It cannot catch the untransposed control: in 3 steps that drifted
# 3e-5 to 6e-5 (GCN), as little as the kernels, and at 4 and 5 steps the
# kernels' and that control's drifts overlap (kernels up to 1.25e-3 at
# 8 steps, the control 9.7e-4 at 4). The gradient check catches both
# controls: kernels against plain at most 4.6e-3 of a leaf (GIN), the
# controls 0.57 or more
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
# the controls the loss check must catch as well (every control must
# fail the gradient check)
LOSS_CONTROLS = ("cut",)


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


def leaf_grads(conv, ds, agg, inputs, block=None) -> dict:
    """Every parameter's gradient after one training forward (dropout
    0.5, generator seed 0) and backward of the masked loss from the seeded
    initialisation; a leaf no gradient reached has zeros. The BatchNorm
    blocks run ``block`` where given, else the plain chain for a
    :class:`PlainAggregate` and K-bn otherwise (:func:`plain_block_of`)."""
    import torch

    from pygim_tpu_torch.nn.models import gnn_apply, make_gnn
    from pygim_tpu_torch.nn.train import softmax_cross_entropy

    x, labels, mask = inputs
    model = make_gnn(0, conv, ds.x.shape[1], HIDDEN, ds.num_classes,
                     device=x.device)
    with bn_block(block if block is not None else plain_block_of(agg)):
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
    0.5 with generator seeds 0, 1, ...) from the seeded initialisation,
    the BatchNorm blocks as :func:`plain_block_of` says: (model, losses,
    launches)."""
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
    with bn_block(plain_block_of(agg)):
        losses = [float(step(*inputs,
                             torch.Generator(device=dev).manual_seed(e)))
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
      apart: TRAIN_LR and TRAIN_STEPS are the swept rate and steps at
      which the honest runs stay inside the bar and the cut control
      fails it, each by a margin of six;
    * each negative control must fail the gradient check, and the cut
      control the loss check too (LOSS_CONTROLS; in 3 steps an
      untransposed backward can move the losses as little as rounding
      does), so neither check can pass a cut or untransposed backward;
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
            if gerr[c] <= GRAD_BAR or (c in LOSS_CONTROLS
                                       and ldrift[c] <= LOSS_BAR):
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
    for phase, kernels in (("forward", ("K-bn stats", "K-bn fwd")),
                           ("backward", ("K-bn bwd stats", "K-bn bwd"))):
        for k in BN_KERNELS:  # three BatchNorm blocks in a 2-layer step
            want = 3 if k in kernels else 0
            if split.launches[phase][k] != want:
                raise AssertionError(f"gcn step {phase}: {k} launched "
                                     f"{split.launches[phase][k]} times, "
                                     f"want {want}")
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
    hybrid (the smoke configuration), and of the GCN with ``config=None``
    (``blocked``, K-rows): ``acc_delta`` against the oracle arm at most
    0.01 on ``ell`` and ``blocked`` and 0.03 on the hybrid (the
    reference's ``acc_tol`` for a rounded core), ``validate`` OK, and
    each backend's kernels launched in its runs."""
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
    for name, cfg, tol, convs, kernels in (
            ("ell", SpmmConfig(backend="ell"), 0.01, CONVS, ("K-tail",)),
            ("stair int8", hybrid, 0.03, CONVS, ("K-core", "K-tail")),
            ("blocked", None, 0.01, ("gcn",), ("K-rows",))):
        for conv in convs:
            rep = DataReporter()
            reset_launch_counts()
            means = run_training_benchmark(
                ds, model=conv, hidden=HIDDEN, config=cfg,
                epochs=TRAIN_EPOCHS, acc_tol=tol, reporter=rep,
                device=device)
            n = launch_counts()
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


def rows_bound(prep, h, peaks_):
    """Least time of one ``A @ x`` of a blocked or coo operand, one bound
    for both layouts of the same product: the larger of its least bytes
    over HBM (every stored entry that is not a pad, at a column index and
    a weight, as CSR holds it, with a row offset a row; each distinct x
    row those entries read, once; every output row written once, the
    rows without entries too) and its multiply-adds over the f32 rate."""
    import torch

    hbm, _bf16, f32, _int8 = peaks_
    d = prep.dev_arrays
    cols = d["colind"] if prep.config.backend == "blocked" else d["cols"]
    real = d["vals"] != 0
    rows_x = int(torch.unique(cols[real]).numel())
    nnz = int(real.sum())
    nbytes = (nnz * (4 + d["vals"].element_size()) + (prep.nrows + 1) * 4
              + rows_x * h * 4 + prep.nrows * h * 4)
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


# The harness phase: named experiments through the sweep runner into a
# results directory under the temporary cache, on the kernels of the
# stair int8 hybrid (float and int32 payloads) and of ell
HARNESS_KERNELS = ("K-core", "K-tail", "K-int", "K-tail-quant")


def harness_experiments():
    """The sweep (``sweep_space("small")`` at one repeat: tiny and small ×
    blocked and ell × nnz and row balance), the stair int8 SpMM with its
    phases on the stand-in and its ``-uniq`` sibling and the int32 GCN
    with its per-layer check on the same core, a ``scaling`` point (on
    one card a single count, ``edges_per_s_n1``), and two points of two
    cards, training and spmm over a (2, 1) mesh: refused with
    ``make_mesh``'s ``ValueError`` where fewer are visible, as the
    reference's on one chip."""
    from pygim_tpu_torch.bench import Experiment
    from pygim_tpu_torch.bench.configs import sweep_space

    core = dict(backend="hybrid", hidden=HIDDEN, hybrid_shape="stair",
                hybrid_dtype="int8", hybrid_core_bytes=CORE_BYTES)
    sweep = [Experiment(repeat=1, **pt) for pt in sweep_space("small")]
    named = [Experiment(dataset=d, kind="spmm", phases=True, **core)
             for d in (DATASET, DATASET + "-uniq")]
    named.append(Experiment(dataset=DATASET, kind="inference", model="gcn",
                            dtype="int32", validate=True, **core))
    named.append(Experiment(dataset="tiny", kind="scaling", backend="ell",
                            repeat=1))
    refused = [Experiment(dataset="tiny", sp_parts=2, kind="training",
                          backend="ell", repeat=1),
               Experiment(dataset="tiny", sp_parts=2, repeat=1)]
    return sweep, named, refused


def harness(results, device="cuda", timeout: int = 300) -> dict:
    """``run_experiments`` on the card, with the launch counts set to 0
    before it and read after it: every record must hold its ``verify`` or
    ``validate: OK`` (a scaling record its ``edges_per_s_n1``) and one
    ``[DATA]device`` line, K-core, K-tail, K-int and K-tail-quant must
    have launched, and the refused points must have left ``.failed``
    records with their ``ValueError`` while the sweep went on. A second call must skip everything and launch
    nothing; ``results_to_csv`` must give one row per record; a directory
    holding a copy of a TPU record from ``results/`` must be refused; and
    ``sweep_cuda.py run --baseline --dry_run`` and ``sweep_cuda.py parse``
    must run as processes of their own. Returns the launch counts."""
    import csv

    import torch

    from pygim_tpu_torch.bench import results_to_csv, run_experiments
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.utils.metrics import parse_data_lines

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.environ["PYGIM_TPU_TORCH_DATA"]
    rdir = os.path.join(work, "results_cuda")
    sweep, named, refused = harness_experiments()
    ran = sweep + named
    visible = (torch.cuda.device_count() if torch.device(device).type == "cuda"
               else 1 << 30)  # the CPU lays a mesh over copies of itself
    refused = [e for e in refused if e.sp_parts * e.ds_parts > visible]

    def counted(exps):
        reset_launch_counts()
        out = run_experiments(exps, rdir, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return out, launch_counts()

    t0 = time.perf_counter()
    out, n = counted(ran + refused)
    secs = time.perf_counter() - t0
    for exp in ran:
        name = exp.frozen_name()
        if name not in out:
            failed = os.path.join(rdir, name + ".failed")
            tail = open(failed).read()[-3000:] if os.path.exists(failed) \
                else ""
            raise AssertionError(f"harness: {name} failed\n{tail}")
        rec = parse_data_lines(
            open(os.path.join(rdir, name + ".out")).read().splitlines())
        check = "validate" if exp.validate else "verify"
        if exp.kind == "scaling":
            ok = rec.get("edges_per_s_n1", [0])[0] > 0
        else:
            ok = rec.get(check) == ["OK"]
        if not ok or len(rec.get("device", [])) != 1:
            raise AssertionError(f"harness: {name}: {check} "
                                 f"{rec.get(check)}, device "
                                 f"{rec.get('device')}")
        print(f"harness {name}: {json.dumps(out[name])}", flush=True)
    for exp in refused:
        failed = os.path.join(rdir, exp.frozen_name() + ".failed")
        # a mesh above the visible cards: make_mesh's ValueError, as the
        # reference's on one chip
        why = "ValueError: need"
        if exp.frozen_name() in out or not os.path.exists(failed) or \
                why not in open(failed).read():
            raise AssertionError(f"harness: {exp.frozen_name()} was not "
                                 f"refused with a .failed record ({why})")
    print(f"harness launches: {n} ({secs:.1f} s)", flush=True)
    for k in HARNESS_KERNELS:
        if n[k] <= 0:
            raise AssertionError(f"harness: {k} was never launched")

    out2, n2 = counted(ran + refused)
    if set(out2) != set(out) or any(n2.values()):
        raise AssertionError(f"harness: the second sweep ran again: "
                             f"{sorted(set(out) ^ set(out2))} {n2}")
    with open(results_to_csv(rdir)) as f:
        rows = list(csv.DictReader(f))
    if len(rows) != len(ran):
        raise AssertionError(f"harness: {len(rows)} CSV rows for "
                             f"{len(ran)} records")

    tpu = os.path.join(work, "results_tpu_copy")
    os.makedirs(tpu, exist_ok=True)
    src = sorted(f for f in os.listdir(os.path.join(here, "results"))
                 if f.endswith(".out"))[0]
    shutil.copy(os.path.join(here, "results", src), tpu)
    try:
        run_experiments(named[:1], tpu, device=device)
    except ValueError as e:
        if src not in str(e):
            raise
    else:
        raise AssertionError("harness: a directory holding a TPU record "
                             "was not refused")

    for argv in (["run", "--baseline", "--dry_run", "--results",
                  os.path.join(work, "results_dry")],
                 ["parse", "--results", rdir]):
        res = subprocess.run([sys.executable, "sweep_cuda.py", *argv],
                             capture_output=True, text=True, timeout=timeout,
                             cwd=here)
        if res.returncode != 0:
            raise AssertionError(f"sweep_cuda.py {argv[0]}: exit "
                                 f"{res.returncode}\n"
                                 f"{(res.stdout + res.stderr)[-3000:]}")
        if argv[0] == "parse" and not res.stdout.strip().endswith(
                "average_all.csv"):
            raise AssertionError(f"sweep_cuda.py parse: {res.stdout}")
    print(f"harness: {len(ran)} records, {len(refused)} refused, a second "
          f"sweep skipped all, {len(rows)} CSV rows, the TPU record "
          "refused, sweep_cuda.py run --dry_run and parse ran", flush=True)
    results["harness"] = dict(launches=n, seconds=secs)
    return n


def harness_operands(results, device="cuda"):
    """Every operand the harness's experiments ran kernels on, prepared
    again from the same dataset and ``Experiment.spmm_config()`` (the
    hybrid ones load the prepare cache the runs saved): the stair int8
    cores of the stand-in and of its ``-uniq`` sibling, whose bands no
    other phase checks, and the ell operands of the sweep. On all rows,
    ``mul`` (K-core and K-tail, or K-tail alone) against ``mul_plain``,
    and on the hybrids the fused int32 ``mul_quantized`` (K-int and
    K-tail-quant) against ``mul_quantized_plain``, each at REL_TOL of the
    sum of |terms|; each launch counted, so a check that skipped its
    kernel fails."""
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import prepare_spmm
    from pygim_tpu_torch.quant import quant_scale

    sweep, named, _refused = harness_experiments()
    operands = {}
    for exp in sweep + named:
        if exp.backend in ("hybrid", "ell"):
            operands.setdefault((exp.dataset, exp.spmm_config()), exp)

    def launched(fn, kernels, name):
        reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        n = launch_counts()
        if any(n[k] <= 0 for k in kernels):
            raise AssertionError(f"{name}: launches {n}, want {kernels}")
        return got

    out = {}
    for (dataset, cfg), exp in operands.items():
        prep = prepare_spmm(load_dataset(dataset).graph, cfg, device=device)
        name = f"{dataset} {cfg.backend} balance={cfg.balance}"
        x = torch.randn(prep.ncols, exp.hidden,
                        generator=torch.Generator().manual_seed(9)).to(device)
        hybrid = cfg.backend == "hybrid"
        got = launched(lambda: prep.mul(x),
                       ("K-core", "K-tail") if hybrid else ("K-tail",), name)
        res = dict(
            bands=prep.stair, tables=prep.ell_meta,
            mul=check_close(f"harness operand {name}: mul", got,
                            prep.mul_plain(x), mul_mag(prep, x), REL_TOL))
        if hybrid:
            got = launched(lambda: prep.mul_quantized(x, "int32"),
                           ("K-int", "K-tail-quant"), name)
            scale, safe = quant_scale(x, "int32")
            res["mul_quantized int32"] = check_close(
                f"harness operand {name}: mul_quantized int32", got,
                prep.mul_quantized_plain(x, "int32"),
                mul_mag(prep, torch.round(x / safe)) * scale, REL_TOL)
        print(f"harness operand {name}: {res}", flush=True)
        out[name] = res
        del prep, x, got
        torch.cuda.empty_cache()
    results["harness operands"] = out


def real_format(results, device="cuda"):
    """The stand-in written in OGB's raw layout (``data/real_layout.py``),
    read back by ``load_dataset`` through the real-format parsers and
    held to the stand-in (``verify_roundtrip``: marked real, the edges
    equal, the features within 2e-5, labels and masks equal); then the
    float GCN at ``HIDDEN`` on the stair int8 core of the parsed graph,
    its logits against the plain versions (``logits_check``)."""
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.data.real_layout import verify_roundtrip, write_ogb
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    ds = load_dataset(DATASET)
    root = os.path.join(os.environ["PYGIM_TPU_TORCH_DATA"], "realdata")
    t0 = time.perf_counter()
    write_ogb(ds, DATASET, root)
    t1 = time.perf_counter()
    real = load_dataset(DATASET, root=root)
    t2 = time.perf_counter()
    verify_roundtrip(ds, DATASET, root, real=real)
    cfg = SpmmConfig(backend="hybrid", hybrid_shape="stair",
                     hybrid_dtype="int8", hybrid_core_bytes=CORE_BYTES)
    prep = prepare_spmm(real.graph, cfg, device=device)
    gnn = make_gnn(0, "gcn", real.x.shape[1], HIDDEN, real.num_classes,
                   num_layers=2, agg_dtype=None, device=device)
    logits_check("real-format float", gnn,
                 torch.as_tensor(real.x).to(device), prep, real.num_classes)
    results["real format"] = dict(write_s=t1 - t0, parse_s=t2 - t1,
                                  nodes=real.num_nodes, edges=real.num_edges)
    print(f"real format: {results['real format']}", flush=True)


# ---- the BCSR tier (K-bcsr), the coo backend and SDDMM ----------------------

# the reference's tile-capture study graph (docs/PERF.md:265-280): hidden
# communities of 256 nodes, which the lp order recovers
BCSR_GRAPH = "brmat-200000-4000000-256"
BCSR_CORE_BYTES = 64 << 20
BCSR_BYTES = 256 << 20
BCSR_CONFIGS = {
    "int8 Tr16 panel lp": dict(hybrid_dtype="int8", bcsr_tile=16,
                               bcsr_layout="panel", bcsr_order="lp"),
    "int8 Tr16 row rcm": dict(hybrid_dtype="int8", bcsr_tile=16,
                              bcsr_layout="row", bcsr_order="rcm"),
    # the rank order scrambles the communities: the auto cutoff (23 edges
    # a tile at H 256) takes no tile, 3 takes about 6,900
    "int8 Tr8 row rank": dict(hybrid_dtype="int8", bcsr_tile=8,
                              bcsr_layout="row", bcsr_order="rank",
                              bcsr_min_edges=3),
    "f32 Tr16 panel lp": dict(hybrid_dtype="float32", bcsr_tile=16,
                              bcsr_layout="panel", bcsr_order="lp"),
}
BCSR_TIMED = "int8 Tr16 panel lp"  # the kernels line's K-bcsr entry
# the training check's graph: smaller, so its Aᵀ prepares in seconds
BCSR_TRAIN_GRAPH = "brmat-20000-400000-64"
# the cases of K-bcsr: tile dtype, payload and whether x is rounded to
# round(x / safe) at the int32 quantized aggregate's scale; every case
# runs on the tensor cores (ops/bcsr.py:kernel_route)
BCSR_MODES = (("bfloat16", "float32", False), ("bfloat16", "bfloat16", False),
              ("bfloat16", "int8", False), ("bfloat16", "int16", False),
              ("bfloat16", "int32", False), ("bfloat16", "float32", True),
              ("float32", "float32", False), ("float32", "bfloat16", False),
              ("float32", "int8", False), ("float32", "int16", False),
              ("float32", "int32", False), ("float32", "float32", True))
# the routes of the kernels line beside the K-bcsr entry (the bf16 route
# on BCSR_TIMED): (route key, the tier, payload, rounded), on the bf16
# tiles of BCSR_TIMED and the f32 tiles of BCSR_F32; the bcsr path's
# products take every one (the port rounds x in the tier for int32 alone:
# int8 and int16 go through their integer tables)
BCSR_F32 = "f32 Tr16 panel lp"
BCSR_ROUTES = (("bf16x2", BCSR_TIMED, "int16", False),
               ("bf16x3", BCSR_TIMED, "int32", False),
               ("bf16x3 rounded", BCSR_TIMED, "float32", True),
               ("tf32x3", BCSR_F32, "float32", False),
               ("tf32x2", BCSR_F32, "int8", False))
BCSR_RAGGED = ((8, 41), (16, 256), (24, 8), (32, 1100), (64, 42), (24, 1100))


def timed_phase(name, fn, *args):
    """``fn(*args)``, its seconds on the host clock printed as a line
    ``phase <name>: <s> s``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def free(device) -> None:
    """Return the card's cached blocks after a large operand is gone."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def rounded_safe(x):
    """``safe`` of the int32 quantized aggregate's scale
    (``quant/__init__.py:quant_scale``) as a 0-dim tensor."""
    from pygim_tpu_torch.quant import quant_scale

    return quant_scale(x, "int32")[1].reshape(())


def bcsr_synthetic(kind, n, slots, tr, nodes, tile_dtype, gen, dev,
                   density=0.2):
    """A random tier on ``dev``: ``n`` virtual blocks / panels of ``slots``
    ``tr``-row tiles (``density`` of the cells nonzero, normal values in
    the tile dtype) over ``nodes`` nodes, its panels and row blocks drawn
    at random (so rows repeat across work items). The arguments of
    ``bcsr_add`` after x."""
    import torch

    n_panels = max(1, nodes // 128)
    n_rb = max(1, nodes // tr)
    tiles = torch.randn(n, slots, tr, 128, generator=gen)
    tiles *= torch.rand(n, slots, tr, 128, generator=gen) < density
    tiles = tiles.to(getattr(torch, tile_dtype))
    pidx = torch.randint(0, n_panels, (n, slots) if kind == "row" else (n,),
                         generator=gen, dtype=torch.int32)
    rb = torch.randint(0, n_rb, (n,) if kind == "row" else (n, slots),
                       generator=gen, dtype=torch.int32)
    pn = torch.randint(0, nodes, (n_panels * 128,), generator=gen,
                       dtype=torch.int32)
    rn = torch.randint(0, nodes, (n_rb * tr,), generator=gen,
                       dtype=torch.int32)
    return tuple([kind] + [t.to(dev) for t in (tiles, pidx, rb, pn, rn)])


def bcsr_payload(nodes, h, dtype, gen, dev):
    """x of ``dtype``: normal floats, or integers of the payload's range
    (int8 in [-127, 127], so |x| stays in range)."""
    import torch

    lim = {"int8": 127, "int16": 1 << 12, "int32": 1 << 20}
    if dtype in lim:
        x = torch.randint(-lim[dtype], lim[dtype] + 1, (nodes, h),
                          generator=gen)
    else:
        x = torch.randn(nodes, h, generator=gen)
    return x.to(getattr(torch, dtype)).to(dev)


def bcsr_mag(x, tables, nodes, safe=None, mag=None):
    """The sum of |terms| behind each element of the tier's product, added
    into ``mag`` where it is given."""
    import torch

    from pygim_tpu_torch.ops.bcsr import bcsr_plain

    kind, tiles, *rest = tables
    if mag is None:
        mag = torch.zeros(nodes, x.shape[1], device=x.device)
    xa = x.abs() if x.is_floating_point() else x.to(torch.int32).abs()
    return bcsr_plain(xa, kind, tiles.abs(), *rest, mag, safe=safe)


def bcsr_case(name, x, tables, nodes, safe=None, out=None, exact=False):
    """K-bcsr against ``bcsr_plain`` on the same inputs, within REL_TOL of
    the sum of |terms|, or ``torch.equal`` where ``exact`` (every partial
    sum an integer below 2^24); ``out`` (zeros) may be given, e.g. at an
    odd offset. Returns the max abs error."""
    import torch

    from pygim_tpu_torch.ops.bcsr import bcsr_add, bcsr_plain

    if out is None:
        out = torch.zeros(nodes, x.shape[1], device=x.device)
    got = bcsr_add(x, *tables, out, safe=safe)
    want = bcsr_plain(x, *tables, torch.zeros_like(got), safe=safe)
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-equal to the plain "
                                 f"version, max abs err "
                                 f"{float((got - want).abs().max())}")
        return 0.0
    return check_close(name, got, want, bcsr_mag(x, tables, nodes, safe),
                       REL_TOL)


def bcsr_kernel_checks(results, device="cuda"):
    """K-bcsr alone against ``bcsr_plain`` on random tiers: every case of
    :data:`BCSR_MODES` in both layouts at ragged (Tr, H), Tr 8 to 64 and
    H 8 to 1100, with an ``out`` at an odd storage offset, and bit-equal
    on integer cells where its payload is an integer; bit-equal on
    integers of 18 bits (an int32 x and a rounded x), which need
    ``bf16x3``'s third part; on a single-tile tier; a hub panel its plan
    splits into items and a row-kind tier it reorders, bf16 and f32
    tiles; two launches on a bf16 tier within
    REL_TOL (f32 atomics: not required bit-equal; the reading says
    whether they were); NaN rows where the plain version has them when a
    pad reads a NaN x row, on every route a float x takes; the refusals
    of the wrapper (Tr past 64, misaligned tiles)."""
    import torch

    from pygim_tpu_torch.ops.bcsr import (
        ITEM_TILES,
        bcsr_add,
        bcsr_plain,
        bcsr_plan,
    )

    gen = torch.Generator().manual_seed(21)
    nodes = 3000
    errs, cases = {}, 0
    for kind in ("row", "panel"):
        for i, (tdt, xdt, rounded) in enumerate(BCSR_MODES):
            tr, h = BCSR_RAGGED[i % len(BCSR_RAGGED)]
            tables = bcsr_synthetic(kind, 48, 4, tr, nodes, tdt, gen, device)
            x = bcsr_payload(nodes, h, xdt, gen, device)
            safe = rounded_safe(x) if rounded else None
            name = (f"K-bcsr {kind} {tdt} tiles x {xdt}"
                    f"{' rounded' if rounded else ''} Tr {tr} H {h}")
            errs[name] = bcsr_case(name, x, tables, nodes, safe)
            cases += 1
            # an out at an odd offset of its storage
            buf = torch.zeros(nodes * h + 1, device=device)
            errs[name + " odd out"] = bcsr_case(
                name + " odd out", x, tables, nodes, safe,
                out=buf[1:].view(nodes, h))
            cases += 1
            # integer cells (|c| <= 3) and an integer payload of at most
            # 2^12: every partial sum an integer below 2^24, so the
            # routes' exact products give the plain version's sums bit
            # for bit
            if xdt.startswith("int"):
                cells = torch.randint(-3, 4, tables[1].shape, generator=gen)
                itables = (kind, (cells.to(device) * (tables[1] != 0)).to(
                    tables[1].dtype), *tables[2:])
                xi = x
                if x.dtype != torch.int8:
                    xi = x.clamp(-(1 << 12), 1 << 12)
                errs[name + " integer cells"] = bcsr_case(
                    name + " integer cells", xi, itables, nodes, exact=True)
                cases += 1
        # bf16x3's third part: integers of 18 bits (|q| in [2^17, 2^18),
        # which two bf16 parts do not hold) on cells in {-1, 0, 1} at most
        # 48 terms a row, so every partial sum is an integer below 2^24:
        # an int32 x and an x rounded to them, bit-equal
        tables = bcsr_synthetic(kind, 12, 2, 16, nodes, "bfloat16", gen,
                                device, density=0.02)
        cells = torch.randint(-1, 2, tables[1].shape, generator=gen)
        tables = (kind, (cells.to(device) * (tables[1] != 0)).to(
            torch.bfloat16), *tables[2:])
        terms = bcsr_plain(torch.ones(nodes, 1, device=device), kind,
                           tables[1].abs(), *tables[2:],
                           torch.zeros(nodes, 1, device=device))
        if not 1 <= float(terms.max()) <= 48:
            raise AssertionError(f"K-bcsr three parts: {float(terms.max())} "
                                 "terms a row")
        mag = torch.randint(1 << 17, 1 << 18, (nodes, 24), generator=gen)
        q = mag * (torch.randint(0, 2, (nodes, 24), generator=gen) * 2 - 1)
        noise = torch.rand(nodes, 24, generator=gen) * 0.8 - 0.4
        half = torch.tensor(0.5, device=device)
        for xdt, x, safe in (
                ("int32", q.to(torch.int32).to(device), None),
                ("float32 rounded", ((q + noise) * 0.5).to(device), half)):
            name = f"K-bcsr {kind} bfloat16 tiles x {xdt} three parts"
            errs[name] = bcsr_case(name, x, tables, nodes, safe, exact=True)
            cases += 1
        for tdt in ("bfloat16", "float32"):
            tables = bcsr_synthetic(kind, 1, 1, 16, 200, tdt, gen, device)
            x = bcsr_payload(200, 64, "float32", gen, device)
            name = f"K-bcsr {kind} {tdt} single tile"
            errs[name] = bcsr_case(name, x, tables, 200)
            cases += 1
    # a hub panel the plan splits into items; a row-kind tier (S = 3, few
    # row blocks, so consecutive entries share one) it reorders
    hub_n = 3 * ITEM_TILES + 9
    for tdt in ("bfloat16", "float32"):
        kind, tiles, pidx, rb, pn, rn = bcsr_synthetic(
            "panel", hub_n, 1, 16, nodes, tdt, gen, device)
        pidx[:hub_n - 4] = 2
        tables = (kind, tiles, torch.sort(pidx)[0], rb, pn, rn)
        plan = bcsr_plan(kind, tables[2], rb, 16, 256)
        if int((plan.items[:, 2] == 2).sum()) < 3:
            raise AssertionError("K-bcsr plan: the hub panel not split")
        x = bcsr_payload(nodes, 256, "float32", gen, device)
        name = f"K-bcsr panel {tdt} split hub panel"
        errs[name] = bcsr_case(name, x, tables, nodes)
        tables = bcsr_synthetic("row", 64, 3, 16, nodes, tdt, gen, device)
        tables = (*tables[:3], torch.sort(tables[3] % 12)[0], *tables[4:])
        plan = bcsr_plan("row", tables[2], tables[3], 16, 256)
        if torch.equal(plan.entries[:, 0],
                       torch.arange(64 * 3, dtype=torch.int32)):
            raise AssertionError("K-bcsr plan: the row tier not reordered")
        name = f"K-bcsr row {tdt} reordered by the plan"
        errs[name] = bcsr_case(name, x, tables, nodes)
        cases += 2
    # two launches on a bf16 tier
    tables = bcsr_synthetic("panel", 256, 8, 16, nodes, "bfloat16", gen,
                            device)
    x = bcsr_payload(nodes, 256, "float32", gen, device)
    a = bcsr_add(x, *tables, torch.zeros(nodes, 256, device=device))
    b = bcsr_add(x, *tables, torch.zeros(nodes, 256, device=device))
    two = check_close("K-bcsr two launches", a, b,
                      bcsr_mag(x, tables, nodes), REL_TOL)
    # a NaN x row that pads (and rows of zero cells) read, on every route
    # that takes a float x: bf16 tiles as bf16 and rounded (bf16x3), f32
    # tiles as tf32x3 and rounded
    xn = x.clone()
    xn[tables[4][0].long()] = float("nan")
    safe_n = (x.abs().max() * 2 / 2 ** 20).reshape(())
    for tdt, rounded in (("bfloat16", False), ("bfloat16", True),
                         ("float32", False), ("float32", True)):
        kind, tiles, pidx, rb, pn, rn = tables
        tiles = tiles.to(getattr(torch, tdt))
        tiles[-1] = 0
        pidx = pidx.clone()
        pidx[-1] = 0  # a pad: zero tiles on panel 0
        safe = safe_n if rounded else None
        got = bcsr_add(xn, kind, tiles, pidx, rb, pn, rn,
                       torch.zeros(nodes, 256, device=device), safe=safe)
        want = bcsr_plain(xn, kind, tiles, pidx, rb, pn, rn,
                          torch.zeros(nodes, 256, device=device), safe)
        if (not torch.equal(got.isnan(), want.isnan())
                or not want.isnan().any()):
            raise AssertionError(f"K-bcsr {tdt} tiles, rounded {rounded}: "
                                 "NaN rows differ from the plain version's "
                                 "where a pad reads a NaN x row")
        cases += 1
    refused = 0
    for bad in ("tr", "align"):
        try:
            if bad == "tr":
                t = bcsr_synthetic("row", 2, 1, 65, 400, "bfloat16", gen,
                                   device)
            else:
                big = torch.zeros(2 * 16 * 128 + 1, dtype=torch.bfloat16,
                                  device=device)
                t = bcsr_synthetic("row", 2, 1, 16, 400, "bfloat16", gen,
                                   device)
                t = (t[0], big[1:].view(2, 1, 16, 128).copy_(t[1]),
                     *t[2:])
            bcsr_add(bcsr_payload(400, 8, "float32", gen, device), *t,
                     torch.zeros(400, 8, device=device))
        except ValueError:
            refused += 1
    if refused != 2 and torch.device(device).type == "cuda":
        raise AssertionError("K-bcsr took tiles of 65 rows or misaligned "
                             "tiles")
    results["K-bcsr checks"] = dict(
        cases=cases, max_abs_err=max(errs.values()), two_launches_err=two,
        two_launches_bit_equal=bool(torch.equal(a, b)), refused=refused)
    print(f"K-bcsr checks: {results['K-bcsr checks']}", flush=True)


def tier_edges(prep):
    """The tier's own edges as a float32 CSR (N, N) on the card: each
    nonzero cell at (its row node, its panel node), duplicates summed —
    ``torch.sparse.mm``'s operand for the library time."""
    import torch

    kind, tiles, pidx, rb, pn, rn = prep.bcsr_tables(prep.dev_arrays)
    return sparse_of(kind, tiles, pidx, rb, pn, rn, prep.nrows)


def sparse_of(kind, tiles, pidx, rb, pn, rn, nodes):
    import torch

    n, slots, tr, tc = tiles.shape
    w, s, r, c = (tiles != 0).nonzero(as_tuple=True)
    vals = tiles[w, s, r, c].float()
    panel = pidx[w, s] if kind == "row" else pidx[w]
    block = rb[w] if kind == "row" else rb[w, s]
    rows = rn[block.long() * tr + r].long()
    cols = pn[panel.long() * tc + c].long()
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                (nodes, nodes)).coalesce()
    return a.to_sparse_csr()


def plan_reading(plan) -> dict:
    """A plan's items, panels staged, adds, bands and modelled bytes, and
    the time those bytes take at 2 TB/s (about the rate a kernel walking
    the tables in their own order reached)."""
    return dict(items=plan.stages, adds=plan.adds, bands=plan.bands,
                band_rb=plan.band_rb, model_gb=plan.model_bytes / 1e9,
                model_parts_gb={k: v / 1e9 for k, v in plan.model.items()},
                model_ms_at_2tbs=plan.model_bytes / 2e12 * 1e3)


def bcsr_timing(name, tables, nodes, x, peaks_, results, launches=None,
                safe=None, sparse=None):
    """K-bcsr's entry on ``tables``: its time on its work plan (built once,
    as a prepared operand keeps it) on the route of ``x`` (``safe``: a
    rounded x; ``ops/bcsr.py:kernel_route``), its plain
    version's, ``torch.sparse.mm`` on the tier's edges (``sparse``, or
    built here; x as f32, rounded where ``safe`` is given), its bound
    (each tile cell, each distinct x row of the panels the work items read
    and each distinct output row of the row blocks they add into once,
    their index entries once: ``utils/device.py:bcsr_traffic``; the
    route's products at its tensor rate) and the plan's readings
    (:func:`plan_reading`)."""
    import torch

    from pygim_tpu_torch.ops.bcsr import (
        ROUTES,
        bcsr_add,
        bcsr_plain,
        bcsr_plan,
        kernel_route,
    )
    from pygim_tpu_torch.utils.device import bcsr_bound, bcsr_traffic

    kind, tiles, pidx, rb = tables[:4]
    n, slots, tr, _ = tiles.shape
    plan = bcsr_plan(kind, pidx, rb, tr, x.shape[1],
                     tile_bytes=tiles.element_size(),
                     x_itemsize=x.element_size(), device=x.device)
    out = torch.zeros(nodes, x.shape[1], device=x.device)
    got = bcsr_add(x, *tables, out, safe=safe, plan=plan)
    err = check_close(name, got, bcsr_plain(x, *tables,
                                            torch.zeros_like(out), safe),
                      bcsr_mag(x, tables, nodes, safe), REL_TOL)
    ms = cuda_ms(lambda: bcsr_add(x, *tables, out.zero_(), safe=safe,
                                  plan=plan))
    plain_ms = cuda_ms(lambda: bcsr_plain(x, *tables, out.zero_(), safe),
                       iters=3, warmup=1)
    a = sparse_of(*tables, nodes) if sparse is None else sparse
    xf = x.float() if safe is None else torch.round(x / safe)
    library_ms = cuda_ms(lambda: torch.sparse.mm(a, xf))
    route = kernel_route(tiles.dtype, x.dtype, safe)[0]
    products, rate = ROUTES[route]
    traffic = bcsr_traffic(*tables[1:])
    bound, by = bcsr_bound(**traffic, h=x.shape[1], peaks_=peaks_,
                           tile_bytes=tiles.element_size(),
                           x_itemsize=x.element_size(), products=products,
                           tf32=rate == "tf32")
    n_panels, n_rb = tables[4].shape[0] // 128, tables[5].shape[0] // tr
    res = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, library_ms=library_ms, share_of_bound=bound / ms,
               route=route, payload=str(x.dtype).replace("torch.", ""),
               rounded=safe is not None,
               kind=kind, work=n, slots=slots, tile_rows=tr, panels=n_panels,
               row_blocks=n_rb, plan=plan_reading(plan),
               x_rows=traffic["x_rows"], out_rows=traffic["out_rows"],
               tier_edges=int(a.values().numel()))
    if launches is not None:
        res["launches"] = launches
    results[name] = res
    print(f"{name}: {res}", flush=True)
    return res


def bcsr_route_timings(key, prep, xs, results, launches) -> None:
    """The kernels line's route entries of :data:`BCSR_ROUTES` on the
    tier of the operand ``key`` of :data:`BCSR_CONFIGS`: each route timed
    by :func:`bcsr_timing` beside its bound and ``torch.sparse.mm``, with
    its launches on the counted products (``launches``: route key ->
    count over every operand)."""
    import torch

    tables = prep.bcsr_tables(prep.dev_arrays)
    a = sparse_of(*tables, prep.nrows)
    for route, tier, dt, rounded in BCSR_ROUTES:
        if tier != key:
            continue
        x = xs[dt]
        res = bcsr_timing(f"K-bcsr {route}", tables, prep.nrows, x,
                          results["peaks"], results,
                          launches=launches.get(route, 0),
                          safe=rounded_safe(x) if rounded else None,
                          sparse=a)
        if res["route"] != route.split()[0]:
            raise AssertionError(f"K-bcsr {route}: ran on {res['route']}")
    del a


def bcsr_paths(results, device="cuda"):
    """The three-tier hybrid on :data:`BCSR_GRAPH` at H 256, one operand
    per :data:`BCSR_CONFIGS` (a square core at 64 MiB, tiles at 256 MiB),
    each counted: ``mul`` on float32, bfloat16, int8, int16 and int32
    payloads and ``mul_quantized`` at int8, int16 and int32, each against
    ``mul_plain`` / ``mul_quantized_plain`` on all rows within REL_TOL of
    the sum of |terms| (the int8 table path bit-equal: every partial sum
    an integer below 2^24), K-bcsr launched once a product; the tier's
    tiles, captured edges and share of the merged edges, ``bcsr_time``;
    K-bcsr timed on :data:`BCSR_TIMED`, and each route of
    :data:`BCSR_ROUTES` on its tier (:func:`bcsr_route_timings`). Returns
    K-bcsr's launches in the products of that operand, and every route's
    launches over all the counted products (``ops/bcsr.py:route_key``)."""
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    t0 = time.perf_counter()
    ds = load_dataset(BCSR_GRAPH)
    print(f"bcsr: {BCSR_GRAPH} in {time.perf_counter() - t0:.1f} s, "
          f"{ds.graph.nnz} stored edges", flush=True)
    gen = torch.Generator().manual_seed(8)
    n = ds.graph.nrows
    xs = {dt: bcsr_payload(n, HIDDEN, dt, gen, device)
          for dt in ("float32", "int8", "int16", "int32")}
    xs["bfloat16"] = xs["float32"].to(torch.bfloat16)
    out, timed_launches, routes = {}, None, {}
    for key, kw in BCSR_CONFIGS.items():
        t0 = time.perf_counter()
        prep = prepare_spmm(ds.graph, SpmmConfig(
            backend="hybrid", hybrid_shape="square",
            hybrid_core_bytes=BCSR_CORE_BYTES, bcsr_bytes=BCSR_BYTES,
            hidden_hint=HIDDEN, **kw), device=device)
        secs = time.perf_counter() - t0
        if not prep.has_bcsr:
            raise AssertionError(f"bcsr {key}: no tile qualified")
        tiles = prep.dev_arrays["tiles"]
        info = dict(prepare_s=secs, k=prep.hybrid_k_eff,
                    tiles=tuple(tiles.shape), tile_dtype=str(tiles.dtype),
                    captured_edges=prep.bcsr_edges, merged_edges=prep.nnz,
                    share=prep.bcsr_edges / prep.nnz, step=prep.bcsr_step,
                    phases={k: round(v, 1) for k, v in
                            prep.prepare_timer.acc.items()})
        print(f"bcsr {key}: {info}", flush=True)
        reset_launch_counts()
        got = {f"mul {dt}": prep.mul(x) for dt, x in xs.items()}
        for agg in ("int8", "int16", "int32"):
            got[f"quantized {agg}"] = prep.mul_quantized(xs["float32"], agg)
        sync(device)
        n_launch = launch_counts()
        if n_launch["K-bcsr"] != len(got):
            raise AssertionError(f"bcsr {key}: K-bcsr launched "
                                 f"{n_launch['K-bcsr']} times in "
                                 f"{len(got)} products")
        for k, v in n_launch.items():
            if k.startswith("K-bcsr "):
                routes[k[len("K-bcsr "):]] = routes.get(
                    k[len("K-bcsr "):], 0) + v
        if not torch.equal(got["quantized int8"], prep.mul_quantized_plain(
                xs["float32"], "int8")):
            raise AssertionError(f"bcsr {key}: the int8 table path is not "
                                 "exact")
        errs = {"quantized int8": 0.0}
        mags = {dt: prep_mag(prep, x) for dt, x in xs.items()
                if dt != "bfloat16"}
        for agg, k in (("int16", 10), ("int32", 20)):
            x = xs["float32"]
            scale = x.abs().max() * 2 / 2 ** k
            mags[agg + " rounded"] = prep_mag(prep, torch.round(x / scale)
                                              * scale)
            errs[f"quantized {agg}"] = check_close(
                f"bcsr {key} quantized {agg}", got[f"quantized {agg}"],
                prep.mul_quantized_plain(x, agg), mags[agg + " rounded"],
                REL_TOL)
        for dt, x in xs.items():
            errs[f"mul {dt}"] = check_close(
                f"bcsr {key} mul {dt}", got[f"mul {dt}"], prep.mul_plain(x),
                mags["float32" if dt == "bfloat16" else dt], REL_TOL)
        del got, mags
        phase = prep.phase_times(xs["float32"], iters=5)
        info.update(max_abs_err=errs, launches=n_launch,
                    bcsr_time_ms=phase["bcsr_time(ms)"],
                    mul_time_ms=phase["mul_time(ms)"],
                    core_time_ms=phase.get("core_time(ms)"),
                    tail_time_ms=phase["tail_time(ms)"])
        print(f"bcsr {key}: max abs errs {errs}; launches {n_launch}; "
              f"phases {phase}", flush=True)
        if key == BCSR_TIMED:
            timed_launches = n_launch["K-bcsr"]
            bcsr_timing("K-bcsr", prep.bcsr_tables(prep.dev_arrays),
                        n, xs["float32"], results["peaks"], results,
                        launches=timed_launches)
        out[key] = info
        out[key]["prep"] = prep
    # each route's entry, with its launches over every counted product
    for key in BCSR_CONFIGS:
        prep = out[key].pop("prep")
        bcsr_route_timings(key, prep, xs, results, routes)
        del prep
        free(device)
    results["bcsr"] = out
    results["bcsr route launches"] = routes
    print(f"bcsr route launches: {routes}", flush=True)
    return timed_launches, routes


def prep_mag(prep, x):
    """``product_mag`` (tail and core) plus the tier's |terms|."""
    return bcsr_mag(x, prep.bcsr_tables(prep.dev_arrays), prep.nrows,
                    mag=product_mag(prep, x))


# a tier of 1 GiB of bf16 tiles (Tr 16, 16 tiles a work item, 10% of
# cells set) over 2,000,000 nodes at H 256: K-bcsr at scale, both layouts
SCALE_TIER = dict(n=16384, slots=16, tr=16, nodes=2_000_000, density=0.1)


def scale_tiers(device):
    """Both layouts of the random tier of :data:`SCALE_TIER`, drawn on the
    card from one seed (a prepared tier this large takes minutes of host
    prepare): yields ``(tables, nodes, x)``, the panel layout first. The
    tiles, the node tables and x are shared. The work items are sorted by
    panel (panel kind) or row block (row kind), as the builders lay them
    out, and read only a part of the tables' panels and row blocks."""
    import torch

    s = SCALE_TIER
    gen = torch.Generator(device=device).manual_seed(3)
    dev = torch.device(device)
    tiles = torch.randn(s["n"], s["slots"], s["tr"], 128, generator=gen,
                        device=dev)
    tiles *= torch.rand(tiles.shape, generator=gen, device=dev) < s["density"]
    tiles = tiles.to(torch.bfloat16)
    n_panels, n_rb = s["nodes"] // 128, s["nodes"] // s["tr"]
    pn = torch.randperm(s["nodes"], generator=gen, device=dev)[
        :n_panels * 128].to(torch.int32)
    rn = torch.randperm(s["nodes"], generator=gen, device=dev)[
        :n_rb * s["tr"]].to(torch.int32)
    x = torch.randn(s["nodes"], HIDDEN, generator=gen, device=dev)
    ints = dict(generator=gen, device=dev, dtype=torch.int32)
    for kind in ("panel", "row"):
        if kind == "panel":
            pidx = torch.sort(torch.randint(0, n_panels, (s["n"],), **ints))[0]
            rb = torch.randint(0, n_rb, (s["n"], s["slots"]), **ints)
        else:
            pidx = torch.randint(0, n_panels, (s["n"], s["slots"]), **ints)
            rb = torch.sort(torch.randint(0, n_rb, (s["n"],), **ints))[0]
        yield (kind, tiles, pidx, rb, pn, rn), s["nodes"], x


def bcsr_scale(results, device="cuda"):
    """K-bcsr alone on both layouts of :func:`scale_tiers`, against
    ``bcsr_plain`` on all rows, timed against its bound and
    ``torch.sparse.mm`` on the tier's edges."""
    for tables, nodes, x in scale_tiers(device):
        bcsr_timing(f"K-bcsr scale tier, {tables[0]}", tables, nodes, x,
                    results["peaks"], results)
        free(device)


def least_time(nbytes, ops, hbm, rate):
    """The least time of ``nbytes`` at the HBM rate and ``ops`` at
    ``rate``: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / hbm * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def coo_sddmm(ds, results, device="cuda"):
    """The ``coo`` backend and SDDMM on the smoke stand-in: a float32 SpMM
    through ``run_spmm_benchmark`` (verify OK) and ``mul`` against the
    oracle backend on all rows; the float GCN against the same forward
    on the oracle backend (1e-4 of the logits' scale, as ``logits_check``);
    GIN and SAGE (tracked config 3's models, without ``tune``) through
    ``run_experiments`` with ``Experiment(sp_format="coo",
    backend="coo", validate=True)``; ``prepare_sddmm(...).run`` against
    a float64 dot on 4096 sampled edges. Both timed beside a bytes bound
    and a library call (:func:`least_time`; ``torch.sparse.mm``,
    ``torch.sparse.sampled_addmm``)."""
    import numpy as np
    import torch

    from pygim_tpu_torch.bench import Experiment, run_experiments
    from pygim_tpu_torch.bench.runners import run_spmm_benchmark
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.reference import spmm_coo_oracle
    from pygim_tpu_torch.ops.sddmm import prepare_sddmm
    from pygim_tpu_torch.ops.spmm import (
        PreparedAggregate,
        SpmmConfig,
        prepare_spmm,
    )
    from pygim_tpu_torch.utils.metrics import DataReporter

    res = {}
    t0 = time.perf_counter()
    coo = prepare_spmm(ds.graph, SpmmConfig(backend="coo"), device=device)
    oracle = prepare_spmm(ds.graph, SpmmConfig(backend="oracle"),
                          device=device)
    x = torch.randn(coo.ncols, HIDDEN,
                    generator=torch.Generator().manual_seed(12)).to(device)
    d = oracle.dev_arrays
    mag = spmm_coo_oracle(d["rows"], d["cols"], d["vals"].abs(), x.abs(),
                          oracle.nrows)
    res["mul_err"] = check_close("coo mul", coo.mul(x), oracle.mul(x), mag,
                                 REL_TOL)
    res["mul_ms"] = cuda_ms(lambda: coo.mul(x), iters=5)
    # its bound (rows_bound, as the blocked backend's) and torch.sparse.mm
    # on the same CSR, which is the blocked backend's library call too (the
    # same merged edges)
    d = coo.dev_arrays
    rows, cols, vals = (d[k].reshape(-1) for k in ("rows", "cols", "vals"))
    csr = torch.sparse_coo_tensor(
        torch.stack([rows.long(), cols.long()]), vals.float(),
        (coo.nrows, coo.ncols)).coalesce().to_sparse_csr()
    res["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=5)
    b = rows_bound(coo, HIDDEN, results["peaks"])
    res["bound_ms"], res["bound_by"] = b["bound_ms"], b["bound_by"]
    del csr
    # the coo main path, counted: the SpMM, the GCN, GIN and SAGE
    reset_launch_counts()
    rep = DataReporter(echo=True)
    run_spmm_benchmark(ds, hidden=HIDDEN, config=SpmmConfig(backend="coo"),
                       repeat=3, reporter=rep, device=device)
    if rep.records["verify"][-1] != "OK":
        raise AssertionError("coo SpMM sampled-row check failed")
    res["pim_time_spmm_ms"] = rep.records["pim_time_spmm(ms)"][-1]
    xf = torch.as_tensor(ds.x).to(device)
    gnn = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                   num_layers=2, device=device)
    with torch.inference_mode():
        logits = gnn(xf, PreparedAggregate(coo))
        want = gnn(xf, PreparedAggregate(oracle))
    scale = max(1.0, float(want.abs().max()))
    res["gcn_logits_err"] = float((logits - want).abs().max())
    res["gcn_logits_scale"] = scale
    if not torch.isfinite(logits).all() or res["gcn_logits_err"] > 1e-4 * scale:
        raise AssertionError(f"coo GCN logits differ from the oracle's: "
                             f"{res['gcn_logits_err']} of {scale}")
    del coo, oracle, x, mag
    rdir = os.path.join(os.environ["PYGIM_TPU_TORCH_DATA"], "results_coo")
    exps = [Experiment(dataset=DATASET, kind="inference", model=m,
                       sp_format="coo", backend="coo", hidden=HIDDEN,
                       validate=True, repeat=3) for m in ("gin", "sage")]
    means = run_experiments(exps, rdir, device=device)
    for e in exps:
        text = open(os.path.join(rdir, f"{e.frozen_name()}.out")).read()
        if "[DATA]validate: OK" not in text:
            raise AssertionError(f"coo {e.model}: validate not OK")
        res[f"{e.model}_infer_time_ms"] = means[e.frozen_name()][
            "infer_time(ms)"]
    sync(device)
    n = launch_counts()
    res["launches"] = n["K-rows coo"]
    if torch.device(device).type == "cuda" and n["K-rows coo"] <= 0:
        raise AssertionError(f"K-rows was never launched on the coo path: "
                             f"{n}")
    sd = prepare_sddmm(ds.graph, device=device)
    gen = torch.Generator().manual_seed(13)
    a = torch.randn(ds.graph.nrows, 64, generator=gen)
    b = torch.randn(ds.graph.ncols, 64, generator=gen)
    got = sd.run(a.to(device), b.to(device)).cpu()
    s = ds.graph.sort_by_row()
    pick = np.random.default_rng(5).choice(s.nnz, 4096, replace=False)
    r, c = torch.from_numpy(s.rows[pick]).long(), torch.from_numpy(
        s.cols[pick]).long()
    want = (a[r].double() * b[c].double()).sum(-1)
    terms = (a[r].double() * b[c].double()).abs().sum(-1)
    err = (got[pick].double() - want).abs()
    if got.shape != (ds.graph.nnz,) or (err > REL_TOL * terms).any():
        raise AssertionError(f"SDDMM off its float64 dot: {float(err.max())}")
    res["sddmm_err"] = float(err.max())
    ad, bd = a.to(device), b.to(device)
    res["sddmm_ms"] = cuda_ms(lambda: sd.run(ad, bd), iters=5)
    # its bytes bound (the edge list read, one score written an edge, each
    # a and b row read once) and torch.sparse.sampled_addmm on the same
    # pattern (the edges as a CSR, duplicates merged)
    er = torch.from_numpy(s.rows).to(device).long()
    ec = torch.from_numpy(s.cols).to(device).long()
    pattern = torch.sparse_coo_tensor(
        torch.stack([er, ec]), torch.ones(s.nnz, device=device),
        (ds.graph.nrows, ds.graph.ncols)).coalesce().to_sparse_csr()
    bt = bd.t().contiguous()
    res["sddmm_library_ms"] = cuda_ms(
        lambda: torch.sparse.sampled_addmm(pattern, ad, bt, beta=0.0),
        iters=5)
    hbm, _, f32_rate, _ = results["peaks"]
    res["sddmm_bound_ms"], res["sddmm_bound_by"] = least_time(
        s.nnz * 12 + (int(torch.unique(er).numel())
                      + int(torch.unique(ec).numel())) * 64 * 4,
        2 * s.nnz * 64, hbm, f32_rate)
    del pattern, er, ec
    res["seconds"] = time.perf_counter() - t0
    results["coo sddmm"] = res
    print(f"coo and SDDMM: {res}", flush=True)
    return res["launches"]


ROWS_WIDTHS = (41, 1100)  # ragged widths K-rows is held at


def rows_mag(prep, x):
    """The sum of |terms| behind each element of a blocked or coo
    operand's product with ``x``: the plain version on |vals| and |x|."""
    from pygim_tpu_torch.ops import seg_rows

    d = prep.dev_arrays
    xa = x.float().abs()
    if prep.config.backend == "blocked":
        return seg_rows.blocked_spmm(d["colind"], d["vals"].float().abs(),
                                     d["rowloc"], d["row_slot"], xa,
                                     prep.rows_pad)
    return seg_rows.coo_plain(d["rows"], d["cols"], d["vals"].float().abs(),
                              xa, prep.nrows)


def rows_plan(prep):
    """A blocked or coo operand's K-rows plan: the one built at prepare on
    the card, else one built here from its tables (a CPU rehearsal)."""
    from pygim_tpu_torch.ops import seg_rows

    if prep._seg_plan is not None:
        return prep._seg_plan
    d = {k: v.cpu().numpy() for k, v in prep.dev_arrays.items()}
    if prep.config.backend == "blocked":
        return seg_rows.blocked_plan(d["rowloc"], d["row_slot"],
                                     prep.rows_pad, d["colind"], d["vals"])
    return seg_rows.coo_plan(d["rows"], prep.nrows)


def rows_call(prep, x, plan):
    """One K-rows product of a blocked or coo operand on ``plan``."""
    from pygim_tpu_torch.ops import seg_rows

    d = prep.dev_arrays
    if prep.config.backend == "blocked":
        return seg_rows.blocked_rows(d["colind"], d["vals"], d["rowloc"],
                                     d["row_slot"], x, prep.rows_pad,
                                     plan=plan)
    return seg_rows.coo_rows(d["rows"], d["cols"], d["vals"], x, prep.nrows,
                             plan=plan)


def rows_host_steps(prep, x, reps: int = 2000) -> dict:
    """The host's µs a call of each step of a K-rows wrapper call
    (``ops/seg_rows.py:_launch``) on ``prep`` (a small operand, so the card
    keeps up) and ``x``, timed alone on the host clock ``reps`` times: the
    dtype codes (as cached by dtype pair, and computed afresh), the tensor
    checks, the output's allocation, the plan's device copy, the library
    lookup, the device context (entered, and the test for whether it is
    needed), the stream (PyTorch's raw query, and a stream object), the
    pointers; the C entry point called alone; and the whole wrapper."""
    import torch

    from pygim_tpu_torch.ops import _build, seg_rows

    d = prep.dev_arrays
    blocked = prep.config.backend == "blocked"
    cols = d["colind"] if blocked else d["cols"]
    keys = d["rowloc"] if blocked else d["rows"]
    vals = d["vals"]
    plan = rows_plan(prep)
    dp = plan.to(x.device)
    lib = _build.load("seg_rows")
    out = torch.empty((plan.nrows, x.shape[1]), device=x.device)

    def checks():
        for t in (cols, vals, keys, x):
            if t.device != x.device or not t.is_contiguous():
                raise AssertionError("K-rows: tables")

    def pointers():
        return (dp["units"].data_ptr(), dp["hub_rows"].data_ptr(),
                cols.data_ptr(), vals.data_ptr(), keys.data_ptr(),
                x.data_ptr(), out.data_ptr())

    vc, xc, ia = seg_rows._codes(vals, x)
    args = (dp["units"].data_ptr(), plan.n_units, dp["hub_rows"].data_ptr(),
            int(plan.hub_rows.size), cols.data_ptr(), vals.data_ptr(), vc,
            keys.data_ptr(), dp["inv"].data_ptr() if blocked else None,
            cols.shape[1] if blocked else 0,
            prep.rows_pad if blocked else 0, x.data_ptr(), xc, int(ia),
            out.data_ptr(), x.shape[1], 0, _build.stream_of(x))

    def device_context():
        with torch.cuda.device(x.device):
            pass

    steps = {
        "codes": lambda: seg_rows._codes(vals, x),
        "codes afresh": lambda: seg_rows._dtype_codes.__wrapped__(
            vals.dtype, x.dtype),
        "checks": checks,
        "output": lambda: torch.empty((plan.nrows, x.shape[1]),
                                      device=x.device),
        "device plan": lambda: plan.to(x.device),
        "library lookup": lambda: _build.load("seg_rows"),
        "device context": device_context,
        "device test": lambda: x.device.index != torch.cuda.current_device(),
        "stream": lambda: _build.stream_of(x),
        "stream object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "pointers": pointers,
        "entry point": lambda: lib.seg_rows(*args),
        "wrapper": lambda: rows_call(prep, x, plan),
    }
    res = {}
    for k, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn()
            if i % 200 == 199:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        res[k] = (time.perf_counter() - t0) / reps * 1e6
    return res


def rows_close(name, prep, x):
    """``prep.mul(x)`` (K-rows) against ``mul_plain``: bit-equal where
    both weights and payload are integers (int32 wrapping), else within
    REL_TOL of the sum of |terms|. Returns the max abs error."""
    import torch

    got, want = prep.mul(x), prep.mul_plain(x)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    if not want.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: integer product differs; max abs "
                                 f"err {int((got - want).abs().max())}")
        return 0.0
    return check_close(name, got, want, rows_mag(prep, x), REL_TOL)


def nan_rows_check(name, prep, n):
    """A NaN in x[0] (the column of every pad) gives NaN in exactly the
    plain version's rows, and the other rows agree."""
    import torch

    x = torch.randn(n, 64, generator=torch.Generator().manual_seed(8)).to(
        prep.device)
    x[0] = float("nan")
    got, want = prep.mul(x), prep.mul_plain(x)
    if not torch.equal(torch.isnan(got), torch.isnan(want)) \
            or not torch.isnan(want).any():
        raise AssertionError(f"{name}: NaN rows differ from the plain "
                             "version's")
    ok = ~torch.isnan(want)
    xm = torch.nan_to_num(x)
    check_close(name, got[ok], want[ok], rows_mag(prep, xm)[ok], REL_TOL)


def rows_edge_graphs():
    """Small graphs whose pads and hubs K-rows must place as the plain
    version does: ``full`` (64 rows in row-balanced blocks of 8: every
    block fills rows_pad, so its pads land on its last row), ``hub`` (a
    row of 20,000 entries beside rows of one and empty rows), ``empty``
    (no edge). ``(graph, config overrides)`` each, float32 weights."""
    import numpy as np

    from pygim_tpu_torch.core.graph import CooGraph

    rng = np.random.default_rng(11)
    out = {}
    for kind, n, rows, cfg in (
            ("full", 64, np.sort(rng.integers(0, 64, 300)),
             dict(n_blocks=8, balance="row")),
            ("hub", 3000, np.sort(np.r_[np.full(20000, 7),
                                        np.arange(0, 3000, 3)]),
             dict(block_nnz_budget=4096)),
            ("empty", 40, np.zeros(0, np.int64), {})):
        cols = rng.integers(0, n, rows.size)
        vals = rng.standard_normal(rows.size).astype(np.float32)
        out[kind] = (CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n),
                     cfg)
    return out


def rows_checks(ds, results, device="cuda"):
    """K-rows (``csrc/seg_rows.cu``) against its plain versions
    (``ops/seg_rows.py:blocked_spmm``, ``coo_plain``) on the card: the
    stand-in's ``blocked`` operand at the runners' default
    (``SpmmConfig()``) and its ``coo`` operand at H 256, at the ragged
    widths :data:`ROWS_WIDTHS`, with bfloat16 and int32 payloads; the
    stand-in's edges with integer weights in [-5, 5] and int8, int16 and
    int32 payloads, bit-equal, the int32 sums wrapping; the NaN-pad case
    and a zero-edge operand on small graphs (:func:`rows_edge_graphs`),
    and a hub of 20,000 entries. Each mode timed at H 256 beside its
    plain version, ``torch.sparse.mm`` on the same merged CSR and its
    bound (:func:`rows_bound`, the same for both modes), and its
    plan's units and hub rows printed."""
    import dataclasses as dc

    import numpy as np
    import torch

    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    g = torch.Generator().manual_seed(14)
    x = torch.randn(ds.graph.ncols, HIDDEN, generator=g).to(device)
    xi = torch.randint(-(1 << 30), 1 << 30, (ds.graph.ncols, 64),
                       generator=g, dtype=torch.int32).to(device)
    ints = dc.replace(ds.graph, vals=np.random.default_rng(3).integers(
        -5, 6, ds.graph.nnz).astype(np.int32))
    csr = None
    for mode, key in (("blocked", "K-rows"), ("coo", "K-rows coo")):
        res = {}
        prep = prepare_spmm(ds.graph, SpmmConfig(backend=mode), device=device)
        plan = rows_plan(prep)
        res["units"] = plan.n_units
        res["hub_rows"] = int(plan.hub_rows.size)
        res["plan"] = plan.reading()
        res["max_abs_err"] = rows_close(f"{key} H {HIDDEN}", prep, x)
        for h in ROWS_WIDTHS:
            res[f"err H {h}"] = rows_close(f"{key} H {h}", prep,
                                           x[:, :h].contiguous())
        res["err bf16"] = rows_close(f"{key} bf16", prep,
                                     x.to(torch.bfloat16))
        res["err int32 payload"] = rows_close(f"{key} int32 payload", prep,
                                              xi)
        pi = prepare_spmm(ints, SpmmConfig(backend=mode), device=device)
        for dt, hi in ((torch.int8, 127), (torch.int16, 1 << 14)):
            rows_close(f"{key} integer weights, {dt}", pi,
                       torch.randint(-hi, hi + 1, (ds.graph.ncols, 41),
                                     generator=g, dtype=dt).to(device))
        rows_close(f"{key} integer weights, int32", pi, xi)
        exact = pi.mul_plain(xi.long())  # int64 is taken as int32
        if not torch.equal(pi.mul(xi.long()), exact):
            raise AssertionError(f"{key}: int64 payload")
        d = pi.dev_arrays
        v = d["vals"].reshape(-1).long()
        idx = (d["colind"] if mode == "blocked" else d["cols"]).reshape(-1)
        wide = v[:, None] * xi.long()[idx.long(), :1]
        if not (wide.abs() >= 1 << 31).any():
            raise AssertionError(f"{key}: no product past 2^31")
        del pi, d, v, idx, wide, exact
        for kind, (graph, cfg) in rows_edge_graphs().items():
            small = prepare_spmm(graph, SpmmConfig(backend=mode, **cfg),
                                 device=device)
            xs = torch.randn(graph.ncols, 64, generator=g).to(device)
            rows_close(f"{key} {kind}", small, xs)
            nan_rows_check(f"{key} {kind} NaN x[0]", small, graph.ncols)
            if kind == "hub" and rows_plan(small).hub_rows.tolist() != [7]:
                raise AssertionError(f"{key}: the hub row was not cut")
        if csr is None:
            mg = merge_duplicate_edges(ds.graph)[0]
            csr = torch.sparse_coo_tensor(
                torch.stack([torch.from_numpy(mg.rows).long(),
                             torch.from_numpy(mg.cols).long()]),
                torch.from_numpy(mg.vals.astype(np.float32)),
                (mg.nrows, mg.ncols)).coalesce().to_sparse_csr().to(device)
        res["ms"] = cuda_ms(lambda: prep.mul(x), iters=20)
        res["plain_ms"] = cuda_ms(lambda: prep.mul_plain(x), iters=3)
        res["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=20)
        b = rows_bound(prep, HIDDEN, results["peaks"])
        res["bound_ms"], res["bound_by"] = b["bound_ms"], b["bound_by"]
        res["bound_entries"], res["bound_x_rows"] = b["entries"], b["x_rows"]
        results[key] = res
        print(f"{key}: {json.dumps(res)}", flush=True)
        del prep
        free(device)
    del csr


def rows_full(dataset="reddit", device="cuda") -> int:
    """``--rows-full``: the runners' default (``config=None``: ``blocked``
    on K-rows) on reddit-sim at H 256, as ``PERF.md`` §4's one-liner: the
    plan's readings, K-rows held to its plain version and timed beside
    ``rows_bound`` and ``torch.sparse.mm``, then ``run_spmm_benchmark``
    (``pim_time_spmm``) and the float and int32 forwards
    (``infer_time``), each with ``repeat=10``."""
    import numpy as np
    import torch

    from pygim_tpu_torch.bench.runners import (
        run_inference_benchmark,
        run_spmm_benchmark,
    )
    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line, peaks
    from pygim_tpu_torch.utils.metrics import DataReporter

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line() if torch.device(device).type == "cuda" else "cpu"
    pk = peaks(torch.cuda.get_device_name(0) if card != "cpu"
               else "NVIDIA H100 80GB HBM3")
    t0 = time.perf_counter()
    ds = load_dataset(dataset)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = prepare_spmm(ds.graph, SpmmConfig(), device=device)
    res = dict(dataset=dataset, load_s=load_s,
               prepare_s=time.perf_counter() - t0,
               plan=rows_plan(prep).reading())
    print(f"rows full: {json.dumps(res)}", flush=True)
    x = torch.randn(ds.graph.ncols, HIDDEN,
                    generator=torch.Generator().manual_seed(14)).to(device)
    b = rows_bound(prep, HIDDEN, pk)
    res.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               bound_entries=b["entries"], bound_x_rows=b["x_rows"])
    res["max_abs_err"] = rows_close("K-rows reddit", prep, x)
    res["ms"] = cuda_ms(lambda: prep.mul(x), iters=10)
    mg = merge_duplicate_edges(ds.graph)[0]
    csr = torch.sparse_coo_tensor(
        torch.stack([torch.from_numpy(mg.rows).long(),
                     torch.from_numpy(mg.cols).long()]),
        torch.from_numpy(mg.vals.astype(np.float32)),
        (mg.nrows, mg.ncols)).coalesce().to_sparse_csr().to(device)
    del mg
    res["library_ms"] = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=10)
    del csr
    free(device)
    rep = DataReporter(echo=True)
    reuse = lambda g, c: prep  # noqa: E731
    run_spmm_benchmark(ds, repeat=10, reporter=rep, prepare_fn=reuse,
                       device=device)
    res["pim_time_spmm_ms"] = rep.records["pim_time_spmm(ms)"][-1]
    res["verify"] = rep.records["verify"][-1]
    for a in (None, "int32"):
        run_inference_benchmark(ds, agg_dtype=a, repeat=10, reporter=rep,
                                prepare_fn=reuse, device=device)
        res[f"infer_time_ms {a or 'float'}"] = rep.records[
            "infer_time(ms)"][-1]
    del prep
    free(device)
    graph, cfg = rows_edge_graphs()["full"]
    small = prepare_spmm(graph, SpmmConfig(backend="blocked", **cfg),
                         device=device)
    xs = torch.randn(graph.ncols, 64,
                     generator=torch.Generator().manual_seed(15)).to(device)
    rows_close("K-rows full blocks", small, xs)
    res["host_us"] = rows_host_steps(small, xs)
    print(f"rows full: {json.dumps(res)}", flush=True)
    print(card, flush=True)
    if res["verify"] != "OK":
        print("chip_smoke --rows-full: the SpMM check failed",
              file=sys.stderr)
        return 1
    return 0


def rows_training(ds, results, card, device="cuda"):
    """One GCN training step at hidden 256 on the stand-in's ``blocked``
    operand (the runners' default) and its ``coo`` operand, the
    aggregate's backward on each one's prepared Aᵀ (K-rows): every leaf's
    gradient within GRAD_BAR of autograd through ``mul_plain`` on A
    (``train_steps``' check), both negative controls off by more, and
    K-rows launched in the forward and the backward of the step."""
    import torch

    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    out = {}
    for mode, kernel in (("blocked", "K-rows"), ("coo", "K-rows coo")):
        prep = prepare_spmm(ds.graph, SpmmConfig(backend=mode), device=device)
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
        print(f"training, gcn step on {mode} (Aᵀ prepared in {secs:.1f} s): "
              f"max leaf gradient err against the plain versions {errs}; "
              f"kernels' launches {n} ({card})", flush=True)
        if errs["kernels"] > GRAD_BAR or n[kernel] < 4:
            raise AssertionError(f"{mode} training step: gradients "
                                 f"{errs['kernels']} (bar {GRAD_BAR}), "
                                 f"launches {n}")
        for c in CONTROLS:
            if errs[c] <= GRAD_BAR:
                raise AssertionError(f"{mode}: the {c} control passed "
                                     f"({errs[c]})")
        out[mode] = dict(grad_err=errs, launches=n[kernel],
                         transpose_s=secs)
        del grads, prep
        free(device)
    results["rows training"] = out


def bcsr_training(results, card, device="cuda"):
    """One GCN training step at hidden 256 through a hybrid with a BCSR
    tier (an int8 square core and bf16 panel-major tiles in the lp order
    on :data:`BCSR_TRAIN_GRAPH`), the aggregate's backward on the
    prepared Aᵀ and its own tier: every leaf's gradient within GRAD_BAR
    of autograd through ``mul_plain`` on A, both negative controls off by
    more, K-bcsr launched in the forward and the backward."""
    import torch

    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    ds = load_dataset(BCSR_TRAIN_GRAPH)
    t0 = time.perf_counter()
    prep = prepare_spmm(ds.graph, SpmmConfig(
        backend="hybrid", hybrid_shape="square", hybrid_dtype="int8",
        hybrid_core_bytes=4 << 20, bcsr_bytes=64 << 20, bcsr_tile=16,
        bcsr_layout="panel", bcsr_order="lp", hidden_hint=HIDDEN),
        device=device)
    pt = prep.transpose(ds.graph)
    secs = time.perf_counter() - t0
    if not (prep.has_bcsr and pt.has_bcsr):
        raise AssertionError("bcsr training: no tier on A or Aᵀ")
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
    res = dict(prepare_s=secs, captured=(prep.bcsr_edges, pt.bcsr_edges),
               grad_err=errs, launches=n)
    print(f"bcsr training: {res} ({card})", flush=True)
    if errs["kernels"] > GRAD_BAR or n["K-bcsr"] < 4:
        raise AssertionError(f"bcsr training step: gradients "
                             f"{errs['kernels']} (bar {GRAD_BAR}), "
                             f"launches {n}")
    for c in CONTROLS:
        if errs[c] <= GRAD_BAR:
            raise AssertionError(f"bcsr training: the {c} control passed "
                                 f"({errs[c]})")
    results["bcsr training"] = res


# the tuner's phase: the candidate audit's size and the pick's bar
TUNE_TOP = 5
TUNE_BAR = 1.20
TUNE_FAMILIES = ("blocked", "ell", "hybrid square", "hybrid stair",
                 "BCSR variant")


def tune_family(point) -> str:
    """A candidate's family: its backend, or for a hybrid its core shape,
    or a BCSR variant."""
    if point.get("backend") != "hybrid":
        return point["backend"]
    if point.get("bcsr_bytes"):
        return "BCSR variant"
    return f"hybrid {point.get('hybrid_shape', 'square')}"


def verify_rtol(cfg) -> float:
    """``run_spmm_benchmark``'s verify tolerance for a float payload: 1e-2
    on a bf16, int8 or int4 core (the payload rounded to bf16), 1e-4
    elsewhere."""
    loose = cfg.backend == "hybrid" and cfg.hybrid_dtype in (
        "bfloat16", "int8", "int4")
    return 1e-2 if loose else 1e-4


def verify_close(name, got, want, rtol) -> float:
    """``got`` against ``want`` on every row with the verify check's rule
    (``bench/runners.py:_verify_against_oracle``: rtol, and an atol of 10
    rtol of the row's largest |value|, at least 10 rtol). Returns the max
    abs error."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite values")
    atol = 10 * rtol * want.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    err = (got - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{name}: max abs err {float(err.max())} past "
                             f"rtol {rtol}")
    return float(err.max())


def tune_constants(card, device="cuda"):
    """``measure_constants`` on the card (cached in the script's temporary
    tune cache), printed with its readings and the card line; every
    constant must be finite and positive and no efficiency above 1.05."""
    import math

    from pygim_tpu_torch.tune import measure_constants
    from pygim_tpu_torch.tune.cost_model import CONSTANTS_FILE, cache_dir

    model = measure_constants(device)
    saved = json.loads((cache_dir() / CONSTANTS_FILE).read_text())
    print(f"tune constants ({card}): {json.dumps(saved['model'])}",
          flush=True)
    print(f"tune readings: {json.dumps(saved['readings'])}", flush=True)
    if saved["card"] != card:
        raise AssertionError(f"tune constants filed under {saved['card']!r}")
    for k, v in dataclasses.asdict(model).items():
        if isinstance(v, float) and not (math.isfinite(v) and v > 0):
            raise AssertionError(f"tune constant {k} = {v}")
    for k in ("gather_eff", "stream_eff", "scatter_eff", "core_eff"):
        if getattr(model, k) > 1.05:
            raise AssertionError(f"tune efficiency {k} = "
                                 f"{getattr(model, k)} > 1.05")
    return model, saved["readings"]


def tune_tail_fit(ds, model, device="cuda"):
    """The fit's check on real tables: the smoke stair int8 operand's
    ``tail_time(ms)`` beside the model's tail terms for its plan (the ELL
    issue time, the byte roofline, and the one the model prices),
    printed."""
    import torch

    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.core.partition import ell_issue_seconds
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.tune import plan_statistics

    cfg = SpmmConfig(backend="hybrid", hybrid_shape="stair",
                     hybrid_dtype="int8", hybrid_core_bytes=CORE_BYTES)
    prep = prepare_spmm(ds.graph, cfg, device=device)
    x = torch.randn(prep.ncols, HIDDEN,
                    generator=torch.Generator().manual_seed(11)).to(device)
    tail = prep.phase_times(x, iters=10)["tail_time(ms)"]
    csr = merge_duplicate_edges(ds.graph)[0].to_csr()
    st = plan_statistics(csr, HIDDEN, cfg)
    m = model
    issue = ell_issue_seconds(
        st["ell_slots"], st["ell_vrows"], HIDDEN,
        slot_ns=m.ell_slot_ns * m.ell_slot_factor,
        vrow_fixed_ns=m.ell_vrow_fixed_ns,
        vrow_ns_per_h=m.ell_vrow_ns_per_h) * 1e3
    nbytes = (st["gather_bytes"] / (m.hbm_bw * m.gather_eff)
              + st["stream_bytes"] / (m.hbm_bw * m.stream_eff)
              + st["scatter_bytes"] / (m.hbm_bw * m.scatter_eff)) * 1e3
    res = dict(slots=st["ell_slots"], vrows=st["ell_vrows"],
               issue_ms=issue, bytes_ms=nbytes,
               model_ms=max(issue, nbytes) if m.tail_roofline else issue,
               tail_time_ms=tail)
    print(f"tune tail fit on the smoke tables: {json.dumps(res)}",
          flush=True)
    return res


def tune_config3(ds, card, device="cuda"):
    """Tracked config 3 (``BASELINE_EXPERIMENTS``' two ``tune=True``
    entries, GIN and SAGE on the stand-in) through ``run_experiments``:
    each record with one ``[DATA]device`` line and the ``tuned_*`` lines,
    then each tuned forward's logits against the plain versions
    (:func:`logits_check`)."""
    import torch

    from pygim_tpu_torch.bench import run_experiments
    from pygim_tpu_torch.bench.configs import BASELINE_EXPERIMENTS
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops.spmm import prepare_spmm
    from pygim_tpu_torch.tune import autotune
    from pygim_tpu_torch.utils.metrics import parse_data_lines

    exps = [e for e in BASELINE_EXPERIMENTS if e.tune]
    rdir = os.path.join(os.environ["PYGIM_TPU_TORCH_DATA"], "results_tune")
    out = run_experiments(exps, rdir, device=device)
    # the tuner's pick, from its cache (the key the runs filed it under)
    cfg = autotune(ds.graph, exps[0].hidden, device=device).config
    xf = torch.as_tensor(ds.x).to(device)
    prep = prepare_spmm(ds.graph, cfg, device=device)
    recs = {}
    for exp in exps:
        name = exp.frozen_name()
        if name not in out:
            failed = os.path.join(rdir, name + ".failed")
            tail = open(failed).read()[-3000:] if os.path.exists(failed) \
                else ""
            raise AssertionError(f"config 3: {name} failed\n{tail}")
        rec = parse_data_lines(
            open(os.path.join(rdir, name + ".out")).read().splitlines())
        tuned = {k: rec.get(k) for k in ("tuned_backend", "tuned_balance",
                                         "tuned_block_nnz_budget")}
        if rec.get("device") != [card] or any(
                v is None or len(v) != 1 for v in tuned.values()):
            raise AssertionError(f"config 3: {name}: device "
                                 f"{rec.get('device')}, {tuned}")
        if tuned["tuned_backend"] != [cfg.backend]:
            raise AssertionError(f"config 3: {name} ran {tuned}, the "
                                 f"tuner's pick is {cfg}")
        gnn = make_gnn(0, exp.model, ds.x.shape[1], exp.hidden,
                       ds.num_classes, num_layers=exp.num_layers,
                       device=device)
        logits_check(f"config 3 {exp.model}", gnn, xf, prep, ds.num_classes)
        recs[name] = dict(infer_ms=out[name]["infer_time(ms)"], **tuned)
        print(f"config 3 {name}: {json.dumps(recs[name])}", flush=True)
    del prep
    torch.cuda.empty_cache()
    return dict(config=dataclasses.asdict(cfg), records=recs)


def tune_audit(ds, device="cuda"):
    """The model-mode ranking on the stand-in at H 256, held to the card:
    the top :data:`TUNE_TOP` candidates and the best-predicted of each
    family present (:data:`TUNE_FAMILIES`), each prepared by
    ``prepare_tuned``, warmed, timed (``mul``, CUDA events) and held to
    ``mul_plain`` at the verify tolerance, with its predicted and measured
    ms, its ``device_bytes`` and the rise of the card's peak memory; one
    JSON line each. The pick's measured time must be at most
    :data:`TUNE_BAR` × the fastest audited. Beside them, not ranked, the
    audited BCSR variant on the graph's own f32 cells (f32 tiles, priced
    at the 3xTF32 rate), its prediction by the same model."""
    import torch

    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.ops.spmm import SpmmConfig
    from pygim_tpu_torch.tune import (
        CardCostModel,
        DistPlan,
        TuneResult,
        autotune,
        plan_statistics,
        predict_spmm_time,
        prepare_tuned,
    )

    res = autotune(ds.graph, HIDDEN, device=device, use_cache=False)
    cands = res.candidates
    chosen = list(range(min(TUNE_TOP, len(cands))))
    for fam in TUNE_FAMILIES:
        i = next((i for i, c in enumerate(cands)
                  if tune_family(c[0]) == fam), None)
        if i is not None and i not in chosen:
            chosen.append(i)
    csr = merge_duplicate_edges(ds.graph)[0].to_csr()
    x = torch.randn(csr.ncols, HIDDEN,
                    generator=torch.Generator().manual_seed(12)).to(device)

    def audit_row(rank, family, point, dist, pred_s):
        cfg = SpmmConfig(**point)
        stats = plan_statistics(csr, HIDDEN, cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        prep = prepare_tuned(ds.graph, TuneResult(cfg, DistPlan(**dist),
                                                  pred_s, None, []),
                             device=device)
        prep_s = time.perf_counter() - t0
        got = prep.mul(x)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: prep.mul(x), iters=10, warmup=1)
        rise = torch.cuda.max_memory_allocated() - base
        err = verify_close(f"tune audit {family} {rank}", got,
                           prep.mul_plain(x), verify_rtol(cfg))
        row = dict(rank=rank, family=family, point=point,
                   predicted_ms=pred_s * 1e3, measured_ms=ms,
                   predicted_device_bytes=stats["device_bytes"],
                   memory_rise_bytes=rise, launches=stats["launches"],
                   max_abs_err=err, prepare_s=prep_s)
        if family == "BCSR f32 tiles":
            row["tile_dtype"] = str(prep.dev_arrays["tiles"].dtype)
        print(f"tune audit: {json.dumps(row)}", flush=True)
        del prep, got
        return row

    rows = [audit_row(i, tune_family(cands[i][0]), *cands[i][:3])
            for i in chosen]
    torch.cuda.empty_cache()
    fastest = min(r["measured_ms"] for r in rows)
    pick = rows[0]
    print(f"tune audit: pick {pick['point']} {pick['measured_ms']:.4f} ms, "
          f"fastest audited {fastest:.4f} ms (ratio "
          f"{pick['measured_ms'] / fastest:.4f}, bar {TUNE_BAR})", flush=True)
    if pick["measured_ms"] > TUNE_BAR * fastest:
        raise AssertionError(f"tune: the model's pick takes "
                             f"{pick['measured_ms']} ms, {TUNE_BAR} × the "
                             f"fastest audited {fastest} ms")
    f32 = None
    variant = next((r for r in rows if r["family"] == "BCSR variant"), None)
    if variant is not None:
        point = {**variant["point"], "hybrid_dtype": None}
        dist = next(c[1] for c in cands if c[0] == variant["point"])
        pred_s = predict_spmm_time(
            plan_statistics(csr, HIDDEN, SpmmConfig(**point)),
            CardCostModel.default())
        f32 = audit_row(variant["rank"], "BCSR f32 tiles", point, dist,
                        pred_s)
        if f32["tile_dtype"] != "torch.float32":
            raise AssertionError(f"tune audit: f32 tiles expected, got "
                                 f"{f32['tile_dtype']}")
        torch.cuda.empty_cache()
    return dict(rows=rows, pick_ratio=pick["measured_ms"] / fastest,
                f32_tiles=f32)


def tune_measure(ds, device="cuda"):
    """``autotune(mode="measure")`` once on the stand-in: its pick and
    ``skipped`` printed; a candidate skipped for anything but running out
    of the card's memory fails."""
    from pygim_tpu_torch.tune import autotune

    res = autotune(ds.graph, HIDDEN, mode="measure", device=device,
                   use_cache=False)
    timed = [(c[0], c[2] * 1e3, c[3] * 1e3) for c in res.candidates
             if c[3] is not None]
    print(f"tune measure: pick {res.config.backend} "
          f"{json.dumps(dataclasses.asdict(res.config))} measured "
          f"{res.measured_s * 1e3:.4f} ms; timed (point, predicted ms, "
          f"measured ms) {json.dumps(timed)}; skipped "
          f"{json.dumps(res.skipped)}", flush=True)
    bad = [s for s in res.skipped if not s[2].startswith("OutOfMemoryError")]
    if bad or not timed:
        raise AssertionError(f"tune measure: skipped {bad}, timed {timed}")
    return dict(pick=dataclasses.asdict(res.config),
                measured_ms=res.measured_s * 1e3, timed=timed,
                skipped=res.skipped)


def tune_phase(results, card, device="cuda"):
    """The tuner on the card: its constants, tracked config 3, the
    candidate audit and one measure-mode run, on the smoke stand-in."""
    from pygim_tpu_torch.data import load_dataset

    ds = load_dataset(DATASET)
    model, readings = tune_constants(card, device)
    fit = tune_tail_fit(ds, model, device)
    config3 = tune_config3(ds, card, device)
    audit = tune_audit(ds, device)
    measure = tune_measure(ds, device)
    results["tune"] = dict(model=dataclasses.asdict(model), readings=readings,
                           tail_fit=fit, config3=config3, audit=audit,
                           measure=measure)


TUNE_MESH_ND = 4  # the tuner's device budget in the tune mesh phase
# the float passthrough against its plain version: both round x to the
# same integers, then sum in f32 in other orders (and a bf16-rounded core
# takes the same bf16 payload): 1e-4 of the output's largest magnitude
PASSTHROUGH_BAR = 1e-4
# (config, the kernels its float passthrough must launch)
PASSTHROUGH_KERNELS = {
    "stair int8": ("K-core", "K-tail"),
    "square int4": ("K-core int4", "K-tail"),
    "bf16 square": ("K-core bf16", "K-tail"),
    "f32 square": ("K-f32", "K-tail"),
    "bcsr": ("K-core", "K-tail", "K-bcsr"),
}


def tune_mesh_constants(devices, card):
    """``measure_ici_constants`` over ``devices``: every collective's
    ``bw`` and ``fixed_us`` printed with the card line and the mesh's tag;
    a non-finite value, a ``bw`` not above 0 or a ``fixed_us`` below 0
    (the fit's floor is 0) fails."""
    import math

    from pygim_tpu_torch.tune import measure_ici_constants
    from pygim_tpu_torch.tune.cost_model import COLLECTIVES

    coll = measure_ici_constants(devices)
    meta = coll["__meta"]
    for name in COLLECTIVES:
        bw, fixed = coll[name]["bw"], coll[name]["fixed_us"]
        print(f"tune mesh ici {name} ({card}; {meta['platform']} x"
              f"{meta['n_devices']}, virtual {meta['virtual']}): bw "
              f"{bw:.6g} B/s, fixed_us {fixed:.6g}, readings "
              f"{json.dumps(meta['readings'][name])}", flush=True)
        if not (math.isfinite(bw) and math.isfinite(fixed) and bw > 0
                and fixed >= 0):
            raise AssertionError(f"ici constants of {name}: {coll[name]}")
    return coll


def tune_mesh_ranking(ds, devices, model, label):
    """Model-mode ``autotune`` at a budget of ``len(devices)`` over
    ``devices`` with ``model``: the best candidate of each layout (single,
    each 2d shape, each halo exchange × order) printed with its predicted
    ms and its statistics' ``psum_bytes``, ``launches`` and
    ``device_bytes``. Returns the result and the rows."""
    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.ops.spmm import SpmmConfig
    from pygim_tpu_torch.tune import DistPlan, autotune, plan_statistics

    t0 = time.perf_counter()
    res = autotune(ds.graph, HIDDEN, n_devices=len(devices), devices=devices,
                   model=model, use_cache=False, device=devices[0])
    plan_s = time.perf_counter() - t0
    csr = merge_duplicate_edges(ds.graph)[0].to_csr()
    memo, best = {}, {}
    for i, (_p, d, _t, _m) in enumerate(res.candidates):
        best.setdefault(DistPlan(**d).describe(), i)
    rows = []
    for layout, i in best.items():
        p, d, t, _ = res.candidates[i]
        st = plan_statistics(csr, HIDDEN, SpmmConfig(**p),
                             plan=DistPlan(**d), _memo=memo)
        row = dict(layout=layout, rank=i, point=p, predicted_ms=t * 1e3,
                   psum_bytes=st["psum_bytes"], launches=st["launches"],
                   device_bytes=st["device_bytes"])
        print(f"tune mesh ranking ({label}): {json.dumps(row)}", flush=True)
        rows.append(row)
    print(f"tune mesh ranking ({label}): pick {res.plan.describe()} "
          f"{json.dumps(res.candidates[0][0])}, {len(res.candidates)} "
          f"candidates, constants {res.constants}, host planning "
          f"{plan_s:.2f} s", flush=True)
    return res, rows


def tune_mesh_audit(ds, res, devices, label, bar=None):
    """``prepare_tuned`` over ``devices`` of the best ``2d`` and the best
    ``halo`` candidate of ``res``, and of its pick if it is neither: each
    float product held to ``mul_plain`` at REL_TOL of the sum of |terms|
    and to the single-card product (REL_TOL, or MESH_LOOSE where a
    rounded core takes the float payload), an int32 payload equal to the
    plain arm's and to the single card's; its kernels counted by
    ``launch_counts()`` beside the statistics' ``launches`` (which count
    the PyTorch ops too), its ms (CUDA events) beside the predicted ms,
    the cards' peak-memory rise beside ``device_bytes`` (a shard's). Times
    are labelled ``label`` ("virtual" on one card). With ``bar`` the
    pick's ms must be at most ``bar`` × the fastest audited."""
    import torch

    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.tune import (
        DistPlan,
        TuneResult,
        plan_statistics,
        prepare_tuned,
    )

    dev = devices[0]
    cands = res.candidates
    chosen = []
    for layout in ("2d", "halo"):
        i = next((i for i, c in enumerate(cands) if c[1]["layout"] == layout),
                 None)
        if i is not None:
            chosen.append(i)
    pick = 0 if res.measured_s is None else next(
        i for i, c in enumerate(cands) if c[3] == res.measured_s
        and c[1] == dataclasses.asdict(res.plan))
    if pick not in chosen:
        chosen.append(pick)
    graph = ds.graph
    csr = merge_duplicate_edges(graph)[0].to_csr()
    g = torch.Generator().manual_seed(31)
    x = torch.randn(graph.ncols, HIDDEN, generator=g).to(dev)
    xi = torch.randint(-9, 10, (graph.ncols, HIDDEN), generator=g,
                       dtype=torch.int32).to(dev)
    mag = abs_magnitude(graph, x, dev)
    cards = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
    rows = []
    for i in chosen:
        p, d, t, _ = cands[i]
        cfg, plan = SpmmConfig(**p), DistPlan(**d)
        st = plan_statistics(csr, HIDDEN, cfg, plan=plan)
        for c in cards:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(c)
        base = {c: torch.cuda.memory_allocated(c) for c in cards}
        t0 = time.perf_counter()
        prep = prepare_tuned(graph, TuneResult(cfg, plan, t, None, []),
                             device=dev, devices=devices)
        prep_s = time.perf_counter() - t0
        reset_launch_counts()
        got = prep.mul(x)
        for c in cards:
            torch.cuda.synchronize(c)
        n = launch_counts()
        rise = max((torch.cuda.max_memory_allocated(c) - base[c]
                    for c in cards), default=None)
        key = f"{label} #{i} {plan.describe()} {json.dumps(p)}"
        ms = cuda_ms(lambda: prep.mul(x), iters=5, warmup=1)
        err_plain = check_close(f"tune mesh {key} vs plain", got,
                                prep.mul_plain(x), mag, REL_TOL)
        single = prepare_spmm(graph, cfg, device=dev)
        loose = cfg.backend == "hybrid" and cfg.hybrid_dtype in (
            "int8", "int4", "bfloat16")
        err_single = check_close(f"tune mesh {key} vs single-card", got,
                                 single.mul(x), mag,
                                 MESH_LOOSE if loose else REL_TOL)
        gi = prep.mul(xi)
        for what, want in (("plain", prep.mul_plain(xi)),
                           ("single", single.mul(xi))):
            if not torch.equal(gi, want):
                raise AssertionError(f"tune mesh {key} int32 vs {what}: max "
                                     f"abs err {float((gi - want).abs().max())}")
        row = dict(rank=i, plan=plan.describe(), point=p,
                   predicted_ms=t * 1e3, measured_ms=ms, timing=label,
                   launches_stat=st["launches"],
                   kernel_launches={k: v for k, v in n.items() if v},
                   device_bytes=st["device_bytes"],
                   shards_a_card=max(1, plan.n_devices // max(1, len(cards))),
                   memory_rise_bytes=rise, err_vs_plain=err_plain,
                   err_vs_single=err_single, prepare_s=prep_s)
        print(f"tune mesh audit: {json.dumps(row)}", flush=True)
        rows.append(row)
        del prep, single, got, gi
        free(dev)
    out = {"rows": rows}
    if bar is not None:
        fastest = min(r["measured_ms"] for r in rows)
        ratio = next(r["measured_ms"] for r in rows
                     if r["rank"] == pick) / fastest
        print(f"tune mesh audit ({label}): pick ratio {ratio:.4f} (bar "
              f"{bar})", flush=True)
        if ratio > bar:
            raise AssertionError(f"tune mesh: the pick takes {ratio} × the "
                                 f"fastest audited")
        out["pick_ratio"] = ratio
    return out


def float_passthrough(ds, results, device="cuda"):
    """``mul_quantized(x, "float32")`` on the smoke stair int8, square
    int4, bf16 and f32 operands and an int8 core with a BCSR tier, each
    launch counted (its float kernels, of :data:`PASSTHROUGH_KERNELS`, and
    neither K-int nor K-tail-quant: the float path), held to
    ``mul_quantized_plain`` within :data:`PASSTHROUGH_BAR` of the output's
    largest magnitude, and timed beside the float ``mul``."""
    import torch

    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    dev = torch.device(device)
    cfgs = {"stair int8": SpmmConfig(backend="hybrid", hybrid_shape="stair",
                                     hybrid_dtype="int8",
                                     hybrid_core_bytes=CORE_BYTES),
            "square int4": SpmmConfig(backend="hybrid", hybrid_shape="square",
                                      hybrid_dtype="int4",
                                      hybrid_core_bytes=CORE_BYTES)}
    fcfgs = float_core_configs()
    cfgs.update({k: fcfgs[k] for k in ("bf16 square", "f32 square")})
    cfgs["bcsr"] = SpmmConfig(backend="hybrid", hybrid_dtype="int8",
                              hybrid_core_bytes=MESH_CORE_BYTES, **MESH_BCSR)
    x = torch.randn(ds.graph.ncols, HIDDEN,
                    generator=torch.Generator().manual_seed(37)).to(dev)
    out = {}
    for name, cfg in cfgs.items():
        prep = prepare_spmm(ds.graph, cfg, device=dev)
        if name == "bcsr" and not prep.has_bcsr:
            raise AssertionError("float passthrough: no tile captured")
        reset_launch_counts()
        got = prep.mul_quantized(x, "float32")
        sync(dev)
        n = launch_counts()
        missing = [k for k in PASSTHROUGH_KERNELS[name] if n[k] <= 0]
        if missing or n["K-int"] or n["K-int int4"] or n["K-tail-quant"]:
            raise AssertionError(f"float passthrough {name}: launches {n}")
        want = prep.mul_quantized_plain(x, "float32")
        mag = float(want.abs().max())
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= PASSTHROUGH_BAR * mag):
            raise AssertionError(f"float passthrough {name}: max abs err "
                                 f"{err}, largest magnitude {mag}")
        rec = dict(max_abs_err=err, magnitude=mag,
                   ms=cuda_ms(lambda: prep.mul_quantized(x, "float32"),
                              iters=10),
                   float_mul_ms=cuda_ms(lambda: prep.mul(x), iters=10),
                   launches={k: v for k, v in n.items() if v})
        print(f"float passthrough {name}: {json.dumps(rec)}", flush=True)
        out[name] = rec
        del prep, got, want
        free(dev)
    results["float passthrough"] = out
    return out


def tune_mesh_phase(ds, results, card, device="cuda"):
    """The tuner over a budget of :data:`TUNE_MESH_ND` devices on a
    virtual mesh of the card (``cuda:0`` repeated; it checks every shard's
    work and measures no scaling): the collectives' constants, the
    model-mode ranking with ``CardCostModel.for_topology``, the audit of
    the best 2d and halo candidates and the pick, and the float
    passthrough."""
    import torch

    from pygim_tpu_torch.tune import CardCostModel

    devices = [torch.device(device, 0)] * TUNE_MESH_ND
    coll = tune_mesh_constants(devices, card)
    model = CardCostModel.for_topology(TUNE_MESH_ND, devices)
    res, ranking = tune_mesh_ranking(ds, devices, model, "virtual")
    audit = tune_mesh_audit(ds, res, devices, "virtual")
    passthrough = float_passthrough(ds, results, device)
    results["tune mesh"] = dict(coll=coll, ranking=ranking, audit=audit,
                                passthrough=passthrough,
                                constants=res.constants)


def tune_cards() -> int:
    """``--tune-cards``: over four real cards, the collectives' constants,
    measure-mode ``autotune(n_devices=4)`` (its three best timed over the
    cards) and the audit of :func:`tune_mesh_audit`, the pick within
    :data:`TUNE_BAR` of the fastest audited. Fewer than four cards exit
    1."""
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.parallel.mesh import visible_cards
    from pygim_tpu_torch.tune import autotune
    from pygim_tpu_torch.utils.device import card_line

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --tune-cards: needs four CUDA cards",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    _build.build()
    ds = load_dataset(DATASET)
    devices = visible_cards()[:TUNE_MESH_ND]
    t0 = time.perf_counter()
    tune_mesh_constants(devices, card)
    res = autotune(ds.graph, HIDDEN, n_devices=TUNE_MESH_ND, mode="measure",
                   devices=devices, use_cache=False, device=devices[0])
    timed = [(c[0], c[1], c[2] * 1e3, c[3] * 1e3) for c in res.candidates
             if c[3] is not None]
    print(f"tune cards: pick {res.plan.describe()} "
          f"{json.dumps(dataclasses.asdict(res.config))}, constants "
          f"{res.constants}; timed (point, plan, predicted ms, measured ms) "
          f"{json.dumps(timed)}; skipped {json.dumps(res.skipped)}",
          flush=True)
    if res.skipped or not timed:
        raise AssertionError(f"tune cards: skipped {res.skipped}")
    tune_mesh_audit(ds, res, devices, "cards", bar=TUNE_BAR)
    print(f"phase tune cards: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"count": torch.cuda.device_count()}))
    return 0


def bcsr_full() -> int:
    """``--bcsr-full``: K-bcsr on the tiers of the full-size three-tier
    operands (``bench/configs.py:THREE_TIER_EXPERIMENTS``, products-sim,
    both layouts; from the user's prepare cache where the experiments ran
    before in it), each held to ``bcsr_plain`` and timed against its
    bound and ``torch.sparse.mm``, as the kernels line's entry, then
    :func:`band_sweep` on it."""
    import torch

    from pygim_tpu_torch.bench.configs import THREE_TIER_EXPERIMENTS
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops.spmm import prepare_spmm
    from pygim_tpu_torch.utils.device import card_line, peaks

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    results = {"peaks": peaks(torch.cuda.get_device_name(0))}
    exps = THREE_TIER_EXPERIMENTS[:2]
    ds = load_dataset(exps[0].dataset)
    x = torch.randn(ds.graph.nrows, exps[0].hidden,
                    generator=torch.Generator().manual_seed(0)).cuda()
    for e in exps:
        t0 = time.perf_counter()
        prep = prepare_spmm(ds.graph, e.spmm_config(), device="cuda")
        print(f"{e.bcsr_layout}: prepared in {time.perf_counter() - t0:.1f} s "
              f"(phases {prep.prepare_timer.acc})", flush=True)
        tables = prep.bcsr_tables(prep.dev_arrays)
        a = sparse_of(*tables, prep.nrows)
        bcsr_timing(f"K-bcsr three-tier {e.bcsr_layout}", tables,
                    prep.nrows, x, results["peaks"], results, sparse=a)
        # the wide payloads' routes on the same tier: an int32 x and x
        # rounded for int32 (bf16x3), an int16 x (bf16x2)
        for dt, rounded in (("int32", False), ("int16", False),
                            ("float32", True)):
            xq, safe = x, None
            if rounded:
                safe = rounded_safe(x)
            else:
                xq = torch.randint(-(1 << 12), 1 << 12, x.shape,
                                   generator=torch.Generator().manual_seed(1),
                                   dtype=getattr(torch, dt)).cuda()
            bcsr_timing(f"K-bcsr three-tier {e.bcsr_layout} {dt}"
                        f"{' rounded' if rounded else ''}", tables,
                        prep.nrows, xq, results["peaks"], results, safe=safe,
                        sparse=a)
        del a
        band_sweep(f"three-tier {e.bcsr_layout}", tables, prep.nrows, x)
        del prep, tables
        free("cuda")
    print(card, flush=True)
    return 0


def band_sweep(key, tables, nodes, x) -> None:
    """K-bcsr's time on ``tables`` on its plan with bands forced off and
    on (``ops/bcsr.py:plan_tables`` at 0 and at the band of
    :data:`~pygim_tpu_torch.ops.bcsr.L2_BAND_BYTES`), each product held to
    ``bcsr_plain``; prints each plan's readings and time beside the
    plan's own choice."""
    import torch

    from pygim_tpu_torch.ops import bcsr as kbcsr

    kind, tiles, pidx, rb, _, _ = tables
    tr, h = tiles.shape[2], x.shape[1]
    chosen = kbcsr.bcsr_plan(kind, pidx, rb, tr, h,
                             tile_bytes=tiles.element_size())
    want = kbcsr.bcsr_plain(x, *tables, torch.zeros(nodes, h,
                                                    device=x.device))
    mag = bcsr_mag(x, tables, nodes)
    out = torch.zeros_like(want)
    readings = {}
    for band_rb in (0, max(1, kbcsr.L2_BAND_BYTES // (tr * h * 4))):
        plan = kbcsr.plan_tables(kind, pidx, rb, tr, h, band_rb,
                                 tiles.element_size()).to(x.device)
        check_close(f"{key} bands {band_rb}",
                    kbcsr.bcsr_add(x, *tables, out.zero_(), plan=plan),
                    want, mag, REL_TOL)
        ms = cuda_ms(lambda: kbcsr.bcsr_add(x, *tables, out.zero_(),
                                            plan=plan), iters=10)
        readings[band_rb] = dict(ms=ms, **plan_reading(plan))
    print(json.dumps({"tier": key, "chosen_band_rb": chosen.band_rb,
                      "by_band_rb": readings}), flush=True)


def bcsr_band_sweep() -> int:
    """``--bcsr-sweep``: :func:`band_sweep` on the smoke tiers of
    :data:`BCSR_CONFIGS` and on both layouts of :func:`scale_tiers`, and
    each smoke tier's :func:`bcsr_timing` entry. Prints the readings;
    checks only the products."""
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line, peaks

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    ds = load_dataset(BCSR_GRAPH)
    n = ds.graph.nrows
    x = torch.randn(n, HIDDEN, generator=torch.Generator().manual_seed(1))
    x = x.cuda()
    for key, kw in BCSR_CONFIGS.items():
        prep = prepare_spmm(ds.graph, SpmmConfig(
            backend="hybrid", hybrid_shape="square",
            hybrid_core_bytes=BCSR_CORE_BYTES, bcsr_bytes=BCSR_BYTES,
            hidden_hint=HIDDEN, **kw), device="cuda")
        band_sweep(key, prep.bcsr_tables(prep.dev_arrays), n, x)
        bcsr_timing(f"K-bcsr {key}", prep.bcsr_tables(prep.dev_arrays), n, x,
                    peaks(torch.cuda.get_device_name(0)), {})
        del prep
        free("cuda")
    for tables, nodes, xs in scale_tiers("cuda"):
        band_sweep(f"scale {tables[0]}", tables, nodes, xs)
    return 0


# ---- the core↔tail interleave and the 2D mesh ----------------------------

INTERLEAVE_CORES = ("int8", "int4")  # square cores on the smoke stand-in
INTERLEAVE_CAPS = (0.5, 0.25)  # K-core / K-int grids tried beside K-tail
# the kernel families by the wrapper that asks for the launch's stream
LAUNCHERS = {"ell_tables_add": "tail", "core_bands_scatter_add": "core",
             "core_int_launch": "core", "core_f32_scatter_add": "core",
             "bcsr_add": "bcsr"}


class StreamLog:
    """Records, for each kernel launch inside it, the family of the
    wrapper that launched it (:data:`LAUNCHERS`) and the raw handle of
    the stream it went on: every wrapper asks ``_build.stream_of`` for
    its stream right at the launch."""

    def __enter__(self):
        from pygim_tpu_torch.ops import _build

        self._build, self._orig = _build, _build.stream_of
        self.launches = []

        def stream_of(t):
            handle = self._orig(t)
            caller = sys._getframe(1).f_code.co_name
            self.launches.append((LAUNCHERS.get(caller, caller), handle))
            return handle

        _build.stream_of = stream_of
        return self

    def __exit__(self, *exc):
        self._build.stream_of = self._orig
        return False

    def streams(self, family) -> set:
        return {h for f, h in self.launches if f == family}


def interleave_preps(graph, core_dtype, device="cuda"):
    """(serial, interleaved): the square ``core_dtype`` operand of
    ``graph`` at ``CORE_BYTES`` prepared with ``PYGIM_HYBRID_INTERLEAVE``
    unset, then set to 1 (the second loads the prepare cache the first
    saved: the host tables are the same)."""
    from pygim_tpu_torch.ops.spmm import INTERLEAVE_ENV, SpmmConfig, prepare_spmm

    cfg = SpmmConfig(backend="hybrid", hybrid_dtype=core_dtype,
                     hybrid_core_bytes=CORE_BYTES)
    old = os.environ.pop(INTERLEAVE_ENV, None)
    try:
        serial = prepare_spmm(graph, cfg, device=device)
        os.environ[INTERLEAVE_ENV] = "1"
        inter = prepare_spmm(graph, cfg, device=device)
    finally:
        os.environ.pop(INTERLEAVE_ENV, None)
        if old is not None:
            os.environ[INTERLEAVE_ENV] = old
    if serial.interleave is not None or inter.interleave is None:
        raise AssertionError(f"{core_dtype} square: the interleave plan is "
                             f"{serial.interleave} unset, {inter.interleave} "
                             "set")
    return serial, inter


class capped_core:
    """Inside it, K-core's and K-int's plans on ``prep`` are built for
    ``frac`` of the card's resident blocks (their schedules spread over a
    grid that leaves the rest of the SMs to K-tail); the plans are
    dropped on entry and exit."""

    def __init__(self, prep, frac):
        self.prep, self.frac = prep, frac

    def __enter__(self):
        from pygim_tpu_torch.ops import core_dot, core_int

        self.saved = (core_dot, core_dot.max_clusters, core_int,
                      core_int.max_clusters)
        frac = self.frac

        def cap(fn):
            return lambda *a, **k: {s: max(1, int(c * frac))
                                    for s, c in fn(*a, **k).items()}

        core_dot.max_clusters = cap(core_dot.max_clusters)
        core_int.max_clusters = cap(core_int.max_clusters)
        self._drop()
        return self

    def _drop(self):
        self.prep._core_plans.clear()
        self.prep._int_plans.clear()

    def __exit__(self, *exc):
        core_dot, dot_mc, core_int, int_mc = self.saved
        core_dot.max_clusters, core_int.max_clusters = dot_mc, int_mc
        self._drop()
        return False


def stream_check(name, log, side, main, families):
    """Each of ``families`` launched, the core on ``side`` only and
    everything else on ``main``; returns the launches by family."""
    got = {}
    for fam in families:
        n = sum(1 for f, _h in log.launches if f == fam)
        if n == 0:
            raise AssertionError(f"{name}: no {fam} launch")
        want = side if fam == "core" else main
        if log.streams(fam) != {want}:
            raise AssertionError(f"{name}: {fam} launched on streams "
                                 f"{log.streams(fam)}, not {{{want}}}")
        got[fam] = n
    if side == main:
        raise AssertionError(f"{name}: one stream for both")
    return got


def interleave_phase(ds, results, device="cuda"):
    """The core↔tail interleave on the stand-in's square int8 and int4
    cores at H 256: float32 SpMMs and the fused int8 aggregate with the
    gate off (serial) and on (interleaved), the launch counts set to 0
    before each interleaved call and read after it, and the stream of
    every launch recorded: the core (K-core / K-int) on the operand's
    second stream, K-tail on the caller's. The interleaved products are
    held to the serial ones and to the plain versions (float: REL_TOL of
    the sum of |terms|, K-tail's atomics order hub sums differently a
    call; int8: bit-equal); the int32 aggregate must stay on one stream
    (and within REL_TOL of the serial operand's: its f32 sums of
    integers up to 2^19 are not exact either).
    Times: each operand's SpMM and int8 aggregate serial and
    interleaved, the SpMM through the plain versions, each kernel alone
    (``phase_times``), the pair's bound (the larger of the two
    kernels'), and the interleaved SpMM with the core's grid capped at
    :data:`INTERLEAVE_CAPS` of the card's resident blocks."""
    import torch

    from pygim_tpu_torch.bench.report import operand_info
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.quant import quant_scale

    dev = torch.device(device)
    g = torch.Generator().manual_seed(17)
    x = torch.randn(ds.graph.nrows, HIDDEN, generator=g).to(dev)
    mag = abs_magnitude(ds.graph, x, dev)
    _scale, safe = quant_scale(x, "int8")
    xq = torch.round(x / safe).to(torch.int8)
    out = {}
    for core_dtype in INTERLEAVE_CORES:
        key = f"{core_dtype} square"
        serial, inter = interleave_preps(ds.graph, core_dtype, device)
        slabs, steps, k = inter.interleave
        rec = {"k": k, "slabs": slabs, "steps": steps}
        main = torch.cuda.current_stream(dev).cuda_stream

        reset_launch_counts()
        with StreamLog() as log:
            got = inter.mul(x)
            torch.cuda.synchronize()
        rec["float launches"] = launch_counts()
        side = inter._side[x.device].cuda_stream
        rec["float streams"] = stream_check(f"{key} float", log, side, main,
                                            ("tail", "core"))
        rec["float err vs serial"] = check_close(
            f"{key} interleaved vs serial", got, serial.mul(x), mag, REL_TOL)
        rec["float err vs plain"] = check_close(
            f"{key} interleaved vs plain", got, inter.mul_plain(x), mag,
            REL_TOL)

        reset_launch_counts()
        with StreamLog() as log:
            gq = inter.mul_quantized(x, "int8")
            torch.cuda.synchronize()
        rec["int8 launches"] = launch_counts()
        rec["int8 streams"] = stream_check(f"{key} int8", log, side, main,
                                           ("tail", "core"))
        for what, want in (("serial", serial.mul_quantized(x, "int8")),
                           ("plain", inter.mul_quantized_plain(x, "int8"))):
            if not torch.equal(gq, want):
                raise AssertionError(f"{key} int8 interleaved vs {what}: "
                                     f"max abs err "
                                     f"{float((gq - want).abs().max())}")
        with StreamLog() as log:
            g32 = inter.mul_quantized(x, "int32")
            torch.cuda.synchronize()
        if {h for _f, h in log.launches} != {main}:
            raise AssertionError(f"{key}: the int32 aggregate left the "
                                 "caller's stream")
        # |q| reaches 2^19: the f32 sums of hub rows depend on the order
        # K-tail's atomics land in, so the bar is REL_TOL, not equality
        check_close(f"{key} int32", g32, serial.mul_quantized(x, "int32"),
                    mag, REL_TOL)
        del got, gq, g32

        rec["float ms serial"] = cuda_ms(lambda: serial.mul(x))
        rec["float ms interleaved"] = cuda_ms(lambda: inter.mul(x))
        rec["float ms plain"] = cuda_ms(lambda: inter.mul_plain(x), iters=3)
        rec["int8 ms serial"] = cuda_ms(
            lambda: serial.mul_quantized(x, "int8"))
        rec["int8 ms interleaved"] = cuda_ms(
            lambda: inter.mul_quantized(x, "int8"))
        ph, phq = serial.phase_times(x, iters=10), serial.phase_times(
            xq, iters=10)
        rec["float alone"] = {k_: ph[k_] for k_ in ("tail_time(ms)",
                                                     "core_time(ms)")}
        rec["int8 alone"] = {k_: phq[k_] for k_ in ("tail_time(ms)",
                                                     "core_time(ms)")}
        info = operand_info(serial, HIDDEN, dev, limbs=1)
        rec["float bound ms"] = max(info["core_bound_ms"],
                                    info["tail_bound_ms"])
        rec["int8 bound ms"] = max(info["int_bound_ms"],
                                   info["tail_int8_bound_ms"])
        for frac in INTERLEAVE_CAPS:
            with capped_core(inter, frac):
                check_close(f"{key} capped {frac}", inter.mul(x),
                            serial.mul(x), mag, REL_TOL)
                rec[f"float ms interleaved, core at {frac}"] = cuda_ms(
                    lambda: inter.mul(x))
                rec[f"int8 ms interleaved, core at {frac}"] = cuda_ms(
                    lambda: inter.mul_quantized(x, "int8"))
        print(f"interleave {key}: {json.dumps(rec)}", flush=True)
        out[key] = rec
        del serial, inter
        free(dev)
    results["interleave"] = out
    return out


def interleave_full(dataset="ogbn-products", device="cuda") -> int:
    """``--interleave-full``: tracked config 4 at full size (PERF.md §4:
    the int8 GCN on products-sim, square int4 core at 6 GiB, validated,
    H 256) with ``PYGIM_HYBRID_INTERLEAVE`` unset and then set at
    prepare, each time ``infer_time``, ``validate`` and a float32 SpMM's
    ``pim_time_spmm``, ``core_time`` and ``tail_time`` (the second
    prepare loads the cache the first saved), and ``mul`` and the fused
    int8 aggregate timed in this process, with the gate set also with the
    core's grid capped at :data:`INTERLEAVE_FULL_CAPS` of the resident
    blocks."""
    import torch

    from pygim_tpu_torch.bench.report import config
    from pygim_tpu_torch.bench.runners import (
        run_inference_benchmark,
        run_spmm_benchmark,
    )
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import _build, launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import INTERLEAVE_ENV, prepare_spmm
    from pygim_tpu_torch.utils.device import card_line
    from pygim_tpu_torch.utils.metrics import DataReporter
    from pygim_tpu_torch.utils.timers import device_time

    on_card = torch.device(device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        print(f"card: {card_line()}", flush=True)
        _build.build()
    t0 = time.perf_counter()
    ds = load_dataset(dataset)
    print(f"load: {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = config()
    res = {}
    for gate in ("unset", "1"):
        os.environ.pop(INTERLEAVE_ENV, None)
        if gate == "1":
            os.environ[INTERLEAVE_ENV] = "1"
        t0 = time.perf_counter()
        prep = prepare_spmm(ds.graph, cfg, device=device)
        prep_s = time.perf_counter() - t0
        rep = DataReporter(echo=False)
        reuse = lambda g, c: prep  # noqa: E731
        reset_launch_counts()
        run_inference_benchmark(ds, hidden=HIDDEN, agg_dtype="int8",
                                config=cfg, repeat=10, reporter=rep,
                                prepare_fn=reuse, validate=True,
                                device=device)
        n_inf = launch_counts()
        run_spmm_benchmark(ds, hidden=HIDDEN, dtype="float32", config=cfg,
                           repeat=10, reporter=rep, prepare_fn=reuse,
                           phases=True, device=device)
        keys = ("infer_time(ms)", "validate", "pim_time_spmm(ms)", "verify",
                "tail_time(ms)", "core_time(ms)")
        res[gate] = {"prepare_s": prep_s, "interleave": prep.interleave and
                     [len(prep.interleave[0]), prep.interleave[2]],
                     "launches": n_inf,
                     **{k: rep.records[k][-1] for k in keys}}
        x = torch.randn(prep.ncols, HIDDEN,
                        generator=torch.Generator().manual_seed(3)).to(device)
        for frac in (None,) + (INTERLEAVE_FULL_CAPS if gate == "1" else ()):
            with capped_core(prep, frac or 1.0):
                tag = "" if frac is None else f", core at {frac}"
                res[gate][f"mul ms{tag}"] = device_time(
                    prep.mul, x, iters=10) * 1e3
                res[gate][f"int8 ms{tag}"] = device_time(
                    lambda: prep.mul_quantized(x, "int8"), iters=10) * 1e3
        del x
        print(f"config 4, {INTERLEAVE_ENV} {gate}: {json.dumps(res[gate])}",
              flush=True)
        if res[gate]["validate"] != "OK" or res[gate]["verify"] != "OK":
            raise AssertionError(f"config 4 with the gate {gate} failed its "
                                 "checks")
        del prep
        free(device)
    if res["1"]["interleave"] is None:
        raise AssertionError("config 4: the interleave did not engage")
    os.environ.pop(INTERLEAVE_ENV, None)
    print(json.dumps(res))
    if on_card:
        print(card_line())
    return 0


INTERLEAVE_FULL_CAPS = (0.5, 0.35)  # config 4: the core's modelled share

MESH_SHAPES = ((2, 2), (4, 2), (1, 8))
MESH_CORE_BYTES = 64 << 20  # a shard's core budget (the 2D rule)
MESH_CORES = ("int8", "int4", "bfloat16", "float32")
# (float payload, int32 payload) kernels of each mesh operand's shards
MESH_KERNELS = {
    "ell": (("K-tail",), ("K-tail-quant",)),
    "hybrid int8": (("K-core", "K-tail"), ("K-int", "K-tail-quant")),
    "hybrid int4": (("K-core int4", "K-tail"), ("K-int int4", "K-tail-quant")),
    "hybrid bfloat16": (("K-core bf16", "K-tail"),
                        ("K-f32 limbs", "K-tail-quant")),
    "hybrid float32": (("K-f32", "K-tail"), ("K-f32", "K-tail-quant")),
    "bcsr": (("K-core", "K-tail", "K-bcsr"),
             ("K-int", "K-tail-quant", "K-bcsr")),
}
MESH_BCSR = dict(bcsr_bytes=64 << 20, bcsr_tile=16, bcsr_min_edges=2)
# a float payload through a rounded core (bf16, int8, int4 cells) on
# either side: the runners' verify bar (PERF.md §2)
MESH_LOOSE = 1e-2


def mesh_configs(shape):
    """``{name: (SpmmConfig, scatter_output)}`` run on a mesh of
    ``shape``: ell and the four hybrid cores everywhere; the BCSR tier and
    ``scatter_output`` on (2, 2)."""
    from pygim_tpu_torch.ops.spmm import SpmmConfig

    cfgs = {"ell": (SpmmConfig(backend="ell"), False)}
    for c in MESH_CORES:
        cfgs[f"hybrid {c}"] = (SpmmConfig(
            backend="hybrid", hybrid_dtype=c,
            hybrid_core_bytes=MESH_CORE_BYTES), False)
    if shape == (2, 2):
        cfgs["bcsr"] = (SpmmConfig(
            backend="hybrid", hybrid_dtype="int8",
            hybrid_core_bytes=MESH_CORE_BYTES, **MESH_BCSR), False)
        cfgs["ell scatter"] = (SpmmConfig(backend="ell"), True)
        cfgs["hybrid int8 scatter"] = (cfgs["hybrid int8"][0], True)
    return cfgs


def abs_magnitude(graph, x, device):
    """The sum of |terms| behind each element of ``graph @ x``: the plain
    ell product of |A| and |x|."""
    from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

    a = dataclasses.replace(graph, vals=abs(graph.vals).astype("float32"))
    return prepare_spmm(a, SpmmConfig(backend="ell"), device=device) \
        .mul_plain(x.float().abs())


def mesh_phase(ds, results, device="cuda", cards=False):
    """The 2D mesh on virtual meshes of :data:`MESH_SHAPES` over one
    device (the card repeated), or with ``cards`` on those of them that
    fit the visible cards, over the cards: on the stand-in at H 256, every operand of
    :func:`mesh_configs` multiplies a float32 and an int32 payload, each
    with the launch counts set to 0 before and read after (the kernels of
    :data:`MESH_KERNELS` must have launched at shard shapes), held to its
    plain version (float: REL_TOL of the sum of |terms|; int32: equal)
    and to the single-card operand of the same configuration (int32:
    equal; float: REL_TOL, or :data:`MESH_LOOSE` where a rounded core
    takes the float payload on either side); its ``phase_times``
    (``mul_time``, ``local_time``, ``psum_time``) beside the merge's
    least bytes and their time at the card's HBM rate. Then the float and
    the int32 GCN forwards over a (2, 2) mesh of f32 cores against the
    same forwards on the single-card f32 core (within 1e-4 of the
    logits' scale), their launches counted."""
    import torch

    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import PreparedAggregate, prepare_spmm
    from pygim_tpu_torch.parallel import make_mesh, prepare_spmm_2d

    dev = torch.device(device)
    graph = ds.graph
    g = torch.Generator().manual_seed(23)
    x = torch.randn(graph.ncols, HIDDEN, generator=g).to(dev)
    xi = torch.randint(-9, 10, (graph.ncols, HIDDEN), generator=g,
                       dtype=torch.int32).to(dev)
    mags = (abs_magnitude(graph, x, dev), abs_magnitude(graph, xi, dev))
    singles, out = {}, {}
    n_cards = torch.cuda.device_count() if cards else 0

    def grid(sp, ds_):
        return make_mesh(sp, ds_, None if cards else [dev] * (sp * ds_))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for shape in MESH_SHAPES:
        if cards and shape[0] * shape[1] > n_cards:
            continue
        mesh = grid(*shape)
        for name, (cfg, scatter) in mesh_configs(shape).items():
            key = f"{shape[0]}x{shape[1]} {name}"
            t0 = time.perf_counter()
            op = prepare_spmm_2d(graph, mesh, cfg, scatter_output=scatter)
            rec = {"prepare_s": time.perf_counter() - t0,
                   "k": op.hybrid_k_eff, "tables": op.ell_meta,
                   "bcsr_edges": op.bcsr_edges,
                   "device_bytes": op.device_bytes}
            if name.startswith("bcsr") and not op.has_bcsr:
                raise AssertionError(f"{key}: no tile captured")
            base = name.replace(" scatter", "")
            if base not in singles:
                singles[base] = prepare_spmm(graph, cfg, device=dev)
            single = singles[base]
            for (label, payload), mag, kernels in zip(
                    (("float", x), ("int32", xi)), mags, MESH_KERNELS[base]):
                reset_launch_counts()
                got = op.mul(payload)
                sync()
                n = launch_counts()
                for k_ in kernels:
                    if n[k_] <= 0:
                        raise AssertionError(f"{key} {label}: {k_} was never "
                                             "launched")
                rec[f"{label} launches"] = {k_: v for k_, v in n.items() if v}
                plain, one = op.mul_plain(payload), single.mul(payload)
                if label == "int32":
                    for what, want in (("plain", plain), ("single", one)):
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"{key} int32 vs {what}: max abs err "
                                f"{float((got - want).abs().max())}")
                    continue
                rec["float err vs plain"] = check_close(
                    f"{key} vs plain", got, plain, mag, REL_TOL)
                loose = cfg.backend == "hybrid" and cfg.hybrid_dtype in (
                    "int8", "int4", "bfloat16")
                rec["float err vs single"] = check_close(
                    f"{key} vs single-card", got, one, mag,
                    MESH_LOOSE if loose else REL_TOL)
                del got, plain, one
            rec["phase_times"] = op.phase_times(x, iters=5)
            # the merge's least bytes: each sp partial read once and each
            # column's sum written once, (rows, H / ds) f32 a shard
            hd = -(-HIDDEN // shape[1])
            merge_bytes = 4 * op.nrows_pad * hd * (shape[0] + 1) * shape[1]
            rec["psum bytes"] = merge_bytes
            if "peaks" in results:
                rec["psum bound ms"] = merge_bytes / results["peaks"][0] * 1e3
            print(f"mesh {key}: {json.dumps(rec)}", flush=True)
            out[key] = rec
            del op
            free(dev)

    mesh = grid(2, 2)
    cfg = mesh_configs((2, 2))["hybrid float32"][0]
    op = prepare_spmm_2d(graph, mesh, cfg)
    single = singles["hybrid float32"]
    xf = torch.as_tensor(ds.x).to(dev)
    gcn = {}
    for agg_dtype, kernels in ((None, ("K-f32", "K-tail")),
                               ("int32", ("K-f32", "K-tail-quant"))):
        gnn = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                       num_layers=2, agg_dtype=agg_dtype, device=dev)
        reset_launch_counts()
        with torch.inference_mode():
            got = gnn(xf, PreparedAggregate(op))
            sync()
            n = launch_counts()
            want = gnn(xf, PreparedAggregate(single))
        for k_ in kernels:
            if n[k_] <= 0:
                raise AssertionError(f"2x2 GCN {agg_dtype}: {k_} was never "
                                     "launched")
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > 1e-4 * scale:
            raise AssertionError(f"2x2 GCN {agg_dtype or 'float'}: logits off "
                                 f"by {err} (scale {scale})")
        with torch.inference_mode():
            gcn[agg_dtype or "float"] = {
                "max_abs_err": err, "scale": scale,
                "launches": {k_: v for k_, v in n.items() if v},
                "ms": cuda_ms(lambda: gnn(xf, PreparedAggregate(op)),
                              iters=5),
                "single_ms": cuda_ms(
                    lambda: gnn(xf, PreparedAggregate(single)), iters=5)}
        print(f"mesh 2x2 GCN {agg_dtype or 'float'}: "
              f"{json.dumps(gcn[agg_dtype or 'float'])}", flush=True)
    out["gcn"] = gcn
    results["mesh"] = out
    return out


def mesh_cards() -> int:
    """``--mesh-cards``: the ``mesh`` phase over the visible cards (the
    shapes of :data:`MESH_SHAPES` that fit them, at least (2, 2): four
    cards), each shard's tables and partial on its own card and the
    partials moved to ``cuda:0`` for the merge."""
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.utils.device import peaks

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --mesh-cards: needs four CUDA cards",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build()
    results = {"peaks": peaks(torch.cuda.get_device_name(0))}
    timed_phase("mesh over the cards", mesh_phase, load_dataset(DATASET),
                results, "cuda:0", True)
    print(json.dumps({"count": torch.cuda.device_count()}))
    return 0


def mesh_full(dataset="reddit", device="cuda") -> int:
    """``--mesh-full``: reddit-sim's 2-layer GCN at H 256 (float and int32
    aggregation) and a float32 SpMM with its phases on a (2, 2) virtual
    mesh of ``ell`` on the card, beside the single-card ``ell``
    operand's."""
    import torch

    from pygim_tpu_torch.bench.runners import (
        run_inference_benchmark,
        run_spmm_benchmark,
    )
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.ops.spmm import SpmmConfig
    from pygim_tpu_torch.parallel import make_mesh
    from pygim_tpu_torch.utils.device import card_line
    from pygim_tpu_torch.utils.metrics import DataReporter

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        print(f"card: {card_line()}", flush=True)
        _build.build()
        dev = torch.device("cuda", 0)
    ds = load_dataset(dataset)
    cfg = SpmmConfig(backend="ell")
    res = {}
    for layout, mesh in (("mesh 2x2", make_mesh(2, 2, [dev] * 4)),
                         ("single-chip", None)):
        rep = DataReporter(echo=False)
        run_spmm_benchmark(ds, hidden=HIDDEN, config=cfg, repeat=5,
                           reporter=rep, phases=True, device=dev, mesh=mesh)
        for agg in (None, "int32"):
            run_inference_benchmark(ds, hidden=HIDDEN, agg_dtype=agg,
                                    config=cfg, repeat=5, reporter=rep,
                                    device=dev, mesh=mesh)
        res[layout] = {k: v for k, v in rep.records.items()
                       if k.endswith("(ms)") or k in ("verify", "layout")}
        print(f"{dataset} {layout}: {json.dumps(res[layout])}", flush=True)
        if rep.records["verify"][-1] != "OK":
            raise AssertionError(f"{dataset} {layout}: SpMM check failed")
        free(dev)
    print(json.dumps(res))
    if on_card:
        print(card_line())
    return 0


HALO_SIZES = (2, 4, 8)
HALO_EXCHANGES = ("all_gather", "all_to_all", "ring")
HALO_CORE_BYTES = 16 << 20  # a shard's slab budget
# (float payload, int32 payload) kernels of each halo operand's shards
HALO_KERNELS = {
    "ell": MESH_KERNELS["ell"],
    "hybrid int8": MESH_KERNELS["hybrid int8"],
    "hybrid int4": MESH_KERNELS["hybrid int4"],
    "hybrid bfloat16": MESH_KERNELS["hybrid bfloat16"],
    "hybrid float32": MESH_KERNELS["hybrid float32"],
    "bcsr": MESH_KERNELS["bcsr"],
}
HALO_ORDERS = ("rcm", "metis", "auto")
# the configurations run at every node count; the rest only at nd 4
HALO_EVERY_SIZE = ("ell", "hybrid int8")


def halo_configs():
    """``{name: SpmmConfig}`` of the halo phase: ell, the four slab cell
    types, and the int8 slab with a BCSR tier."""
    from pygim_tpu_torch.ops.spmm import SpmmConfig

    cfgs = {"ell": SpmmConfig(backend="ell")}
    for c in MESH_CORES:
        cfgs[f"hybrid {c}"] = SpmmConfig(backend="hybrid", hybrid_dtype=c,
                                         hybrid_core_bytes=HALO_CORE_BYTES)
    cfgs["bcsr"] = SpmmConfig(backend="hybrid", hybrid_dtype="int8",
                              hybrid_core_bytes=HALO_CORE_BYTES, **MESH_BCSR)
    return cfgs


def halo_cases():
    """``(nd, exchange, config name, order)`` of the halo phase: at nd 4
    every exchange × every configuration; at the other node counts (a
    shard with no rows at 8, a ring of one shift at 2) every exchange ×
    :data:`HALO_EVERY_SIZE`; then the orders rcm, metis and auto at nd 4
    on all_to_all with ell (none everywhere else)."""
    cases = [(nd, e, c, None) for nd in HALO_SIZES for e in HALO_EXCHANGES
             for c in halo_configs() if nd == 4 or c in HALO_EVERY_SIZE]
    cases += [(4, "all_to_all", "ell", o) for o in HALO_ORDERS]
    return cases


def exchange_rows(op) -> int:
    """Rows the exchange of one product writes, summed over the shards:
    all of x once a distinct device (all_gather; shards on one device
    share it), ``nd`` slots of ``halo_k`` (all_to_all), the ring's blocks
    (ring)."""
    if op.exchange == "all_gather":
        return len(set(op.mesh.devices)) * op.n_pad
    if op.exchange == "all_to_all":
        return op.nd * op.nd * op.halo_k
    return op.nd * (op.halo_k if op.nd > 1 else 0)


def halo_phase(ds, results, device="cuda", cards=False):
    """The halo layout on node meshes of :data:`HALO_SIZES` over one
    device (the card repeated: virtual meshes), or with ``cards`` on
    those that fit the visible cards: on the stand-in at H 256, each case
    of :func:`halo_cases` multiplies a float32 and an int32 payload, each
    with the launch counts set to 0 before and read after (the kernels of
    :data:`HALO_KERNELS` must have launched at shard shapes), held to its
    plain version (float: REL_TOL of the sum of |terms|; int32: equal)
    and to the single-card operand of the same configuration (int32:
    equal; float: REL_TOL, or :data:`MESH_LOOSE` where a rounded core
    takes the float payload on either side). At nd 4 each operand's
    ``phase_times`` and its exchange alone are timed beside the
    exchange's least time: the rows it delivers read and written once at
    the card's HBM rate. Then ``run_scaling_benchmark`` over ``cuda:0``
    four times, which must report ``virtual_mesh``."""
    import torch

    from pygim_tpu_torch.bench.scaling import run_scaling_benchmark
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import prepare_spmm
    from pygim_tpu_torch.parallel import make_node_mesh, prepare_spmm_halo
    from pygim_tpu_torch.utils.metrics import DataReporter

    dev = torch.device(device)
    graph = ds.graph
    g = torch.Generator().manual_seed(29)
    x = torch.randn(graph.ncols, HIDDEN, generator=g).to(dev)
    xi = torch.randint(-9, 10, (graph.ncols, HIDDEN), generator=g,
                       dtype=torch.int32).to(dev)
    mags = (abs_magnitude(graph, x, dev), abs_magnitude(graph, xi, dev))
    n_cards = torch.cuda.device_count() if cards else 0
    cfgs = halo_configs()
    singles, out = {}, {}
    for nd, exchange, name, order in halo_cases():
        if cards and nd > n_cards:
            continue
        mesh = make_node_mesh(nd, None if cards else [dev] * nd)
        key = f"nd{nd} {exchange} {name}" + (f" {order}" if order else "")
        t0 = time.perf_counter()
        op = prepare_spmm_halo(graph, mesh, cfgs[name], exchange=exchange,
                               order=order)
        rec = {"prepare_s": time.perf_counter() - t0, "k": op.hybrid_k_eff,
               "halo_k": op.halo_k, "request_rows": op.request_rows,
               "order": op.order_choice, "bcsr_edges": op.bcsr_edges,
               "device_bytes": op.device_bytes}
        if name == "bcsr" and not op.has_bcsr:
            raise AssertionError(f"{key}: no tile captured")
        if name not in singles:
            singles[name] = prepare_spmm(graph, cfgs[name], device=dev)
        single = singles[name]
        first = mesh.devices[0]
        for (label, payload), mag, kernels in zip(
                (("float", x), ("int32", xi)), mags, HALO_KERNELS[name]):
            reset_launch_counts()
            got = op.mul(payload)
            sync(first)
            n = launch_counts()
            for k_ in kernels:
                if n[k_] <= 0:
                    raise AssertionError(f"{key} {label}: {k_} was never "
                                         "launched")
            rec[f"{label} launches"] = {k_: v for k_, v in n.items() if v}
            plain, one = op.mul_plain(payload), single.mul(payload)
            if label == "int32":
                for what, want in (("plain", plain), ("single", one)):
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{key} int32 vs {what}: max abs err "
                            f"{float((got - want).abs().max())}")
                continue
            rec["float err vs plain"] = check_close(
                f"{key} vs plain", got, plain, mag, REL_TOL)
            loose = name != "ell" and name != "hybrid float32"
            rec["float err vs single"] = check_close(
                f"{key} vs single-card", got, one, mag,
                MESH_LOOSE if loose else REL_TOL)
            del got, plain, one
        if nd == 4 and order is None:
            rec["phase_times"] = op.phase_times(x, iters=5)
            x_loc = op._x_loc(x, op.dev_arrays)
            rec["exchange ms"] = cuda_ms(
                lambda: op._received(x_loc, op.dev_arrays), iters=5)
            rows = exchange_rows(op)
            rec["exchange rows"] = rows
            rec["exchange bound ms"] = (2 * 4 * rows * HIDDEN
                                        / results["peaks"][0] * 1e3)
            del x_loc
        print(f"halo {key}: {json.dumps(rec)}", flush=True)
        out[key] = rec
        del op
        free(dev)
    del singles
    free(dev)
    means = run_scaling_benchmark(
        ds, [1, 2, 4], hidden=HIDDEN, exchange="all_to_all", repeat=5,
        reporter=DataReporter(echo=False),
        devices=None if cards else [dev] * 4)
    print(f"halo scaling benchmark ({'cards' if cards else 'virtual'}): "
          f"{json.dumps(means)}", flush=True)
    if bool(means["virtual_mesh"]) == cards:
        raise AssertionError(f"virtual_mesh {means['virtual_mesh']} on "
                             f"{'the cards' if cards else 'one card'}")
    out["scaling"] = means
    results["halo"] = out
    return out


MESH_TRAIN_OPERANDS = {
    "2x2 ell": ("2d", "ell"), "2x2 hybrid int8": ("2d", "hybrid int8"),
    "halo 4 ell all_to_all": ("all_to_all", "ell"),
    "halo 4 hybrid int8 ring": ("ring", "hybrid int8"),
}


def mesh_train_phase(ds, results, card, device="cuda"):
    """Training over the meshes: a (2, 2) 2D mesh and a 4-way halo, each
    of ``ell`` and of a square int8 core (virtual meshes of the card),
    their transposes prepared; the GCN at hidden 256 trains through the
    kernels (``SpmmFunction`` on the mesh's Aᵀ), through the plain
    versions (autograd through ``mul_plain`` on A) and through the two
    negative controls: every leaf's gradient of one step within GRAD_BAR
    of the plain arm's and the losses of TRAIN_STEPS Adam steps within
    LOSS_BAR, both controls failing the gradient check and the cut control
    the loss check too (LOSS_CONTROLS), the kernels' launches counted and
    none in the plain arm."""
    import numpy as np
    import torch

    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.ops.spmm import PreparedAggregate
    from pygim_tpu_torch.parallel import (
        make_mesh,
        make_node_mesh,
        prepare_spmm_2d,
        prepare_spmm_halo,
    )

    dev = torch.device(device)
    inputs = train_inputs(ds, dev)
    cfgs = halo_configs()
    out = {}
    for key, (layout, name) in MESH_TRAIN_OPERANDS.items():
        t0 = time.perf_counter()
        if layout == "2d":
            op = prepare_spmm_2d(ds.graph, make_mesh(2, 2, [dev] * 4),
                                 cfgs[name])
        else:
            op = prepare_spmm_halo(ds.graph, make_node_mesh(4, [dev] * 4),
                                   cfgs[name], exchange=layout)
        op.transpose(ds.graph)
        prep_s = time.perf_counter() - t0
        arms = {"kernels": PreparedAggregate(op), "plain": PlainAggregate(op),
                "cut": CutAggregate(op), "untransposed": untransposed(op)}
        grads = {a: leaf_grads("gcn", ds, agg, inputs)
                 for a, agg in arms.items()}
        gerr = {a: max(leaf_errs(g, grads["plain"]).values())
                for a, g in grads.items() if a != "plain"}
        del grads
        runs = {a: arm_losses("gcn", ds, agg, inputs, TRAIN_LR)
                for a, agg in arms.items()}
        lp = runs["plain"][1]
        ldrift = {a: drift(r[1], lp) for a, r in runs.items() if a != "plain"}
        nk = runs["kernels"][2]
        rec = dict(prepare_s=prep_s, grad_err=gerr, loss_drift=ldrift,
                   losses=runs["kernels"][1], plain_losses=lp,
                   launches={k_: v for k_, v in nk.items() if v})
        print(f"mesh train {key}: {json.dumps(rec)} ({card})", flush=True)
        if (gerr["kernels"] > GRAD_BAR or ldrift["kernels"] > LOSS_BAR
                or not np.isfinite(runs["kernels"][1]).all()):
            raise AssertionError(f"mesh train {key}: kernels against plain, "
                                 f"gradients {gerr['kernels']}, losses "
                                 f"{ldrift['kernels']}")
        for c in CONTROLS:
            if gerr[c] <= GRAD_BAR or (c in LOSS_CONTROLS
                                       and ldrift[c] <= LOSS_BAR):
                raise AssertionError(f"mesh train {key}: the {c} control "
                                     f"passed ({gerr[c]}, {ldrift[c]})")
        want = HALO_KERNELS[name][0]
        plain_n = {k_: v for k_, v in runs["plain"][2].items() if v}
        if any(nk[k_] <= 0 for k_ in want) or plain_n:
            raise AssertionError(f"mesh train {key}: launches {nk}, plain "
                                 f"{plain_n}")
        out[key] = rec
        del runs, arms, op
        free(dev)
    results["mesh train"] = out
    return out


def dryrun_phase(results, device="cuda"):
    """``pygim_tpu_torch/entry.py:dryrun_multichip(8)`` on the card (a
    virtual mesh where fewer than eight cards are visible)."""
    from pygim_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(8, device=device)
    results["dryrun"] = time.perf_counter() - t0
    print(f"dryrun_multichip(8): passed in {results['dryrun']:.1f} s",
          flush=True)


def halo_full_tune(ds, hidden, res, dev) -> dict:
    """The tuner at a budget of eight on config 5's graph at ``hidden``:
    model-mode ``autotune`` with ``CardCostModel.for_topology`` over the
    virtual mesh, its host planning's seconds, and the best predicted
    ``ell`` plan of the halo ``all_to_all`` and ``ring`` exchanges (order
    none) and of one card beside the ``mul_time`` the scaling runs
    measured at nd 8 and on one card (``res``: their means by
    exchange)."""
    from pygim_tpu_torch.tune import CardCostModel, autotune

    devices = [dev] * 8
    model = CardCostModel.for_topology(8, devices)
    t0 = time.perf_counter()
    tuned = autotune(ds.graph, hidden, n_devices=8, devices=devices,
                     model=model, use_cache=False, device=dev)
    out = {"host_planning_s": time.perf_counter() - t0,
           "pick": tuned.plan.describe(), "constants": tuned.constants}
    nnz = ds.graph.nnz
    for exchange in ("all_to_all", "ring", "single"):
        pred = next((c[2] for c in tuned.candidates
                    if c[0]["backend"] == "ell" and (
                        c[1]["layout"] == "single" if exchange == "single"
                        else (c[1]["layout"] == "halo"
                              and c[1]["exchange"] == exchange
                              and c[1]["order"] == "none"))), None)
        means = res.get("ring" if exchange == "single" else exchange, {})
        n = 1 if exchange == "single" else 8
        eps = means.get(f"edges_per_s_n{n}")
        out[exchange] = {"predicted_ms": None if pred is None else pred * 1e3,
                         "virtual_mul_ms": nnz / eps * 1e3 if eps else None}
    print(f"config 5 tuner at a budget of 8 (virtual mesh; the mesh "
          f"predictions are per device as if the cards ran at once, the "
          f"measured times of one card running every shard): "
          f"{json.dumps(out)}", flush=True)
    return out


def halo_full(device="cuda") -> int:
    """``--halo-full``: tracked config 5's four entries
    (``bench/configs.py``) through ``run_scaling_benchmark`` on a virtual
    node mesh of eight (``cuda:0`` repeated) at counts 1, 2, 4 and 8:
    ``edges_per_s`` and the halo request and buffer rows. One card runs
    every shard in turn, so these measure no scaling. Then the tuner at
    a budget of eight on the same graph (:func:`halo_full_tune`)."""
    import torch

    from pygim_tpu_torch.bench.configs import BASELINE_EXPERIMENTS
    from pygim_tpu_torch.bench.scaling import run_scaling_benchmark
    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.utils.device import card_line
    from pygim_tpu_torch.utils.metrics import DataReporter

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    _build.build()
    dev = torch.device(device, 0)
    res, ell_means = {}, {}
    for exp in (e for e in BASELINE_EXPERIMENTS if e.kind == "scaling"):
        t0 = time.perf_counter()
        ds = load_dataset(exp.dataset)
        means = run_scaling_benchmark(
            ds, [1, 2, 4, 8], hidden=exp.hidden, exchange=exp.exchange,
            config=exp.spmm_config(), repeat=exp.repeat,
            reporter=DataReporter(echo=False),
            model=exp.model if exp.scale_model else None,
            num_layers=exp.num_layers,
            agg_dtype=None if exp.dtype == "float32" else exp.dtype,
            order=exp.cluster or None, devices=[dev] * 8)
        means["seconds"] = time.perf_counter() - t0
        res[exp.frozen_name()] = means
        print(f"config 5 {exp.frozen_name()} (virtual mesh of 8 on one card, "
              f"no scaling measured): {json.dumps(means)}", flush=True)
        if exp.backend == "ell" and not exp.scale_model:
            ell_means[exp.exchange] = means
            hidden = exp.hidden
        del ds
        free(dev)
    res["tuner"] = halo_full_tune(load_dataset(exp.dataset), hidden,
                                  ell_means, dev)
    print(json.dumps(res))
    print(card_line())
    return 0


def halo_cards() -> int:
    """``--halo-cards``: the ``halo`` phase over the visible cards (the
    node meshes of :data:`HALO_SIZES` that fit them, at least 4 cards),
    each shard's tables and products on its own card, the exchanges peer
    copies."""
    import torch

    from pygim_tpu_torch.data import load_dataset
    from pygim_tpu_torch.ops import _build
    from pygim_tpu_torch.utils.device import peaks

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_smoke --halo-cards: needs four CUDA cards",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build()
    results = {"peaks": peaks(torch.cuda.get_device_name(0))}
    timed_phase("halo over the cards", halo_phase, load_dataset(DATASET),
                results, "cuda:0", True)
    print(json.dumps({"count": torch.cuda.device_count()}))
    return 0


EPI_EPS = 1e-5
EPI_RAGGED = ((1037, 41), (1037, 1100))  # N off every block; H 41: single elements


def same(got, want) -> bool:
    """Equal shape, dtype and values, NaN where the other has NaN
    (``torch.equal`` alone holds a NaN unequal to itself)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def same_bits(got, want) -> bool:
    """:func:`same` for float32, and every non-NaN value equal in its bits
    (the sign of a zero too)."""
    import torch

    ok = ~torch.isnan(want)
    return same(got, want) and torch.equal(
        got[ok].contiguous().view(torch.int32),
        want[ok].contiguous().view(torch.int32))


def with_specials(t):
    """``t`` (float32) with a NaN, +inf, -inf and -0 in four of its
    elements, in place."""
    flat = t.view(-1)
    n = flat.numel()
    for i, v in zip((0, n // 3, n // 2, n - 1),
                    (float("nan"), float("inf"), float("-inf"), -0.0)):
        flat[i] = v
    return t


def misaligned(t):
    """A contiguous copy of ``t`` one element off 16-byte alignment: the
    kernels' single-element paths."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def half_steps(n, h, k, step, gen, dev):
    """float32 (n, h) of half steps ``(j + 1/2) · step`` with max|x| =
    ``2^(k-1) · step``, so ``safe`` is ``step`` and every value a tie."""
    import torch

    half = 1 << (k - 1)
    j = torch.randint(-half, half, (n, h), generator=gen)
    x = ((j + 0.5) * step).float()
    x.view(-1)[0] = half * step
    return x.to(dev)


def epi_params(h, gen, dev, scale, bias):
    import torch

    mean, gamma, beta = (torch.randn(h, generator=gen).to(dev)
                         for _ in range(3))
    var = (torch.rand(h, generator=gen) + 0.2).to(dev)
    s = torch.tensor(0.37).to(dev) if scale else None
    c = torch.randn(h, generator=gen).to(dev) if bias else None
    return mean, var, gamma, beta, s, c


def forward_launches(gnn, xf, agg) -> dict:
    """The kernels' launches of one evaluation forward, by name (the
    counts set to 0 before it)."""
    import torch

    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    with torch.inference_mode():
        gnn(xf, agg)
    torch.cuda.synchronize()
    return {k: v for k, v in launch_counts().items() if v}


def epilogue_checks(ds, prep, prep4, results, device="cuda"):
    """K-epi (``csrc/epilogue.cu``) and K-quant (``csrc/quant.cu``) against
    their plain versions, bit for bit (:func:`same`; K-quant's scales in
    their bits): K-epi at the smoke shape (the stand-in's N at H 256) and
    at ragged shapes (:data:`EPI_RAGGED`), a misaligned input, each with
    the scale and the bias absent and present, NaN, ±inf and -0 entries;
    K-quant's max|x| at the same shapes and with NaN, ±inf, -0 and
    all-zero inputs for each scale exponent; its table (int8, int16, int32,
    int64) there and on half-step ties; its core payload on the smoke
    operand's rank gather (f32 rounded at three limbs, the int8 and int16
    tables at one and two, a raw int32 at four) and at the ragged widths
    with ties, specials and zeros. Each timed at the smoke shape beside its
    plain version, its bytes bound and a library call where one computes
    it (K-epi: ``F.batch_norm(training=False)`` and ``torch.relu``, two
    calls, on the input without scale and bias; max|x|:
    ``torch.linalg.vector_norm(x, inf)``). Then one fused forward of each
    main path's model counted: three K-epi launches a 2-layer GCN, and
    K-quant's entry points where it quantizes."""
    import torch
    import torch.nn.functional as F

    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.ops import epilogue as epi
    from pygim_tpu_torch.ops import quant_prologue as kq
    from pygim_tpu_torch.ops.spmm import (
        PreparedAggregate,
        SpmmConfig,
        prepare_spmm,
    )

    hbm, _bf16, f32_rate, _int8 = results["peaks"]
    gen = torch.Generator().manual_seed(22)
    n_smoke = prep.nrows
    t0 = time.perf_counter()
    cases = {"K-epi": 0, "K-quant abs_max": 0, "K-quant table": 0,
             "K-quant payload": 0}

    # K-epi
    for n, h in ((n_smoke, HIDDEN),) + EPI_RAGGED:
        for scale, bias in itertools.product((False, True), repeat=2):
            mean, var, gamma, beta, s, c = epi_params(h, gen, device, scale,
                                                      bias)
            inv = torch.rsqrt(var + EPI_EPS)
            a = (3 * torch.randn(n, h, generator=gen)).to(device)
            for label, x in (("", a), ("specials", with_specials(a.clone())),
                             ("misaligned", misaligned(a))):
                got = epi.epilogue(x, mean, var, gamma, beta, EPI_EPS,
                                   scale=s, bias=c)
                want = epi.epilogue_plain(x, mean, inv, gamma, beta, s, c)
                if not same(got, want):
                    raise AssertionError(
                        f"K-epi {n}x{h} scale {scale} bias {bias} {label}: "
                        f"{int((got != want).sum())} elements differ")
                cases["K-epi"] += 1
    n, h = n_smoke, HIDDEN
    mean, var, gamma, beta, s, c = epi_params(h, gen, device, True, True)
    inv = torch.rsqrt(var + EPI_EPS)
    a = torch.randn(n, h, generator=gen).to(device)
    res = dict(cases=cases["K-epi"], max_abs_err=0.0, shape=[n, h])
    res["ms"] = cuda_ms(lambda: epi.epilogue(a, mean, var, gamma, beta,
                                             EPI_EPS, scale=s, bias=c))
    res["ms_no_scale_bias"] = cuda_ms(
        lambda: epi.epilogue(a, mean, var, gamma, beta, EPI_EPS))
    res["plain_ms"] = cuda_ms(
        lambda: epi.epilogue_plain(a, mean, inv, gamma, beta, s, c))
    res["library_ms"] = cuda_ms(lambda: torch.relu(F.batch_norm(
        a, mean, var, gamma, beta, training=False, eps=EPI_EPS)))
    res["library"] = "F.batch_norm(training=False) + torch.relu, two calls"
    res["bound_ms"], res["bound_by"] = least_time(
        2 * n * h * 4 + 5 * h * 4, 7 * n * h, hbm, f32_rate)
    results["K-epi"] = res
    print(f"K-epi: {json.dumps(res)}", flush=True)
    del a

    # K-quant (a): max|x|, scale, safe
    def abs_max_case(name, x, dtype):
        got = kq.abs_max_scale(x, dtype)
        want = kq.abs_max_scale_plain(x, dtype)
        for what, g_, w_ in zip(("abs_max", "scale", "safe"), got, want):
            if not same_bits(g_.reshape(1), w_.reshape(1).float()):
                raise AssertionError(f"K-quant abs_max {name} {dtype} {what}:"
                                     f" {float(g_)} != {float(w_)}")
        cases["K-quant abs_max"] += 1

    xs = {"smoke": torch.randn(n_smoke, HIDDEN, generator=gen).to(device)}
    for n, h in EPI_RAGGED:
        xs[f"{n}x{h}"] = torch.randn(n, h, generator=gen).to(device)
    base = xs["1037x41"]
    xs["misaligned"] = misaligned(base)
    for what, v in (("nan", float("nan")), ("+inf", float("inf")),
                    ("-inf", float("-inf"))):
        t = base.clone()
        t[5, 7] = v
        xs[what] = t
    xs["-0 and zeros"] = torch.zeros_like(base)
    xs["-0 and zeros"][3, 3] = -0.0
    xs["tiny"] = base * 1e-40
    for name, x in xs.items():
        for dtype in ("int8", "int16", "int32", "float32"):
            abs_max_case(name, x, dtype)
    x = xs["smoke"]
    res = dict(cases=cases["K-quant abs_max"], max_abs_err=0.0,
               shape=list(x.shape))
    res["ms"] = cuda_ms(lambda: kq.abs_max_scale(x, "int32"))
    res["plain_ms"] = cuda_ms(lambda: kq.abs_max_scale_plain(x, "int32"))
    res["library_ms"] = cuda_ms(
        lambda: torch.linalg.vector_norm(x, float("inf")))
    res["library"] = "torch.linalg.vector_norm(x, inf)"
    res["bound_ms"], res["bound_by"] = least_time(x.numel() * 4, x.numel(),
                                                  hbm, f32_rate)
    results["K-quant abs_max"] = res
    print(f"K-quant abs_max: {json.dumps(res)}", flush=True)

    # K-quant (b): the table
    ties = {f"ties {dtype} step {step}": half_steps(
        1037, 41, kq.scale_exponent(dtype), step, gen, device)
        for dtype in ("int8", "int16", "int32") for step in (1.0, 1.5)}
    for name, x in {**xs, **ties}.items():
        for dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
            safe = kq.abs_max_scale_plain(x, dtype)[2]
            got = kq.quant_table(x, safe, dtype)
            want = kq.quant_table_plain(x, safe, dtype)
            if not same(got, want):
                raise AssertionError(
                    f"K-quant table {name} {dtype}: "
                    f"{int((got != want).sum())} elements differ")
            cases["K-quant table"] += 1
    x = xs["smoke"]
    safe = kq.abs_max_scale_plain(x, "int8")[2]
    res = dict(cases=cases["K-quant table"], max_abs_err=0.0,
               shape=list(x.shape), dtype="int8")
    res["ms"] = cuda_ms(lambda: kq.quant_table(x, safe, torch.int8))
    res["ms_int32"] = cuda_ms(lambda: kq.quant_table(x, safe, torch.int32))
    res["plain_ms"] = cuda_ms(lambda: kq.quant_table_plain(x, safe,
                                                           torch.int8))
    res["library_ms"] = None  # no one PyTorch call rounds and casts
    res["bound_ms"], res["bound_by"] = least_time(x.numel() * 5, x.numel(),
                                                  hbm, f32_rate)
    results["K-quant table"] = res
    print(f"K-quant table: {json.dumps(res)}", flush=True)

    # K-quant (c): the core payload
    def payload_case(name, x, rows, safe, limbs):
        dims = kq.payload_dims(rows.numel(), x.shape[1])
        got = kq.core_payload(x, rows, safe, limbs, *dims)
        want = kq.core_payload_plain(x, rows, safe, limbs, *dims)
        if not torch.equal(got, want):
            raise AssertionError(f"K-quant payload {name} limbs {limbs}: "
                                 f"{int((got != want).sum())} bytes differ")
        cases["K-quant payload"] += 1

    w_max = max(w for *_, w in prep.stair)
    rows = prep.dev_arrays["core_nodes"][:w_max]
    x = xs["smoke"]
    safe32 = kq.abs_max_scale_plain(x, "int32")[2]
    tables = {d: kq.quant_table_plain(x, kq.abs_max_scale_plain(x, d)[2], d)
              for d in ("int8", "int16")}
    raw = torch.randint(-(1 << 31), 1 << 31, x.shape, generator=gen,
                        dtype=torch.int64).to(torch.int32).to(device)
    payload_case("smoke f32", x, rows, safe32, 3)
    payload_case("smoke int8 table", tables["int8"], rows, None, 1)
    payload_case("smoke int16 table", tables["int16"], rows, None, 2)
    payload_case("smoke raw int32", raw, rows, None, 4)
    rows4 = prep4.dev_arrays["core_nodes"][:max(w for *_, w in prep4.stair)]
    payload_case("square int4 int8 table", tables["int8"], rows4, None, 1)
    for name, xr in {**xs, **ties}.items():
        if name == "smoke":
            continue
        r = torch.randperm(xr.shape[0], generator=gen)[:1000].to(
            torch.int32).to(device)
        for limbs in (1, 3):
            payload_case(name, xr, r, kq.abs_max_scale_plain(
                xr, "int8" if limbs == 1 else "int32")[2], limbs)
        payload_case(f"{name} int16", kq.quant_table_plain(
            xr, kq.abs_max_scale_plain(xr, "int16")[2], "int16"), r, None, 2)
    dims = kq.payload_dims(rows.numel(), HIDDEN)
    res = dict(cases=cases["K-quant payload"], max_abs_err=0.0,
               rows=rows.numel(), h=HIDDEN, limbs=3, dims=list(dims))
    res["ms"] = cuda_ms(lambda: kq.core_payload(x, rows, safe32, 3, *dims))
    res["ms_int8_table_1_limb"] = cuda_ms(
        lambda: kq.core_payload(tables["int8"], rows, None, 1, *dims))
    res["plain_ms"] = cuda_ms(
        lambda: kq.core_payload_plain(x, rows, safe32, 3, *dims))
    res["library_ms"] = None  # no PyTorch call writes the limb layout
    res["bound_ms"], res["bound_by"] = least_time(
        rows.numel() * (HIDDEN * 4 + 4) + 3 * dims[0] * dims[1],
        rows.numel() * HIDDEN, hbm, f32_rate)
    results["K-quant payload"] = res
    print(f"K-quant payload: {json.dumps(res)}", flush=True)
    del xs, ties, tables, raw, x
    print(f"epilogue_checks: kernels held and timed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # one fused forward of each main path's model, counted
    xf = torch.as_tensor(ds.x).to(device)
    blocked = prepare_spmm(ds.graph, SpmmConfig(), device=device)
    want = {  # (agg_dtype, operand): launches of one 2-layer GCN forward
        (None, "stair int8"): {"K-epi": 3},
        ("int32", "stair int8"): {"K-epi": 3, "K-quant abs_max": 2,
                                  "K-quant payload": 2},
        ("int8", "square int4"): {"K-epi": 3, "K-quant abs_max": 2,
                                  "K-quant table": 2, "K-quant payload": 2},
        ("int32", "blocked"): {"K-epi": 3, "K-quant abs_max": 2,
                               "K-quant table": 2},
    }
    ops = {"stair int8": prep, "square int4": prep4, "blocked": blocked}
    counted = {}
    for (agg_dtype, name), kernels in want.items():
        gnn = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                       num_layers=2, agg_dtype=agg_dtype, device=device)
        n = forward_launches(gnn, xf, PreparedAggregate(ops[name]))
        label = f"{agg_dtype or 'float'} {name}"
        counted[label] = n
        for k in ("K-epi", "K-quant abs_max", "K-quant table",
                  "K-quant payload"):
            if n.get(k, 0) != kernels.get(k, 0):
                raise AssertionError(f"one {label} forward: {k} launched "
                                     f"{n.get(k, 0)} times, want "
                                     f"{kernels.get(k, 0)} ({n})")
    results["epilogue forwards"] = counted
    print(f"one forward's launches: {json.dumps(counted)}", flush=True)
    del blocked, xf
    free(device)


BN_KERNELS = ("K-bn stats", "K-bn fwd", "K-bn bwd stats", "K-bn bwd")
BN_EPS = 1e-5
# rate 0: no dropout; 0.5: 1 / (1 - rate) exact; 0.3: its f32 reciprocal
BN_RATES = (0.0, 0.5, 0.3)
BN_RAGGED = ((1037, 41), (1037, 256))  # N odd; H 41: single elements
# the statistics and the backward's column sums: sums in another order,
# held within 1e-5 of the sum of |terms| (REL_TOL's reasoning); dz given
# the same sums: four roundings of terms each at most the sum of |terms|
BN_SUM_TOL = 1e-5
BN_DZ_TOL = 1e-6


def rel_err(got, want, mag):
    """``(max |got - want| / mag, max |got - want|)`` (mag: the sum of
    |terms| behind each value; NaN where anything is not finite)."""
    import torch

    diff = (got.double() - want.double()).abs()
    err = diff / mag.double().clamp_min(1e-30)
    if not torch.isfinite(err).all():
        return float("nan"), float("nan")
    return float(err.max()), float(diff.max())


def bn_case(name, z, g, gamma, beta, key, rate, counts):
    """The four K-bn kernels against their plain versions on one input:
    the statistics and the backward's sums within BN_SUM_TOL of the sum of
    |terms|, the forward bit-equal given the same statistics and key (and
    the mask: with β large every kept element is above 0), dz within
    BN_DZ_TOL given the same sums. Returns ``{piece: (error over the sum
    of |terms|, abs error)}`` and whether dz was bit-equal."""
    import torch

    from pygim_tpu_torch.ops import bn_train as kb

    zd = z.double()
    mean, var = kb.bn_stats(z)
    pm, pv = kb.bn_stats_plain(z)
    err = {"stats": max(rel_err(mean, pm, zd.abs().mean(0)),
                        rel_err(var, pv, (zd - zd.mean(0)).square().mean(0)))}
    inv = torch.rsqrt(var + BN_EPS)
    got = kb.bn_apply(z, mean, inv, gamma, beta, key, rate)
    if not same_bits(got, kb.bn_apply_plain(z, mean, inv, gamma, beta, key,
                                            rate)):
        raise AssertionError(f"K-bn fwd {name} rate {rate}: not bit-equal")
    counts["K-bn fwd"] += 1
    if key is not None:
        big = torch.full_like(beta, 1e4)
        kept = kb.bn_apply(z, mean, inv, gamma, big, key, rate) != 0
        if not torch.equal(kept, kb.keep_mask(key, z.shape, rate)):
            raise AssertionError(f"K-bn mask {name} rate {rate}: "
                                 f"{int((kept != kb.keep_mask(key, z.shape, rate)).sum())} "
                                 "elements differ")
        counts["mask"] += 1
    sb, sx = kb.bn_bwd_stats(g, z, mean, inv, gamma, beta, key, rate)
    psb, psx = kb.bn_bwd_stats_plain(g, z, mean, inv, gamma, beta, key, rate)
    xhat = (z - mean) * inv
    gb = kb._grad_b(g, xhat, gamma, beta, key, rate).double().abs()
    err["bwd stats"] = max(rel_err(sb, psb, gb.sum(0)),
                           rel_err(sx, psx, (gb * xhat.double().abs()).sum(0)))
    dz = kb.bn_bwd(g, z, mean, inv, gamma, beta, key, rate, sb, sx)
    pdz = kb.bn_bwd_plain(g, z, mean, inv, gamma, beta, key, rate, sb, sx)
    a, m_b, m_x = (f.double().abs() for f in kb.bn_bwd_factors(
        gamma, inv, z.shape[0], sb, sx))
    mag = a * gb + m_b + xhat.double().abs() * m_x
    err["bwd"] = rel_err(dz, pdz, mag)
    err["bwd bit-equal"] = same_bits(dz, pdz)
    for k, bar in (("stats", BN_SUM_TOL), ("bwd stats", BN_SUM_TOL),
                   ("bwd", BN_DZ_TOL)):
        if not err[k][0] <= bar:
            raise AssertionError(f"K-bn {k} {name} rate {rate}: {err[k]} > "
                                 f"{bar} of the sum of |terms|")
    for k in ("K-bn stats", "K-bn bwd stats", "K-bn bwd"):
        counts[k] += 1
    return err


def bn_train_checks(ds, prep, results, card, device="cuda"):
    """K-bn (``csrc/bn_train.cu``) against its plain versions
    (``ops/bn_train.py``) on the card, then the training step through it.

    * Kernels (:func:`bn_case`): at the smoke shape (the stand-in's N at H
      256) and at :data:`BN_RAGGED`, each at every rate of
      :data:`BN_RATES`, and on a misaligned copy (the single-element path
      at H 256); the forward also on inputs with NaN, ±inf and -0, bit for
      bit; the statistics also in 1, 1000 (the last 481 empty) and N
      chunks of rows. Each kernel timed at the smoke shape (rate 0.5)
      beside its plain version, its bytes bound and the library:
      ``torch.var_mean`` for the statistics, the chain without statistics
      ``F.batch_norm(training=False)`` on the batch mean and var +
      ``torch.relu`` + ``F.dropout`` for the forward, none for the
      backward's pieces alone. The block (statistics and forward;
      backward sums and dz) beside the chain with
      ``F.batch_norm(training=True)`` and its autograd backward.
    * One training step's gradients, GCN, GIN and SAGE at H 256 on the
      smoke operand (its Aᵀ prepared by the training phase): every leaf
      through K-bn against autograd through the plain chain
      (:func:`plain_bn_block`) within GRAD_BAR, K-bn run twice (the
      run-to-run noise of the aggregate's atomics), and the negative
      control, a backward with the ReLU's sign dropped
      (:func:`no_relu_sign_block`), must fail it.
    * One GCN training step counted, the counts set to 0 before it: each
      K-bn kernel three times, no plain version run (each made to raise).
      Returns those launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pygim_tpu_torch.bench.runners import train_inputs
    from pygim_tpu_torch.nn.models import make_gnn
    from pygim_tpu_torch.nn.train import make_train_step
    from pygim_tpu_torch.ops import bn_train as kb
    from pygim_tpu_torch.ops import launch_counts, reset_launch_counts
    from pygim_tpu_torch.ops.spmm import PreparedAggregate

    hbm, _bf16, f32_rate, _int8 = results["peaks"]
    gen = torch.Generator().manual_seed(23)
    dgen = torch.Generator(device=device).manual_seed(23)
    n_smoke = prep.nrows
    t0 = time.perf_counter()
    counts = dict.fromkeys(BN_KERNELS, 0)
    counts["mask"] = 0
    worst, dz_bits = {}, True

    def inputs(n, h):
        z = (torch.randn(n, h, generator=gen) * (torch.rand(h, generator=gen)
                                                  * 2.5 + 0.5)
             + torch.randn(h, generator=gen)).to(device)
        g = torch.randn(n, h, generator=gen).to(device)
        gamma = (torch.rand(h, generator=gen) + 0.5).to(device)
        beta = (0.3 * torch.randn(h, generator=gen)).to(device)
        return z, g, gamma, beta

    for n, h in ((n_smoke, HIDDEN),) + BN_RAGGED:
        z, g, gamma, beta = inputs(n, h)
        cases = [("", z, g)]
        if (n, h) == BN_RAGGED[-1]:
            cases.append(("misaligned", misaligned(z), misaligned(g)))
        for label, zc, gc in cases:
            for rate in BN_RATES:
                key = kb.draw_key(dgen, device) if rate else None
                err = bn_case(f"{n}x{h} {label}", zc, gc, gamma, beta, key,
                              rate, counts)
                dz_bits = dz_bits and err.pop("bwd bit-equal")
                for k, (rel, ab) in err.items():
                    worst[k] = max(worst.get(k, (0.0, 0.0)), (rel, ab))
        # the forward with NaN, ±inf and -0 in z, given finite statistics
        mean, var = kb.bn_stats_plain(z)
        inv = torch.rsqrt(var + BN_EPS)
        zs = with_specials(z.clone())
        for rate in BN_RATES:
            key = kb.draw_key(dgen, device) if rate else None
            got = kb.bn_apply(zs, mean, inv, gamma, beta, key, rate)
            if not same_bits(got, kb.bn_apply_plain(zs, mean, inv, gamma,
                                                    beta, key, rate)):
                raise AssertionError(f"K-bn fwd {n}x{h} specials rate {rate}")
            counts["K-bn fwd"] += 1
        del z, g, zs
    # the statistics over chunk counts the default never takes: one
    # chunk, one row a chunk, and 1000 chunks of 2 rows of which the last
    # 481 are empty
    for n, h in BN_RAGGED:
        z = inputs(n, h)[0]
        zd = z.double()
        pm, pv = kb.bn_stats_plain(z)
        for chunks in (1, 1000, n):
            mean, var = kb.bn_stats(z, chunks=chunks)
            e = max(rel_err(mean, pm, zd.abs().mean(0)),
                    rel_err(var, pv, (zd - zd.mean(0)).square().mean(0)))
            if not e[0] <= BN_SUM_TOL:
                raise AssertionError(f"K-bn stats {n}x{h} in {chunks} "
                                     f"chunks: {e} > {BN_SUM_TOL}")
            counts["K-bn stats"] += 1
            worst["stats"] = max(worst["stats"], e)
        del z, zd
    # the plain mask does not depend on the device
    key = kb.draw_key(dgen, device)
    if not torch.equal(kb.keep_mask(key, (1037, 41), 0.3).cpu(),
                       kb.keep_mask(key.cpu(), (1037, 41), 0.3)):
        raise AssertionError("keep_mask differs between the card and the CPU")
    print(f"bn_train_checks: cases {counts}; worst (of the sum of |terms|,"
          f" abs) {worst}; dz bit-equal in every case: {dz_bits}", flush=True)

    # timed at the smoke shape, rate 0.5
    n, h = n_smoke, HIDDEN
    z, g, gamma, beta = inputs(n, h)
    key = kb.draw_key(dgen, device)
    mean, var = kb.bn_stats(z)
    inv = torch.rsqrt(var + BN_EPS)
    sb, sx = kb.bn_bwd_stats(g, z, mean, inv, gamma, beta, key, 0.5)
    zl, gl, bl = (t.clone().requires_grad_() for t in (z, gamma, beta))

    def chain():
        return F.dropout(torch.relu(F.batch_norm(
            zl, None, None, gl, bl, training=True, eps=BN_EPS)), 0.5,
            training=True)

    out = chain()
    chain_fwd_ms = cuda_ms(lambda: chain().detach())
    chain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (zl, gl, bl), g, retain_graph=True))
    del out
    nh = n * h
    timed = {
        "K-bn stats": (lambda: kb.bn_stats(z),
                       lambda: kb.bn_stats_plain(z),
                       lambda: torch.var_mean(z, 0, unbiased=False),
                       "torch.var_mean(z, 0, unbiased=False)",
                       (nh * 4 + 2 * h * 4, 4 * nh)),
        "K-bn fwd": (lambda: kb.bn_apply(z, mean, inv, gamma, beta, key, 0.5),
                     lambda: kb.bn_apply_plain(z, mean, inv, gamma, beta, key,
                                               0.5),
                     lambda: F.dropout(torch.relu(F.batch_norm(
                         z, mean, var, gamma, beta, training=False,
                         eps=BN_EPS)), 0.5, training=True),
                     "the chain without statistics: F.batch_norm("
                     "training=False) on the batch mean and var + "
                     "torch.relu + F.dropout, three calls",
                     (nh * 8 + 4 * h * 4 + 16, 7 * nh)),
        "K-bn bwd stats": (
            lambda: kb.bn_bwd_stats(g, z, mean, inv, gamma, beta, key, 0.5),
            lambda: kb.bn_bwd_stats_plain(g, z, mean, inv, gamma, beta, key,
                                          0.5),
            None, "none alone: the chain's autograd backward computes both "
            "pieces (the K-bn block line)", (nh * 8 + 6 * h * 4 + 16,
                                              10 * nh)),
        "K-bn bwd": (
            lambda: kb.bn_bwd(g, z, mean, inv, gamma, beta, key, 0.5, sb, sx),
            lambda: kb.bn_bwd_plain(g, z, mean, inv, gamma, beta, key, 0.5,
                                    sb, sx),
            None, "none alone: the chain's autograd backward computes both "
            "pieces (the K-bn block line)", (nh * 12 + 7 * h * 4 + 16,
                                              12 * nh)),
    }
    for k, (fn, plain, lib, lib_name, (nbytes, ops)) in timed.items():
        piece = {"K-bn stats": "stats", "K-bn bwd stats": "bwd stats",
                 "K-bn bwd": "bwd"}.get(k)
        res = dict(shape=[n, h], rate=0.5, cases=counts[k],
                   max_abs_err=worst[piece][1] if piece else 0.0,
                   max_err_of_terms=worst[piece][0] if piece else 0.0)
        if k == "K-bn bwd":
            res["bit_equal"] = dz_bits
        res["ms"] = cuda_ms(fn)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        res["library_ms"] = cuda_ms(lib) if lib is not None else None
        res["library"] = lib_name
        res["bound_ms"], res["bound_by"] = least_time(nbytes, ops, hbm,
                                                      f32_rate)
        results[k] = res
        print(f"{k}: {json.dumps(res)}", flush=True)
    fused = dict(forward_ms=results["K-bn stats"]["ms"]
                 + results["K-bn fwd"]["ms"],
                 backward_ms=results["K-bn bwd stats"]["ms"]
                 + results["K-bn bwd"]["ms"],
                 chain_forward_ms=chain_fwd_ms, chain_backward_ms=chain_bwd_ms)
    results["K-bn block"] = fused
    print(f"K-bn block at {n}x{h}: {json.dumps(fused)} ({card})", flush=True)
    del z, g, zl, gl, bl
    free(device)
    print(f"bn_train_checks: kernels held and timed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # one training step's gradients: K-bn against the plain chain
    dev = prep.device
    tin = train_inputs(ds, dev)
    agg = PreparedAggregate(prep)
    grads_out = {}
    for conv in CONVS:
        grads = {"plain": leaf_grads(conv, ds, agg, tin, plain_bn_block),
                 "kernels": leaf_grads(conv, ds, agg, tin),
                 "kernels again": leaf_grads(conv, ds, agg, tin),
                 "no relu sign": leaf_grads(conv, ds, agg, tin,
                                            no_relu_sign_block)}
        errs = {a: max(leaf_errs(gr, grads["plain"]).values())
                for a, gr in grads.items() if a != "plain"}
        grads_out[conv] = errs
        print(f"K-bn training step, {conv}: max leaf err against the plain "
              f"chain {errs} ({card})", flush=True)
        if errs["kernels"] > GRAD_BAR or errs["kernels again"] > GRAD_BAR:
            raise AssertionError(f"K-bn {conv} step gradients: {errs}")
        if errs["no relu sign"] <= GRAD_BAR:
            raise AssertionError(f"K-bn {conv}: the no-relu-sign control "
                                 f"passed ({errs})")
        del grads
    results["K-bn step gradients"] = grads_out

    # one GCN training step, counted, every plain version of K-bn made to
    # raise while it runs
    model = make_gnn(0, "gcn", ds.x.shape[1], HIDDEN, ds.num_classes,
                     device=dev)
    step = make_train_step(model, agg, torch.optim.Adam(
        model.parameters(), lr=TRAIN_LR))
    plains = ("bn_stats_plain", "bn_apply_plain", "bn_bwd_stats_plain",
              "bn_bwd_plain", "keep_mask")
    saved = {name: getattr(kb, name) for name in plains}
    reset_launch_counts()
    try:
        for name in plains:
            setattr(kb, name, _refuse_plain)
        loss = float(step(*tin, torch.Generator(device=dev).manual_seed(0)))
        sync(dev)
    finally:
        for name, f in saved.items():
            setattr(kb, name, f)
    n = launch_counts()
    got = {k: n[k] for k in BN_KERNELS}
    if got != dict.fromkeys(BN_KERNELS, 3) or not np.isfinite(loss):
        raise AssertionError(f"one GCN step: K-bn launches {got}, loss {loss}")
    print(f"K-bn: one GCN training step launches {got}", flush=True)
    free(dev)
    return got


def main() -> int:
    """Run every phase in a fresh prepare and dataset cache, removed at
    the end: no phase reads the user's cache."""
    if "--bcsr-full" in sys.argv[1:]:
        return bcsr_full()
    if "--bcsr-sweep" in sys.argv[1:]:
        return bcsr_band_sweep()
    if "--interleave-full" in sys.argv[1:]:
        return interleave_full()
    if "--mesh-full" in sys.argv[1:]:
        return mesh_full()
    if "--halo-full" in sys.argv[1:]:
        return halo_full()
    if "--rows-full" in sys.argv[1:]:
        return rows_full()
    root = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    os.environ["PYGIM_TPU_TORCH_DATA"] = root
    os.environ["PYGIM_TPU_TORCH_TUNE_CACHE"] = root
    try:
        if "--train-sweep" in sys.argv[1:]:
            return train_sweep()
        if "--mesh-cards" in sys.argv[1:]:
            return mesh_cards()
        if "--halo-cards" in sys.argv[1:]:
            return halo_cards()
        if "--tune-cards" in sys.argv[1:]:
            return tune_cards()
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
    timed_phase("epilogue_checks", epilogue_checks, ds, prep, prep4, results)

    # the main paths, each counted: float aggregation, then int32
    # aggregation (the reference's default) with the int32 SpMM
    rep = DataReporter(echo=True)
    reuse = lambda g, c: prep  # noqa: E731 — the operand prepared above
    launches = {}
    for agg_dtype, spmm_dtype, kernels in (
            (None, "float32", ("K-core", "K-tail", "K-epi")),
            ("int32", "int32", ("K-int", "K-tail-quant", "K-epi",
                                "K-quant abs_max", "K-quant payload"))):
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
                   ("K-epi", n_gcn["K-epi"]),
                   ("K-quant abs_max", n_gcn["K-quant abs_max"]),
                   ("K-quant table", n_gcn["K-quant table"]),
                   ("K-quant payload", n_gcn["K-quant payload"]),
                   ("K-core int4", n["K-core int4"] - n_gcn["K-core int4"])):
        if got <= 0:
            raise AssertionError(f"{k} was never launched on the square int4 "
                                 "main path")
    launches["K-int int4"] = n_gcn["K-int int4"]
    launches["K-quant table"] = n_gcn["K-quant table"]
    launches["K-core int4"] = n["K-core int4"] - n_gcn["K-core int4"]
    if rep.records["validate"][-1] != "OK":
        raise AssertionError("int8 GCN per-layer validation failed")
    if rep.records["verify"][-1] != "OK":
        raise AssertionError("square int4 SpMM sampled-row check failed")
    print(f"square int4 path: validate {rep.records['validate'][-1]}, "
          f"agg0/agg1 max rel err {rep.records['agg0_max_rel_err'][-1]} / "
          f"{rep.records['agg1_max_rel_err'][-1]}", flush=True)

    # the runners' default configuration: the blocked backend on K-rows,
    # counted: a float32 SpMM, then the float and the int32 (default)
    # GCN forwards, each with config=None
    t0 = time.perf_counter()
    reset_launch_counts()
    run_spmm_benchmark(ds, hidden=HIDDEN, repeat=3, reporter=rep,
                       device="cuda")
    if rep.records["verify"][-1] != "OK":
        raise AssertionError("blocked (default config) SpMM check failed")
    spmm_ms = rep.records["pim_time_spmm(ms)"][-1]
    infer_ms = {}
    for agg_dtype in (None, "int32"):
        run_inference_benchmark(ds, model="gcn", num_layers=2, hidden=HIDDEN,
                                agg_dtype=agg_dtype, repeat=10, reporter=rep,
                                device="cuda")
        infer_ms[agg_dtype or "float"] = rep.records["infer_time(ms)"][-1]
    torch.cuda.synchronize()
    n = launch_counts()
    for k in ("K-rows", "K-epi", "K-quant abs_max", "K-quant table"):
        if n[k] <= 0:
            raise AssertionError(f"{k} was never launched on the runners' "
                                 f"default path: {n}")
    launches["K-rows"] = n["K-rows"]
    bound = rows_bound(prepare_spmm(ds.graph, SpmmConfig(),
                                       device="cuda"), HIDDEN,
                          results["peaks"])
    print(f"blocked backend (config=None): verify OK, {spmm_ms:.4f} ms a "
          f"SpMM, infer_time float / int32 {infer_ms} ms; launches {n} "
          f"({time.perf_counter() - t0:.1f} s); bound {bound}", flush=True)
    results["runners default"] = dict(pim_time_spmm_ms=spmm_ms,
                                      infer_time_ms=infer_ms)
    timed_phase("rows_checks", rows_checks, ds, results)

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

    # this slice's path: named experiments through the sweep runner, and
    # the real-format parsers
    harness_launches = harness(results)
    harness_operands(results)
    real_format(results)
    torch.cuda.empty_cache()

    # this slice's paths: the BCSR tier (K-bcsr; its main path counted in
    # bcsr_paths), the coo backend and SDDMM
    timed_phase("bcsr_kernel_checks", bcsr_kernel_checks, results)
    launches["K-bcsr"], bcsr_routes = timed_phase("bcsr_paths", bcsr_paths,
                                                  results)
    for route, *_ in BCSR_ROUTES:
        launches[f"K-bcsr {route}"] = bcsr_routes.get(route, 0)
        if launches[f"K-bcsr {route}"] <= 0:
            raise AssertionError(f"K-bcsr's {route} route was never "
                                 f"launched on the bcsr path")
    timed_phase("bcsr_scale", bcsr_scale, results)
    launches["K-rows coo"] = timed_phase("coo_sddmm", coo_sddmm, ds, results)

    # the training path: the backward product on the prepared Aᵀ, real
    # steps of each conv, then train_cuda.py and run_training_benchmark
    backward_product(prep, ds.graph, results, card)
    train_steps(ds, prep, results, card)
    training_entry(results, card)
    training = results["train steps"]["gcn step"]["launches"]
    # this slice's path: the training block's BatchNorm, ReLU and dropout
    # (K-bn), each kernel held and timed, a step's gradients, one step
    # counted
    launches.update(timed_phase("bn_train_checks", bn_train_checks, ds, prep,
                                results, card))
    float_core_training(ds, fpreps, results, card)
    float_core_entry(results, card)
    del fpreps
    timed_phase("bcsr_training", bcsr_training, results, card)
    timed_phase("rows_training", rows_training, ds, results, card)

    # this slice's path: the tuner (its constants, tracked config 3, the
    # candidate audit, measure mode)
    timed_phase("tune", tune_phase, results, card)
    # this slice's paths: the tuner over a budget of four devices on a
    # virtual mesh of the card (the collectives' constants, the ranking,
    # the audit of its mesh candidates) and the float passthrough
    timed_phase("tune mesh", tune_mesh_phase, ds, results, card)

    # this slice's paths: the core↔tail interleave (each interleaved call
    # counted and its streams read) and the 2D mesh on virtual meshes of
    # the card (each operand's products counted)
    timed_phase("interleave", interleave_phase, ds, results)
    timed_phase("mesh", mesh_phase, ds, results)

    # this slice's paths: the halo layout on virtual node meshes of the
    # card (every exchange, slab and order, each product counted), training
    # over the 2D and halo meshes, and the multi-device dry run
    timed_phase("halo", halo_phase, ds, results)
    timed_phase("mesh train", mesh_train_phase, ds, results, card)
    timed_phase("dryrun", dryrun_phase, results)

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
                               "pygim_tpu/ops/spmm.py:481"),
               "K-bcsr": ("cuda", "pygim_tpu_torch/csrc/bcsr.cu",
                          "pygim_tpu/ops/spmm.py:690"),
               **{f"K-bcsr {route}": ("cuda", "pygim_tpu_torch/csrc/bcsr.cu",
                                      "pygim_tpu/ops/spmm.py:633")
                  for route, *_ in BCSR_ROUTES},
               "K-rows": ("cuda", "pygim_tpu_torch/csrc/seg_rows.cu",
                          "pygim_tpu/ops/spmm.py:136"),
               "K-rows coo": ("cuda", "pygim_tpu_torch/csrc/seg_rows.cu",
                              "pygim_tpu/ops/spmm.py:1883"),
               "K-epi": ("cuda", "pygim_tpu_torch/csrc/epilogue.cu",
                         "pygim_tpu/nn/layers.py:65"),
               "K-quant abs_max": ("cuda", "pygim_tpu_torch/csrc/quant.cu",
                                   "pygim_tpu/ops/spmm.py:1576"),
               "K-quant table": ("cuda", "pygim_tpu_torch/csrc/quant.cu",
                                 "pygim_tpu/ops/spmm.py:1587"),
               "K-quant payload": ("cuda", "pygim_tpu_torch/csrc/quant.cu",
                                   "pygim_tpu/ops/spmm.py:1622"),
               "K-bn stats": ("cuda", "pygim_tpu_torch/csrc/bn_train.cu",
                              "pygim_tpu/nn/layers.py:76"),
               "K-bn fwd": ("cuda", "pygim_tpu_torch/csrc/bn_train.cu",
                            "pygim_tpu/nn/layers.py:79"),
               "K-bn bwd stats": ("cuda", "pygim_tpu_torch/csrc/bn_train.cu",
                                  "pygim_tpu/nn/layers.py:72"),
               "K-bn bwd": ("cuda", "pygim_tpu_torch/csrc/bn_train.cu",
                            "pygim_tpu/nn/layers.py:72")}
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
            } if k in ("K-core", "K-tail") + BN_KERNELS else None,
            "harness_launches": harness_launches.get(k),
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
