"""K-core: the hub-core bands' integer or bf16 × bf16 products,
scatter-added.

Counterpart of ``pygim_tpu/ops/pallas_core.py`` (``bf16(int8 core) @
bf16(x)`` with f32 accumulation), and of ``_core_matmul``'s bf16 branch
(``pygim_tpu/ops/spmm.py:630``, ``dot(bf16 core, bf16(x))``), fused with
the scatter of its product
into the output rows (``out.at[core_nodes[lo:hi]].add`` in
``pygim_tpu/ops/spmm.py:_core_scatter``). The CUDA kernel is
``csrc/core_dot.cu``: one persistent TMA + ``wgmma`` launch over all bands
of one SpMM, walking a tile list built here on the host. A launch runs
one of two schedules (:func:`choose_schedule`): whole tiles, spread over
the resident blocks longest first (split 1, :func:`cluster_schedule`),
or, where the host model predicts a gain, stream-K (split 0,
:func:`stream_schedule`): the launch's stages are cut into one equal
span a resident block, a tile cut across spans hands its leading
pieces' partials through a global workspace to the block that holds its
last piece, which adds them in a fixed order, so the result does not
change from run to run. (The cluster split of a tile's contraction,
:func:`choose_split`, is K-int's; ``ops/core_int.py``.)

``xc`` is ``x[core_nodes]`` already rounded to bf16 (round-to-nearest-
even, as ``xq.astype(bf16)`` in the reference); the gather and the cast
stay outside the kernel, as in JAX. Every int8 × bf16 and bf16 × bf16
product is exact in f32, so the kernel and :func:`core_bands_plain`
differ only in the order of the f32 sums.

A band is int8 ``(r, w)``, bf16 ``(r, w)``, or int4 nibble-packed into
uint8 ``(r, w // 2)``: byte j of a row holds cells (2j, 2j + 1), the low nibble the even
column, each a two's-complement nibble in [-8, 7]. That is the packed
core of the reference's ``_core_matmul`` (``pygim_tpu/ops/spmm.py:586-
597``, ``dot(lo, x[0::2]) + dot(hi, x[1::2])`` over the nibble planes of
``_nibble_halves``), which equals one product of the unpacked band with
x; the kernel's int4 mode unpacks in registers and never widens the band
in memory. A square core is the one band ``(0, k, w)``.

On the card the kernel takes bands of width ``w % 16 == 0`` (int8; the
planner snaps widths to 256; bf16: whole 16-deep steps, a 2w-byte row
stride) or ``w % 32 == 0`` (int4: the TMA row stride, ``w / 2`` bytes, is
a multiple of 16), ``H % 8 == 0`` and 16-byte aligned operands; the
wrapper raises on anything else. One launch carries at most
:data:`MAX_BANDS` bands, all of one cell type (its mode,
:func:`cell_mode`), so a stair of more bands takes one launch per group
of them. The bf16 mode's ring holds 3 stages, not 4 (its A box is twice
the int8 one), and its schedule weighs a stage at
:func:`step_cost` of its cell size.
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq

import numpy as np
import torch

from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (plain ints; launches only): the
# int8 mode, the int4 (packed) mode and the bf16 mode
launches = 0
packed_launches = 0
bf16_launches = 0

INT8, PACKED, BF16 = 0, 1, 2   # the kernel's cell modes
MODE_CELL_BYTES = {INT8: 1.0, PACKED: 0.5, BF16: 2.0}

BM, BN = 128, 256          # output tile of one block: band rows × columns
MAX_BANDS = 16             # band maps one launch carries
_MAP_BYTES = 128           # sizeof(CUtensorMap)


def unpack_nibbles(packed):
    """The int8 cells ``(r, 2c)`` of a nibble-packed uint8 band ``(r, c)``:
    the sign-extended low nibble of byte j is cell 2j, the high one cell
    2j + 1 (the reference's ``_nibble_halves``, interleaved)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = lo - (lo > 7).to(torch.int8) * 16
    hi = hi - (hi > 7).to(torch.int8) * 16
    return torch.stack((lo, hi), dim=-1).reshape(packed.shape[0], -1)


def band_cells(band):
    """The band's cells as int8 ``(r, w)``: an int8 band itself, a packed
    one unpacked."""
    return unpack_nibbles(band) if band.dtype == torch.uint8 else band


def cell_width(band) -> int:
    """Cells a row of ``band``: two a byte when it is packed."""
    return band.shape[1] * (2 if band.dtype == torch.uint8 else 1)


def core_band_plain(band, xc, rows, out):
    """``out[rows] += f32(cells(band)) @ f32(xc[:w])`` in plain PyTorch."""
    w = cell_width(band)
    return out.index_add_(0, rows, band_cells(band).float() @ xc[:w].float())


def core_bands_plain(bands, xc, core_nodes, stair, out):
    """:func:`core_band_plain` for every band ``(lo, hi, w)`` of ``stair``
    with rows ``core_nodes[lo:hi]``."""
    for band, (lo, hi, _w) in zip(bands, stair):
        core_band_plain(band, xc, core_nodes[lo:hi], out)
    return out


def _check(bands, xc, core_nodes, stair, out,
           xc_dtypes=(torch.bfloat16,)) -> None:
    if len(bands) != len(stair):
        raise ValueError(f"{len(bands)} bands for {len(stair)} stair entries")
    if xc.dtype not in xc_dtypes or xc.dim() != 2:
        raise TypeError(f"xc must be 2-D {' or '.join(map(str, xc_dtypes))}, "
                        f"got {xc.dtype} {tuple(xc.shape)}")
    if core_nodes.dtype != torch.int32 or core_nodes.dim() != 1:
        raise TypeError(f"rows must be 1-D int32, got {core_nodes.dtype} "
                        f"{tuple(core_nodes.shape)}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise TypeError(f"out must be 2-D float32, got {out.dtype} {tuple(out.shape)}")
    if xc.shape[1] != out.shape[1]:
        raise ValueError(f"xc width {xc.shape[1]} != out width {out.shape[1]}")
    if len({band.dtype for band in bands}) > 1:
        raise TypeError("bands of one call must share their cell type")
    for band, (lo, hi, w) in zip(bands, stair):
        if (band.dtype not in (torch.int8, torch.uint8, torch.bfloat16)
                or band.dim() != 2):
            raise TypeError(f"band must be 2-D int8, bf16 or packed uint8, "
                            f"got {band.dtype} {tuple(band.shape)}")
        if band.dtype == torch.uint8 and w % 2:
            raise ValueError(f"a packed band holds an even width, got {w}")
        if tuple(band.shape) != (hi - lo, w // (1 + (band.dtype == torch.uint8))):
            raise ValueError(f"band {band.dtype} {tuple(band.shape)} for "
                             f"stair entry {(lo, hi, w)}")
        if xc.shape[0] < w:
            raise ValueError(f"xc has {xc.shape[0]} rows for a band of width {w}")
        if core_nodes.shape[0] < hi:
            raise ValueError(
                f"rows has {core_nodes.shape[0]} entries for band rows up to {hi}")
    devs = {t.device for t in (*bands, xc, core_nodes, out)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    for name, t in (("xc", xc), ("rows", core_nodes), ("out", out), *(
            (f"band {b}", t) for b, t in enumerate(bands))):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def width_rule(packed: bool) -> int:
    """The kernels' stored-width rule: band widths (in cells) a multiple
    of 16 for int8 and bf16 and 32 for packed int4, so each row's bytes,
    the TMA row stride, are a multiple of 16 (and a bf16 band's width
    whole 16-deep steps)."""
    return 32 if packed else 16


def is_packed(bands) -> bool:
    """Whether the bands hold nibble-packed int4 cells."""
    return bool(bands) and bands[0].dtype == torch.uint8


def cell_mode(bands) -> int:
    """The kernel's cell mode of the bands: :data:`INT8`, :data:`PACKED`
    (nibble-packed int4) or :data:`BF16`."""
    if is_packed(bands):
        return PACKED
    return BF16 if bands and bands[0].dtype == torch.bfloat16 else INT8


def step_cost(cell_bytes: float) -> float:
    """The schedule's cost of one 64-deep stage of a band of
    ``cell_bytes`` cells, in int8 stages: a stage takes the longer of its
    wgmmas (alike for every cell type) and its loads, modeled as its
    bytes, A box and B stage, over an int8 stage's, never below 1."""
    a_bytes = BM * BK * cell_bytes
    return max(1.0, (a_bytes + BK * BN * 2) / (BM * BK + BK * BN * 2))


def _check_kernel_contract(bands, xc, core_nodes, stair, out) -> None:
    h = out.shape[1]
    why = []
    if h % 8:
        why.append(f"H % 8 == 0 (H={h})")
    q = width_rule(is_packed(bands))
    bad_w = [w for _lo, _hi, w in stair if w % q]
    if bad_w:
        why.append(f"band widths % {q} == 0 (got {bad_w})")
    ptrs = [("xc", xc), ("out", out),
            *((f"band {b}", t) for b, t in enumerate(bands))]
    mis = [name for name, t in ptrs if t.data_ptr() % 16]
    if mis:
        why.append(f"16-byte aligned {', '.join(mis)}")
    if why:
        raise ValueError("K-core kernel needs " + "; ".join(why))


# Work of a tile, in contraction steps of 64 (one ring stage): the
# epilogue's read-modify-write of up to 128 rows × 1 KB costs about as
# much as 12 steps on an H100, which matters for the w = 256 bands' tiles
# of 4 steps.
_EPILOGUE_COST = 12
# A split tile's leader (K-int's cluster split) reads each peer's f32
# partial of its tile (128 rows × 1 KB) through distributed shared memory:
# about a third of the epilogue's traffic, so 4 steps a peer.
_REDUCE_COST = 4

BK = 64                 # contraction of one ring stage (cells)
SPLITS = (1, 2, 4)      # chunks K-int may split a tile's contraction into
STREAM = 0              # the split value of a stream-K launch
SCHEDULES = (STREAM, 1)  # K-core's: stream-K, whole tiles
_FIELDS = 6             # a block's tile: band, m0, n0, live, k0, k1
# A stream-K piece that ends before its tile does writes its f32 partial
# (128 rows × 1 KB) to the workspace, and the tile's last piece reads it
# back; each way about half the epilogue's traffic, so 6 steps each.
_PARTIAL_COST = 6
# The predicted gain stream-K must show over whole tiles: a launch keeps
# whole tiles unless stream-K's longest block is at least this much
# shorter than the longest block of whole tiles. Set from both schedules
# forced on an H100 (PERF.md §6): where the model put stream-K at 0.76 of
# whole tiles or less (the smoke cores) it ran faster; at 0.95 and 1.00
# (the reddit-sim bf16 square and stair, whose blocks then read the
# payload at scattered depths) it ran 1.36 and 1.30 times slower. The
# margin sits in the middle of (0.05, 0.24).
_STREAM_MARGIN = 0.15


def chunk_bounds(w: int, s: int):
    """The ``s`` contiguous chunks ``[k0, k1)`` of a contraction of ``w``
    cells, in whole 64-deep stages (sizes differ by at most one stage; the
    last chunk ends at ``w``, so it holds a ragged last stage)."""
    steps = -(-w // BK)
    cuts = [min(w, BK * (steps * c // s)) for c in range(s + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def cluster_counts(n) -> dict:
    """``{split: clusters the card runs at once}``: ``n`` itself when it
    is such a dict (the card's answer, :func:`max_clusters`), else the
    blocks ``n`` split evenly into clusters of each size."""
    return dict(n) if isinstance(n, dict) else {s: n // s for s in SPLITS}


def stream_blocks(clusters) -> int:
    """The blocks of a stream-K launch: the card's resident blocks of the
    stream-K kernel (``clusters[STREAM]``), else its single blocks."""
    counts = cluster_counts(clusters)
    return counts.get(STREAM, counts[1])


def _greedy(cells, n_clusters: int):
    """Cells ``(cost, *tile)`` longest first, each to the cluster with the
    least work so far: the clusters' tile lists and loads."""
    cells = sorted(cells, key=lambda c: -c[0])  # stable: band, m0, n0 order
    n_clusters = max(1, min(n_clusters, len(cells)))
    heap = [(0, i) for i in range(n_clusters)]
    per = [[] for _ in range(n_clusters)]
    loads = [0] * n_clusters
    for cost, *tile in cells:
        load, i = heapq.heappop(heap)
        per[i].append(tile)
        loads[i] = load + cost
        heapq.heappush(heap, (load + cost, i))
    return per, loads


def _cells(stair, h: int, bn: int, rows: int, split: int,
           cell_bytes: float = 1.0):
    """Every cluster tile ``(cost, band, m0, n0)``: ``rows`` row tiles of
    :data:`BM` and one column tile of ``bn`` of one band, its contraction
    split into ``split`` chunks run side by side, each stage at
    :func:`step_cost` of ``cell_bytes``."""
    out = []
    step = step_cost(cell_bytes)
    for b, (lo, hi, w) in enumerate(stair):
        steps = max(-(-(k1 - k0) // BK) for k0, k1 in chunk_bounds(w, split))
        cost = steps * step + _EPILOGUE_COST + _REDUCE_COST * (split - 1)
        out += [(cost, b, m0, n0) for m0 in range(0, hi - lo, BM * rows)
                for n0 in range(0, h, bn)]
    return out


def choose_split(stair, h: int, bn: int, clusters, rows: int = 1,
                 splits=SPLITS, cell_bytes: float = 1.0) -> int:
    """The contraction split of one launch: the smallest of ``splits``
    whose greedy schedule's longest cluster comes within 10% of the mean
    cluster's load (each load the tiles' longest chunk, its stages at
    :func:`step_cost` of ``cell_bytes``, plus the epilogue and the
    reduction), else the one whose longest cluster is shortest.
    Clusters of ``rows`` row tiles (K-int's multicast) are not split, nor
    is a band into chunks of no stage."""
    counts = cluster_counts(clusters)
    best = None
    for s in splits if rows == 1 else (1,):
        if counts.get(s, 0) < 1 or any(-(-w // BK) < s for *_, w in stair):
            continue
        _per, loads = _greedy(_cells(stair, h, bn, rows, s, cell_bytes),
                              counts[s])
        if 10 * max(loads) * len(loads) <= 11 * sum(loads):
            return s
        if best is None or max(loads) < best[0]:
            best = (max(loads), s)
    return 1 if best is None else best[1]


def cluster_schedule(stair, h: int, bn: int, clusters, rows: int = 1,
                     split=None, splits=SPLITS, cell_bytes: float = 1.0):
    """The kernels' work list for bands ``stair`` of ``cell_bytes`` cells
    at width ``h`` over clusters of ``rows`` × ``split`` blocks (``split``
    chosen from ``splits`` by :func:`choose_split` when not given).

    A cluster tile covers ``rows`` row tiles of :data:`BM` rows and one
    column tile of ``bn`` columns of one band; its contraction over ``w``
    is cut into ``split`` chunks of whole stages (:func:`chunk_bounds`),
    and block ``i · split + c`` of the cluster takes row tile ``m0 + BM ·
    i`` and chunk ``c``. A block whose rows lie past the band's is kept,
    marked not live: it still takes part in the cluster's shared stages
    and stores nothing. The cluster tiles go longest first to the cluster
    with the least work so far (greedy longest-first), so short bands
    fill the clusters that the long ones leave idle.

    Returns ``(tiles, starts)``: ``tiles`` int32 ``(n, rows · split,
    6)``, each block's ``(band, m0, n0, live, k0, k1)`` per cluster tile,
    grouped by cluster, each cluster's longest first; cluster ``c`` runs
    ``tiles[starts[c]:starts[c + 1]]``."""
    counts = cluster_counts(clusters)
    if split is None:
        split = choose_split(stair, h, bn, counts, rows, splits, cell_bytes)
    elif (split not in splits or any(-(-w // BK) < split for *_, w in stair)
          or rows > 1 < split):
        raise ValueError(f"cannot split {stair} into {split} chunks "
                         f"(clusters of {rows} row tiles)")
    per, _loads = _greedy(_cells(stair, h, bn, rows, split, cell_bytes),
                          counts[split])
    blocks = rows * split
    tiles = np.array(
        [[(b, m0 + BM * i, n0, int(m0 + BM * i < stair[b][1] - stair[b][0]),
           k0, k1)
          for i in range(rows) for k0, k1 in chunk_bounds(stair[b][2], split)]
         for ts in per for b, m0, n0 in ts],
        dtype=np.int32).reshape(-1, blocks, _FIELDS)
    starts = np.cumsum([0] + [len(ts) for ts in per]).astype(np.int32)
    return tiles, starts


def _stream_tiles(stair, h: int, bn: int):
    """The tiles of a stream-K launch in the order their stages are
    laid out: ``(stages, band, m0, n0)``, the longest first (stable: band,
    m0, n0 order among equals, so one band's row tiles stay together)."""
    tiles = [(-(-w // BK), b, m0, n0) for b, (lo, hi, w) in enumerate(stair)
             for m0 in range(0, hi - lo, BM) for n0 in range(0, h, bn)]
    return sorted(tiles, key=lambda t: -t[0])


def stream_cuts(tiles, blocks: int, cell_bytes: float = 1.0):
    """Where a stream-K launch's spans begin and end, in stages of the
    laid-out tiles (:func:`_stream_tiles`): the modeled work (every stage
    at :func:`step_cost` of ``cell_bytes``, a tile's epilogue after its
    last stage) cut into ``blocks`` equal shares, each cut moved to the
    stage boundary at or after it; cuts that meet are merged, so every
    span holds a stage and there may be fewer spans than ``blocks``. Span
    i is ``[cuts[i], cuts[i + 1])``; each ends within one stage and one
    epilogue of its share."""
    step = step_cost(cell_bytes)
    steps = np.array([t[0] for t in tiles], dtype=np.int64)
    first = np.concatenate(([0], np.cumsum(steps)))  # a tile's first stage
    cost0 = first[:-1] * step + np.arange(len(steps)) * _EPILOGUE_COST
    total = first[-1] * step + len(steps) * _EPILOGUE_COST
    cuts = [0]
    for i in range(1, blocks):
        c = total * i / blocks
        t = int(np.searchsorted(cost0, c, side="right")) - 1
        k = min(int(steps[t]), int(np.ceil((c - cost0[t]) / step - 1e-9)))
        cuts.append(int(first[t]) + k)
    cuts.append(int(first[-1]))
    return sorted(set(cuts))


def stream_schedule(stair, h: int, bn: int, blocks: int,
                    cell_bytes: float = 1.0):
    """K-core's stream-K work list for bands ``stair`` at width ``h``
    over at most ``blocks`` blocks (the card's resident blocks,
    :func:`max_clusters`).

    Every tile's stages are laid out one after another
    (:func:`_stream_tiles`) and the whole is cut into contiguous spans of
    equal modeled work (:func:`stream_cuts`), one a block. Block i runs
    the pieces of its span, the last first: ``(band, m0, n0, role, k0,
    k1)`` with ``[k0, k1)`` the piece's cells. ``role`` 0: the piece ends
    before its tile does; its block writes the partial to workspace slot
    i (it is the block's first piece run, so it waits on nothing).
    ``role`` n ≥ 1: the tile's last piece, after n - 1 earlier ones held
    by blocks i - 1, ..., i - n + 1; block i adds their partials in that
    order and scatters the sum. So a block waits only on blocks of lower
    index.

    Returns ``(tiles, starts)`` as :func:`cluster_schedule` (int32 ``(n,
    1, 6)``; block i runs ``tiles[starts[i]:starts[i + 1]]``)."""
    tiles = _stream_tiles(stair, h, bn)
    cuts = stream_cuts(tiles, blocks, cell_bytes)
    per = [[] for _ in range(len(cuts) - 1)]
    s0, i = 0, 0
    for steps, b, m0, n0 in tiles:
        s1, w = s0 + steps, stair[b][2]
        first = i
        while True:
            p0, p1 = max(s0, cuts[i]), min(s1, cuts[i + 1])
            role = 1 + i - first if p1 == s1 else 0
            per[i].append((b, m0, n0, role, BK * (p0 - s0),
                           min(w, BK * (p1 - s0))))
            if p1 == s1:
                break
            i += 1
        if s1 == cuts[i + 1] and i + 2 < len(cuts):
            i += 1
        s0 = s1
    tiles = np.array([t for ts in per for t in reversed(ts)],
                     dtype=np.int32).reshape(-1, 1, _FIELDS)
    starts = np.cumsum([0] + [len(ts) for ts in per]).astype(np.int32)
    return tiles, starts


def stream_loads(tiles, starts, cell_bytes: float = 1.0):
    """Each block's modeled work in :func:`stream_schedule`'s ``tiles``:
    its stages (each at :func:`step_cost` of ``cell_bytes``), an epilogue
    for each tile it ends, and a partial written or read for each piece
    handed over."""
    t = tiles[:, 0, :]
    steps = -(-(t[:, 5] - t[:, 4]) // BK)
    role = t[:, 3]
    cost = (steps * step_cost(cell_bytes) + (role > 0) * _EPILOGUE_COST
            + _PARTIAL_COST * np.where(role > 0, role - 1, 1))
    return np.add.reduceat(cost, starts[:-1])


def choose_schedule(stair, h: int, bn: int, clusters,
                    cell_bytes: float = 1.0) -> int:
    """K-core's schedule of one launch: :data:`STREAM` where the model
    predicts stream-K's longest block (:func:`stream_loads`) at least
    :data:`_STREAM_MARGIN` shorter than the longest block of whole tiles
    (split 1), else 1."""
    counts = cluster_counts(clusters)
    _per, loads = _greedy(_cells(stair, h, bn, 1, 1, cell_bytes), counts[1])
    stream = stream_loads(*stream_schedule(stair, h, bn,
                                           stream_blocks(counts), cell_bytes),
                          cell_bytes=cell_bytes)
    if float(stream.max()) <= (1 - _STREAM_MARGIN) * max(loads):
        return STREAM
    return 1


def schedule_loads(tiles, starts, rows: int = 1, cell_bytes: float = 1.0):
    """Each cluster's modeled work in :func:`cluster_schedule`'s
    ``tiles``: per tile its longest chunk in stages (each at
    :func:`step_cost` of ``cell_bytes``), the epilogue and the reduction
    of its chunks."""
    split = tiles.shape[1] // rows
    steps = -(-(tiles[:, :, 5] - tiles[:, :, 4]) // BK)
    cost = (steps.max(axis=1) * step_cost(cell_bytes) + _EPILOGUE_COST
            + _REDUCE_COST * (split - 1))
    return np.add.reduceat(cost, starts[:-1])


def tile_schedule(stair, h: int, clusters, bn: int = BN,
                  cell_bytes: float = 1.0, split=None):
    """K-core's work list: ``(tiles, starts)``, ``tiles`` int32 ``(n, 1,
    6)``, by :func:`stream_schedule` at split :data:`STREAM`, else (split
    1) :func:`cluster_schedule` of whole tiles; ``split`` one of
    :data:`SCHEDULES`, chosen by :func:`choose_schedule` when not given;
    ``clusters`` the blocks of the card, or its :func:`cluster_counts`."""
    counts = cluster_counts(clusters)
    if split is None:
        split = choose_schedule(stair, h, bn, counts, cell_bytes)
    elif split not in SCHEDULES:
        raise ValueError(f"K-core runs split 1 or stream-K, not {split}")
    if split == STREAM:
        return stream_schedule(stair, h, bn, stream_blocks(counts),
                               cell_bytes)
    return cluster_schedule(stair, h, bn, counts, split=split,
                            cell_bytes=cell_bytes)


def _launch_schedules(stair, h: int, clusters, bn: int, cell_bytes: float):
    """Each launch of one grouped call: its split and ``(tiles,
    starts)``."""
    counts = cluster_counts(clusters)
    out = []
    for group in band_groups(stair, h):
        sub = [stair[b] for b in group]
        split = choose_schedule(sub, h, bn, counts, cell_bytes)
        out.append((split, tile_schedule(sub, h, counts, bn, cell_bytes,
                                         split)))
    return out


def schedule_balance(stair, h: int, clusters, bn: int = BN,
                     cell_bytes: float = 1.0) -> float:
    """The longest block's work over the mean in
    :func:`tile_schedule`'s assignment of ``stair`` at width ``h`` (1.0 is
    perfect balance), the worst over the launches of one grouped call."""
    worst = 1.0
    for split, (tiles, starts) in _launch_schedules(stair, h, clusters, bn,
                                                    cell_bytes):
        loads = (stream_loads(tiles, starts, cell_bytes) if split == STREAM
                 else schedule_loads(tiles, starts, cell_bytes=cell_bytes))
        worst = max(worst, float(loads.max() / loads.mean()))
    return worst


def schedule_split(stair, h: int, clusters, bn: int = BN,
                   cell_bytes: float = 1.0) -> list:
    """The schedule of each launch of :func:`tile_schedule`'s grouped
    call: 1 for whole tiles, :data:`STREAM` (0) for stream-K."""
    return [split for split, _ in _launch_schedules(stair, h, clusters, bn,
                                                    cell_bytes)]


def band_groups(stair, h: int):
    """The launches of one grouped call at width ``h``: the indices of the
    bands that hold cells, in order, in groups of at most
    :data:`MAX_BANDS`; none at ``h == 0``."""
    keep = [b for b, (lo, hi, w) in enumerate(stair)
            if hi > lo and w > 0 and h > 0]
    return [keep[i:i + MAX_BANDS] for i in range(0, len(keep), MAX_BANDS)]


def band_maps(bands, stair, group):
    """The TMA maps of the CUDA bands ``group`` (host; boxes of 128 rows
    and 64 bytes, 64-byte swizzle, for int8; of 32 bytes, unswizzled, for
    packed int4; of 64 cells, 128-byte swizzle, for bf16) and their
    ``(lo, r, w)`` (host), as one launch takes them; K-int launches on
    the same maps."""
    lib = _build.load("core_dot")
    maps = (ctypes.c_uint8 * (_MAP_BYTES * len(group)))()
    base = ctypes.addressof(maps)
    mode = cell_mode(bands)
    for i, b in enumerate(group):
        r = bands[b].shape[0]
        nbytes = bands[b].shape[1] * bands[b].element_size()
        err = lib.core_encode_band_map(
            base + _MAP_BYTES * i, bands[b].data_ptr(), r, nbytes, mode)
        _build.check(err, f"core_encode_band_map (band {b}, {r}×{nbytes} "
                     f"{bands[b].dtype})")
    info = (ctypes.c_int * (3 * len(group)))(
        *[v for b in group
          for v in (stair[b][0], stair[b][1] - stair[b][0], stair[b][2])])
    return maps, info


@dataclasses.dataclass
class CorePlan:
    """What one launch over a fixed group of device bands needs: the
    bands' TMA maps and ``(lo, r, w)`` (host), the tile schedule (on the
    device), its split (1 whole tiles, :data:`STREAM`) and what it was
    built for (band indices, addresses, H, tile width)."""

    group: list
    ptrs: tuple
    h: int
    bn: int
    maps: ctypes.Array
    info: ctypes.Array
    tiles: torch.Tensor
    starts: torch.Tensor
    grid: int
    split: int = 1
    # stream-K's workspace (split STREAM): a partial of 2 × 128 × 128 f32
    # a block, and a flag a warpgroup, zero between launches (the kernel
    # resets each flag it takes); launches of one plan run in stream order
    partials: torch.Tensor = None
    flags: torch.Tensor = None


def max_clusters(device, mode) -> dict:
    """``{split: blocks}``: how many blocks of the K-core kernel in cell
    mode ``mode`` (:func:`cell_mode`; a bool reads as int8 or packed int4)
    the card runs at once at each of :data:`SCHEDULES`
    (``cudaOccupancyMaxActiveClusters`` of clusters of one)."""
    lib = _build.load("core_dot")
    out = {}
    with torch.cuda.device(device):
        for s in SCHEDULES:
            n = ctypes.c_int(0)
            _build.check(lib.core_max_clusters(s, int(mode),
                                               ctypes.addressof(n)),
                         "core_max_clusters")
            out[s] = n.value
    if out[1] < 1 or out[STREAM] < 1:
        raise RuntimeError("the card runs no block of the K-core kernel")
    return out


def core_plans(bands, stair, h: int, bn: int = BN, split=None) -> list:
    """The plans of one grouped call over these CUDA bands at width ``h``,
    one per launch (:func:`band_groups`), for tiles ``bn`` columns wide,
    each with the schedule :func:`choose_schedule` chooses for the card's
    resident blocks, or ``split`` where given (1 forces whole tiles,
    :data:`STREAM` stream-K, with its workspace). A prepared operand's bands never move,
    so its owner builds them once per width and passes them to
    :func:`core_bands_scatter_add`: encoding the maps and uploading the
    schedule synchronise the stream."""
    groups = band_groups(stair, h)
    if not groups:
        return []
    dev = bands[groups[0][0]].device
    mode = cell_mode(bands)
    counts = max_clusters(dev, mode)
    plans = []
    for group in groups:
        sub = [stair[b] for b in group]
        maps, info = band_maps(bands, stair, group)
        s = (choose_schedule(sub, h, bn, counts, MODE_CELL_BYTES[mode])
             if split is None else split)
        tiles, starts = tile_schedule(sub, h, counts, bn,
                                      MODE_CELL_BYTES[mode], s)
        grid = len(starts) - 1
        plan = CorePlan(
            group=group, ptrs=tuple(bands[b].data_ptr() for b in group), h=h,
            bn=bn, maps=maps, info=info, tiles=torch.from_numpy(tiles).to(dev),
            starts=torch.from_numpy(starts).to(dev), grid=grid, split=s)
        if s == STREAM:
            plan.partials = torch.empty((grid, 2, 128, 128),
                                        dtype=torch.float32, device=dev)
            plan.flags = torch.zeros((grid, 2), dtype=torch.int32, device=dev)
        plans.append(plan)
    return plans


def plans_match(plans, bands, stair, h: int, bn: int) -> bool:
    """Whether ``plans`` were built for these bands at width ``h`` with
    tiles ``bn`` columns wide."""
    return [(p.group, p.ptrs, p.h, p.bn) for p in plans] == [
        (g, tuple(bands[b].data_ptr() for b in g), h, bn)
        for g in band_groups(stair, h)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def core_bands_scatter_add(bands, xc, core_nodes, stair, out, plans=None):
    """``out[core_nodes[lo + i]] += Σ_{j<w} f32(band[i, j]) · f32(xc[j])``
    for every band ``(lo, hi, w)`` of ``stair``, in one launch per group
    of :data:`MAX_BANDS` bands.

    bands int8 or bf16 ``(hi - lo, w)`` or packed uint8 ``(hi - lo, w //
    2)`` each, all alike (:data:`packed_launches` counts the packed mode's
    launches, :data:`bf16_launches` the bf16 mode's, :data:`launches` the
    int8 mode's); xc bf16 (≥ max w, H); core_nodes
    int32, distinct over ``[0, hi_last)``; out f32 (N, H), updated in
    place and returned. CPU tensors take :func:`core_bands_plain`; CUDA
    tensors launch the kernel or raise. ``plans`` (:func:`core_plans` of
    these bands at this H) is built here when not given."""
    global launches, packed_launches, bf16_launches
    _check(bands, xc, core_nodes, stair, out)
    _build.refuse_grad("core_bands_scatter_add", xc, out)
    if out.device.type == "cpu":
        return core_bands_plain(bands, xc, core_nodes, stair, out)
    if out.device.type != "cuda":
        raise ValueError(f"no K-core kernel for device {out.device}")
    _check_kernel_contract(bands, xc, core_nodes, stair, out)
    h = out.shape[1]
    if plans is None:
        plans = core_plans(bands, stair, h)
    elif not (plans_match(plans, bands, stair, h, BN)
              and all(p.tiles.shape[1:] == (1, _FIELDS)
                      and (p.split != STREAM or p.flags is not None)
                      for p in plans)):
        raise ValueError("K-core plans were built for other bands or another H")
    lib = _build.load("core_dot")
    mode = cell_mode(bands)
    with torch.cuda.device(out.device):
        for plan in plans:
            err = lib.core_bands_scatter_add(
                ctypes.addressof(plan.maps), ctypes.addressof(plan.info),
                len(plan.group), xc.data_ptr(), xc.shape[0],
                plan.tiles.data_ptr(), plan.starts.data_ptr(), plan.grid,
                plan.split, core_nodes.data_ptr(), out.data_ptr(), h,
                mode, _ptr(plan.partials), _ptr(plan.flags),
                _build.stream_of(out),
            )
            _build.check(err, "core_bands_scatter_add")
            if mode == PACKED:
                packed_launches += 1
            elif mode == BF16:
                bf16_launches += 1
            else:
                launches += 1
    return out


def core_band_scatter_add(band, xc, rows, out):
    """``out[rows[i]] += Σ_j f32(band[i, j]) · f32(xc[j])`` for one band:
    the grouped kernel on a one-band list. band int8 or bf16 (r, w) or
    packed uint8 (r, w // 2); xc bf16 (≥ w, H); rows int32 (r,), distinct;
    out f32 (N, H)."""
    if band.dim() != 2:
        raise TypeError(f"band must be 2-D, got {band.dtype} {tuple(band.shape)}")
    r, w = band.shape[0], cell_width(band)
    if rows.dim() == 1 and rows.shape[0] != r:
        raise ValueError(f"rows has {rows.shape[0]} entries for {r} band rows")
    return core_bands_scatter_add([band], xc, rows, [(0, r, w)], out)
