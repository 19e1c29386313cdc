"""K-core: the staircase bands' int8 × bf16 products, scatter-added.

Counterpart of ``pygim_tpu/ops/pallas_core.py`` (``bf16(int8 core) @
bf16(x)`` with f32 accumulation) fused with the scatter of its product
into the output rows (``out.at[core_nodes[lo:hi]].add`` in
``pygim_tpu/ops/spmm.py:_core_scatter``). The CUDA kernel is
``csrc/core_dot.cu``: one persistent TMA + ``wgmma`` launch over all bands
of one SpMM, walking a tile list built here on the host.

``xc`` is ``x[core_nodes]`` already rounded to bf16 (round-to-nearest-
even, as ``xq.astype(bf16)`` in the reference); the gather and the cast
stay outside the kernel, as in JAX. Every int8 × bf16 product is exact
in f32, so the kernel and :func:`core_bands_plain` differ only in the
order of the f32 sums.

On the card the kernel takes bands of width ``w % 16 == 0`` (the planner
snaps widths to 256), ``H % 8 == 0`` and 16-byte aligned operands; the
wrapper raises on anything else. One launch carries at most
:data:`MAX_BANDS` bands, so a stair of more bands takes one launch per
group of them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import heapq

import numpy as np
import torch

from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (plain int; launches only)
launches = 0

BM, BN = 128, 256          # output tile of one block: band rows × columns
MAX_BANDS = 16             # band maps one launch carries
_MAP_BYTES = 128           # sizeof(CUtensorMap)


def core_band_plain(band, xc, rows, out):
    """``out[rows] += f32(band) @ f32(xc[:w])`` in plain PyTorch."""
    w = band.shape[1]
    return out.index_add_(0, rows, band.float() @ xc[:w].float())


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
    for band, (lo, hi, w) in zip(bands, stair):
        if band.dtype != torch.int8 or band.dim() != 2:
            raise TypeError(
                f"band must be 2-D int8, got {band.dtype} {tuple(band.shape)}")
        if tuple(band.shape) != (hi - lo, w):
            raise ValueError(f"band {tuple(band.shape)} for stair entry {(lo, hi, w)}")
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


def _check_kernel_contract(bands, xc, core_nodes, stair, out) -> None:
    h = out.shape[1]
    why = []
    if h % 8:
        why.append(f"H % 8 == 0 (H={h})")
    bad_w = [w for _lo, _hi, w in stair if w % 16]
    if bad_w:
        why.append(f"band widths % 16 == 0 (got {bad_w})")
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


def tile_schedule(stair, h: int, n_blocks: int, bn: int = BN):
    """The kernel's work list for bands ``stair`` at width ``h``.

    Every ``(band, row tile m0, column block n0)`` of 128 rows and ``bn``
    columns, each running its whole contraction over ``w``. The tiles go
    longest contraction first to ``n_blocks`` persistent blocks, each to
    the block with the least work so far (greedy longest-first), so the
    short bands fill the blocks that the long ones leave idle.

    Returns ``(tiles, starts)``: ``tiles`` int32 ``(n, 3)`` rows ``(band,
    m0, n0)`` grouped by block, each block's longest first; block ``i``
    runs ``tiles[starts[i]:starts[i + 1]]``."""
    steps = [-(-w // 64) for _lo, _hi, w in stair]
    cells = [(steps[b] + _EPILOGUE_COST, b, m0, n0)
             for b, (lo, hi, _w) in enumerate(stair)
             for m0 in range(0, hi - lo, BM) for n0 in range(0, h, bn)]
    cells.sort(key=lambda c: -c[0])  # stable: band, m0, n0 order
    n_blocks = max(1, min(n_blocks, len(cells)))
    heap = [(0, i) for i in range(n_blocks)]
    per_block = [[] for _ in range(n_blocks)]
    for cell in cells:
        load, i = heapq.heappop(heap)
        per_block[i].append(cell[1:])
        heapq.heappush(heap, (load + cell[0], i))
    tiles = np.array([c for cs in per_block for c in cs],
                     dtype=np.int32).reshape(-1, 3)
    starts = np.cumsum([0] + [len(cs) for cs in per_block]).astype(np.int32)
    return tiles, starts


def schedule_balance(stair, h: int, n_blocks: int, bn: int = BN) -> float:
    """The longest block's work over the mean block's in
    :func:`tile_schedule`'s assignment of ``stair`` at width ``h`` (1.0 is
    perfect balance), the worst over the launches of one grouped call."""
    worst = 1.0
    for group in band_groups(stair, h):
        sub = [stair[b] for b in group]
        tiles, starts = tile_schedule(sub, h, n_blocks, bn)
        work = np.array([-(-sub[b][2] // 64) + _EPILOGUE_COST
                         for b in tiles[:, 0]])
        loads = np.add.reduceat(work, starts[:-1])
        worst = max(worst, float(loads.max() / loads.mean()))
    return worst


def band_groups(stair, h: int):
    """The launches of one grouped call at width ``h``: the indices of the
    bands that hold cells, in order, in groups of at most
    :data:`MAX_BANDS`; none at ``h == 0``."""
    keep = [b for b, (lo, hi, w) in enumerate(stair)
            if hi > lo and w > 0 and h > 0]
    return [keep[i:i + MAX_BANDS] for i in range(0, len(keep), MAX_BANDS)]


def band_maps(bands, stair, group):
    """The TMA maps of the CUDA bands ``group`` (host, 64 × 128 boxes,
    64-byte swizzle) and their ``(lo, r, w)`` (host), as one launch takes
    them; K-int launches on the same maps."""
    lib = _build.load("core_dot")
    maps = (ctypes.c_uint8 * (_MAP_BYTES * len(group)))()
    base = ctypes.addressof(maps)
    for i, b in enumerate(group):
        r, w = bands[b].shape
        err = lib.core_encode_band_map(base + _MAP_BYTES * i,
                                       bands[b].data_ptr(), r, w)
        _build.check(err, f"core_encode_band_map (band {b}, {r}×{w})")
    info = (ctypes.c_int * (3 * len(group)))(
        *[v for b in group
          for v in (stair[b][0], stair[b][1] - stair[b][0], stair[b][2])])
    return maps, info


@dataclasses.dataclass
class CorePlan:
    """What one launch over a fixed group of device bands needs: the
    bands' TMA maps and ``(lo, r, w)`` (host), the tile schedule (on the
    device), and what it was built for (band indices, addresses, H, tile
    width)."""

    group: list
    ptrs: tuple
    h: int
    bn: int
    maps: ctypes.Array
    info: ctypes.Array
    tiles: torch.Tensor
    starts: torch.Tensor
    grid: int


def core_plans(bands, stair, h: int, bn: int = BN) -> list:
    """The plans of one grouped call over these CUDA bands at width ``h``,
    one per launch (:func:`band_groups`), for tiles ``bn`` columns wide. A
    prepared operand's bands never move, so its owner builds them once per
    width and passes them to :func:`core_bands_scatter_add`: encoding the
    maps and uploading the schedule synchronise the stream."""
    groups = band_groups(stair, h)
    if not groups:
        return []
    dev = bands[groups[0][0]].device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = []
    for group in groups:
        maps, info = band_maps(bands, stair, group)
        tiles, starts = tile_schedule([stair[b] for b in group], h, n_sm, bn)
        plans.append(CorePlan(
            group=group, ptrs=tuple(bands[b].data_ptr() for b in group), h=h,
            bn=bn, maps=maps, info=info, tiles=torch.from_numpy(tiles).to(dev),
            starts=torch.from_numpy(starts).to(dev), grid=len(starts) - 1))
    return plans


def plans_match(plans, bands, stair, h: int, bn: int) -> bool:
    """Whether ``plans`` were built for these bands at width ``h`` with
    tiles ``bn`` columns wide."""
    return [(p.group, p.ptrs, p.h, p.bn) for p in plans] == [
        (g, tuple(bands[b].data_ptr() for b in g), h, bn)
        for g in band_groups(stair, h)]


def core_bands_scatter_add(bands, xc, core_nodes, stair, out, plans=None):
    """``out[core_nodes[lo + i]] += Σ_{j<w} f32(band[i, j]) · f32(xc[j])``
    for every band ``(lo, hi, w)`` of ``stair``, in one launch per group
    of :data:`MAX_BANDS` bands.

    bands int8 ``(hi - lo, w)`` each; xc bf16 (≥ max w, H); core_nodes
    int32, distinct over ``[0, hi_last)``; out f32 (N, H), updated in
    place and returned. CPU tensors take :func:`core_bands_plain`; CUDA
    tensors launch the kernel or raise. ``plans`` (:func:`core_plans` of
    these bands at this H) is built here when not given."""
    global launches
    _check(bands, xc, core_nodes, stair, out)
    if out.device.type == "cpu":
        return core_bands_plain(bands, xc, core_nodes, stair, out)
    if out.device.type != "cuda":
        raise ValueError(f"no K-core kernel for device {out.device}")
    _check_kernel_contract(bands, xc, core_nodes, stair, out)
    h = out.shape[1]
    if plans is None:
        plans = core_plans(bands, stair, h)
    elif not plans_match(plans, bands, stair, h, BN):
        raise ValueError("K-core plans were built for other bands or another H")
    lib = _build.load("core_dot")
    with torch.cuda.device(out.device):
        for plan in plans:
            err = lib.core_bands_scatter_add(
                ctypes.addressof(plan.maps), ctypes.addressof(plan.info),
                len(plan.group), xc.data_ptr(), xc.shape[0],
                plan.tiles.data_ptr(), plan.starts.data_ptr(), plan.grid,
                core_nodes.data_ptr(), out.data_ptr(), h,
                _build.stream_of(out),
            )
            _build.check(err, "core_bands_scatter_add")
            launches += 1
    return out


def core_band_scatter_add(band, xc, rows, out):
    """``out[rows[i]] += Σ_j f32(band[i, j]) · f32(xc[j])`` for one band:
    the grouped kernel on a one-band list. band int8 (r, w); xc bf16
    (≥ w, H); rows int32 (r,), distinct; out f32 (N, H)."""
    if band.dim() != 2:
        raise TypeError(f"band must be 2-D int8, got {band.dtype} {tuple(band.shape)}")
    r, w = band.shape
    if rows.dim() == 1 and rows.shape[0] != r:
        raise ValueError(f"rows has {rows.shape[0]} entries for {r} band rows")
    return core_bands_scatter_add([band], xc, rows, [(0, r, w)], out)
