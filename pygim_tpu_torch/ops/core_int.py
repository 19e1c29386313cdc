"""K-int: the staircase bands' exact integer products, scatter-added.

Counterpart of the s8 branch of ``pygim_tpu/ops/spmm.py:_core_matmul``
(``dot(int8 band, int8 xc) -> int32``) and of ``_wide_int_core_dot`` (the
wrapped int32 product of an int8 band with an int16 or int32 payload),
fused with the scatter of the product into the output rows as f32
(``out.at[core_nodes[lo:hi]].add(f32(P))`` in ``_core_scatter``). The
CUDA kernel is ``csrc/core_int.cu``: one persistent TMA + ``wgmma`` launch
over all bands of one SpMM on K-core's band maps, walking a cluster
schedule built here (:func:`cluster_schedule`); at four limbs two blocks
of a cluster share their limb stage by TMA multicast.

The payload ``xc`` is integer (int8, int16 or int32). On the card it goes
to the kernel as ``limbs`` int8 digits (:func:`limb_split`), K-major:
``q = Σ_l 2^(8l) · limb_l (mod 2^32)``, and the kernel recombines the
per-limb int32 products in uint32 arithmetic, which is the reference's
wrapped int32 product bit for bit. The digits are balanced (each in
[-128, 127]); all but the last are exact, and the last is taken mod 256,
which loses nothing where ``2^(8(L-1)) · 256 ≡ 0 (mod 2^32)`` (L = 4) or
where the payload's range leaves it in [-128, 127]. So:

* raw payloads (``prep.mul``), any value of the dtype: :data:`RAW_LIMBS`,
  1 for int8, 3 for int16 (two balanced digits reach only
  [-32896, 32639]), 4 for int32;
* quantized payloads: :data:`QUANT_LIMBS`, 1 for int8 (|q| ≤ 16), 2 for
  int16 (|q| ≤ 2^9 + 1), 3 for int32 (|q| ≤ 2^19 + 1).

The limb split and the transpose stay PyTorch ops, as the float path's
gather and bf16 cast do. Every product is exact, so the kernel and
:func:`core_int_plain` agree bit for bit on ``out``.

On the card the kernel takes band widths ``w % 16 == 0`` and 16-byte
aligned bands, any H; the wrapper raises otherwise.
"""

from __future__ import annotations

import ctypes
import heapq

import numpy as np
import torch

from pygim_tpu_torch.ops import _build
from pygim_tpu_torch.ops.core_dot import (
    _EPILOGUE_COST,
    CorePlan,
    _check,
    band_groups,
    band_maps,
    plans_match,
)

# kernel launches since the last reset (plain int; launches only)
launches = 0

INT_DTYPES = (torch.int8, torch.int16, torch.int32)
RAW_LIMBS = {torch.int8: 1, torch.int16: 3, torch.int32: 4}
QUANT_LIMBS = {"int8": 1, "int16": 2, "int32": 3}

_ROWS_PER_STEP = 4096  # band rows a plain step multiplies at once

BM = 128  # band rows of one block's tile
# Blocks (row tiles) of one K-int cluster, by limb count: at four limbs two
# blocks share their limb stage by TMA multicast, which only there was
# faster on an H100 (PERF.md); single blocks elsewhere.
# csrc/core_int.cu:cluster_rows holds the same.
CLUSTER_ROWS = {1: 1, 2: 1, 3: 1, 4: 2}


def tile_columns(limbs: int) -> int:
    """Output columns of one kernel tile: the ``wgmma`` is 256 wide (192
    at three limbs) and holds every limb of its columns."""
    if not 1 <= limbs <= 4:
        raise ValueError(f"limbs must be 1..4, got {limbs}")
    return 64 if limbs >= 3 else 256 // limbs


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2^32 (two's complement)."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def band_product_plain(band, xc):
    """``int32(band @ xc[:w])`` in plain PyTorch: exact, and wrapped mod
    2^32 as the reference's int32 dot. The payload is split into 16-bit
    halves and each half multiplied in f64, whose sums stay exact integers
    (|band| ≤ 128, so below 2^23 · w): PyTorch has no integer matmul on
    CUDA, and this one runs on any device."""
    r, w = band.shape
    q = xc[:w].to(torch.int64)
    hi, lo = (q >> 16).double(), (q & 0xFFFF).double()
    p = torch.empty((r, xc.shape[1]), dtype=torch.int32, device=band.device)
    for r0 in range(0, r, _ROWS_PER_STEP):
        a = band[r0:r0 + _ROWS_PER_STEP].double()
        p[r0:r0 + _ROWS_PER_STEP] = _wrap32(
            (a @ hi).to(torch.int64) * 65536 + (a @ lo).to(torch.int64))
    return p


def core_band_int_plain(band, xc, rows, out):
    """``out[rows] += f32(band_product_plain(band, xc))``."""
    return out.index_add_(0, rows, band_product_plain(band, xc).float())


def core_int_plain(bands, xc, core_nodes, stair, out):
    """:func:`core_band_int_plain` for every band ``(lo, hi, w)`` of
    ``stair`` with rows ``core_nodes[lo:hi]``."""
    for band, (lo, hi, _w) in zip(bands, stair):
        core_band_int_plain(band, xc, core_nodes[lo:hi], out)
    return out


def limb_split(q, limbs: int, h_pad: int, k_pad: int):
    """The kernel's payload: ``q`` (K, H) integer as ``limbs`` balanced
    int8 digits, K-major and zero-padded, shape ``(limbs, h_pad, k_pad)``:
    digit l of ``q[j, n]`` at ``[l, n, j]``, with ``q ≡ Σ_l 2^(8l) ·
    digit_l (mod 2^32)`` wherever the last digit fits (module
    docstring).

    The balanced digits of q are the bytes of ``u = q + 128 · Σ_l 256^l``
    (mod 2^32), each less 128, i.e. each byte with its top bit flipped,
    read as int8; byte l is little-endian byte l of u's int32."""
    k, h = q.shape
    bias = sum(128 << (8 * l) for l in range(limbs))
    u = (q.to(torch.int64) + bias).to(torch.int32)  # wraps mod 2^32
    digits = u.view(torch.uint8).view(k, h, 4)[..., :limbs] ^ 0x80
    out = torch.zeros((limbs, h_pad, k_pad), dtype=torch.int8,
                      device=q.device)
    out[:, :h, :k] = digits.view(torch.int8).permute(2, 1, 0)
    return out


def _check_kernel_contract(bands, stair) -> None:
    why = []
    bad_w = [w for _lo, _hi, w in stair if w % 16]
    if bad_w:
        why.append(f"band widths % 16 == 0 (got {bad_w})")
    mis = [b for b, t in enumerate(bands) if t.data_ptr() % 16]
    if mis:
        why.append(f"16-byte aligned bands {mis}")
    if why:
        raise ValueError("K-int kernel needs " + "; ".join(why))


def cluster_schedule(stair, h: int, limbs: int, n_clusters: int):
    """The kernel's work list for bands ``stair`` at width ``h`` and
    ``limbs``, for ``n_clusters`` clusters of ``cm =``
    :data:`CLUSTER_ROWS` ``[limbs]`` blocks.

    A cluster tile ``(band, m0, n0)`` covers ``cm`` row tiles of
    :data:`BM` rows and one column tile of :func:`tile_columns` columns
    of one band, each running the band's whole contraction. Block ``i`` of
    the cluster takes row tile ``m0 + BM · i``; a block whose rows lie
    past the band's is kept, marked not live: it still takes part in the
    cluster's shared stages and stores nothing. The cluster tiles go
    longest contraction first to the cluster with the least work so far
    (greedy longest-first).

    Returns ``(tiles, starts)``: ``tiles`` int32 ``(n, cm, 4)``, each
    block's ``(band, m0, n0, live)`` per cluster tile, grouped by cluster,
    each cluster's longest first; cluster ``c`` runs ``tiles[starts[c]:
    starts[c + 1]]``."""
    cm = CLUSTER_ROWS[limbs]
    bn = tile_columns(limbs)
    steps = [-(-w // 64) for _lo, _hi, w in stair]
    cells = [(steps[b] + _EPILOGUE_COST, b, m0, n0)
             for b, (lo, hi, _w) in enumerate(stair)
             for m0 in range(0, hi - lo, BM * cm)
             for n0 in range(0, h, bn)]
    cells.sort(key=lambda c: -c[0])  # stable: band, m0, n0 order
    n_clusters = max(1, min(n_clusters, len(cells)))
    heap = [(0, i) for i in range(n_clusters)]
    per_cluster = [[] for _ in range(n_clusters)]
    for cost, b, m0, n0 in cells:
        load, c = heapq.heappop(heap)
        r = stair[b][1] - stair[b][0]
        per_cluster[c].append([(b, m0 + BM * i, n0, int(m0 + BM * i < r))
                               for i in range(cm)])
        heapq.heappush(heap, (load + cost, c))
    tiles = np.array([c for cs in per_cluster for c in cs],
                     dtype=np.int32).reshape(-1, cm, 4)
    starts = np.cumsum([0] + [len(cs) for cs in per_cluster]).astype(np.int32)
    return tiles, starts


def max_clusters(limbs: int, device) -> int:
    """How many clusters of the ``limbs`` kernel the card runs at once
    (``cudaOccupancyMaxActiveClusters``); raises where it runs none."""
    n = ctypes.c_int(0)
    lib = _build.load("core_int")
    with torch.cuda.device(device):
        _build.check(lib.core_int_max_clusters(limbs, ctypes.addressof(n)),
                     "core_int_max_clusters")
    if n.value < 1:
        raise RuntimeError(f"the card runs no cluster of the {limbs}-limb "
                           "K-int kernel")
    return n.value


def core_int_plans(bands, stair, h: int, limbs: int) -> list:
    """The plans of one grouped K-int call over these CUDA bands at width
    ``h`` and ``limbs``, one per launch (``core_dot.band_groups``): K-core's
    band maps with K-int's cluster schedule. A prepared operand keeps them
    per (H, limbs): encoding the maps and uploading the schedule
    synchronise the stream."""
    groups = band_groups(stair, h)
    if not groups:
        return []
    dev = bands[groups[0][0]].device
    n_clusters = max_clusters(limbs, dev)
    plans = []
    for group in groups:
        maps, info = band_maps(bands, stair, group)
        tiles, starts = cluster_schedule([stair[b] for b in group], h, limbs,
                                         n_clusters)
        plans.append(CorePlan(
            group=group, ptrs=tuple(bands[b].data_ptr() for b in group), h=h,
            bn=tile_columns(limbs), maps=maps, info=info,
            tiles=torch.from_numpy(tiles).to(dev),
            starts=torch.from_numpy(starts).to(dev), grid=len(starts) - 1))
    return plans


def core_int_launch(bands, xct, core_nodes, stair, out, plans):
    """Launch the kernel on a limb payload ``xct`` (:func:`limb_split`)
    with ``plans`` (:func:`core_int_plans`); ``out`` f32 (N, H) on the
    card, updated in place and returned."""
    global launches
    limbs, h_pad, k_pad = xct.shape
    h = out.shape[1]
    if not (plans_match(plans, bands, stair, h, tile_columns(limbs))
            and all(p.tiles.shape[1:] == (CLUSTER_ROWS[limbs], 4)
                    for p in plans)):
        raise ValueError("K-int plans were built for other bands, H or limbs")
    if (xct.dtype != torch.int8 or not xct.is_contiguous() or h_pad % 64
            or h_pad < h or k_pad % 16 or xct.data_ptr() % 16
            or k_pad < max((w for *_, w in stair), default=0)):
        raise ValueError(f"K-int needs an int8 limb payload (L, h_pad % 64, "
                         f"k_pad % 16), contiguous and 16-byte aligned; got "
                         f"{xct.dtype} {tuple(xct.shape)}")
    vec = int(h % 4 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.load("core_int")
    with torch.cuda.device(out.device):
        for plan in plans:
            err = lib.core_int_scatter_add(
                ctypes.addressof(plan.maps), ctypes.addressof(plan.info),
                len(plan.group), xct.data_ptr(), k_pad, h_pad, limbs,
                plan.tiles.data_ptr(), plan.starts.data_ptr(), plan.grid,
                core_nodes.data_ptr(), out.data_ptr(), h, vec,
                _build.stream_of(out),
            )
            _build.check(err, "core_int_scatter_add")
            launches += 1
    return out


def core_int_scatter_add(bands, xc, core_nodes, stair, out, limbs=None,
                         plans=None):
    """``out[core_nodes[lo + i]] += f32(int32(Σ_{j<w} band[i, j] ·
    xc[j]))`` (the sum wrapped mod 2^32) for every band ``(lo, hi, w)`` of
    ``stair``, in one launch per group of up to 16 bands.

    bands int8 ``(hi - lo, w)`` each; xc int8, int16 or int32 (≥ max w,
    H); core_nodes int32, distinct over ``[0, hi_last)``; out f32 (N, H),
    updated in place and returned. ``limbs`` defaults to
    :data:`RAW_LIMBS` of xc's dtype, which holds any value; a quantized
    caller passes :data:`QUANT_LIMBS`. CPU tensors take
    :func:`core_int_plain`; CUDA tensors launch the kernel or raise.
    ``plans`` (:func:`core_int_plans` at this H and ``limbs``) is built
    here when not given."""
    _check(bands, xc, core_nodes, stair, out, xc_dtypes=INT_DTYPES)
    if out.device.type == "cpu":
        return core_int_plain(bands, xc, core_nodes, stair, out)
    if out.device.type != "cuda":
        raise ValueError(f"no K-int kernel for device {out.device}")
    _check_kernel_contract(bands, stair)
    limbs = RAW_LIMBS[xc.dtype] if limbs is None else limbs
    h = out.shape[1]
    if plans is None:
        plans = core_int_plans(bands, stair, h, limbs)
    w_max = max((w for *_, w in stair), default=0)
    xct = limb_split(xc[:w_max], limbs, -(-h // 64) * 64,
                     -(-w_max // 16) * 16)
    return core_int_launch(bands, xct, core_nodes, stair, out, plans)
