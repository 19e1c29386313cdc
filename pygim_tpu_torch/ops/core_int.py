"""K-int: the hub-core bands' exact integer products, scatter-added.

Counterpart of the s8 branch of ``pygim_tpu/ops/spmm.py:_core_matmul``
(``dot(int8 band, int8 xc) -> int32``) and of ``_wide_int_core_dot`` (the
wrapped int32 product of an int8 band with an int16 or int32 payload),
fused with the scatter of the product into the output rows as f32
(``out.at[core_nodes[lo:hi]].add(f32(P))`` in ``_core_scatter``). The
CUDA kernel is ``csrc/core_int.cu``: one persistent TMA + ``wgmma`` launch
over all bands of one SpMM on K-core's band maps, walking a cluster
schedule built here (:func:`cluster_schedule`); at four limbs two blocks
of a cluster share their limb stage by TMA multicast, and at one and two
limbs, where row tiles are few, the blocks of a cluster split each
tile's contraction and the leader adds their products as uint32 before
the conversion.

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

A band is int8 ``(r, w)`` or int4 nibble-packed into uint8 ``(r, w //
2)`` (``core_dot.py``): the packed core's s8 and wide-integer products
(the uint8 branches of ``_core_matmul`` and ``_wide_int_core_dot``,
``pygim_tpu/ops/spmm.py:538-555, 586-597``) equal the same products of
the unpacked band. The kernel's int4 mode unpacks each stage's nibbles
once, in registers, into the s8 ``wgmma``'s A fragments for all limbs.

On the card the kernel takes band widths ``w % 16 == 0`` (int8) or ``w %
32 == 0`` (int4) and 16-byte aligned bands, any H; the wrapper raises
otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from pygim_tpu_torch.ops import _build, core_dot
from pygim_tpu_torch.ops.core_dot import (
    CorePlan,
    _check,
    band_cells,
    band_groups,
    band_maps,
    cell_width,
    is_packed,
    plans_match,
    width_rule,
)

# kernel launches since the last reset (plain ints; launches only): the
# int8 mode and the int4 (packed) mode
launches = 0
packed_launches = 0

INT_DTYPES = (torch.int8, torch.int16, torch.int32)
RAW_LIMBS = {torch.int8: 1, torch.int16: 3, torch.int32: 4}
QUANT_LIMBS = {"int8": 1, "int16": 2, "int32": 3}

_ROWS_PER_STEP = 4096  # band rows a plain step multiplies at once

# Blocks (row tiles) of one K-int cluster, by limb count: at four limbs two
# blocks share their limb stage by TMA multicast, which only there was
# faster on an H100 (PERF.md); single blocks elsewhere.
# csrc/core_int.cu:cluster_rows holds the same.
CLUSTER_ROWS = {1: 1, 2: 1, 3: 1, 4: 2}
# Contraction splits by limb count: one and two limbs (256 and 128 output
# columns a tile) leave few tiles on a square core and may split; three
# (64 columns) and four (the multicast pairs) do not.
# csrc/core_int.cu:MAX_SPLIT_LIMBS holds the same.
SPLIT_LIMBS = 2


def splits(limbs: int) -> tuple:
    """The contraction splits a launch at ``limbs`` may take."""
    return core_dot.SPLITS if limbs <= SPLIT_LIMBS else (1,)


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
    r, w = band.shape[0], cell_width(band)
    q = xc[:w].to(torch.int64)
    hi, lo = (q >> 16).double(), (q & 0xFFFF).double()
    p = torch.empty((r, xc.shape[1]), dtype=torch.int32, device=band.device)
    for r0 in range(0, r, _ROWS_PER_STEP):
        a = band_cells(band[r0:r0 + _ROWS_PER_STEP]).double()
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
    q = width_rule(is_packed(bands))
    bad_w = [w for _lo, _hi, w in stair if w % q]
    if bad_w:
        why.append(f"band widths % {q} == 0 (got {bad_w})")
    mis = [b for b, t in enumerate(bands) if t.data_ptr() % 16]
    if mis:
        why.append(f"16-byte aligned bands {mis}")
    if why:
        raise ValueError("K-int kernel needs " + "; ".join(why))


def cluster_schedule(stair, h: int, limbs: int, clusters, split=None):
    """The kernel's work list for bands ``stair`` at width ``h`` and
    ``limbs`` (``core_dot.cluster_schedule``): clusters of
    :data:`CLUSTER_ROWS` ``[limbs]`` row tiles of :func:`tile_columns`
    columns, each block running the band's whole contraction, at four
    limbs; elsewhere single row tiles, whose contraction at one or two
    limbs is split into chunks where row tiles are few
    (``core_dot.choose_split``).
    ``clusters``: the card's clusters of each split (:func:`max_clusters`),
    or its blocks; ``split`` the split, where not chosen.

    Returns ``(tiles, starts)``: ``tiles`` int32 ``(n, rows · split, 6)``,
    each block's ``(band, m0, n0, live, k0, k1)`` per cluster tile."""
    return core_dot.cluster_schedule(stair, h, tile_columns(limbs), clusters,
                                     rows=CLUSTER_ROWS[limbs], split=split,
                                     splits=splits(limbs))


def cluster_balance(stair, h: int, limbs: int, clusters) -> float:
    """The longest cluster's work over the mean cluster's in
    :func:`cluster_schedule`'s assignment (1.0 is perfect balance)."""
    loads = core_dot.schedule_loads(
        *cluster_schedule(stair, h, limbs, clusters), CLUSTER_ROWS[limbs])
    return float(loads.max() / loads.mean())


def max_clusters(limbs: int, device, packed: bool = False) -> dict:
    """``{split: clusters}``: how many clusters of the ``limbs`` kernel
    (its int4 mode where ``packed``) the card runs at once
    (``cudaOccupancyMaxActiveClusters``), for each contraction split it
    may take (:func:`splits`); raises where it runs none."""
    lib = _build.load("core_int")
    out = {}
    with torch.cuda.device(device):
        for s in splits(limbs):
            n = ctypes.c_int(0)
            _build.check(lib.core_int_max_clusters(
                limbs, int(packed), s, ctypes.addressof(n)),
                "core_int_max_clusters")
            out[s] = n.value
    if out[1] < 1:
        raise RuntimeError(f"the card runs no cluster of the {limbs}-limb "
                           "K-int kernel")
    return out


def core_int_plans(bands, stair, h: int, limbs: int, split=None) -> list:
    """The plans of one grouped K-int call over these CUDA bands at width
    ``h`` and ``limbs``, one per launch (``core_dot.band_groups``): K-core's
    band maps with K-int's cluster schedule (its split chosen for the
    card's cluster counts, or ``split`` where given). A prepared operand
    keeps them per (H, limbs): encoding the maps and uploading the
    schedule synchronise the stream."""
    groups = band_groups(stair, h)
    if not groups:
        return []
    dev = bands[groups[0][0]].device
    counts = max_clusters(limbs, dev, is_packed(bands))
    plans = []
    for group in groups:
        maps, info = band_maps(bands, stair, group)
        tiles, starts = cluster_schedule([stair[b] for b in group], h, limbs,
                                         counts, split)
        plans.append(CorePlan(
            group=group, ptrs=tuple(bands[b].data_ptr() for b in group), h=h,
            bn=tile_columns(limbs), maps=maps, info=info,
            tiles=torch.from_numpy(tiles).to(dev),
            starts=torch.from_numpy(starts).to(dev), grid=len(starts) - 1,
            split=tiles.shape[1] // CLUSTER_ROWS[limbs]))
    return plans


def core_int_launch(bands, xct, core_nodes, stair, out, plans):
    """Launch the kernel on a limb payload ``xct`` (:func:`limb_split`)
    with ``plans`` (:func:`core_int_plans`); ``out`` f32 (N, H) on the
    card, updated in place and returned."""
    global launches, packed_launches
    limbs, h_pad, k_pad = xct.shape
    h = out.shape[1]
    if not (plans_match(plans, bands, stair, h, tile_columns(limbs))
            and all(p.tiles.shape[1:] == (CLUSTER_ROWS[limbs] * p.split, 6)
                    and (p.split == 1 or CLUSTER_ROWS[limbs] == 1)
                    for p in plans)):
        raise ValueError("K-int plans were built for other bands, H or limbs")
    if (xct.dtype != torch.int8 or not xct.is_contiguous() or h_pad % 64
            or h_pad < h or k_pad % 16 or xct.data_ptr() % 16
            or k_pad < max((w for *_, w in stair), default=0)):
        raise ValueError(f"K-int needs an int8 limb payload (L, h_pad % 64, "
                         f"k_pad % 16), contiguous and 16-byte aligned; got "
                         f"{xct.dtype} {tuple(xct.shape)}")
    vec = int(h % 4 == 0 and out.data_ptr() % 16 == 0)
    packed = is_packed(bands)
    lib = _build.load("core_int")
    with torch.cuda.device(out.device):
        for plan in plans:
            err = lib.core_int_scatter_add(
                ctypes.addressof(plan.maps), ctypes.addressof(plan.info),
                len(plan.group), xct.data_ptr(), k_pad, h_pad, limbs,
                plan.tiles.data_ptr(), plan.starts.data_ptr(), plan.grid,
                plan.split, core_nodes.data_ptr(), out.data_ptr(), h, vec, int(packed),
                _build.stream_of(out),
            )
            _build.check(err, "core_int_scatter_add")
            if packed:
                packed_launches += 1
            else:
                launches += 1
    return out


def core_int_scatter_add(bands, xc, core_nodes, stair, out, limbs=None,
                         plans=None):
    """``out[core_nodes[lo + i]] += f32(int32(Σ_{j<w} band[i, j] ·
    xc[j]))`` (the sum wrapped mod 2^32) for every band ``(lo, hi, w)`` of
    ``stair``, in one launch per group of up to 16 bands.

    bands int8 ``(hi - lo, w)`` or packed uint8 ``(hi - lo, w // 2)``
    each, all alike (:data:`packed_launches` counts the packed mode's
    launches); xc int8, int16 or int32 (≥ max w, H); core_nodes int32, distinct over ``[0, hi_last)``; out f32 (N, H),
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
