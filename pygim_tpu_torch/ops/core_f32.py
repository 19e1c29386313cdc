"""K-f32: the hub-core bands' products in f32, scatter-added.

Counterpart of two branches of ``pygim_tpu/ops/spmm.py:_core_matmul``
fused with the scatter of their product (``out.at[core_nodes[lo:hi]].add``
in ``_core_scatter``): the f32 core's product (``:630``, ``dot(core,
f32(x))``; the reference's default hybrid core on a float graph, whose
float64 core is stored as f32 cells too), and a bf16 core's product with
an int16 or int32 payload (``:615-628``, both operands promoted to f32).
The CUDA kernel is in ``csrc/core_f32.cu``, one launch over all bands of
one SpMM (at most :data:`MAX_BANDS`; more take one launch per group),
walking a tile list built here on the host (:func:`core_f32_plans`).

A band is f32 or bf16 ``(r, w)``; ``xc`` ``(>= max w, H)`` is f32, bf16,
int8, int16 or int32. The kernel runs an f32-accurate split on TF32
``wgmma``: f32 cells are split in the kernel into a TF32 hi and lo
(``cvt.rna``), the payload here, once a call, into the parts of
:func:`payload_parts`, K-major; f32 cells take 3 TF32 products a term
(3xTF32: ``a_hi b_hi + a_hi b_lo + a_lo b_hi``, about 3 · 2^-22 of the
sum of |terms| off the f32 dot), bf16 cells one a part, every product
exact in f32. bf16 cells with an integer payload (balanced 11-bit limbs)
stay bit-equal to the f32 dot wherever its partial sums are integers
below 2^24. Counted in :data:`launches` (f32 cells) and
:data:`limb_launches` (bf16 cells).

On the card every band's row must be a multiple of 16 bytes (``w % 4 ==
0`` for f32 cells, ``w % 8 == 0`` for bf16; the TMA's row stride) and
each band 16-byte aligned (:func:`tc_bands`); any H. The wrapper raises
on other bands; the prepared operand pads its bands to this rule
(``ops/spmm.py:WIDTH_RULE``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pygim_tpu_torch.ops import _build
from pygim_tpu_torch.ops.core_dot import band_groups

# kernel launches since the last reset (plain ints; launches only): on
# f32 cells (3xTF32) and on bf16 cells (payload limbs)
launches = 0
limb_launches = 0

CELLS = {torch.float32: 0, torch.bfloat16: 1}
PAYLOADS = (torch.float32, torch.bfloat16, torch.int8, torch.int16,
            torch.int32)
BM, BN = 128, 128   # output tile of one block: band rows × columns
MAX_BANDS = 16      # bands one launch carries (core_dot.band_groups' groups)
_MAP_BYTES = 128    # sizeof(CUtensorMap)
# the kernel's band width rule, in cells: 16-byte rows
TC_WIDTH = {torch.float32: 4, torch.bfloat16: 8}
LIMB_BITS = 11      # a TF32 holds 11 significant bits
# payload parts of the kernel: (cell, payload) -> kind, where
# "exact" is one part exact in TF32, "split" an f32 row as a TF32 hi and
# lo, and "limbs" an integer row as balanced 11-bit limbs
PART_KINDS = {
    **{(c, p): "exact" for c in CELLS for p in (torch.bfloat16, torch.int8)},
    **{(torch.float32, p): "split"
       for p in (torch.float32, torch.int16, torch.int32)},
    (torch.bfloat16, torch.float32): "split",
    (torch.bfloat16, torch.int16): "limbs",
    (torch.bfloat16, torch.int32): "limbs",
}


def core_f32_plain(bands, xc, core_nodes, stair, out):
    """``out[core_nodes[lo:hi]] += f32(band) @ f32(xc[:w])`` for every
    band ``(lo, hi, w)`` of ``stair``, in plain PyTorch."""
    for band, (lo, hi, w) in zip(bands, stair):
        out.index_add_(0, core_nodes[lo:hi], band.float() @ xc[:w].float())
    return out


def tf32_rna(x):
    """``x`` (f32) rounded to TF32, 11 significant bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: half a TF32 ulp added
    to the magnitude's bits, the low 13 bits cleared (NaN kept)."""
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isnan(x), x, bits.view(torch.float32))


def limbs(q, n: int) -> list:
    """Integer rows ``q`` as ``n`` balanced limbs of :data:`LIMB_BITS`
    bits: ``q = Σ_l 2^(11 l) · d_l``, each ``d_l`` in ``[-1024, 1024)``
    but the last, which takes the rest (int64)."""
    q = q.to(torch.int64)
    half = 1 << (LIMB_BITS - 1)
    out = []
    for _ in range(n - 1):
        d = ((q + half) & ((1 << LIMB_BITS) - 1)) - half
        out.append(d)
        q = (q - d) >> LIMB_BITS
    return out + [q]


def n_parts(cell, payload) -> int:
    """The kernel's payload parts for ``cell`` cells and a ``payload``
    dtype (:func:`payload_parts`)."""
    kind = PART_KINDS[(cell, payload)]
    if kind == "limbs":
        return 2 if payload == torch.int16 else 3
    return 1 if kind == "exact" else 2


def n_products(cell, payload) -> int:
    """TF32 products a term in the kernel: one a payload part,
    and beside f32 cells one more, ``a_lo`` times the first part
    (3xTF32 drops ``a_lo b_lo``)."""
    return n_parts(cell, payload) + (cell == torch.float32)


def payload_parts(xc, cell, h_pad: int, k_pad: int):
    """The kernel's payload: ``xc`` (K, H) as :func:`n_parts`
    f32 parts, each exact in TF32, K-major and zero-padded, shape ``(P,
    h_pad, k_pad)``: part p of ``xc[j, n]`` at ``[p, n, j]``.

    By :data:`PART_KINDS`: bf16 and int8 rows are one part, as they are;
    f32 rows, and beside f32 cells int16 and int32 rows (converted to f32
    first, rounding beyond 2^24 as the reference's convert), are ``hi =
    tf32_rna(x)`` and ``lo = tf32_rna(x - hi)`` (``lo`` 0 where ``hi`` is
    not finite); beside bf16 cells, int16 and int32 rows are their
    balanced limbs (:func:`limbs`, 2 and 3), limb l scaled by 2^(11 l),
    exactly."""
    k, h = xc.shape
    kind = PART_KINDS[(cell, xc.dtype)]
    if kind == "exact":
        parts = [xc.float()]
    elif kind == "split":
        x = xc.float()
        hi = tf32_rna(x)
        lo = torch.where(torch.isfinite(hi), x - hi, torch.zeros_like(x))
        parts = [hi, tf32_rna(lo)]
    else:
        parts = [d.float() * float(1 << (LIMB_BITS * l)) for l, d in
                 enumerate(limbs(xc, n_parts(cell, xc.dtype)))]
    out = torch.zeros((len(parts), h_pad, k_pad), dtype=torch.float32,
                      device=xc.device)
    out[:, :h, :k] = torch.stack(parts).transpose(1, 2)
    return out


def _check(bands, xc, core_nodes, stair, out) -> None:
    if len(bands) != len(stair):
        raise ValueError(f"{len(bands)} bands for {len(stair)} stair entries")
    if xc.dtype not in PAYLOADS or xc.dim() != 2:
        raise TypeError(f"xc must be 2-D float32, bfloat16, int8, int16 or "
                        f"int32, got {xc.dtype} {tuple(xc.shape)}")
    if core_nodes.dtype != torch.int32 or core_nodes.dim() != 1:
        raise TypeError(f"rows must be 1-D int32, got {core_nodes.dtype} "
                        f"{tuple(core_nodes.shape)}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise TypeError(f"out must be 2-D float32, got {out.dtype} "
                        f"{tuple(out.shape)}")
    if xc.shape[1] != out.shape[1]:
        raise ValueError(f"xc width {xc.shape[1]} != out width {out.shape[1]}")
    if len({band.dtype for band in bands}) > 1:
        raise TypeError("bands of one call must share their cell type")
    for band, (lo, hi, w) in zip(bands, stair):
        if band.dtype not in CELLS or band.dim() != 2:
            raise TypeError(f"band must be 2-D float32 or bfloat16, got "
                            f"{band.dtype} {tuple(band.shape)}")
        if tuple(band.shape) != (hi - lo, w):
            raise ValueError(f"band {tuple(band.shape)} for stair entry "
                             f"{(lo, hi, w)}")
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


@dataclasses.dataclass
class F32Plan:
    """What one launch over a fixed group of device bands needs: their
    addresses, TMA maps and ``(lo, r, w)`` (host), the tile list (on the
    device) and what it was built for (band indices, H)."""

    group: list
    h: int
    ptrs: tuple
    info: ctypes.Array
    tiles: torch.Tensor
    maps: ctypes.Array

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])


def tile_list(stair, h: int):
    """Every block's ``(band, m0, n0)`` over bands ``stair`` at width
    ``h``: :data:`BM`-row by :data:`BN`-column tiles, the widest bands'
    first (they run longest)."""
    order = sorted(range(len(stair)), key=lambda b: -stair[b][2])
    return [(b, m0, n0) for b in order
            for m0 in range(0, stair[b][1] - stair[b][0], BM)
            for n0 in range(0, h, BN)]


def tc_bands(bands, stair) -> bool:
    """Whether the bands meet the kernel's rule: widths a multiple of
    :data:`TC_WIDTH` of their cell type (16-byte rows, the TMA's row
    stride) and 16-byte aligned."""
    return all(w % TC_WIDTH[band.dtype] == 0 and band.data_ptr() % 16 == 0
               for band, (_lo, _hi, w) in zip(bands, stair))


def _check_kernel_contract(bands, stair) -> None:
    if not tc_bands(bands, stair):
        raise ValueError(
            "K-f32 kernel needs band widths % "
            f"{TC_WIDTH[bands[0].dtype]} == 0 and 16-byte aligned bands "
            f"(got widths {[w for *_, w in stair]})")


def band_maps(bands, stair, group):
    """The TMA maps of the CUDA bands ``group`` (host; boxes of 128 rows
    and 32 cells, 128-byte swizzle for f32, 64-byte for bf16)."""
    lib = _build.load("core_f32")
    maps = (ctypes.c_uint8 * (_MAP_BYTES * len(group)))()
    base = ctypes.addressof(maps)
    for i, b in enumerate(group):
        r, w = stair[b][1] - stair[b][0], stair[b][2]
        err = lib.core_f32_encode_band_map(base + _MAP_BYTES * i,
                                           bands[b].data_ptr(), r, w,
                                           CELLS[bands[b].dtype])
        _build.check(err, f"core_f32_encode_band_map (band {b}, {r}×{w} "
                     f"{bands[b].dtype})")
    return maps


def core_f32_plans(bands, stair, h: int) -> list:
    """The plans of one grouped call over these CUDA bands at width
    ``h``, one per launch (``core_dot.band_groups``), with the bands' TMA
    maps. A prepared operand's bands never move, so its owner builds them
    once per width and passes them to :func:`core_f32_scatter_add`."""
    plans = []
    for group in band_groups(stair, h):
        sub = [stair[b] for b in group]
        tiles = torch.tensor(tile_list(sub, h), dtype=torch.int32)
        plans.append(F32Plan(
            group=group, h=h,
            ptrs=tuple(bands[b].data_ptr() for b in group),
            info=(ctypes.c_int * (3 * len(group)))(
                *[v for lo, hi, w in sub for v in (lo, hi - lo, w)]),
            tiles=tiles.reshape(-1, 3).to(bands[group[0]].device),
            maps=band_maps(bands, stair, group)))
    return plans


def plans_match(plans, bands, stair, h: int) -> bool:
    """Whether ``plans`` were built for these bands at width ``h``."""
    return [(p.group, p.ptrs, p.h) for p in plans] == [
        (g, tuple(bands[b].data_ptr() for b in g), h)
        for g in band_groups(stair, h)]


def core_f32_scatter_add(bands, xc, core_nodes, stair, out, plans=None):
    """``out[core_nodes[lo + i]] += Σ_{j<w} f32(band[i, j]) · f32(xc[j])``
    for every band ``(lo, hi, w)`` of ``stair``, in one launch per group
    of :data:`MAX_BANDS` bands.

    bands f32 or bf16 ``(hi - lo, w)`` each, all alike; xc f32, bf16,
    int8, int16 or int32 (≥ max w, H); core_nodes int32, distinct over
    ``[0, hi_last)``; out f32 (N, H), updated in place and returned. CPU
    tensors take :func:`core_f32_plain`; CUDA tensors launch the kernel
    (counted in :data:`launches` on f32 cells, :data:`limb_launches` on
    bf16 cells) or raise. ``plans`` (:func:`core_f32_plans` of these bands
    at this H) is built here when not given."""
    global launches, limb_launches
    _check(bands, xc, core_nodes, stair, out)
    _build.refuse_grad("core_f32_scatter_add", xc, out)
    if out.device.type == "cpu":
        return core_f32_plain(bands, xc, core_nodes, stair, out)
    if out.device.type != "cuda":
        raise ValueError(f"no K-f32 kernel for device {out.device}")
    _check_kernel_contract(bands, stair)
    h = out.shape[1]
    if plans is None:
        plans = core_f32_plans(bands, stair, h)
    elif not plans_match(plans, bands, stair, h):
        raise ValueError("K-f32 plans were built for other bands or another H")
    if not plans:
        return out
    lib = _build.load("core_f32")
    cell = CELLS[bands[0].dtype]
    w_max = max(w for *_, w in stair)
    xct = payload_parts(xc[:w_max], bands[0].dtype, -(-h // BN) * BN,
                        -(-w_max // 4) * 4)
    with torch.cuda.device(out.device):
        for plan in plans:
            err = lib.core_f32_tc_scatter_add(
                ctypes.addressof(plan.maps), ctypes.addressof(plan.info),
                len(plan.group), cell, xct.data_ptr(), xct.shape[0],
                xct.shape[2], xct.shape[1], plan.tiles.data_ptr(),
                plan.n_tiles, core_nodes.data_ptr(), out.data_ptr(), h,
                _build.stream_of(out))
            _build.check(err, "core_f32_tc_scatter_add")
            if cell == CELLS[torch.float32]:
                launches += 1
            else:
                limb_launches += 1
    return out
