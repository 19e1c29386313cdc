"""K-f32: the hub-core bands' products in f32, scatter-added.

Counterpart of two branches of ``pygim_tpu/ops/spmm.py:_core_matmul``
fused with the scatter of their product (``out.at[core_nodes[lo:hi]].add``
in ``_core_scatter``): the f32 core's product (``:630``, ``dot(core,
f32(x))``; the reference's default hybrid core on a float graph, whose
float64 core is stored as f32 cells too), and a bf16 core's product with
an int16 or int32 payload (``:615-628``, both operands promoted to f32).
The CUDA kernel is ``csrc/core_f32.cu``: a tiled SIMT FFMA product, one
launch over all bands of one SpMM (at most :data:`MAX_BANDS`; more take
one launch per group), walking a tile list built here on the host
(:func:`core_f32_plans`).

A band is f32 or bf16 ``(r, w)``; ``xc`` ``(>= max w, H)`` is f32, bf16,
int8, int16 or int32, converted to f32 as it is loaded (exact for bf16
and for integers up to 2^24). Every product is an f32 FFMA (never TF32),
so the kernel, :func:`core_f32_plain` and the reference differ only in
the order of their f32 sums. The kernel takes any width and any H; its
loads are bounds-checked scalars, so no alignment is asked.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from pygim_tpu_torch.ops import _build
from pygim_tpu_torch.ops.core_dot import band_groups

# kernel launches since the last reset (a plain int; launches only)
launches = 0

CELLS = {torch.float32: 0, torch.bfloat16: 1}
PAYLOADS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.int16: 3, torch.int32: 4}
BM, BN = 128, 128   # output tile of one block: band rows × columns
MAX_BANDS = 16      # bands one launch carries (core_dot.band_groups' groups)


def core_f32_plain(bands, xc, core_nodes, stair, out):
    """``out[core_nodes[lo:hi]] += f32(band) @ f32(xc[:w])`` for every
    band ``(lo, hi, w)`` of ``stair``, in plain PyTorch."""
    for band, (lo, hi, w) in zip(bands, stair):
        out.index_add_(0, core_nodes[lo:hi], band.float() @ xc[:w].float())
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
    addresses and ``(lo, r, w)`` (host), the tile list (on the device) and
    what it was built for (band indices, H)."""

    group: list
    h: int
    ptrs: ctypes.Array
    info: ctypes.Array
    tiles: torch.Tensor

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


def core_f32_plans(bands, stair, h: int) -> list:
    """The plans of one grouped call over these CUDA bands at width
    ``h``, one per launch (``core_dot.band_groups``). A prepared
    operand's bands never move, so its owner builds them once per width
    and passes them to :func:`core_f32_scatter_add`."""
    plans = []
    for group in band_groups(stair, h):
        sub = [stair[b] for b in group]
        tiles = torch.tensor(tile_list(sub, h), dtype=torch.int32)
        plans.append(F32Plan(
            group=group, h=h,
            ptrs=(ctypes.c_void_p * len(group))(
                *[bands[b].data_ptr() for b in group]),
            info=(ctypes.c_int * (3 * len(group)))(
                *[v for lo, hi, w in sub for v in (lo, hi - lo, w)]),
            tiles=tiles.reshape(-1, 3).to(bands[group[0]].device)))
    return plans


def plans_match(plans, bands, stair, h: int) -> bool:
    """Whether ``plans`` were built for these bands at width ``h``."""
    return [(p.group, tuple(p.ptrs), p.h) for p in plans] == [
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
    (counted in :data:`launches`) or raise. ``plans``
    (:func:`core_f32_plans` of these bands at this H) is built here when
    not given."""
    global launches
    _check(bands, xc, core_nodes, stair, out)
    _build.refuse_grad("core_f32_scatter_add", xc, out)
    if out.device.type == "cpu":
        return core_f32_plain(bands, xc, core_nodes, stair, out)
    if out.device.type != "cuda":
        raise ValueError(f"no K-f32 kernel for device {out.device}")
    h = out.shape[1]
    if plans is None:
        plans = core_f32_plans(bands, stair, h)
    elif not plans_match(plans, bands, stair, h):
        raise ValueError("K-f32 plans were built for other bands or another H")
    if not plans:
        return out
    lib = _build.load("core_f32")
    cell = CELLS[bands[0].dtype]
    with torch.cuda.device(out.device):
        for plan in plans:
            err = lib.core_f32_scatter_add(
                ctypes.addressof(plan.ptrs), ctypes.addressof(plan.info),
                len(plan.group), cell, xc.data_ptr(), PAYLOADS[xc.dtype],
                plan.tiles.data_ptr(), plan.n_tiles, core_nodes.data_ptr(),
                out.data_ptr(), h, _build.stream_of(out))
            _build.check(err, "core_f32_scatter_add")
            launches += 1
    return out
