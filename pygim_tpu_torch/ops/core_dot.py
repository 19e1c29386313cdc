"""K-core: one staircase band's int8 × bf16 product, scatter-added.

Counterpart of ``pygim_tpu/ops/pallas_core.py`` (``bf16(int8 core) @
bf16(x)`` with f32 accumulation) fused with the scatter of its product
into the output rows (``out.at[core_nodes[lo:hi]].add`` in
``pygim_tpu/ops/spmm.py:_core_scatter``). The CUDA kernel is
``csrc/core_dot.cu``.

``xc`` is ``x[core_nodes]`` already rounded to bf16 (round-to-nearest-
even, as ``xq.astype(bf16)`` in the reference); the gather and the cast
stay outside the kernel, as in JAX. Every int8 × bf16 product is exact
in f32, so the kernel and :func:`core_band_plain` differ only in the
order of the f32 sums.
"""

from __future__ import annotations

import torch

from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (plain int; launches only)
launches = 0


def core_band_plain(band, xc, rows, out):
    """``out[rows] += f32(band) @ f32(xc[:w])`` in plain PyTorch."""
    w = band.shape[1]
    return out.index_add_(0, rows, band.float() @ xc[:w].float())


def _check(band, xc, rows, out) -> None:
    if band.dtype != torch.int8 or band.dim() != 2:
        raise TypeError(f"band must be 2-D int8, got {band.dtype} {tuple(band.shape)}")
    if xc.dtype != torch.bfloat16 or xc.dim() != 2:
        raise TypeError(f"xc must be 2-D bfloat16, got {xc.dtype} {tuple(xc.shape)}")
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise TypeError(f"rows must be 1-D int32, got {rows.dtype} {tuple(rows.shape)}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise TypeError(f"out must be 2-D float32, got {out.dtype} {tuple(out.shape)}")
    r, w = band.shape
    if xc.shape[0] < w or xc.shape[1] != out.shape[1]:
        raise ValueError(
            f"xc {tuple(xc.shape)} must hold ≥ {w} rows of width {out.shape[1]}"
        )
    if rows.shape[0] != r:
        raise ValueError(f"rows has {rows.shape[0]} entries for {r} band rows")
    devs = {t.device for t in (band, xc, rows, out)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    for name, t in (("band", band), ("xc", xc), ("rows", rows), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def core_band_scatter_add(band, xc, rows, out):
    """``out[rows[i]] += Σ_j f32(band[i, j]) · f32(xc[j])`` for one band.

    band int8 (r, w); xc bf16 (≥ w, H); rows int32 (r,), distinct;
    out f32 (N, H), updated in place and returned. CPU tensors take
    :func:`core_band_plain`; CUDA tensors launch the kernel (H a multiple
    of 8) or raise."""
    global launches
    _check(band, xc, rows, out)
    if out.device.type == "cpu":
        return core_band_plain(band, xc, rows, out)
    if out.device.type != "cuda":
        raise ValueError(f"no K-core kernel for device {out.device}")
    r, w = band.shape
    h = out.shape[1]
    if h % 8 or xc.data_ptr() % 16 or out.data_ptr() % 8:
        raise ValueError(
            f"K-core needs H % 8 == 0 and aligned xc/out (H={h})"
        )
    if r == 0 or w == 0 or h == 0:
        return out
    vec_a = int(w % 16 == 0 and band.data_ptr() % 16 == 0)
    lib = _build.load("core_dot")
    with torch.cuda.device(out.device):
        err = lib.core_band_scatter_add(
            band.data_ptr(), xc.data_ptr(), rows.data_ptr(), out.data_ptr(),
            r, w, h, vec_a, _build.stream_of(out),
        )
    _build.check(err, "core_band_scatter_add")
    launches += 1
    return out
