"""K-tail: the ELL gather-weight-reduce of the hybrid SpMM's tail.

Counterpart of ``pygim_tpu/ops/spmm.py:ell_scan_spmm`` /
``_ell_grouped_scan`` (the XLA body the reference runs per table). The
CUDA kernel is ``csrc/ell_tail.cu``.

A table in step layout holds ``cols2d`` / ``vals2d`` of shape
``(n_steps, chunk·D)`` and ``vrow_to_row`` of shape ``(n_steps, chunk)``.
For every virtual row ``v``::

    out[vrow_to_row[v]] += Σ_d vals[v, d] · x[cols[v, d]]

x stays float32; the tail does not round to bf16.
"""

from __future__ import annotations

import torch

from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (plain int; launches only)
launches = 0

MAX_H = 1024  # widest row the kernel keeps in registers


def ell_tail_plain(x, cols2d, vals2d, vrow_to_row, degree: int, out):
    """The same sum in plain PyTorch, one step at a time as the reference
    scans, so the largest temporary is one step's (chunk·D, H) gather."""
    h = x.shape[1]
    chunk = vrow_to_row.shape[1]
    for s in range(cols2d.shape[0]):
        g = x.index_select(0, cols2d[s]) * vals2d[s][:, None]
        out.index_add_(0, vrow_to_row[s], g.view(chunk, degree, h).sum(1))
    return out


def _check(x, cols2d, vals2d, vrow_to_row, degree, out) -> None:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32, got {x.dtype} {tuple(x.shape)}")
    if cols2d.dtype != torch.int32 or cols2d.dim() != 2:
        raise TypeError(f"cols2d must be 2-D int32, got {cols2d.dtype}")
    if vals2d.dtype != torch.float32 or vals2d.shape != cols2d.shape:
        raise TypeError(
            f"vals2d must be float32 of shape {tuple(cols2d.shape)}, got "
            f"{vals2d.dtype} {tuple(vals2d.shape)}"
        )
    if vrow_to_row.dtype != torch.int32 or vrow_to_row.dim() != 2:
        raise TypeError(f"vrow_to_row must be 2-D int32, got {vrow_to_row.dtype}")
    n_steps, cd = cols2d.shape
    if vrow_to_row.shape[0] != n_steps or vrow_to_row.shape[1] * degree != cd:
        raise ValueError(
            f"tables disagree: cols2d {tuple(cols2d.shape)}, vrow_to_row "
            f"{tuple(vrow_to_row.shape)}, degree {degree}"
        )
    if out.dtype != torch.float32 or out.dim() != 2 or out.shape[1] != x.shape[1]:
        raise TypeError(
            f"out must be float32 (N, {x.shape[1]}), got {out.dtype} "
            f"{tuple(out.shape)}"
        )
    devs = {t.device for t in (x, cols2d, vals2d, vrow_to_row, out)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    for name, t in (("x", x), ("cols2d", cols2d), ("vals2d", vals2d),
                    ("vrow_to_row", vrow_to_row), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ell_tail_add(x, cols2d, vals2d, vrow_to_row, degree: int, out):
    """Add one ELL table's product into ``out`` (in place; returned).
    ``vrow_to_row`` must be non-decreasing, as prepare builds it: the
    kernel adds a row that it sees whole without atomics. CPU tensors
    take :func:`ell_tail_plain`; CUDA tensors launch the kernel (H a
    multiple of 4, at most :data:`MAX_H`) or raise."""
    global launches
    _check(x, cols2d, vals2d, vrow_to_row, degree, out)
    if out.device.type == "cpu":
        return ell_tail_plain(x, cols2d, vals2d, vrow_to_row, degree, out)
    if out.device.type != "cuda":
        raise ValueError(f"no K-tail kernel for device {out.device}")
    h = x.shape[1]
    if h % 4 or h > MAX_H or x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(
            f"K-tail needs H % 4 == 0, H <= {MAX_H} and 16-byte aligned "
            f"x and out (H={h})"
        )
    n_vrows = vrow_to_row.numel()
    if n_vrows == 0 or h == 0 or x.shape[0] == 0:
        return out
    lib = _build.load("ell_tail")
    with torch.cuda.device(out.device):
        err = lib.ell_tail_add(
            x.data_ptr(), cols2d.data_ptr(), vals2d.data_ptr(),
            vrow_to_row.data_ptr(), out.data_ptr(), n_vrows, int(degree), h,
            _build.stream_of(out),
        )
    _build.check(err, "ell_tail_add")
    launches += 1
    return out
