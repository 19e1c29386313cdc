"""The card's published peaks, by name, and its name and power limit.

NVIDIA's data sheets, dense rates: HBM bytes/s, bf16 tensor FLOP/s, f32
non-tensor FLOP/s and int8 tensor OP/s of the Hopper parts, at their full
power limit. ``chip_smoke.py`` computes its bounds from them and
``bench_cuda.py`` its ``vs_baseline``; a card outside the table raises.
"""

from __future__ import annotations

import subprocess

# checked in order: "H100" last, so the NVL and PCIe parts match first
PEAKS = {
    "H200": (4.8e12, 989e12, 67e12, 1979e12),
    "H100 NVL": (3.9e12, 835e12, 60e12, 1671e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
    "H100": (3.35e12, 989e12, 67e12, 1979e12),  # SXM
}


def peaks(name: str):
    """``(hbm, bf16, f32, int8)`` per second of the card named ``name``
    (``torch.cuda.get_device_name``)."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no peak table for card {name!r}")


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def core_bound(shapes, h, peaks_, cell_bytes: float = 1.0):
    """Least time of one K-core launch over bands ``(r, w)`` at width
    ``h``: the larger of its bytes over HBM (every band at ``cell_bytes``
    a cell — 1 for int8, 0.5 for packed int4, 2 for bf16 —,
    ``xc[:max w]``, the row ids, and the output rows read and written,
    each once) and its operations over the bf16 rate. The bands share the launch, so one
    band's bytes overlap another's products. Returns (ms, "bytes" |
    "operations")."""
    hbm, bf16, _f32, _int8 = peaks_
    rows = sum(r for r, _w in shapes)
    nbytes = (sum(r * w for r, w in shapes) * cell_bytes
              + max(w for _r, w in shapes) * h * 2 + rows * 4
              + 2 * rows * h * 4)
    t_bytes = nbytes / hbm * 1e3
    t_ops = sum(2 * r * w * h for r, w in shapes) / bf16 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def int_bound(shapes, h, limbs, peaks_, cell_bytes: float = 1.0):
    """Least time of one K-int launch over bands ``(r, w)`` at width ``h``
    and ``limbs``: the larger of its bytes over HBM (every band at
    ``cell_bytes`` a cell, the limb payload ``limbs · h · max w``, the row
    ids, and the output rows read and written, each once) and its int8
    tensor operations (``limbs · 2 · r · w · h``) over the card's int8
    rate. Returns (ms, "bytes" | "operations")."""
    hbm, _bf16, _f32, int8 = peaks_
    rows = sum(r for r, _w in shapes)
    w_max = max(w for _r, w in shapes)
    nbytes = (sum(r * w for r, w in shapes) * cell_bytes
              + limbs * h * w_max + rows * 4 + 2 * rows * h * 4)
    t_bytes = nbytes / hbm * 1e3
    t_ops = limbs * sum(2 * r * w * h for r, w in shapes) / int8 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tail_bound(nnz, unique_cols, unique_rows, h, peaks_, itemsize=4):
    """Least time of one grouped K-tail call over ``nnz`` real entries:
    the larger of its bytes over HBM (each entry's index and value, each
    needed x row at ``itemsize`` bytes an element, each touched f32
    output row read and written, once) and its multiply-adds over the
    f32 rate. Returns (ms, "bytes" | "operations")."""
    hbm, _bf16, f32, _int8 = peaks_
    nbytes = nnz * 8 + unique_cols * h * itemsize + 2 * unique_rows * h * 4
    t_bytes, t_ops = nbytes / hbm * 1e3, 2 * nnz * h / f32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def f32_bound(shapes, h, peaks_, cell_bytes: float = 4.0,
              x_itemsize: float = 4.0):
    """Least time of one K-f32 launch over bands ``(r, w)`` at width ``h``:
    the larger of its bytes over HBM (every band at ``cell_bytes`` a cell
    — 4 for f32, 2 for bf16 —, ``xc[:max w]`` at ``x_itemsize`` bytes an
    element, the row ids, and the output rows read and written, each
    once) and its operations (``2 · r · w · h``) over the card's f32 rate
    outside the tensor cores (the kernel runs no TF32). Returns (ms,
    "bytes" | "operations")."""
    hbm, _bf16, f32, _int8 = peaks_
    rows = sum(r for r, _w in shapes)
    nbytes = (sum(r * w for r, w in shapes) * cell_bytes
              + max(w for _r, w in shapes) * h * x_itemsize + rows * 4
              + 2 * rows * h * 4)
    t_bytes = nbytes / hbm * 1e3
    t_ops = sum(2 * r * w * h for r, w in shapes) / f32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
