"""The square hub-core, built band by band in its stored dtype.

NumPy counterpart of ``core_tail_mask`` and ``core_build_banded`` in
``pygim_tpu/core/native.py:174-303`` (the reference's native planner):
the same signature and the same ``(core, tail_mask, bad_flat)``, byte for
byte, for the integer cores the port stores (int8 ``(k, k)``, and int4
nibble-packed into uint8 ``(k, k / 2)``).

The (k, k) float32 core is never built: at k = 113,408 (ogbn-products,
int4 at 6 GiB) it would be 51 GB. Instead a reused float32 row band of
about ``band_bytes`` is filled from the rank-space CSR of the core's
edges, one band of rows at a time, with the cell sums taken in float32
in CSR order (the native fill's order, so a float-valued cell rounds the
same way). Each band's cells are then range-checked
(:func:`~pygim_tpu_torch.core.partition.int_demote_slab`) and written
into the core, nibble-packed for int4 (byte j of a row holds cells
(2j, 2j + 1), the low nibble the even column). Only the cells that some
edge touches are checked and written: an untouched cell is 0, which
every check passes and the zeroed core already holds, so the result is
the dense pass's at a cost that follows the edges, not k². Flat cell
indices are int64 (k² exceeds 2^31).
"""

from __future__ import annotations

import numpy as np

from pygim_tpu_torch.core.partition import int_demote_slab

CORE_DTYPES = ("int8", "int4")


def core_tail_mask(rows, cols, rank, k: int) -> np.ndarray:
    """True for the edges outside the core: row or column of rank >= k."""
    return (rank[rows] >= k) | (rank[cols] >= k)


def core_build_banded(rows, cols, vals, rank, k: int, core_dtype: str,
                      band_bytes: int = 512 << 20):
    """The square core of the edges ``(rows, cols, vals)`` (node ids,
    float32 values) over ranks ``[0, k)`` in its stored dtype.

    Returns ``(core, tail_mask, bad_flat)``: ``core`` int8 ``(k, k)`` or
    packed uint8 ``(k, k // 2)``; ``tail_mask`` (nnz,) bool, the edges
    outside the core; ``bad_flat`` the sorted row-major flat indices
    (int64, in the unpacked (k, k)) of the cells that are not an integer
    in the dtype's range — zeroed in the core, their edges for the caller
    to demote to the exact tail."""
    if core_dtype not in CORE_DTYPES:
        raise ValueError(f"core dtype {core_dtype!r} not in {CORE_DTYPES}")
    if core_dtype == "int4" and k % 2:
        raise ValueError("an int4 core pairs columns: k must be even")
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float32)
    rank = np.asarray(rank)
    tail_mask = core_tail_mask(rows, cols, rank, k)
    packed = core_dtype == "int4"
    core = np.zeros((k, k // 2) if packed else (k, k),
                    dtype=np.uint8 if packed else np.int8)
    idx = np.flatnonzero(~tail_mask)
    if idx.size == 0:
        return core, tail_mask, np.empty(0, dtype=np.int64)
    rr = rank[rows[idx]].astype(np.int64)
    order = np.argsort(rr, kind="stable")  # CSR order: input order in a row
    rr = rr[order]
    cc = rank[cols[idx[order]]].astype(np.int64)
    vv = vals[idx[order]]
    del idx, order

    band_rows = max(1, min(k, band_bytes // (4 * k)))
    band = np.zeros(band_rows * k, dtype=np.float32)  # reused, kept zero
    flat_core = core.reshape(-1)
    bad = []
    starts = np.searchsorted(rr, np.arange(0, k + band_rows, band_rows))
    for i, r0 in enumerate(range(0, k, band_rows)):
        e0, e1 = int(starts[i]), int(starts[i + 1])
        if e0 == e1:
            continue
        flat = (rr[e0:e1] - r0) * k + cc[e0:e1]
        np.add.at(band, flat, vv[e0:e1])  # f32 sums, in edge order
        cells = np.unique(flat)
        q, bad_at = int_demote_slab(band[cells][None, :], core_dtype)
        band[cells] = 0.0
        q = q[0].astype(np.int8)
        if bad_at.size:
            bad.append(cells[bad_at] + r0 * k)
        at = cells + r0 * k
        if packed:
            nib = (q.astype(np.uint8) & 0xF) << (4 * (at & 1)).astype(np.uint8)
            np.bitwise_or.at(flat_core, at >> 1, nib)
        else:
            flat_core[at] = q
    bad_flat = np.concatenate(bad) if bad else np.empty(0, dtype=np.int64)
    return core, tail_mask, bad_flat
