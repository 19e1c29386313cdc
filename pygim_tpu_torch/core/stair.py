"""Staircase (variable-width banded) hub-core planning.

Counterpart of ``pygim_tpu/core/stair.py``. In degree-rank space the
dense core is not a square but ≤ ``max_bands`` row bands
``(row_lo, row_hi, width)`` of tapering width: the superlevel set of the
rank×rank cell density under a cell budget, found by a Lagrangian
threshold on a geometric histogram, merged to the band budget and
snapped to row / column multiples. Each band is one dense product
against the rank-gathered activations ``x[order[:width]]``.
"""

from __future__ import annotations

import numpy as np


def _geom_edges(n: int, count: int, start: int = 64) -> np.ndarray:
    return np.unique(
        np.concatenate(
            [[0], np.geomspace(start, n, count).astype(np.int64), [n]]
        )
    )


def stair_grid(
    rank_r: np.ndarray, rank_c: np.ndarray, n: int, grid: int = 192
) -> tuple:
    """The geometric rank×rank edge histogram — the O(nnz) part of
    staircase planning."""
    redges = _geom_edges(n, grid)
    cedges = _geom_edges(n, grid)
    ri = np.searchsorted(redges, rank_r, side="right") - 1
    ci = np.searchsorted(cedges, rank_c, side="right") - 1
    nb_r, nb_c = len(redges) - 1, len(cedges) - 1
    g = np.zeros((nb_r, nb_c), dtype=np.int64)
    np.add.at(g, (ri, ci), 1)
    return redges, cedges, g


def plan_staircase(
    rank_r: np.ndarray,
    rank_c: np.ndarray,
    n: int,
    budget_cells: int,
    *,
    max_bands: int = 8,
    row_quant: int = 8,
    col_quant: int = 256,
    grid: int = 192,
    _grid_data=None,
) -> "list[tuple[int, int, int]]":
    """Choose ≤ ``max_bands`` row bands ``(row_lo, row_hi, width)`` in
    rank space, total cells ≤ ``budget_cells``, approximately maximizing
    captured edges. An edge is captured iff its row rank falls in a band
    and its col rank < that band's width. Bands tile ``[0, row_hi_last)``
    contiguously. Returns [] when no band is worth keeping.
    ``_grid_data``: a precomputed :func:`stair_grid` result (the tuner
    plans many budgets on one histogram)."""
    if budget_cells <= 0 or len(rank_r) == 0:
        return []
    redges, cedges, g = (_grid_data if _grid_data is not None
                         else stair_grid(rank_r, rank_c, n, grid))
    nb_r = len(redges) - 1
    cum = np.cumsum(g, axis=1)  # cum[i, j]: edges with col < cedges[j+1]
    rows_per = np.diff(redges).astype(np.int64)
    col_hi = cedges[1:].astype(np.int64)

    def widths_for(lam: float) -> np.ndarray:
        # per fine band: width maximizing captured − λ·cells (width 0 ok)
        score = cum - lam * rows_per[:, None] * col_hi[None, :]
        best = np.argmax(score, axis=1)
        w = col_hi[best]
        w[score[np.arange(nb_r), best] <= 0] = 0
        return w

    def cells_of(w: np.ndarray) -> int:
        return int((rows_per * w).sum())

    lo, hi = 0.0, 1.0
    while cells_of(widths_for(hi)) > budget_cells:
        hi *= 4
        if hi > 1e9:
            return []
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if cells_of(widths_for(mid)) > budget_cells:
            lo = mid
        else:
            hi = mid
    w = widths_for(hi)

    # merge contiguous fine bands into ≤ max_bands groups, cutting at the
    # largest relative width drops (each group takes its max width)
    nz = np.flatnonzero(w > 0)
    if len(nz) == 0:
        return []
    last = int(nz.max()) + 1
    w = w[:last].copy()
    w[w == 0] = col_quant  # interior zero-width bands: keep tiling cheap
    if last > max_bands:
        lw = np.log2(np.maximum(w, 1).astype(np.float64))
        drops = np.abs(np.diff(lw))
        cuts = np.sort(np.argsort(-drops)[: max_bands - 1] + 1)
    else:
        cuts = np.arange(1, last)
    bounds = np.concatenate([[0], cuts, [last]])
    bands = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        bands.append([int(redges[a]), int(redges[b]), int(w[a:b].max())])

    # snap rows to row_quant and widths to col_quant (both capped at n),
    # then trim widths until the snap overshoot fits the budget
    for band in bands:
        band[1] = min(n, -(-band[1] // row_quant) * row_quant)
        band[2] = min(n, -(-band[2] // col_quant) * col_quant)
    for i in range(1, len(bands)):
        bands[i][0] = bands[i - 1][1]
    bands = [b for b in bands if b[1] > b[0] and b[2] > 0]

    def total_cells(bs):
        return sum((b[1] - b[0]) * b[2] for b in bs)

    while total_cells(bands) > budget_cells and bands:
        j = int(np.argmax([(b[1] - b[0]) * b[2] for b in bands]))
        bands[j][2] = (bands[j][2] - 1) // col_quant * col_quant
        if bands[j][2] <= 0:
            # bands stay contiguous from rank 0: a popped middle band's
            # rows go to the band below; a popped last band's rows
            # return to the tail
            if j + 1 < len(bands):
                bands[j + 1][0] = bands[j][0]
            bands.pop(j)
    return [tuple(b) for b in bands]


def staircase_coverage(
    bands, rank_r: np.ndarray, rank_c: np.ndarray
) -> int:
    """Edges captured by ``bands`` (exact count on the edge list of rank
    pairs ``(rank_r, rank_c)``): an edge is captured where the band that
    holds its row has its column below the band's width."""
    if not bands:
        return 0
    los = np.array([b[0] for b in bands], dtype=np.int64)
    his = np.array([b[1] for b in bands], dtype=np.int64)
    ws = np.array([b[2] for b in bands], dtype=np.int64)
    # the bands tile the rows from 0: each edge's band by its row
    idx = np.searchsorted(his, rank_r, side="right")
    ok = idx < len(bands)
    idx = np.minimum(idx, len(bands) - 1)
    return int((ok & (rank_r >= los[idx]) & (rank_c < ws[idx])).sum())
