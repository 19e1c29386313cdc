"""The BCSR middle tier's host build: dense (Tr × 128) tiles in
degree-rank space, the port of ``pygim_tpu/core/bcsr.py``.

Between the hub-core and the ELL tail, the rank-permuted adjacency still
holds locally dense tiles. A dense ``(Tr, 128)`` tile times a contiguous
``(128, H)`` panel of rank-permuted x replaces one gather a row of x
with one panel read for 128 rows, and runs on the tensor cores
(``ops/bcsr.py``, K-bcsr).

Tiles are chosen by marginal cost: a tile of ``c`` edges moves
``Tr·128·itemsize`` (tile) + ``128·H·4`` (panel) + ``Tr·H·4`` (partial)
bytes, and pays where that is below ``c × edge_cost_bytes`` (the
bandwidth-equivalent of one gather of the tail). Qualifying tiles go in
densest first until the byte budget is spent. Two layouts:

* row-major (:func:`build_bcsr_tiles`): row blocks holding many tiles
  are split into virtual blocks of exactly ``S`` tiles;
* panel-major (:func:`build_bcsr_panels`): tiles grouped by column
  block, ``T`` a virtual panel, so one panel read serves all of them
  (a lower per-tile bar, :func:`panel_tile_cutoffs`).

Every table is the reference's, byte for byte: cells are summed in
float64, cast to float32 and then, for bf16 tiles, rounded to nearest
even as ``ml_dtypes`` does (``core/banded.py:f32_to_bf16_bits``; the
port does not import ``ml_dtypes``), and stored as their uint16 bits
(the reference's stored form). Cell sums of float32 tiles stay float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pygim_tpu_torch.core.banded import f32_to_bf16_bits
from pygim_tpu_torch.core.graph import INDEX_DTYPE

TILE_COLS = 128  # a panel's rows: the gather granularity

# bandwidth-equivalent cost of one gather of the tail, the reference's
# constant (~8 ns an edge at ~800 GB/s)
EDGE_COST_BYTES = 6400


@dataclasses.dataclass(frozen=True)
class BcsrTiles:
    """Row-major tables.

    ``tiles``        (n_vblocks, S, Tr, TILE_COLS): bf16 bits (uint16)
                     or float32 (``dtype``), padding 0.
    ``panel_idx``    (n_vblocks, S) int32: panel of each tile.
    ``vblock_to_rb`` (n_vblocks,) int32: compact row block of each
                     virtual block, non-decreasing.
    ``panel_nodes``  (n_panels · TILE_COLS,) int32: original node ids of
                     each panel's rows (clamped at the last rank; their
                     cells are 0).
    ``row_nodes``    (n_rb · Tr,) int32: original node ids receiving each
                     partial row (clamped likewise).
    ``n_edges``      edges the tier captured.
    """

    tiles: np.ndarray
    panel_idx: np.ndarray
    vblock_to_rb: np.ndarray
    panel_nodes: np.ndarray
    row_nodes: np.ndarray
    tile_rows: int
    tiles_per_vblock: int
    n_edges: int
    dtype: str = "bfloat16"


def min_edges_per_tile(
    tile_rows: int, hidden: int, itemsize: int = 2,
    edge_cost_bytes: int = EDGE_COST_BYTES,
) -> int:
    """The smallest edge count at which a tile beats the per-edge
    gathers (row-major layout)."""
    tile_bytes = (
        tile_rows * TILE_COLS * itemsize        # tile read
        + TILE_COLS * hidden * 4                # panel read
        + tile_rows * hidden * 4                # partial write
    )
    return max(2, -(-tile_bytes // edge_cost_bytes))


def _choose_tiles_per_vblock(tiles_per_rb: np.ndarray) -> int:
    """The tiles a virtual block S (or a virtual panel T) that pad the
    fewest slots."""
    best_s, best_cost = 1, float("inf")
    for s in (1, 2, 4, 8, 16, 32):
        cost = int((-(-tiles_per_rb // s)).sum()) * s
        if cost < best_cost:
            best_s, best_cost = s, cost
    return best_s


def _fill_tiles(e_flat, vals, n_cells: int, dtype: str) -> np.ndarray:
    """The flat tile store: each cell the float64 sum of its edges' values
    cast to float32, then bf16 bits (round to nearest even) or kept."""
    uflat, uinv = np.unique(e_flat, return_inverse=True)
    sums = np.bincount(
        uinv, weights=vals.astype(np.float64), minlength=uflat.shape[0],
    ).astype(np.float32)
    if dtype == "bfloat16":
        tiles = np.zeros(n_cells, dtype=np.uint16)
        tiles[uflat] = f32_to_bf16_bits(sums)
    else:
        tiles = np.zeros(n_cells, dtype=np.float32)
        tiles[uflat] = sums
    return tiles


def build_bcsr_tiles(
    rr: np.ndarray,
    cc: np.ndarray,
    vals: np.ndarray,
    order: np.ndarray,
    *,
    n: int,
    tile_rows: int,
    budget_bytes: int,
    hidden: int,
    dtype: str = "bfloat16",
    min_edges: int = 0,
    col_order: "np.ndarray | None" = None,
    n_cols: "int | None" = None,
) -> "tuple[BcsrTiles | None, np.ndarray]":
    """Select and fill row-major tiles from edges in RANK coordinates
    (``rr`` / ``cc``: the ranks of each edge's row and column; ``order``:
    rank → original node). Returns ``(tiles, in_tile)``; ``tiles`` is
    None where no tile qualifies. ``col_order`` / ``n_cols``: a separate
    rank space of the columns (the mesh layouts'); default the rows'."""
    if col_order is None:
        col_order = order
    if n_cols is None:
        n_cols = n
    itemsize = 2 if dtype == "bfloat16" else 4
    if budget_bytes <= 0 or rr.size == 0:
        return None, np.zeros(rr.shape[0], dtype=bool)
    tr, tc = tile_rows, TILE_COLS
    if min_edges <= 0:
        min_edges = min_edges_per_tile(tr, hidden, itemsize)

    ncb = -(-n_cols // tc)
    tid = (rr.astype(np.int64) // tr) * ncb + cc.astype(np.int64) // tc
    utid, inv, counts = np.unique(tid, return_inverse=True, return_counts=True)

    max_tiles = max(0, budget_bytes // (tr * tc * itemsize))
    qual = np.flatnonzero(counts >= min_edges)
    if qual.size == 0 or max_tiles == 0:
        return None, np.zeros(rr.shape[0], dtype=bool)
    if qual.size > max_tiles:  # densest first under the budget
        qual = qual[np.argsort(-counts[qual], kind="stable")[:max_tiles]]
    sel_mask = np.zeros(utid.shape[0], dtype=bool)
    sel_mask[qual] = True
    in_tile = sel_mask[inv]

    # the selected tiles by row block, in (rb, cb) order
    sel_tids = np.sort(utid[qual])
    rb_all = sel_tids // ncb
    cb_all = sel_tids % ncb
    urb, tiles_per_rb = np.unique(rb_all, return_counts=True)
    s = _choose_tiles_per_vblock(tiles_per_rb)
    vb_per_rb = -(-tiles_per_rb // s)
    n_vb = int(vb_per_rb.sum())
    vb_offset = np.zeros(urb.shape[0] + 1, dtype=np.int64)
    np.cumsum(vb_per_rb, out=vb_offset[1:])
    rb_of_tile = np.searchsorted(urb, rb_all)
    j_in_rb = np.arange(sel_tids.shape[0]) - np.repeat(
        np.concatenate(([0], np.cumsum(tiles_per_rb)[:-1])), tiles_per_rb)
    tile_vb = vb_offset[rb_of_tile] + j_in_rb // s
    tile_slot = j_in_rb % s

    ucb = np.unique(cb_all)
    panel_of_tile = np.searchsorted(ucb, cb_all)
    panel_ranks = (ucb[:, None] * tc
                   + np.arange(tc, dtype=np.int64)[None, :]).reshape(-1)
    panel_nodes = col_order[np.minimum(panel_ranks, n_cols - 1)].astype(
        INDEX_DTYPE)
    row_ranks = (urb[:, None] * tr
                 + np.arange(tr, dtype=np.int64)[None, :]).reshape(-1)
    row_nodes = order[np.minimum(row_ranks, n - 1)].astype(INDEX_DTYPE)

    # fill (duplicate edges summed)
    e_pos = np.searchsorted(sel_tids, tid[in_tile])
    e_flat = (
        (tile_vb[e_pos] * s + tile_slot[e_pos]) * (tr * tc)
        + (rr[in_tile].astype(np.int64) % tr) * tc
        + cc[in_tile].astype(np.int64) % tc
    )
    tiles = _fill_tiles(e_flat, vals[in_tile], n_vb * s * tr * tc,
                        dtype).reshape(n_vb, s, tr, tc)
    panel_idx = np.zeros((n_vb, s), dtype=INDEX_DTYPE)
    panel_idx[tile_vb, tile_slot] = panel_of_tile
    vblock_to_rb = np.repeat(np.arange(urb.shape[0], dtype=INDEX_DTYPE),
                             vb_per_rb)
    return (
        BcsrTiles(tiles=tiles, panel_idx=panel_idx,
                  vblock_to_rb=vblock_to_rb, panel_nodes=panel_nodes,
                  row_nodes=row_nodes, tile_rows=tr, tiles_per_vblock=s,
                  n_edges=int(in_tile.sum()), dtype=dtype),
        in_tile,
    )


def tail_tile_order(
    rows: np.ndarray,
    cols: np.ndarray,
    order: np.ndarray,
    rank: np.ndarray,
    k: int,
    n: int,
    method: str,
) -> "tuple[np.ndarray, np.ndarray]":
    """Re-rank the band outside the core by the tail's own structure.

    ``rows`` / ``cols``: the tail edges in ORIGINAL node ids. Returns
    ``(t_order, t_rank)``, copies of ``(order, rank)`` with ranks ``k..``
    permuted by reverse Cuthill-McKee (``"rcm"``, SciPy's, on the same
    ``csr_matrix`` of int8 ones as the reference's) or label propagation
    (``"lp"``, ``core/cluster.py:locality_order``) of the subgraph whose
    both ends lie in the tail."""
    import scipy.sparse as sp

    tail_nodes = np.sort(order[k:])
    pos = np.full(n, -1, dtype=np.int64)
    pos[tail_nodes] = np.arange(n - k)
    mm = (pos[rows] >= 0) & (pos[cols] >= 0)
    if method == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        sub = sp.csr_matrix(
            (np.ones(int(mm.sum()), np.int8),
             (pos[rows[mm]], pos[cols[mm]])),
            shape=(n - k, n - k),
        )
        perm = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=False))
    else:
        from pygim_tpu_torch.core.cluster import locality_order
        from pygim_tpu_torch.core.graph import CooGraph

        perm = locality_order(
            CooGraph(rows=pos[rows[mm]].astype(np.int32),
                     cols=pos[cols[mm]].astype(np.int32),
                     vals=np.ones(int(mm.sum()), np.float32),
                     nrows=n - k, ncols=n - k),
            "lp",
        )
    t_order = np.concatenate([order[:k], tail_nodes[perm]]).astype(
        order.dtype)
    t_rank = np.empty(n, dtype=rank.dtype)
    t_rank[t_order] = np.arange(n, dtype=rank.dtype)
    return t_order, t_rank


def panel_tile_cutoffs(
    tile_rows: int, hidden: int, itemsize: int = 2,
    edge_cost_bytes: int = EDGE_COST_BYTES,
) -> "tuple[int, int]":
    """The panel-major layout's two bars ``(min edges a tile, min edges a
    panel)``: a tile pays its own read and its partial's write and merge
    read; a panel qualifies where its qualified tiles' edges cover one
    ``(128, H)`` panel read."""
    tile_bytes = (
        tile_rows * TILE_COLS * itemsize     # tile read
        + 2 * tile_rows * hidden * 4         # partial write + merge read
    )
    panel_bytes = TILE_COLS * hidden * 4
    return (
        max(2, -(-tile_bytes // edge_cost_bytes)),
        max(2, -(-panel_bytes // edge_cost_bytes)),
    )


@dataclasses.dataclass(frozen=True)
class BcsrPanels:
    """Panel-major tables.

    ``tiles``       (n_vp, T, Tr, TILE_COLS): bf16 bits or float32,
                    padding 0.
    ``panel_idx``   (n_vp,) int32: panel of each virtual panel.
    ``tile_rb``     (n_vp, T) int32: compact row block of each tile slot
                    (padding slots: block 0, zero tiles).
    ``panel_nodes`` (n_panels · TILE_COLS,) original node ids.
    ``row_nodes``   (n_rb · Tr,) original node ids receiving rows.
    """

    tiles: np.ndarray
    panel_idx: np.ndarray
    tile_rb: np.ndarray
    panel_nodes: np.ndarray
    row_nodes: np.ndarray
    tile_rows: int
    tiles_per_vp: int
    n_rb: int
    n_edges: int
    dtype: str = "bfloat16"


def build_bcsr_panels(
    rr: np.ndarray,
    cc: np.ndarray,
    vals: np.ndarray,
    order: np.ndarray,
    *,
    n: int,
    tile_rows: int,
    budget_bytes: int,
    hidden: int,
    dtype: str = "bfloat16",
    min_edges: int = 0,
) -> "tuple[BcsrPanels | None, np.ndarray]":
    """Panel-major selection and fill (rank coordinates, as
    :func:`build_bcsr_tiles`): tiles pass the per-tile bar, then column
    blocks pass where their qualified tiles cover the panel read; the
    densest panels (edges a tile) go in first under the budget."""
    itemsize = 2 if dtype == "bfloat16" else 4
    if budget_bytes <= 0 or rr.size == 0:
        return None, np.zeros(rr.shape[0], dtype=bool)
    tr, tc = tile_rows, TILE_COLS
    t_min, p_min = panel_tile_cutoffs(tr, hidden, itemsize)
    if min_edges > 0:
        t_min = min_edges

    ncb = -(-n // tc)
    tid = (rr.astype(np.int64) // tr) * ncb + cc.astype(np.int64) // tc
    utid, inv, counts = np.unique(tid, return_inverse=True, return_counts=True)
    qual_t = counts >= t_min
    if not qual_t.any():
        return None, np.zeros(rr.shape[0], dtype=bool)

    cb_of_utid = (utid % ncb).astype(np.int64)
    panel_edges = np.bincount(cb_of_utid[qual_t], weights=counts[qual_t],
                              minlength=ncb)
    sel = qual_t & (panel_edges >= p_min)[cb_of_utid]
    if not sel.any():
        return None, np.zeros(rr.shape[0], dtype=bool)

    sel_idx = np.flatnonzero(sel)
    tiles_per_panel = np.bincount(cb_of_utid[sel_idx], minlength=ncb)
    max_tiles = max(0, budget_bytes // (tr * tc * itemsize))
    if sel_idx.size > max_tiles:
        density = np.zeros(ncb)
        np.divide(panel_edges, tiles_per_panel, out=density,
                  where=tiles_per_panel > 0)
        keep_p = np.zeros(ncb, dtype=bool)
        acc = 0
        for p in np.argsort(-density, kind="stable"):
            tpp = int(tiles_per_panel[p])
            if tpp == 0 or acc + tpp > max_tiles:
                continue
            keep_p[p] = True
            acc += tpp
        sel = sel & keep_p[cb_of_utid]
        sel_idx = np.flatnonzero(sel)
        if sel_idx.size == 0:
            return None, np.zeros(rr.shape[0], dtype=bool)
    in_tile = sel[inv]

    # the selected tiles by panel (cb-major)
    sel_tids = utid[sel_idx]
    sel_tids = sel_tids[np.argsort(sel_tids % ncb, kind="stable")]
    cb_all = sel_tids % ncb
    rb_all = sel_tids // ncb
    ucb, tiles_per_cb = np.unique(cb_all, return_counts=True)
    t_fixed = _choose_tiles_per_vblock(tiles_per_cb)
    vp_per_cb = -(-tiles_per_cb // t_fixed)
    n_vp = int(vp_per_cb.sum())
    vp_off = np.zeros(ucb.shape[0] + 1, dtype=np.int64)
    np.cumsum(vp_per_cb, out=vp_off[1:])
    cb_pos = np.searchsorted(ucb, cb_all)
    j_in_cb = np.arange(sel_tids.shape[0]) - np.repeat(
        np.concatenate(([0], np.cumsum(tiles_per_cb)[:-1])), tiles_per_cb)
    tile_vp = vp_off[cb_pos] + j_in_cb // t_fixed
    tile_slot = j_in_cb % t_fixed

    urb = np.unique(rb_all)
    rb_compact = np.searchsorted(urb, rb_all)
    panel_ranks = (ucb[:, None] * tc
                   + np.arange(tc, dtype=np.int64)[None, :]).reshape(-1)
    panel_nodes = order[np.minimum(panel_ranks, n - 1)].astype(INDEX_DTYPE)
    row_ranks = (urb[:, None] * tr
                 + np.arange(tr, dtype=np.int64)[None, :]).reshape(-1)
    row_nodes = order[np.minimum(row_ranks, n - 1)].astype(INDEX_DTYPE)

    # fill (duplicates summed); each edge's tile found through the
    # tid-sorted view of the cb-sorted list
    srt = np.argsort(sel_tids, kind="stable")
    e_pos = srt[np.searchsorted(sel_tids[srt], tid[in_tile])]
    e_flat = (
        (tile_vp[e_pos] * t_fixed + tile_slot[e_pos]) * (tr * tc)
        + (rr[in_tile].astype(np.int64) % tr) * tc
        + cc[in_tile].astype(np.int64) % tc
    )
    tiles = _fill_tiles(e_flat, vals[in_tile], n_vp * t_fixed * tr * tc,
                        dtype).reshape(n_vp, t_fixed, tr, tc)
    panel_idx = np.zeros(n_vp, dtype=INDEX_DTYPE)
    panel_idx[tile_vp] = np.searchsorted(ucb, cb_all)
    tile_rb = np.zeros((n_vp, t_fixed), dtype=INDEX_DTYPE)
    tile_rb[tile_vp, tile_slot] = rb_compact
    return (
        BcsrPanels(tiles=tiles, panel_idx=panel_idx, tile_rb=tile_rb,
                   panel_nodes=panel_nodes, row_nodes=row_nodes,
                   tile_rows=tr, tiles_per_vp=t_fixed, n_rb=int(urb.shape[0]),
                   n_edges=int(in_tile.sum()), dtype=dtype),
        in_tile,
    )
