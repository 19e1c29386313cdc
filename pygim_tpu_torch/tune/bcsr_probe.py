"""Sampled structure probe pricing the hybrid backend's BCSR middle tier:
the port of ``pygim_tpu/tune/bcsr_probe.py`` (host NumPy, the same
results key for key). The tuner that reads it is a later slice.

The BCSR tier's value depends on how many tail edges land in dense
(Tr, 128) tiles — a function of the graph's block structure AND the tile
ordering (rank / rcm / lp), which only materializes during prepare. The
reference tuner never faced this (its cost was structure-free nnz
balancing, utils/autotuner.py:309-343); here the probe estimates tile
capture WITHOUT running prepare:

* tail edges are stride-sampled down to a bounded budget;
* for ``order='rank'`` the memoized degree rank gives tile coordinates
  directly; for ``'rcm'``/``'lp'`` the ordering is computed on the
  SAMPLED tail subgraph (community/bandwidth structure survives uniform
  edge sampling while average degree stays well above 1), mirroring the
  prepare-time reorder (ops/spmm.py bcsr_order handling);
* per-tile sampled counts are scaled by the stride, thresholded at the
  marginal-analysis cutoff (core/bcsr.py:min_edges_per_tile), and taken
  densest-first under the byte budget — the same selection rule the
  builder applies.

Near-threshold tiles are noisy under sampling (binomial thinning), but
they contribute little capture; the dense tiles that decide whether the
tier pays are detected reliably. Estimates are conservative for lp/rcm:
prepare orders the FULL tail, which can only improve locality vs the
sampled ordering.
"""

from __future__ import annotations

import numpy as np

from pygim_tpu_torch.core.bcsr import (
    TILE_COLS,
    _choose_tiles_per_vblock,
    min_edges_per_tile,
)
from pygim_tpu_torch.core.graph import CooGraph, CsrGraph

# probe size bounds: enough edges that the sampled threshold stays ≥ ~2
# on production graphs, small enough that the probe costs seconds
_SAMPLE_TARGET = 4_000_000
_SAMPLE_MAX = 16_000_000


def probe_tile_counts(
    csr: CsrGraph,
    rank: np.ndarray,
    rows_of: np.ndarray,
    k: int,
    tile_rows: int,
    order: str,
) -> dict:
    """Per-tile occupancy statistics of the tail (non-core) band under a
    tile ordering, from a stride-sampled edge subset.

    Returns ``{"tids", "counts", "stride", "tail_edges"}`` — ``counts``
    are SAMPLED occupancies (multiply by ``stride`` to estimate true
    counts). Memoize per (k, tile_rows, order): budget and cutoff
    selection on top of these is cheap (:func:`select_tiles`).
    """
    n = csr.nrows
    tail = (rank[rows_of] >= k) | (rank[csr.colind] >= k)
    t_idx = np.flatnonzero(tail)
    tail_edges = int(t_idx.size)
    if tail_edges == 0:
        return {
            "tids": np.empty(0, np.int64),
            "counts": np.empty(0, np.int64),
            "stride": 1,
            "tail_edges": 0,
        }
    stride = max(1, -(-tail_edges // _SAMPLE_TARGET))
    if tail_edges // stride > _SAMPLE_MAX:
        stride = -(-tail_edges // _SAMPLE_MAX)
    s_idx = t_idx[::stride]
    rr0 = rows_of[s_idx].astype(np.int64)
    cc0 = csr.colind[s_idx].astype(np.int64)

    if order in ("rcm", "lp") and k < n:
        # sampled analog of the prepare-time tail reorder
        # (ops/spmm.py: bcsr_order in ("rcm","lp")): tail nodes get
        # ranks k.., permuted by the structure of the SAMPLED tail
        # subgraph; core nodes keep their degree ranks (<k)
        t_rank = _sampled_tail_order(csr, rank, k, rr0, cc0, order)
        rr, cc = t_rank[rr0], t_rank[cc0]
    else:
        rr, cc = rank[rr0], rank[cc0]

    ncb = -(-n // TILE_COLS)
    tid = (rr // tile_rows) * ncb + cc // TILE_COLS
    tids, counts = np.unique(tid, return_counts=True)
    return {
        "tids": tids,
        "counts": counts.astype(np.int64),
        "stride": stride,
        "tail_edges": tail_edges,
    }


def _sampled_tail_order(
    csr: CsrGraph,
    rank: np.ndarray,
    k: int,
    rr0: np.ndarray,
    cc0: np.ndarray,
    order: str,
) -> np.ndarray:
    """rank-like array (node → tile rank) with tail nodes reordered by
    ``locality_order`` of the sampled both-tail subgraph."""
    from pygim_tpu_torch.core.cluster import locality_order

    n = csr.nrows
    n_tail = n - k
    # position of each tail node in ascending-node order (prepare sorts
    # tail_nodes the same way, ops/spmm.py)
    pos = np.full(n, -1, dtype=np.int64)
    tail_nodes = np.flatnonzero(rank >= k)
    pos[tail_nodes] = np.arange(n_tail)
    mm = (pos[rr0] >= 0) & (pos[cc0] >= 0)
    if not mm.any():
        return rank.astype(np.int64)
    sub = CooGraph(
        rows=pos[rr0[mm]].astype(np.int32),
        cols=pos[cc0[mm]].astype(np.int32),
        vals=np.ones(int(mm.sum()), np.float32),
        nrows=n_tail,
        ncols=n_tail,
    )
    perm = locality_order(sub, order)  # tail position → tail position
    t_rank = rank.astype(np.int64).copy()
    inv = np.empty(n_tail, dtype=np.int64)
    inv[perm] = np.arange(n_tail)
    t_rank[tail_nodes] = k + inv[pos[tail_nodes]]
    return t_rank


def select_tiles(
    probe: dict,
    *,
    tile_rows: int,
    budget_bytes: int,
    hidden: int,
    itemsize: int = 2,
    min_edges: int = 0,
) -> dict:
    """Apply the builder's selection rule (cutoff + densest-first budget,
    core/bcsr.py:build_bcsr_tiles) to probed tile counts; returns
    estimated tier statistics for the cost model."""
    stride = probe["stride"]
    counts = probe["counts"]
    empty = {
        "captured_edges": 0, "n_tiles": 0,
        "sel_tids": np.empty(0, np.int64),
        "tail_edges": probe["tail_edges"],
    }
    if counts.size == 0 or budget_bytes <= 0:
        return empty
    if min_edges <= 0:
        min_edges = min_edges_per_tile(tile_rows, hidden, itemsize)
    tile_bytes = tile_rows * TILE_COLS * itemsize
    max_tiles = max(0, budget_bytes // tile_bytes)
    qual = np.flatnonzero(counts * stride >= min_edges)
    if qual.size == 0 or max_tiles == 0:
        return empty
    if qual.size > max_tiles:
        top = np.argsort(-counts[qual], kind="stable")[:max_tiles]
        qual = qual[top]
    sel_tids = probe["tids"][qual]
    captured = int(counts[qual].sum()) * stride
    # a tile cannot hold more edges than cells (duplicates merge)
    captured = min(captured, int(qual.size) * tile_rows * TILE_COLS)
    captured = min(captured, probe["tail_edges"])
    return {
        "captured_edges": captured,
        "n_tiles": int(qual.size),
        "sel_tids": sel_tids,
        "tail_edges": probe["tail_edges"],
    }


def bcsr_statistics(
    csr: CsrGraph,
    rank: np.ndarray,
    rows_of: np.ndarray,
    k: int,
    *,
    tile_rows: int,
    order: str,
    budget_bytes: int,
    hidden: int,
    itemsize: int = 2,
    min_edges: int = 0,
    _memo: dict | None = None,
) -> dict:
    """Estimated BCSR-tier statistics for one candidate: captured edges,
    padded tile slots, virtual/row blocks, panel count. Probe results are
    memoized per (k, tile_rows, order) in ``_memo``; budget/cutoff
    selection is recomputed per candidate."""
    memo = _memo if _memo is not None else {}
    pkey = ("bcsr_probe", k, tile_rows, order)
    probe = memo.get(pkey)
    if probe is None:
        probe = probe_tile_counts(csr, rank, rows_of, k, tile_rows, order)
        memo[pkey] = probe
    sel = select_tiles(
        probe,
        tile_rows=tile_rows,
        budget_bytes=budget_bytes,
        hidden=hidden,
        itemsize=itemsize,
        min_edges=min_edges,
    )
    n_tiles = sel["n_tiles"]
    if n_tiles == 0:
        return {
            "captured_edges": 0, "n_tiles": 0, "slots": 0, "n_vb": 0,
            "n_panels": 0, "n_rb": 0, "tail_edges": sel["tail_edges"],
        }
    ncb = -(-csr.nrows // TILE_COLS)
    sel_tids = np.sort(sel["sel_tids"])
    rb_all = sel_tids // ncb
    cb_all = sel_tids % ncb
    urb, tiles_per_rb = np.unique(rb_all, return_counts=True)
    s = _choose_tiles_per_vblock(tiles_per_rb)
    vb_per_rb = -(-tiles_per_rb // s)
    n_vb = int(vb_per_rb.sum())
    return {
        "captured_edges": sel["captured_edges"],
        "n_tiles": n_tiles,
        "slots": n_vb * s,
        "n_vb": n_vb,
        "n_panels": int(np.unique(cb_all).size),
        "n_rb": int(urb.size),
        "tail_edges": sel["tail_edges"],
    }
