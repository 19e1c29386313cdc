"""Graph transforms in NumPy: degrees, self-loops, symmetrization and the
GCN and mean normalizations, the twin of ``pygim_tpu/core/transforms.py``.

The models aggregate with the matrix as given; these host transforms
are the preprocessing a caller applies first (PyG's ``gcn_norm``
pipeline), so the package needs no other library for it.
"""

from __future__ import annotations

import numpy as np

from pygim_tpu_torch.core.graph import CooGraph


def degrees(coo: CooGraph, axis: str = "row") -> np.ndarray:
    """Entries per row (``axis="row"``) or per column, int64."""
    idx = coo.rows if axis == "row" else coo.cols
    n = coo.nrows if axis == "row" else coo.ncols
    return np.bincount(idx, weights=None, minlength=n).astype(np.int64)


def add_self_loops(coo: CooGraph, fill_value: float = 1.0) -> CooGraph:
    """A loop of ``fill_value`` on every node that has none, appended
    after the existing entries."""
    if coo.nrows != coo.ncols:
        raise ValueError("self-loops require a square adjacency")
    n = coo.nrows
    has_loop = np.zeros(n, dtype=bool)
    loop_mask = coo.rows == coo.cols
    has_loop[coo.rows[loop_mask]] = True
    missing = np.flatnonzero(~has_loop).astype(coo.rows.dtype)
    rows = np.concatenate([coo.rows, missing])
    cols = np.concatenate([coo.cols, missing])
    vals = np.concatenate(
        [coo.vals, np.full(missing.shape[0], fill_value, dtype=coo.vals.dtype)]
    )
    return CooGraph(rows=rows, cols=cols, vals=vals, nrows=n, ncols=n)


def to_undirected(coo: CooGraph) -> CooGraph:
    """Symmetrize: A ∪ Aᵀ with duplicate (r, c) values summed, in (row,
    col) order."""
    if coo.nrows != coo.ncols:
        raise ValueError("symmetrization requires a square adjacency")
    rows = np.concatenate([coo.rows, coo.cols])
    cols = np.concatenate([coo.cols, coo.rows])
    vals = np.concatenate([coo.vals, coo.vals])
    key = rows.astype(np.int64) * coo.ncols + cols
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(uniq.shape[0], dtype=np.float64)
    np.add.at(summed, inv, vals.astype(np.float64))
    return CooGraph(
        rows=(uniq // coo.ncols).astype(coo.rows.dtype),
        cols=(uniq % coo.ncols).astype(coo.cols.dtype),
        vals=summed.astype(coo.vals.dtype),
        nrows=coo.nrows, ncols=coo.ncols,
    )


def gcn_norm(
    coo: CooGraph, add_loops: bool = True, eps: float = 0.0
) -> CooGraph:
    """Kipf-Welling normalization, Â = D̃^{-1/2} (A + I) D̃^{-1/2}, with
    the weighted row degrees of A + I; float32 values (float64 stays
    float64)."""
    g = add_self_loops(coo) if add_loops else coo
    deg = np.bincount(g.rows, weights=g.vals.astype(np.float64),
                      minlength=g.nrows)
    dinv = 1.0 / np.sqrt(np.maximum(deg + eps, 1e-12))
    vals = (
        g.vals.astype(np.float64) * dinv[g.rows] * dinv[g.cols]
    ).astype(np.float32 if g.vals.dtype != np.float64 else np.float64)
    return CooGraph(rows=g.rows, cols=g.cols, vals=vals,
                    nrows=g.nrows, ncols=g.ncols)


def mean_aggregate_norm(coo: CooGraph) -> CooGraph:
    """Row-normalize by entry count, D^{-1} A (SAGE's mean aggregation):
    the degree counts entries whatever their weights; float32 values."""
    deg = np.bincount(coo.rows, minlength=coo.nrows).astype(np.float64)
    dinv = 1.0 / np.maximum(deg, 1.0)
    vals = (coo.vals.astype(np.float64) * dinv[coo.rows]).astype(np.float32)
    return CooGraph(rows=coo.rows, cols=coo.cols, vals=vals,
                    nrows=coo.nrows, ncols=coo.ncols)
