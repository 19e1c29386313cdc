"""Locality orders of a graph's nodes, the twin of
``pygim_tpu/core/cluster.py`` (``locality_order``, ``relabel``):

* ``rcm``: reverse Cuthill-McKee bandwidth reduction (SciPy's). Most
  edges land near the diagonal, so contiguous node ranges become good
  clusters.
* ``lp``: a few rounds of majority label propagation, then a stable sort
  by label: community-shaped clusters where bandwidth reduction is a
  poor proxy.
* ``none``: the identity (contiguous ids; the R-MAT stand-ins' locality
  is id-correlated already).

An order maps new position → original node id; :func:`relabel` applies
it to a graph. The multilevel k-way partitioner (``partition_kway``,
``partition_order``, ``edge_cut_fraction``), which needs the native
``partition_ml.cpp``, is not ported yet (ROADMAP.md, Queue 1 item 6b).
"""

from __future__ import annotations

import numpy as np

from pygim_tpu_torch.core.graph import CooGraph, CsrGraph

LOCALITY_METHODS = ("none", "rcm", "lp")


def locality_order(graph, method: str = "rcm") -> np.ndarray:
    """A locality-improving node order (position → original id), int64."""
    csr = graph if isinstance(graph, CsrGraph) else graph.to_csr()
    n = csr.nrows
    if method == "none":
        return np.arange(n, dtype=np.int64)
    if method == "rcm":
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        m = sp.csr_matrix(
            (np.ones(csr.nnz, dtype=np.int8), csr.colind, csr.rowptr),
            shape=(n, csr.ncols),
        )
        return np.asarray(
            reverse_cuthill_mckee(m, symmetric_mode=False), dtype=np.int64
        )
    if method == "lp":
        return _label_prop_order(csr)
    raise ValueError(f"unknown locality method {method!r}")


def _label_prop_order(csr: CsrGraph, rounds: int = 3) -> np.ndarray:
    """Majority label propagation, then a stable sort by the final label:
    each community becomes one contiguous range. A node takes the most
    frequent label among its row's entries (ties: the smaller label); a
    node without entries keeps its own."""
    n = csr.nrows
    labels = np.arange(n, dtype=np.int64)
    rows_of = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(csr.rowptr)
    )
    cols = csr.colind.astype(np.int64)
    for _ in range(rounds):
        pair = rows_of * n + labels[cols]
        uniq, counts = np.unique(pair, return_counts=True)
        u_node = uniq // n
        u_label = uniq % n
        # by (node, count descending, label ascending)
        sel = np.lexsort((u_label, -counts, u_node))
        u_node_s = u_node[sel]
        first = np.ones(sel.shape[0], dtype=bool)
        first[1:] = u_node_s[1:] != u_node_s[:-1]
        best_label = np.full(n, -1, dtype=np.int64)
        best_label[u_node_s[first]] = u_label[sel][first]
        new = np.where(best_label < 0, labels, best_label)
        if np.array_equal(new, labels):
            break
        labels = new
    return np.argsort(labels, kind="stable").astype(np.int64)


def relabel(graph, order: np.ndarray) -> CooGraph:
    """Apply an order to a square graph: new node ``i`` is old
    ``order[i]`` (both endpoints remapped; values unchanged)."""
    coo = graph if isinstance(graph, CooGraph) else graph.to_coo()
    if coo.nrows != coo.ncols:
        raise ValueError("relabel requires a square adjacency")
    inv = np.empty(coo.nrows, dtype=np.int64)
    inv[order] = np.arange(coo.nrows)
    return CooGraph(
        rows=inv[coo.rows].astype(coo.rows.dtype),
        cols=inv[coo.cols].astype(coo.cols.dtype),
        vals=coo.vals,
        nrows=coo.nrows,
        ncols=coo.ncols,
    )
