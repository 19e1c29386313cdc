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
it to a graph.

The multilevel k-way partitioner (``pygim_tpu/core/cluster.py:84-135``):
:func:`partition_kway` runs ``csrc/partition_ml.cpp`` (heavy-edge
matching, greedy growing, boundary refinement; ``core/native.py`` builds
it with ``g++``), :func:`partition_order` sorts the nodes by part, so the
halo layout's contiguous row ranges become the parts, and
:func:`edge_cut_fraction` measures a membership's cut.
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


def partition_kway(graph, nparts: int, tol: float = 0.03,
                   seed: int = 0) -> np.ndarray:
    """Multilevel k-way partition membership (int32, one part id a node)
    under a ``tol`` balance constraint, from the native library. Under
    ``core/native.py:NO_NATIVE_ENV`` it takes the reference's fallback:
    label-propagation communities packed in order into ``nparts`` equal
    bins (much weaker cuts, the same interface)."""
    from pygim_tpu_torch.core.native import partition_kway_native

    csr = graph if isinstance(graph, CsrGraph) else graph.to_csr()
    if nparts <= 1:
        return np.zeros(csr.nrows, dtype=np.int32)
    res = partition_kway_native(csr.rowptr, csr.colind, nparts, tol=tol,
                                seed=seed)
    if res is not None:
        return res[0]
    order = _label_prop_order(csr)
    n = csr.nrows
    target = -(-n // nparts)
    part = np.empty(n, dtype=np.int32)
    part[order] = np.arange(n, dtype=np.int64) // target
    return part


def partition_order(graph, nparts: int, tol: float = 0.02,
                    seed: int = 0) -> np.ndarray:
    """Node order (position → original id) sorting the nodes by their
    k-way part: contiguous equal ranges of the reordered graph then
    coincide with the parts (up to the ``tol`` imbalance)."""
    part = partition_kway(graph, nparts, tol=tol, seed=seed)
    return np.argsort(part, kind="stable").astype(np.int64)


def edge_cut_fraction(graph, part: np.ndarray) -> float:
    """Share of the (directed, non-self-loop) edges whose endpoints lie in
    different parts."""
    coo = graph if isinstance(graph, CooGraph) else graph.to_coo()
    off = coo.rows != coo.cols
    m = int(off.sum())
    if m == 0:
        return 0.0
    return float((part[coo.rows[off]] != part[coo.cols[off]]).sum() / m)


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
