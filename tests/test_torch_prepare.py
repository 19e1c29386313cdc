"""Host prepare of the PyTorch port against the JAX reference: the same
inputs must give bit-equal graphs, plans and device tables."""

import fcntl
import os
import tempfile

import numpy as np
import pytest

from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import native
from pygim_tpu.core import partition as jpart
from pygim_tpu.core import stair as jstair
from pygim_tpu.data import datasets as jdata
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import partition as tpart
from pygim_tpu_torch.core import stair as tstair
from pygim_tpu_torch.data import datasets as tdata
from pygim_tpu_torch.ops import spmm as tspmm

N, E = 2000, 40_000
BUDGET = 256 << 10
KW = dict(backend="hybrid", hybrid_shape="stair", hybrid_dtype="int8",
          hybrid_core_bytes=BUDGET)


def reference_planner() -> bool:
    """Whether the reference's native planner is loaded in this process,
    loading it if it is not.

    The reference builds ``native/libpygim_planner.so`` at first use, in
    place and without a lock, and tries once a process: a test worker
    that loads the library while another worker is still writing it runs
    the reference without its planner from then on, and the planner
    decides the order of edges within a CSR row (row-stable with it, (row,
    col) order without). So the build and the load happen here under an
    exclusive lock outside the repository, and a process whose first try
    failed tries again once the library is whole."""
    lock = os.path.join(tempfile.gettempdir(), "pygim_tpu_native_build.lock")
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if native._lib is None:
                native._tried = False
                native.get_lib()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    return native._lib is not None


def by_row_col(rows, cols, vals):
    """The edges in (row, col) order (a stable sort)."""
    o = np.lexsort((cols, rows))
    return rows[o], cols[o], vals[o]


def make_graph(kind: str):
    """(rows, cols, vals) of a test graph, numpy, from a fixed seed.

    The port's CSR keeps input order within a row; the reference does so
    only with its native planner (:func:`reference_planner`), and sorts
    by (row, col) without it. Where no planner can be built at all, the
    edges come in (row, col) order, so that both orders agree."""
    rows, cols = jdata.rmat_edges(N, E, seed=3)
    vals = np.ones(rows.size, np.float32)
    if kind == "simple":
        # unique pairs in first-occurrence order: not sorted, so the CSR
        # must keep input order within rows
        key = rows.astype(np.int64) * N + cols
        _, first = np.unique(key, return_index=True)
        first.sort()
        rows, cols, vals = rows[first], cols[first], vals[first]
    elif kind == "wide":
        # cells outside int8 or not integer: 300 parallel edges on a hub
        # cell and fractional weights on hub edges — demoted to the tail
        hub = np.bincount(rows, minlength=N).argmax()
        rows = np.concatenate([rows, np.full(300, hub, np.int32)])
        cols = np.concatenate([cols, np.full(300, hub, np.int32)])
        vals = np.concatenate([vals, np.ones(300, np.float32)])
        vals[rows == hub] *= np.where(np.arange((rows == hub).sum()) % 7 == 0,
                                      0.5, 1.0).astype(np.float32)
    if not reference_planner():
        rows, cols, vals = by_row_col(rows, cols, vals)
    return rows, cols, vals


GRAPHS = ["multigraph", "simple", "wide"]


def both_preps(kind: str, **over):
    rows, cols, vals = make_graph(kind)
    jg = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    tg = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    jp = jspmm.prepare_spmm(jg, jspmm.SpmmConfig(**KW, **over))
    tp = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(**KW, **over), device="cpu")
    return jp, tp


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("kind", GRAPHS)
def test_prepare_tables_bit_equal(kind, merge):
    jp, tp = both_preps(kind, merge_duplicates=merge)
    assert jp.stair is not None and len(jp.stair) > 1
    assert tp.stair == jp.stair
    assert tp.ell_meta == jp.ell_meta
    assert tp.hybrid_k_eff == jp.hybrid_k_eff
    assert tp.nnz == jp.nnz
    jdev = {k: np.asarray(v) for k, v in jp.dev_arrays.items()}
    assert set(tp.dev_arrays) == set(jdev)
    for k, v in jdev.items():
        got = tp.dev_arrays[k].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


@pytest.mark.parametrize("merge", [True, False])
def test_wide_cells_are_demoted(merge):
    _, tp = both_preps("wide", merge_duplicates=merge)
    tail_vals = np.concatenate([
        tp.dev_arrays[k].numpy().ravel() for k in tp.dev_arrays
        if k.startswith("vals2d")
    ])
    # the non-integer weights reach the tail in both cases; merged, the
    # 300-edge cell arrives as one value above 127
    assert np.any(tail_vals % 1 != 0)
    if merge:
        assert tail_vals.max() > 127


def test_band_shapes_are_ragged():
    _, tp = both_preps("multigraph")
    assert any((hi - lo) % 256 for lo, hi, _ in tp.stair)
    assert any(w > hi - lo for lo, hi, w in tp.stair)
    for b, (lo, hi, w) in enumerate(tp.stair):
        assert tuple(tp.dev_arrays[f"stair{b}"].shape) == (hi - lo, w)


@pytest.mark.parametrize("kind", GRAPHS)
def test_coo_to_csr_matches(kind):
    rows, cols, vals = make_graph(kind)
    j = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N).to_csr()
    t = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N).to_csr()
    for a in ("rowptr", "colind", "vals"):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a), err_msg=a)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_merge_duplicate_edges_matches(dtype):
    rows, cols, vals = make_graph("multigraph")
    vals = vals.astype(dtype)
    jm, jmerged = jgraph.merge_duplicate_edges(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N,
                                   dtype=dtype))
    tm, tmerged = tgraph.merge_duplicate_edges(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N,
                                   dtype=dtype))
    assert jmerged and tmerged
    for a in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tm, a), getattr(jm, a))


@pytest.mark.parametrize("budget,max_bands", [(64 << 10, 8), (256 << 10, 8),
                                              (1 << 20, 4), (3 << 20, 8)])
def test_plan_staircase_matches(budget, max_bands):
    rng = np.random.default_rng(5)
    rr = np.minimum((rng.pareto(1.2, 30_000) * 30).astype(np.int64), N - 1)
    cc = np.minimum((rng.pareto(1.2, 30_000) * 30).astype(np.int64), N - 1)
    assert tstair.plan_staircase(rr, cc, N, budget, max_bands=max_bands) == \
        jstair.plan_staircase(rr, cc, N, budget, max_bands=max_bands)


@pytest.mark.parametrize("max_tables,hidden", [(1, 256), (3, 256), (3, 64)])
def test_ell_degrees_and_tables_match(max_tables, hidden):
    rows, cols, vals = make_graph("simple")
    jc = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N).to_csr()
    tc = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N).to_csr()
    cfg = tspmm.SpmmConfig(**KW, ell_tables=max_tables, hidden_hint=hidden)
    degs = tpart.choose_degrees_for_config(tc.row_lengths, cfg)
    assert degs == jpart.choose_degrees_for_config(jc.row_lengths, cfg)
    jt = jpart.build_ell_rows_multi(jc, degs, hidden=hidden, row_chunk_for=lambda d: 64)
    tt = tpart.build_ell_rows_multi(tc, degs, hidden=hidden, row_chunk_for=lambda d: 64)
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert (a.degree, a.n_virtual) == (b.degree, b.n_virtual)
        for f in ("cols", "vals", "vrow_to_row"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


@pytest.mark.parametrize("name", ["tiny", "cora", "rmat-1500-9000"])
def test_dataset_standins_match(name, tmp_path):
    j = jdata.load_dataset(name, root=str(tmp_path), use_cache=False)
    t = tdata.load_dataset(name)
    assert (t.num_classes, t.synthetic, t.metric) == \
        (j.num_classes, j.synthetic, j.metric)
    for a in ("x", "y", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a), err_msg=a)
    for a in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(t.graph, a), getattr(j.graph, a))
    assert (t.graph.nrows, t.graph.ncols) == (j.graph.nrows, j.graph.ncols)


def test_unknown_dataset_raises():
    with pytest.raises(KeyError):
        tdata.load_dataset("no-such-graph")
