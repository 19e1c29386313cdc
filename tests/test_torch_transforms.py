"""The port's host transforms, locality orders, search spaces, logger and
profiling hooks against the JAX package's on the same seeded inputs:
``core/transforms.py`` on the cases of ``tests/test_core.py``,
``core/cluster.py``'s ``locality_order`` and ``relabel`` (equal arrays),
``tune/space.py`` on the cases of ``tests/test_tune.py``, and
``make_logger``, ``trace`` and ``annotate`` on the CPU."""

import json
import logging
import sys

import numpy as np
import pytest

from pygim_tpu.core import cluster as jcluster
from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import transforms as jtransforms
from pygim_tpu.tune import space as jspace
from pygim_tpu_torch.core import cluster as tcluster
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import transforms as ttransforms
from pygim_tpu_torch.tune import Concat, For, Product, Table, Unit
from pygim_tpu_torch.utils.logging import make_logger
from pygim_tpu_torch.utils.profiling import annotate, trace


def pair(rows, cols, vals=None, n=None, dtype="float32"):
    """The same graph in both packages."""
    kw = dict(nrows=n, ncols=n, dtype=dtype)
    return (jgraph.CooGraph.from_edges(rows, cols, vals, **kw),
            tgraph.CooGraph.from_edges(rows, cols, vals, **kw))


def random_pair(seed, n=50, nnz=300, dtype="float32", distinct=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    if distinct:
        flat = np.unique(rows.astype(np.int64) * n + cols)
        rows, cols = flat // n, flat % n
    vals = (rng.integers(-4, 5, rows.size) if dtype.startswith("int")
            else rng.standard_normal(rows.size))
    return pair(rows, cols, vals, n, dtype)


def assert_same(j, t):
    assert (j.nrows, j.ncols) == (t.nrows, t.ncols)
    for name in ("rows", "cols", "vals"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


GRAPHS = {
    "loops": lambda: pair([0, 1, 2], [1, 1, 0], n=3),
    "duplicates": lambda: pair([0, 1], [1, 0], [2.0, 3.0], n=2),
    "random": lambda: random_pair(1),
    "random-distinct": lambda: random_pair(2, distinct=True),
    "float64": lambda: random_pair(3, dtype="float64"),
    "int32": lambda: random_pair(4, dtype="int32"),
    "empty": lambda: pair([], [], n=4),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("fn", ["add_self_loops", "to_undirected", "gcn_norm",
                                "gcn_norm_no_loops", "mean_aggregate_norm"])
def test_transforms_match_jax(graph, fn):
    j, t = GRAPHS[graph]()
    if fn == "gcn_norm_no_loops":
        assert_same(jtransforms.gcn_norm(j, add_loops=False, eps=0.5),
                    ttransforms.gcn_norm(t, add_loops=False, eps=0.5))
        return
    assert_same(getattr(jtransforms, fn)(j), getattr(ttransforms, fn)(t))


@pytest.mark.parametrize("axis", ["row", "col"])
def test_degrees_match_jax(axis):
    j, t = random_pair(5)
    got = ttransforms.degrees(t, axis)
    np.testing.assert_array_equal(got, jtransforms.degrees(j, axis))
    assert got.dtype == np.int64


def test_transform_cases_of_the_reference():
    """``tests/test_core.py``'s cases on the port alone."""
    _, g = pair([0, 1, 2], [1, 1, 0], n=3)
    g2 = ttransforms.add_self_loops(g)
    dense = g2.to_dense()
    assert dense[0, 0] == 1 and dense[2, 2] == 1 and dense[1, 1] == 1
    assert g2.nnz == 5
    _, g = random_pair(6, distinct=True)
    g = tgraph.CooGraph.from_edges(g.rows, g.cols, nrows=50, ncols=50)
    dense = ttransforms.gcn_norm(ttransforms.to_undirected(g)).to_dense()
    np.testing.assert_allclose(dense, dense.T, atol=1e-6)
    assert np.linalg.eigvalsh(dense).max() <= 1.0 + 1e-5
    sums = ttransforms.mean_aggregate_norm(g).to_dense().sum(axis=1)
    nz = np.bincount(g.rows, minlength=50) > 0
    np.testing.assert_allclose(sums[nz], 1.0, atol=1e-6)
    _, g = pair([0, 1], [1, 0], [2.0, 3.0], n=2)
    dense = ttransforms.to_undirected(g).to_dense()
    assert dense[0, 1] == 5.0 and dense[1, 0] == 5.0


def test_non_square_refused():
    _, t = pair([0, 1], [2, 0], n=None)
    t = tgraph.CooGraph(rows=t.rows, cols=t.cols, vals=t.vals, nrows=2,
                        ncols=3)
    for fn in (ttransforms.add_self_loops, ttransforms.to_undirected,
               lambda g: tcluster.relabel(g, np.arange(2))):
        with pytest.raises(ValueError):
            fn(t)


def scrambled_communities(seed, n=1024, nc=8, deg=8, p_intra=0.95):
    """A block-community graph under a random permutation, in (row, col)
    order (so both packages' CSR orders agree with or without the
    reference's native planner)."""
    rng = np.random.default_rng(seed)
    w = n // nc
    rows = np.repeat(np.arange(n), deg)
    intra = rng.random(rows.size) < p_intra
    cols = np.where(intra, (rows // w) * w + rng.integers(0, w, rows.size),
                    rng.integers(0, n, rows.size))
    perm = rng.permutation(n)
    rows, cols = perm[rows], perm[cols]
    order = np.lexsort((cols, rows))
    return pair(rows[order], cols[order], n=n)


@pytest.mark.parametrize("method", ["none", "rcm", "lp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_locality_order_matches_jax(method, seed):
    j, t = scrambled_communities(seed)
    got = tcluster.locality_order(t, method)
    want = jcluster.locality_order(j, method)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(t.nrows))
    # from a CSR operand too
    np.testing.assert_array_equal(
        tcluster.locality_order(t.to_csr(), method), want)
    assert_same(jcluster.relabel(j, want), tcluster.relabel(t, got))


def test_label_prop_rounds_match_jax():
    """More rounds than the default, and isolated nodes keeping their
    labels."""
    j, t = scrambled_communities(3, n=512, deg=4)
    keep = t.rows % 7 != 0  # every 7th node has no entries
    j, t = pair(t.rows[keep], t.cols[keep], n=512)
    np.testing.assert_array_equal(
        tcluster._label_prop_order(t.to_csr(), rounds=6),
        jcluster._label_prop_order(j.to_csr(), rounds=6))


def test_unknown_locality_method():
    _, t = scrambled_communities(0, n=64)
    with pytest.raises(ValueError):
        tcluster.locality_order(t, "metis")


@pytest.mark.parametrize("method", ["rcm", "lp"])
def test_locality_order_lowers_the_cut(method):
    """A locality order recovers part of the hidden communities:
    contiguous ranges of the relabeled graph cut fewer edges than those
    of the scrambled one."""
    _, t = scrambled_communities(4)
    g = tcluster.relabel(t, tcluster.locality_order(t, method))

    def cut(g):
        return float(np.mean(g.rows // 128 != g.cols // 128))

    assert cut(g) < 0.85 * cut(t)


def spaces(mod):
    return {
        "product": lambda: (mod.For("a", [1, 2])
                            * mod.For("b", ["x", "y", "z"])),
        "concat": lambda: mod.For("a", [1]) + mod.For("a", [2, 3]),
        "unit": lambda: mod.Unit() * mod.For("a", [1, 2]),
        "table": lambda: mod.Table.from_dicts([{"a": 1, "b": 2},
                                               {"a": 3, "b": 4}]),
        "nested": lambda: (mod.For("a", [1, 2]) * mod.For("b", [0])
                           + mod.Table([{"b": 5, "a": 9}])) * mod.Unit(),
    }


@pytest.mark.parametrize("name", list(spaces(jspace)))
def test_space_matches_jax(name):
    j, t = spaces(jspace)[name](), spaces(sys.modules[For.__module__])[name]()
    assert list(t) == list(j)
    assert len(t) == len(j) and t.fields == j.fields


def test_space_cases_of_the_reference():
    s = For("a", [1, 2]) * For("b", ["x", "y", "z"])
    assert len(list(s)) == len(s) == 6 and {"a": 2, "b": "z"} in list(s)
    assert isinstance(s, Product)
    with pytest.raises(ValueError):
        For("a", [1]) * For("a", [2])
    c = For("a", [1]) + For("a", [2, 3])
    assert isinstance(c, Concat) and len(c) == 3
    with pytest.raises(ValueError):
        For("a", [1]) + For("b", [2])
    assert list(Unit() * For("a", [1, 2])) == [{"a": 1}, {"a": 2}]
    t = Table.from_dicts([{"a": 1, "b": 2}, {"a": 3, "b": 4}])
    assert len(t) == 2 and t.fields == ("a", "b")
    with pytest.raises(ValueError):
        Table([{"a": 1}, {"b": 2}])
    assert len(Table([])) == 0 and Table([]).fields == ()


def test_make_logger_idempotent(tmp_path):
    name = "pygim_tpu_torch.test_make_logger"
    log_file = tmp_path / "run.log"
    a = make_logger(name, str(log_file))
    b = make_logger(name, str(log_file))
    assert a is b
    assert sum(isinstance(h, logging.FileHandler) for h in a.handlers) == 1
    assert sum(type(h) is logging.StreamHandler for h in a.handlers) == 1
    make_logger(name, str(tmp_path / "other.log"))
    assert sum(isinstance(h, logging.FileHandler) for h in a.handlers) == 2
    a.info("hello %d", 7)
    for h in a.handlers:
        h.flush()
    assert "INFO hello 7" in log_file.read_text()
    for h in list(a.handlers):
        a.removeHandler(h)
        h.close()


def test_trace_writes_chrome_trace_with_annotations(tmp_path):
    import torch

    with trace(str(tmp_path)) as d:
        assert d == str(tmp_path)
        with annotate("pygim-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "pygim-region" for e in events)


def test_trace_dir_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("PYGIM_TPU_TRACE_DIR", str(tmp_path / "env"))
    with trace() as d:
        pass
    assert d == str(tmp_path / "env")
    assert list((tmp_path / "env").glob("trace-*.json"))


def test_exceptions_propagate_unchanged(tmp_path):
    """An exception in an annotated or traced body comes out as raised
    (the reference's ``annotate`` yields a second time there and turns it
    into a RuntimeError), and the trace is still written."""
    err = KeyError("inside")
    with pytest.raises(KeyError) as got:
        with annotate("failing"):
            raise err
    assert got.value is err
    with pytest.raises(ZeroDivisionError):
        with trace(str(tmp_path)):
            with annotate("failing"):
                1 / 0
    assert list(tmp_path.glob("trace-*.json"))
