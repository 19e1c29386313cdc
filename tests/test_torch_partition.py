"""The port's multilevel k-way partitioner against the reference's, the
twin of ``tests/test_partition_kway.py``: ``partition_kway`` (the port's
copy of ``partition_ml.cpp``, built with ``g++``) gives the reference's
native membership array exactly, for several seeds, part counts and
balance tolerances; its label-propagation packing under
``NO_NATIVE_ENV`` equals the reference's fallback; ``partition_order``,
``edge_cut_fraction`` and ``cluster_partition(method="metis")`` equal;
and a failed build raises with the compiler's log."""

import numpy as np
import pytest

from pygim_tpu.core import cluster as jcluster
from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import native as jnative
from pygim_tpu.data import datasets as jdata
from pygim_tpu_torch.core import cluster as tcluster
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import native as tnative
from pygim_tpu_torch.data import datasets as tdata

from test_torch_prepare import reference_planner


def planted(n=4096, blocks=16, deg=8, seed=0, p_intra=0.9):
    """``test_partition_kway.py``'s block-community graph under a hidden
    permutation, in both packages."""
    rng = np.random.default_rng(seed)
    bs = n // blocks
    rows = rng.integers(0, n, size=n * deg)
    intra = rng.random(n * deg) < p_intra
    base = (rows // bs) * bs
    cols = np.where(intra, base + rng.integers(0, bs, size=n * deg),
                    rng.integers(0, n, size=n * deg))
    perm = rng.permutation(n)
    edges = (perm[rows], perm[cols], np.ones(n * deg, np.float32))
    return (jgraph.CooGraph.from_edges(*edges, nrows=n, ncols=n),
            tgraph.CooGraph.from_edges(*edges, nrows=n, ncols=n))


@pytest.fixture(scope="module")
def graphs():
    return planted()


def reference_native():
    if not reference_planner():
        pytest.skip("the reference's native planner did not build")


@pytest.mark.parametrize("tol", [0.03, 0.1])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("nparts", [2, 5, 8])
def test_kway_matches_reference_native(graphs, nparts, seed, tol):
    reference_native()
    jg, tg = graphs
    got = tcluster.partition_kway(tg, nparts, tol=tol, seed=seed)
    want = jcluster.partition_kway(jg, nparts, tol=tol, seed=seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the native path on both sides, not the fallback
    csr = tg.to_csr()
    part, cut = tnative.partition_kway_native(csr.rowptr, csr.colind, nparts,
                                              tol=tol, seed=seed)
    np.testing.assert_array_equal(part, want)
    assert cut == jnative.partition_kway_native(
        csr.rowptr, csr.colind, nparts, tol=tol, seed=seed)[1]
    assert np.bincount(got, minlength=nparts).max() <= 1.15 * (
        tg.nrows / nparts)


def test_single_part_and_determinism(graphs):
    jg, tg = graphs
    np.testing.assert_array_equal(tcluster.partition_kway(tg, 1),
                                  np.zeros(tg.nrows, np.int32))
    a = tcluster.partition_kway(tg, 4, seed=7)
    np.testing.assert_array_equal(a, tcluster.partition_kway(tg, 4, seed=7))


@pytest.mark.parametrize("nparts", [3, 8])
def test_fallback_matches_reference(graphs, nparts, monkeypatch):
    """Under the switch the port takes the reference's label-propagation
    packing (the reference's path without its native library)."""
    jg, tg = graphs
    monkeypatch.setenv(tnative.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(jnative, "partition_kway_native",
                        lambda *a, **k: None)
    got = tcluster.partition_kway(tg, nparts)
    np.testing.assert_array_equal(got, jcluster.partition_kway(jg, nparts))
    assert tnative.partition_kway_native(np.zeros(2, np.int32),
                                         np.zeros(0, np.int32), 2) is None


def test_order_and_cut_match_reference(graphs):
    reference_native()
    jg, tg = graphs
    for nd in (2, 4):
        order = tcluster.partition_order(tg, nd)
        np.testing.assert_array_equal(order, jcluster.partition_order(jg, nd))
        assert order.dtype == np.int64
        part = tcluster.partition_kway(tg, nd)
        got = tcluster.edge_cut_fraction(tg, part)
        assert got == jcluster.edge_cut_fraction(jg, part)
        contig = (np.arange(tg.nrows) * nd // tg.nrows).astype(np.int32)
        assert got < 0.6 * tcluster.edge_cut_fraction(tg, contig)
    loops = tgraph.CooGraph.from_edges(np.arange(4), np.arange(4), nrows=4,
                                       ncols=4)
    assert tcluster.edge_cut_fraction(loops, np.arange(4)) == 0.0


def test_cluster_partition_metis_matches_reference():
    """``cluster_partition(method="metis")`` takes the same part of the
    same partition: the same nodes, edges and features."""
    reference_native()
    jg, tg = planted(n=2048, blocks=8, deg=6, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2048, 4)).astype(np.float32)
    y = rng.integers(0, 3, 2048)
    masks = rng.random(2048) < 0.5, rng.random(2048) < 0.3
    dsets = [mod.GraphDataset(name="p", graph=g, x=x, y=y,
                              train_mask=masks[0], test_mask=masks[1],
                              num_classes=3, synthetic=True)
             for mod, g in ((jdata, jg), (tdata, tg))]
    for part_idx in (0, 1, 5):
        want = jdata.cluster_partition(dsets[0], part_size=512,
                                       part_idx=part_idx, method="metis")
        got = tdata.cluster_partition(dsets[1], part_size=512,
                                      part_idx=part_idx, method="metis")
        assert got.name == want.name
        for a in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(got.graph, a),
                                          getattr(want.graph, a))
        for a in ("x", "y", "train_mask", "test_mask"):
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises with its log; no quiet fallback."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "CXX_FLAGS",
                        tnative.CXX_FLAGS + ("-fno-such-flag-anywhere",))
    _jg, tg = planted(n=256, blocks=4, deg=4)
    with pytest.raises(RuntimeError, match="no-such-flag-anywhere"):
        tcluster.partition_kway(tg, 2)
    monkeypatch.setenv("CXX", str(tmp_path / "no-compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        tcluster.partition_kway(tg, 2)
    assert not list(tmp_path.glob("*.so"))
