"""The port's dataset names against the JAX package's on the same names
and seeds: the unique R-MAT draw and its errors, ``<name>-uniq`` and
``rmat-<n>-<e>-uniq``, ``brmat-<n>-<e>-<b>``, ``.mtx`` files,
``cluster_partition``'s ``rcm`` and ``lp`` methods, and the gated
``torch_geometric`` path (mocked) — array for array."""

import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from pygim_tpu.data import datasets as jdata
from pygim_tpu_torch.data import datasets as tdata


def assert_same_dataset(j, t, val_mask=False):
    for name in ("rows", "cols", "vals"):
        a, b = getattr(j.graph, name), getattr(t.graph, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (j.graph.nrows, j.graph.ncols) == (t.graph.nrows, t.graph.ncols)
    for name in ("x", "y", "train_mask", "test_mask"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (j.name, j.num_classes, j.synthetic, j.metric) == (
        t.name, t.num_classes, t.synthetic, t.metric)
    if val_mask:
        np.testing.assert_array_equal(j.val_mask, t.val_mask)
    else:
        assert j.val_mask is None and t.val_mask is None


@pytest.mark.parametrize("n,e,seed", [(256, 20_000, 2), (1000, 10_000, 0),
                                      (3000, 60_000, 5), (64, 3000, 1),
                                      (128, 9000, 3)])
def test_unique_rmat_matches_jax(n, e, seed):
    """The last two are near the skew's reachable cells: many rejection
    batches, each merged into the accepted keys."""
    want = jdata.rmat_edges(n, e, seed=seed, unique=True)
    got = tdata.rmat_edges(n, e, seed=seed, unique=True)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    keys = got[0].astype(np.int64) * n + got[1]
    assert np.unique(keys).size == e


def test_unique_rmat_errors():
    with pytest.raises(ValueError):
        tdata.rmat_edges(4, 17, unique=True)
    # feasible on paper, beyond the skew's reachable cells
    with pytest.raises(RuntimeError, match="stalled"):
        tdata.rmat_edges(32, 1000, unique=True, seed=0)
    with pytest.raises(RuntimeError, match="stalled"):
        jdata.rmat_edges(32, 1000, unique=True, seed=0)


def test_multigraph_rmat_unchanged():
    for a, b in zip(jdata.rmat_edges(500, 7000, seed=4),
                    tdata.rmat_edges(500, 7000, seed=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [
    "tiny-uniq", "rmat-500-2000-uniq", "rmat-2000-30000-uniq",
    "brmat-1000-8000-50", "brmat-4096-40000-256", "brmat-100-500-1000",
    "tiny", "rmat-700-5000", "planted-600-5000-3",
])
@pytest.mark.parametrize("seed", [0, 3])
def test_dataset_names_match_jax(name, seed, tmp_path):
    j = jdata.load_dataset(name, root=str(tmp_path / "j"), seed=seed)
    t = tdata.load_dataset(name, root=str(tmp_path / "t"), seed=seed)
    assert_same_dataset(j, t)


def test_uniq_spec_name_is_cached(tmp_path):
    ds = tdata.load_dataset("tiny-uniq", root=str(tmp_path))
    n, e, _f, _c = tdata.DATASET_SPECS["tiny"]
    assert ds.num_nodes == n and ds.num_edges == e
    keys = ds.graph.rows.astype(np.int64) * n + ds.graph.cols
    assert np.unique(keys).size == e
    assert (tmp_path / "tiny-uniq-sim.npz").exists()
    again = tdata.load_dataset("tiny-uniq", root=str(tmp_path))
    assert_same_dataset(ds, again)
    # the file has the reference's layout: the JAX package reads it
    assert_same_dataset(jdata.load_dataset("tiny-uniq", root=str(tmp_path)),
                        ds)


def test_unknown_names_raise(tmp_path):
    for name in ("nope", "nope-uniq"):
        with pytest.raises(KeyError):
            tdata.load_dataset(name, root=str(tmp_path))


MTX = {
    "square": ("%%MatrixMarket matrix coordinate real general\n"
               "3 3 3\n1 2 1.5\n2 3 2.5\n3 1 3.5\n"),
    "rect": ("%%MatrixMarket matrix coordinate real general\n"
             "4 6 4\n1 6 1.0\n2 3 -2.0\n4 1 0.5\n3 5 4.0\n"),
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                  "4 4 3\n2 1 1.0\n3 3 2.0\n4 2 3.0\n"),
    "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                "5 5 4\n1 2\n2 3\n5 1\n3 3\n"),
    "cli": ("%%MatrixMarket matrix coordinate real general\n50 50 100\n"
            + "\n".join(f"{(i * 7) % 50 + 1} {(i * 13) % 50 + 1} "
                        f"{1.0 + i % 3}" for i in range(100)) + "\n"),
}


@pytest.mark.parametrize("case", list(MTX))
def test_mtx_matches_jax(case, tmp_path):
    p = tmp_path / f"{case}.mtx"
    p.write_text(MTX[case])
    for dtype in ("float32", "float64"):
        j, t = jdata.load_mtx(str(p), dtype), tdata.load_mtx(str(p), dtype)
        for name in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
            assert getattr(j, name).dtype == getattr(t, name).dtype
        assert (j.nrows, j.ncols) == (t.nrows, t.ncols)
        np.testing.assert_array_equal(j.to_dense(), t.to_dense())
    j = jdata.load_dataset(f"{case}.mtx", root=str(tmp_path), seed=2)
    t = tdata.load_dataset(f"{case}.mtx", root=str(tmp_path), seed=2)
    assert_same_dataset(j, t)
    assert t.graph.nrows == t.graph.ncols  # padded square


def test_mtx_values():
    """``tests/test_data.py``'s case on the port alone."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.mtx"
        p.write_text(MTX["square"])
        g = tdata.load_mtx(str(p))
    assert g.nrows == 3 and g.nnz == 3
    dense = g.to_dense()
    assert dense[0, 1] == 1.5 and dense[2, 0] == 3.5


def sorted_dataset(mod, name, tmp_path):
    """A dataset of ``mod`` with its graph in (row, col) order, so the two
    packages' CSR orders agree with or without the reference's native
    planner."""
    ds = mod.load_dataset(name, root=str(tmp_path))
    return dataclasses.replace(ds, graph=ds.graph.sort_by_row())


@pytest.mark.parametrize("method", ["none", "rcm", "lp"])
@pytest.mark.parametrize("name,part_size,part_idx", [
    ("brmat-2048-20000-128", 512, 1), ("tiny", 300, 1), ("tiny", 300, 7),
    ("brmat-1000-9000-100", 1000, 1), ("rmat-900-9000", 250, 2),
])
def test_cluster_partition_matches_jax(method, name, part_size, part_idx,
                                       tmp_path):
    j = jdata.cluster_partition(sorted_dataset(jdata, name, tmp_path / "j"),
                                part_size=part_size, part_idx=part_idx,
                                method=method)
    t = tdata.cluster_partition(sorted_dataset(tdata, name, tmp_path / "t"),
                                part_size=part_size, part_idx=part_idx,
                                method=method)
    assert_same_dataset(j, t)


def test_clustered_part_keeps_more_edges(tmp_path):
    """On a graph whose ids carry no locality, a locality-ordered part
    holds more of its nodes' edges than a contiguous one."""
    ds = sorted_dataset(tdata, "brmat-4096-40000-256", tmp_path)
    flat = tdata.cluster_partition(ds, part_size=512, part_idx=1)
    for method in ("rcm", "lp"):
        clus = tdata.cluster_partition(ds, part_size=512, part_idx=1,
                                       method=method)
        assert clus.graph.nnz > flat.graph.nnz
        assert clus.x.shape == flat.x.shape


def test_cluster_partition_metis_not_ported(tmp_path, monkeypatch):
    """``method="metis"``, refused until the multilevel partitioner was
    ported (ROADMAP.md Queue 1 item 6b), takes the reference's part of its
    k-way partition (where the reference has no native library, both take
    the label-propagation packing); an unknown method raises as in the
    reference."""
    from pygim_tpu_torch.core import native as tnative
    from test_torch_prepare import reference_planner

    if not reference_planner():
        monkeypatch.setenv(tnative.NO_NATIVE_ENV, "1")
    j = sorted_dataset(jdata, "tiny", tmp_path)
    t = sorted_dataset(tdata, "tiny", tmp_path)
    for part_idx in (1, 3):
        want = jdata.cluster_partition(j, part_size=300, part_idx=part_idx,
                                       method="metis")
        got = tdata.cluster_partition(t, part_size=300, part_idx=part_idx,
                                      method="metis")
        assert_same_dataset(want, got)
        assert 0 < got.num_nodes <= 300 * 1.1
    with pytest.raises(ValueError):
        tdata.cluster_partition(t, part_size=300, method="bogus")


def fake_pyg(monkeypatch, n=20):
    """A ``torch_geometric`` module whose Planetoid holds a 20-node graph
    (the twin of ``tests/test_data.py``'s mock)."""
    edge_index = torch.tensor([[0, 1, 2, 3], [1, 2, 3, 0]], dtype=torch.int64)
    gen = torch.Generator().manual_seed(0)

    class FakeData:
        num_nodes = n
        x = torch.randn(n, 5, generator=gen)
        y = torch.arange(n) % 3
        train_mask = torch.zeros(n, dtype=torch.bool)
        test_mask = torch.ones(n, dtype=torch.bool)

    FakeData.edge_index = edge_index

    class FakePlanetoid:
        def __init__(self, root, name):
            assert name == "Pubmed"

        def __getitem__(self, i):
            return FakeData()

    tg = types.ModuleType("torch_geometric")
    tg_ds = types.ModuleType("torch_geometric.datasets")
    tg_ds.Planetoid = FakePlanetoid
    tg_ds.Reddit = None
    tg.datasets = tg_ds
    monkeypatch.setitem(sys.modules, "torch_geometric", tg)
    monkeypatch.setitem(sys.modules, "torch_geometric.datasets", tg_ds)


def test_mocked_pyg_path_matches_jax(tmp_path, monkeypatch):
    fake_pyg(monkeypatch)
    t = tdata._try_real_dataset("pubmed", str(tmp_path))
    j = jdata._try_real_dataset("pubmed", str(tmp_path))
    assert t is not None and not t.synthetic
    assert t.graph.nrows == 20 and t.graph.nnz == 4
    # row = destination: edge 0 -> 1 lands at row 1
    assert 1 in t.graph.rows[t.graph.cols == 0]
    assert t.num_classes == 3 and t.test_mask.all()
    assert_same_dataset(j, t)
    # the name lookup takes it before the stand-in, as the reference's
    assert_same_dataset(jdata.load_dataset("pubmed", root=str(tmp_path)),
                        tdata.load_dataset("pubmed", root=str(tmp_path)))
    assert not (tmp_path / "pubmed-sim.npz").exists()


def test_pyg_path_absent_or_failing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch_geometric", None)
    assert tdata._try_real_dataset("pubmed", str(tmp_path)) is None
    fake_pyg(monkeypatch)
    # a name the mock cannot load: the failure gives None, not an error
    assert tdata._try_real_dataset("cora", str(tmp_path)) is None
    assert tdata._try_real_dataset("tiny", str(tmp_path)) is None


def test_val_mask_field():
    fields = [f.name for f in dataclasses.fields(tdata.GraphDataset)]
    assert fields == [f.name for f in dataclasses.fields(jdata.GraphDataset)]
    assert tdata.GraphDataset.__dataclass_fields__["val_mask"].default is None
