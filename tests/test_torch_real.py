"""The port's real-format parsers (``pygim_tpu_torch/data/real.py``) and
its stand-in writer (``data/real_layout.py``) against the JAX package's
parsers: the Planetoid (with citeseer's gap), Reddit and OGB raw layouts
written once and parsed by both packages into equal arrays, a stand-in
written in each layout and read back by both, the malformed-file error,
and real files taking precedence over the stand-in. Twins of
``tests/test_real_datasets.py``."""

import dataclasses
import gzip
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from pygim_tpu.data import datasets as jdata
from pygim_tpu.data import real as jreal
from pygim_tpu_torch.bench.runners import run_inference_benchmark
from pygim_tpu_torch.data import datasets as tdata
from pygim_tpu_torch.data import real as treal
from pygim_tpu_torch.data import real_layout
from test_real_datasets import _write_ogb, _write_planetoid


def assert_same_parse(j, t):
    """``(graph, x, y, train, val, test)`` of both packages equal."""
    jg, tg = j[0], t[0]
    for name in ("rows", "cols", "vals"):
        a, b = getattr(jg, name), getattr(tg, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (jg.nrows, jg.ncols) == (tg.nrows, tg.ncols)
    for a, b in zip(j[1:], t[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def assert_same_dataset(j, t):
    assert_same_parse(
        (j.graph, j.x, j.y, j.train_mask, j.val_mask, j.test_mask),
        (t.graph, t.x, t.y, t.train_mask, t.val_mask, t.test_mask))
    assert (j.name, j.num_classes, j.synthetic, j.metric) == (
        t.name, t.num_classes, t.synthetic, t.metric)


@pytest.mark.parametrize("name,gap", [("pubmed", False), ("cora", False),
                                      ("citeseer", True)])
def test_planetoid_matches_jax(name, gap, tmp_path):
    tx, ty, test_ids = _write_planetoid(tmp_path, name, gap=gap)
    t = treal.load_planetoid(str(tmp_path), name)
    assert_same_parse(jreal.load_planetoid(str(tmp_path), name), t)
    graph, x, y, train, val, test = t
    assert x.shape == (8, 4) and train.sum() == 3 and train[:3].all()
    txd = np.asarray(tx.todense())
    for k, nid in enumerate(test_ids):  # permuted rows at their node ids
        np.testing.assert_allclose(x[nid], txd[k])
    assert set(np.flatnonzero(test)) == set(test_ids.tolist())
    if gap:  # the missing id comes back as a zero row, not a test node
        np.testing.assert_allclose(x[6], 0.0)
    pairs = set(zip(graph.rows.tolist(), graph.cols.tolist()))
    assert (7, 2) in pairs and (2, 7) in pairs
    assert len(pairs) == graph.nnz  # deduplicated
    assert_same_dataset(jreal.try_load_real(name, str(tmp_path)),
                        treal.try_load_real(name, str(tmp_path)))


def write_reddit_raw(root, n=10, f=6, seed=1):
    d = root / "Reddit" / "raw"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    feat = rng.random((n, f)).astype(np.float32)
    types = np.array([1, 1, 1, 1, 2, 2, 3, 3, 3, 3])
    np.savez(d / "reddit_data.npz", feature=feat,
             label=rng.integers(0, 4, n), node_types=types)
    adj = sp.random(n, n, density=0.3, random_state=2, format="coo")
    sp.save_npz(d / "reddit_graph.npz", adj.tocsr())
    return feat, adj


def test_reddit_matches_jax(tmp_path):
    feat, adj = write_reddit_raw(tmp_path)
    t = treal.load_reddit(str(tmp_path))
    assert_same_parse(jreal.load_reddit(str(tmp_path)), t)
    graph, x, y, train, val, test = t
    np.testing.assert_allclose(x, feat)
    assert train.sum() == 4 and val.sum() == 2 and test.sum() == 4
    pairs = set(zip(graph.rows.tolist(), graph.cols.tolist()))
    assert pairs == set(zip(adj.col.tolist(), adj.row.tolist()))
    assert_same_dataset(jreal.try_load_real("reddit", str(tmp_path)),
                        treal.try_load_real("reddit", str(tmp_path)))


@pytest.mark.parametrize("scheme", ["time", "sales_ranking"])
def test_ogb_matches_jax(scheme, tmp_path):
    edges, feat, label = _write_ogb(tmp_path, scheme=scheme)
    t = treal.load_ogb_nodeprop(str(tmp_path), "ogbn-arxiv")
    assert_same_parse(jreal.load_ogb_nodeprop(str(tmp_path), "ogbn-arxiv"), t)
    graph, x, y, train, val, test = t
    np.testing.assert_allclose(x, feat, atol=1e-6)
    np.testing.assert_array_equal(y, label)
    pairs = set(zip(graph.rows.tolist(), graph.cols.tolist()))
    assert pairs == set(zip(edges[:, 1].tolist(), edges[:, 0].tolist()))
    assert train.sum() == 3 and val.sum() == 1
    assert set(np.flatnonzero(test)) == {4, 8}
    assert_same_dataset(jreal.try_load_real("ogbn-arxiv", str(tmp_path)),
                        treal.try_load_real("ogbn-arxiv", str(tmp_path)))


def test_ogb_without_split_is_all_test(tmp_path):
    _write_ogb(tmp_path)
    import shutil

    shutil.rmtree(tmp_path / "ogbn_arxiv" / "split")
    t = treal.load_ogb_nodeprop(str(tmp_path), "ogbn-arxiv")
    assert_same_parse(jreal.load_ogb_nodeprop(str(tmp_path), "ogbn-arxiv"), t)
    assert t[5].all() and not t[3].any() and not t[4].any()


def csv_gz(path, text: str):
    with gzip.open(path, "wt") as f:
        f.write(text)


@pytest.mark.parametrize("text,dtype", [
    ("1,2\n3,4\n5,6\n", np.int64),
    ("1,2\n3,4\n5,6", np.int64),                 # no final newline
    ("0.1,2.5e-3,-7\n1e10,3,4\n", np.float32),
    ("-0.000123457,1.5\n", np.float32),
    ("42\n", np.int64),
    ("", np.int64),                              # an empty file
    ("9007199254740991\n", np.int64),            # 2^53 - 1
])
@pytest.mark.parametrize("chunk", [1 << 26, 5])
def test_read_csv_gz_matches_jax(text, dtype, chunk, tmp_path, monkeypatch):
    """Against the reference's reader through pandas where it is
    installed, and through its own NumPy fallback; blocks of 5 bytes cut
    lines everywhere."""
    p = tmp_path / "a.csv.gz"
    csv_gz(p, text)
    got = treal._read_csv_gz(p, dtype, chunk_bytes=chunk)
    want = jreal._read_csv_gz(p, dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    monkeypatch.setitem(sys.modules, "pandas", None)
    want = jreal._read_csv_gz(p, dtype, chunk_bytes=chunk)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout,source", [
    ("ogbn-arxiv", "tiny"), ("ogbn-products", "rmat-3000-40000"),
    ("ogbn-proteins", "brmat-1000-8000-50"), ("reddit", "tiny-uniq"),
])
def test_real_layout_round_trip(layout, source, tmp_path):
    """A stand-in written in a raw layout comes back through both
    packages' parsers: equal arrays, and ``verify_roundtrip``'s checks
    against the source."""
    ds = tdata.load_dataset(source, root=str(tmp_path / "cache"))
    if layout == "reddit":
        real_layout.write_reddit(ds, tmp_path / "raw")
    else:
        real_layout.write_ogb(ds, layout, tmp_path / "raw")
    t = treal.try_load_real(layout, str(tmp_path / "raw"))
    assert_same_dataset(jreal.try_load_real(layout, str(tmp_path / "raw")), t)
    assert t.metric == ("rocauc" if layout == "ogbn-proteins" else "acc")
    real_layout.verify_roundtrip(ds, layout, tmp_path / "raw")
    real_layout.verify_roundtrip(ds, layout, tmp_path / "raw", real=t)
    # the name lookup prefers the files
    loaded = tdata.load_dataset(layout, root=str(tmp_path / "raw"))
    assert not loaded.synthetic
    assert_same_dataset(t, loaded)


def test_verify_roundtrip_catches_a_difference(tmp_path):
    ds = tdata.load_dataset("tiny", root=str(tmp_path / "cache"))
    real_layout.write_ogb(ds, "ogbn-arxiv", tmp_path / "raw")
    x = ds.x.copy()
    x[3, 1] += 1e-3
    with pytest.raises(AssertionError, match="features"):
        real_layout.verify_roundtrip(dataclasses.replace(ds, x=x),
                                     "ogbn-arxiv", tmp_path / "raw")
    y = ds.y.copy()
    y[0] += 1
    with pytest.raises(AssertionError, match="labels"):
        real_layout.verify_roundtrip(dataclasses.replace(ds, y=y),
                                     "ogbn-arxiv", tmp_path / "raw")


def test_real_layout_cli_merges_a_multigraph(tmp_path, monkeypatch):
    """The command line writes a multigraph stand-in's merged cells, and
    verifies them."""
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path / "cache"))
    real_layout.main(["reddit", str(tmp_path / "raw"), "tiny"])
    t = treal.try_load_real("reddit", str(tmp_path / "raw"))
    ds = tdata.load_dataset("tiny")
    assert t.graph.nnz < ds.graph.nnz
    assert np.unique(t.graph.rows.astype(np.int64) * t.graph.ncols
                     + t.graph.cols).size == t.graph.nnz


def test_load_dataset_prefers_real_files(tmp_path):
    _write_planetoid(tmp_path, "pubmed")
    ds = tdata.load_dataset("pubmed", root=str(tmp_path))
    assert not ds.synthetic and ds.num_nodes == 8 and ds.x.shape[1] == 4
    assert ds.val_mask is not None
    assert_same_dataset(jdata.load_dataset("pubmed", root=str(tmp_path)), ds)
    res = run_inference_benchmark(ds, hidden=8, repeat=1, device="cpu")
    assert res["data_source"] == "real"


def test_stand_in_where_no_files(tmp_path):
    for name in ("pubmed", "ogbn-arxiv", "reddit"):
        assert treal.try_load_real(name, str(tmp_path)) is None
    assert treal.try_load_real("tiny", str(tmp_path)) is None
    assert tdata.load_dataset("tiny", root=str(tmp_path)).synthetic


@pytest.mark.parametrize("name,path", [
    ("pubmed", "Pubmed/raw/ind.pubmed.graph"),
    ("reddit", "Reddit/raw/reddit_data.npz"),
    ("ogbn-arxiv", "ogbn_arxiv/raw/edge.csv.gz"),
])
def test_malformed_real_raises(name, path, tmp_path):
    """Files that do not parse fail loudly, never turn into the
    stand-in."""
    p = tmp_path / path
    p.parent.mkdir(parents=True)
    p.write_bytes(b"not a dataset")
    with pytest.raises(Exception):
        tdata.load_dataset(name, root=str(tmp_path))
    assert not (tmp_path / f"{name}-sim.npz").exists()
