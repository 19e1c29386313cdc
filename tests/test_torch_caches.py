"""The port's disk caches against the reference's: the prepare cache
(same key, same contents, its own directory) and the dataset cache (the
reference's file layout), and ``cluster_partition``."""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.data import datasets as jdata
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import datasets as tdata
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.utils import cache as tcache

from test_torch_prepare import KW, N, make_graph


@pytest.fixture(autouse=True)
def cache_dirs(tmp_path, monkeypatch):
    """A fresh directory for each package's cache."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(port))
    monkeypatch.setenv("PYGIM_TPU_DATA", str(ref))
    return port, ref


@pytest.fixture
def cpu_cached(monkeypatch):
    """CPU operands through the prepare cache, as the card's go."""
    monkeypatch.setattr(tspmm, "CACHED_DEVICES", ("cuda", "cpu"))


def port_prep(kind, **over):
    rows, cols, vals = make_graph(kind)
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    return tspmm.prepare_spmm(g, tspmm.SpmmConfig(**KW, **over),
                              device="cpu")


def merged(kind):
    rows, cols, vals = make_graph(kind)
    return jgraph.merge_duplicate_edges(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N))[0]


@pytest.mark.parametrize("kind", ["multigraph", "wide"])
def test_prepare_cache_round_trip(kind, cache_dirs, cpu_cached):
    port, _ref = cache_dirs
    cold = port_prep(kind)
    assert "core_fill" in cold.prepare_timer.acc
    assert "cache_save" in cold.prepare_timer.acc
    files = list(port.glob("hybrid-torch-*.npz"))
    assert len(files) == 1 and not list(port.glob("*.tmp.npz"))
    warm = port_prep(kind)
    assert "cache_load" in warm.prepare_timer.acc
    assert "core_fill" not in warm.prepare_timer.acc
    assert (warm.stair, warm.ell_meta, warm.hybrid_k_eff) == \
        (cold.stair, cold.ell_meta, cold.hybrid_k_eff)
    assert set(warm.dev_arrays) == set(cold.dev_arrays)
    for k, v in cold.dev_arrays.items():
        assert warm.dev_arrays[k].dtype == v.dtype, k
        assert torch.equal(warm.dev_arrays[k], v), k
    # the file holds the reference's host dict, key for key
    ref = object.__new__(jspmm.PreparedSpmm)
    want = ref._prepare_hybrid_build(merged(kind), jspmm.SpmmConfig(**KW))
    with np.load(files[0]) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_prepare_cache_key_is_the_reference_key(cache_dirs, cpu_cached):
    """The reference's prepare writes ``hybrid-<key>.npz`` under its own
    directory; the port writes ``hybrid-torch-<key>.npz``, the same key,
    under its own, and neither touches the other's directory."""
    port, ref = cache_dirs
    rows, cols, vals = make_graph("multigraph")
    jspmm.prepare_spmm(jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N,
                                                  ncols=N),
                       jspmm.SpmmConfig(**KW))
    port_prep("multigraph")
    (ref_file,) = [p.name for p in ref.iterdir()]
    (port_file,) = [p.name for p in port.iterdir()]
    key = tspmm.prepare_cache_key(merged("multigraph"),
                                  tspmm.SpmmConfig(**KW))
    assert ref_file == f"hybrid-{key}.npz"
    assert port_file == f"{tspmm.CACHE_PREFIX}{key}.npz" \
        == f"hybrid-torch-{key}.npz"


def test_cache_key_changes_with_edge_values():
    g = merged("multigraph")
    cfg = tspmm.SpmmConfig(**KW)
    keys = {tspmm.prepare_cache_key(g, cfg)}
    vals = g.vals.copy()
    vals[0] = 2.0  # the first edge is among the hashed (every nnz // 64th)
    keys.add(tspmm.prepare_cache_key(
        tgraph.CooGraph(rows=g.rows, cols=g.cols, vals=vals, nrows=N,
                        ncols=N), cfg))
    keys.add(tspmm.prepare_cache_key(
        tgraph.CooGraph(rows=g.rows, cols=g.cols,
                        vals=g.vals.astype(np.float64), nrows=N, ncols=N),
        cfg))
    keys.add(tspmm.prepare_cache_key(g, tspmm.SpmmConfig(
        **{**KW, "hybrid_core_bytes": KW["hybrid_core_bytes"] * 2})))
    assert len(keys) == 4


def test_cache_directories_never_coincide(monkeypatch):
    monkeypatch.delenv("PYGIM_TPU_TORCH_DATA")
    home = os.path.expanduser("~")
    assert tcache.cache_dir() == Path(home, ".cache", "pygim_tpu_torch")
    assert tcache.cache_dir() != Path(home, ".cache", "pygim_tpu")
    assert tcache.cache_dir() != Path(os.environ["PYGIM_TPU_DATA"])
    monkeypatch.setenv("PYGIM_TPU_DATA", str(tcache.cache_dir()))
    assert tcache.cache_dir() == Path(home, ".cache", "pygim_tpu_torch")


def test_cache_off_and_on_the_card_default(cache_dirs):
    port, _ref = cache_dirs
    assert tspmm.CACHED_DEVICES == ("cuda",)
    prep = port_prep("multigraph")  # on the CPU: no cache
    assert "cache_save" not in prep.prepare_timer.acc
    assert "cache_load" not in prep.prepare_timer.acc
    assert not port.exists()


def test_damaged_prepare_cache_is_rebuilt(cache_dirs, cpu_cached, caplog):
    port, _ref = cache_dirs
    cold = port_prep("multigraph")
    (path,) = port.glob("hybrid-torch-*.npz")
    path.write_bytes(b"not a zip file")
    with caplog.at_level("WARNING", logger="pygim_tpu_torch"):
        again = port_prep("multigraph")
    assert "rebuilding" in caplog.text
    assert "core_fill" in again.prepare_timer.acc
    for k, v in cold.dev_arrays.items():
        assert torch.equal(again.dev_arrays[k], v), k
    with np.load(path) as z:  # written anew
        assert "stair0" in z.files


def test_failed_cache_write_leaves_nothing(tmp_path, monkeypatch,
                                          cpu_cached):
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(blocker / "below"))
    prep = port_prep("multigraph")
    assert "cache_save" in prep.prepare_timer.acc and prep.stair
    assert not tcache.save_npz(blocker / "x.npz", {"a": np.zeros(1)})


def assert_same_dataset(a, b):
    for f in ("x", "y", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a.graph, f), getattr(b.graph, f))
    assert (a.num_classes, a.synthetic, a.graph.nrows) == \
        (b.num_classes, b.synthetic, b.graph.nrows)


@pytest.mark.parametrize("name", ["tiny", "cora"])
def test_dataset_cache_round_trip(name, cache_dirs):
    port, _ref = cache_dirs
    fresh = tdata.load_dataset(name, use_cache=False)
    assert not port.exists()
    first = tdata.load_dataset(name)
    path = port / f"{name}-sim.npz"
    assert path.exists()
    cached = tdata.load_dataset(name)
    assert_same_dataset(first, fresh)
    assert_same_dataset(cached, fresh)
    # the reference's layout: its loader reads the port's file
    assert_same_dataset(jdata._load_cache(name, path), fresh)
    other = tdata.load_dataset(name, root=str(port / "elsewhere"))
    assert (port / "elsewhere" / f"{name}-sim.npz").exists()
    assert_same_dataset(other, fresh)


def test_damaged_dataset_cache_is_synthesized_anew(cache_dirs, caplog):
    port, _ref = cache_dirs
    fresh = tdata.load_dataset("tiny", use_cache=False)
    port.mkdir(parents=True)
    (port / "tiny-sim.npz").write_bytes(b"PK not a zip file")
    with caplog.at_level("WARNING", logger="pygim_tpu_torch"):
        again = tdata.load_dataset("tiny")
    assert "unreadable" in caplog.text
    assert_same_dataset(again, fresh)
    assert_same_dataset(tdata.load_dataset("tiny"), fresh)  # written anew


def test_rmat_names_are_not_cached(cache_dirs):
    port, _ref = cache_dirs
    tdata.load_dataset("rmat-500-2000")
    assert not port.exists()


def test_cached_dataset_loads_metric_acc(cache_dirs):
    """The reference's quirk: a cached load does not restore the metric
    (a cached ogbn-proteins loads with "acc")."""
    port, _ref = cache_dirs
    ds = tdata.load_dataset("tiny", use_cache=False)
    ds.metric = "rocauc"
    tdata._save_cache(ds, port / "tiny-sim.npz")
    assert tdata.load_dataset("tiny").metric == "acc"
    assert jdata._load_cache("tiny", port / "tiny-sim.npz").metric == "acc"


@pytest.mark.parametrize("part_size,part_idx", [(400, 1), (300, 5), (2000, 1)])
def test_cluster_partition_matches_reference(part_size, part_idx):
    t = tdata.cluster_partition(tdata.load_dataset("tiny", use_cache=False),
                                part_size, part_idx)
    j = jdata.cluster_partition(jdata.load_dataset("tiny", use_cache=False),
                                part_size, part_idx)
    assert t.name == j.name
    assert_same_dataset(t, j)


@pytest.mark.parametrize("method", ["rcm", "lp", "metis"])
def test_cluster_partition_methods_raise(method, monkeypatch):
    """Every method gives the reference's part (on (row, col)-ordered
    edges, so both CSR orders agree with or without the reference's
    native planner): ``rcm``, ``lp`` and ``metis`` (the multilevel
    partitioner, refused until ROADMAP.md Queue 1 item 6b; where the
    reference has no native library, both sides take its
    label-propagation packing)."""
    from pygim_tpu_torch.core import native as tnative
    from test_torch_prepare import reference_planner

    def sorted_tiny(mod):
        ds = mod.load_dataset("tiny", use_cache=False)
        return dataclasses.replace(ds, graph=ds.graph.sort_by_row())

    if method == "metis" and not reference_planner():
        monkeypatch.setenv(tnative.NO_NATIVE_ENV, "1")
    assert_same_dataset(
        tdata.cluster_partition(sorted_tiny(tdata), 400, 1, method=method),
        jdata.cluster_partition(sorted_tiny(jdata), 400, 1, method=method))
