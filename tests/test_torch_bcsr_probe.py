"""``tune/bcsr_probe.py`` against the JAX package's: the sampled tile
probe and the tier statistics it prices, key for key, for the rank, rcm
and lp orders (twin of tests/test_tune.py:604-631)."""

import numpy as np
import pytest

from pygim_tpu.core import graph as jgraph
from pygim_tpu.tune import bcsr_probe as jprobe
from pygim_tpu_torch.core import bcsr as tbcsr
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.tune import bcsr_probe as tprobe


def block_graph(n=4096, blk=128, deg=16, shuffle=False, seed=0):
    """128-node communities, exactly regular degree (the reference's
    ``_block_graph``); ``shuffle`` relabels the nodes."""
    rows = np.repeat(np.arange(n), deg)
    cols = (rows // blk) * blk + (
        rows % blk + np.tile(np.arange(1, deg + 1), n)) % blk
    if shuffle:
        relabel = np.random.default_rng(seed).permutation(n)
        rows, cols = relabel[rows], relabel[cols]
    return rows, cols, n


def csr_pair(rows, cols, n):
    return (jgraph.CooGraph.from_edges(rows, cols, nrows=n, ncols=n).to_csr(),
            tgraph.CooGraph.from_edges(rows, cols, nrows=n, ncols=n).to_csr())


def degree_rank(csr):
    n = csr.nrows
    rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.rowptr))
    deg = np.bincount(rows_of, minlength=n) + np.bincount(csr.colind,
                                                          minlength=n)
    order = np.argsort(-deg, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    return rank, rows_of


def equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("sample", [False, True])
@pytest.mark.parametrize("k", [0, 256])
@pytest.mark.parametrize("order", ["rank", "rcm", "lp"])
def test_bcsr_statistics_match_reference(order, k, sample, monkeypatch):
    """Equal key for key, at stride 1 and with the tail stride-sampled
    (the sample target cut to a few thousand edges)."""
    if sample:
        for mod in (jprobe, tprobe):
            monkeypatch.setattr(mod, "_SAMPLE_TARGET", 5000)
    rows, cols, n = block_graph(shuffle=True)
    jcsr, tcsr = csr_pair(rows, cols, n)
    rank, rows_of = degree_rank(tcsr)
    for budget in (256 << 10, 4 << 20):
        kw = dict(tile_rows=32, order=order, budget_bytes=budget, hidden=64)
        want = jprobe.bcsr_statistics(jcsr, rank, rows_of, k, **kw)
        got = tprobe.bcsr_statistics(tcsr, rank, rows_of, k, **kw)
        equal(got, want)
        assert got["tail_edges"] > 0
    probe_w = jprobe.probe_tile_counts(jcsr, rank, rows_of, k, 16, order)
    probe_g = tprobe.probe_tile_counts(tcsr, rank, rows_of, k, 16, order)
    equal(probe_g, probe_w)
    assert (probe_g["stride"] > 1) == sample
    for cut in (0, 3, 40):
        equal(tprobe.select_tiles(probe_g, tile_rows=16, budget_bytes=1 << 20,
                                  hidden=64, min_edges=cut),
              jprobe.select_tiles(probe_w, tile_rows=16, budget_bytes=1 << 20,
                                  hidden=64, min_edges=cut))


def test_probe_exact_matches_builder():
    """At stride 1 in the rank order, the probe's selection is the
    builder's: captured edges and slots equal build_bcsr_tiles'."""
    rows, cols, n = block_graph()
    _jcsr, csr = csr_pair(rows, cols, n)
    rank = np.arange(n, dtype=np.int64)
    rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.rowptr))
    est = tprobe.bcsr_statistics(csr, rank, rows_of, 0, tile_rows=32,
                                 order="rank", budget_bytes=4 << 20,
                                 hidden=64)
    bc, in_tile = tbcsr.build_bcsr_tiles(
        rows_of, csr.colind.astype(np.int64), csr.vals.astype(np.float32),
        rank, n=n, tile_rows=32, budget_bytes=4 << 20, hidden=64)
    assert est["captured_edges"] == bc.n_edges == int(in_tile.sum())
    assert est["slots"] == bc.tiles.shape[0] * bc.tiles.shape[1]


def test_empty_tail():
    rows, cols, n = block_graph(n=512)
    _jcsr, csr = csr_pair(rows, cols, n)
    rank, rows_of = degree_rank(csr)
    got = tprobe.bcsr_statistics(csr, rank, rows_of, n, tile_rows=16,
                                 order="rcm", budget_bytes=1 << 20,
                                 hidden=64)
    assert got["n_tiles"] == 0 and got["tail_edges"] == 0
