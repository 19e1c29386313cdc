"""The halo layout of the port against the JAX reference, the twin of
``tests/test_halo.py``: the reference's ``prepare_spmm_halo`` on the
conftest's 8-device virtual CPU mesh beside the port's on ``["cpu"] *
nd``, inputs made from a seed with numpy.

Each case holds the port's host tables byte for byte to the reference's
(ELL tables, send tables, slabs, hub rows, BCSR, orders) and its
product to a float64 dense product, to its own plain version (equal) and,
where named, to the reference's product. Tolerances are the reference
tests' own: rtol 1e-4, atol 1e-4 for a float payload on the ell backend
and on f32 slabs (both packages sum in f32, in other orders); rtol 3e-2,
atol 4e-1 against the dense product where a float payload goes through a
bf16, int8 or int4 slab (x rounded to bf16, ``test_halo.py``'s
``test_reduced_precision_cores``), and there rtol 1e-4, atol 1e-4
against the reference, which rounds the same way; integer payloads
bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.parallel.halo import make_node_mesh as jmake_node_mesh
from pygim_tpu.parallel.halo import prepare_spmm_halo as jprepare_halo
from pygim_tpu_torch import compat as tcompat
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.parallel import (
    PreparedSpmmHalo,
    make_node_mesh,
    prepare_spmm_halo,
)
from pygim_tpu_torch.parallel.collectives import all_gather, all_to_all, ppermute

from pygim_tpu_torch.core import native as tnative

from test_torch_mesh import community_edges, dense, graphs, random_edges
from test_torch_prepare import reference_planner

EXCHANGES = ["all_gather", "all_to_all", "ring"]
NDS = [1, 2, 4, 8]
LOOSE = dict(rtol=3e-2, atol=4e-1)
TIGHT = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def same_partitioner(monkeypatch):
    """Whether the reference's native planner is loaded: without it the
    reference's ``partition_kway`` takes the label-propagation packing, so
    the port takes it too, and its CSR rows keep (row, col) order, where
    the port keeps the relabelled graph's input order (its tables then
    agree in everything but the order of a row's entries)."""
    if reference_planner():
        return True
    monkeypatch.setenv(tnative.NO_NATIVE_ENV, "1")
    return False


def same_order(jp, tp):
    """The resolved orders are the reference's."""
    assert tp.order_choice == jp.order_choice
    for k in ("order", "inv_order"):
        assert (k in tp.host_arrays) == (k in jp.dev_arrays)
        if k in tp.host_arrays:
            np.testing.assert_array_equal(tp.host_arrays[k],
                                          np.asarray(jp.dev_arrays[k]))


def both(edges, nd, exchange, order=None, dtype="float32", **kw):
    """(reference, port) halo operands of ``edges`` over ``nd`` shards."""
    jg, tg = graphs(edges, dtype)
    jp = jprepare_halo(jg, jmake_node_mesh(nd), jspmm.SpmmConfig(**kw),
                       exchange=exchange, order=order)
    tp = prepare_spmm_halo(tg, make_node_mesh(nd, ["cpu"] * nd),
                           tspmm.SpmmConfig(**kw), exchange=exchange,
                           order=order)
    return jp, tp


def host_equal(jp, tp):
    """The port's host tables are the reference's, byte for byte, and so
    are its plan's numbers."""
    jdev = {k: np.asarray(v) for k, v in jp.dev_arrays.items()}
    assert set(tp.host_arrays) == set(jdev)
    for k, want in jdev.items():
        got = tp.host_arrays[k]
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for a in ("halo_k", "request_rows", "hybrid_k_eff", "has_bcsr",
              "n_pad", "rows_per_dev", "order_choice", "ell_degree",
              "row_chunk"):
        assert getattr(tp, a) == getattr(jp, a), a
    for a in ("ell_meta", "_local_meta", "_halo_meta", "ring_ks"):
        if hasattr(jp, a):
            assert getattr(tp, a) == [tuple(m) if isinstance(m, tuple)
                                      else m for m in getattr(jp, a)], a
    if jp.has_bcsr:
        assert (tp.bcsr_edges, tp.bcsr_step) == (jp.bcsr_edges, jp.bcsr_step)


def products(tp, x, jp=None):
    """The port's product, held equal to its plain version, and the
    reference's (None without ``jp``)."""
    got = tp.mul(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],
                                                        x.shape[1])
    assert torch.equal(tp.mul_plain(torch.from_numpy(x)), got)
    want = None if jp is None else np.asarray(jp.mul(jnp.asarray(x)))
    return got.numpy(), want


def payload(n, h, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-4, 5, (n, h)).astype(dtype)
    return rng.standard_normal((n, h)).astype(dtype)


def hub_edges(seed, n=200, integer=False):
    """``test_halo.py``'s hub graph: 4000 edges among 24 hubs and 1200
    random ones, duplicates kept (the operands merge them)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, 24, 4000), rng.integers(0, n, 1200)])
    cols = np.concatenate([rng.integers(0, 24, 4000), rng.integers(0, n, 1200)])
    o = np.lexsort((cols, rows))
    vals = (np.ones(rows.size) if integer
            else rng.standard_normal(rows.size))
    return rows[o], cols[o], vals, n, n


@pytest.mark.parametrize("nd", NDS)
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_ell_matches_reference(exchange, nd):
    """Uneven rows (197 over nd shards): tables equal, products against
    the dense product, and at nd 4 against the reference's."""
    edges = random_edges(197, 197, 3000, seed=nd)
    x = payload(197, 24, 1)
    jp, tp = both(edges, nd, exchange, n_blocks=3)
    host_equal(jp, tp)
    got, want = products(tp, x, jp if nd == 4 else None)
    np.testing.assert_allclose(got, dense(edges, x), **TIGHT)
    if want is not None:
        np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("core_dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_hybrid_matches_reference(exchange, core_dtype):
    """The row-sharded hub slab of each cell type on every exchange, an
    out-of-range cell (40 parallel hub edges) demoted to the tail on the
    integer slabs; against the reference on all_to_all for every cell
    type."""
    rows, cols, vals, n, m = hub_edges(2, integer=core_dtype != "float32")
    edges = (np.r_[rows, np.zeros(40, int)], np.r_[cols, np.ones(40, int)],
             np.r_[vals, np.ones(40)], n, m)
    o = np.lexsort((edges[1], edges[0]))
    edges = (edges[0][o], edges[1][o], edges[2][o], n, m)
    x = payload(n, 16, 3)
    jp, tp = both(edges, 4, exchange, backend="hybrid", hybrid_k=24,
                  hybrid_dtype=None if core_dtype == "float32" else core_dtype)
    host_equal(jp, tp)
    assert tp.hybrid_k_eff == 24
    got, want = products(tp, x, jp if exchange == "all_to_all" else None)
    bar = TIGHT if core_dtype == "float32" else LOOSE
    np.testing.assert_allclose(got, dense(edges, x), **bar)
    if want is not None:
        np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("xdt", [np.int8, np.int32])
@pytest.mark.parametrize("core", ["int8", "int4"])
def test_integer_payload_exact(core, xdt):
    """Integer payloads stay exact through the local and halo tables, the
    integer slab (K-int's product) and the tile tier."""
    rows, cols, vals, n, m = hub_edges(4, integer=True)
    x = payload(n, 8, 5, xdt)
    jp, tp = both((rows, cols, vals, n, m), 4, "all_to_all",
                  backend="hybrid", hybrid_k=12, hybrid_dtype=core,
                  bcsr_bytes=1 << 20, bcsr_tile=8, bcsr_min_edges=2)
    host_equal(jp, tp)
    against = core == "int8" and xdt == np.int32
    got, want = products(tp, x, jp if against else None)
    np.testing.assert_array_equal(got, dense((rows, cols, vals, n, m), x))
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_int32_graph_int32_payload():
    edges = random_edges(96, 96, 800, seed=6, integer=True)
    x = payload(96, 16, 7, np.int32)
    jp, tp = both(edges, 4, "all_gather", dtype="int32")
    host_equal(jp, tp)
    got, want = products(tp, x, jp)
    np.testing.assert_array_equal(got, dense(edges, x))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", ["none", "rcm", "lp", "metis", "auto",
                                   "array"])
def test_orders(order, same_partitioner):
    """Every order on the ring, a scrambled community graph (metis and
    auto's choice cut it): the order arrays equal, the tables too (with
    the reference's planner), the product in the original order."""
    edges = community_edges(8, n=256, blk=64, deg=8, shuffle=True)
    arg = (np.random.default_rng(9).permutation(256) if order == "array"
           else None if order == "none" else order)
    x = payload(256, 8, 10)
    jp, tp = both(edges, 4, "ring", order=arg, n_blocks=2)
    same_order(jp, tp)
    if same_partitioner:
        host_equal(jp, tp)
    if order == "auto":
        assert tp.order_choice == "metis"
    got, _ = products(tp, x)
    np.testing.assert_allclose(got, dense(edges, x), **TIGHT)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_bcsr_tier(exchange):
    """The in-band tile tier on a community graph, with a hub slab, the
    lp tile order on the ring."""
    edges = community_edges(11, n=512, blk=128, deg=12)
    x = payload(512, 24, 12)
    kw = dict(backend="hybrid", hybrid_k=32, bcsr_bytes=8 << 20, bcsr_tile=8,
              bcsr_min_edges=2)
    if exchange == "ring":
        kw["bcsr_order"] = "lp"
    jp, tp = both(edges, 4, exchange, **kw)
    host_equal(jp, tp)
    assert tp.has_bcsr and tp.bcsr_edges > 0
    got, want = products(tp, x, jp if exchange == "all_gather" else None)
    np.testing.assert_allclose(got, dense(edges, x), **TIGHT)
    if want is not None:
        np.testing.assert_allclose(got, want, **TIGHT)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_trailing_empty_shards(exchange):
    """Six nodes over four shards: the last owns no row; a hub core on
    two hubs leaves two shards without a slab row."""
    edges = random_edges(6, 6, 20, seed=13)
    x = payload(6, 8, 14)
    for kw in (dict(n_blocks=1), dict(backend="hybrid", hybrid_k=2)):
        jp, tp = both(edges, 4, exchange, **kw)
        host_equal(jp, tp)
        got, _ = products(tp, x)
        np.testing.assert_allclose(got, dense(edges, x), **TIGHT)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_multi_degree_tables(exchange):
    """A zipf-degree graph splits the local and halo tables into several
    degrees."""
    rng = np.random.default_rng(15)
    n = 600
    deg = np.minimum(rng.zipf(1.4, n), 300)
    deg = (deg * (9000 / deg.sum())).astype(np.int64) + 1
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    o = np.lexsort((cols, rows))
    edges = (rows[o], cols[o], np.ones(rows.size), n, n)
    x = payload(n, 16, 16)
    jp, tp = both(edges, 4, exchange, block_nnz_budget=512)
    host_equal(jp, tp)
    metas = ([tp.ell_meta] if exchange == "all_gather"
             else [tp._local_meta, tp._halo_meta])
    assert any(len(m) >= 2 for m in metas)
    got, _ = products(tp, x)
    np.testing.assert_allclose(got, dense(edges, x), **TIGHT)


def test_block_diagonal_small_halo():
    """No cross edges: empty requests, halo_k stays 8, shards without halo
    edges."""
    rng = np.random.default_rng(17)
    rows = np.concatenate([rng.integers(d * 50, d * 50 + 50, 200)
                           for d in range(4)])
    cols = np.concatenate([rng.integers(d * 50, d * 50 + 50, 200)
                           for d in range(4)])
    o = np.lexsort((cols, rows))
    edges = (rows[o], cols[o], np.ones(800), 200, 200)
    jp, tp = both(edges, 4, "all_to_all", n_blocks=2)
    host_equal(jp, tp)
    assert tp.halo_k <= 8 and tp.request_rows == 0
    got, _ = products(tp, payload(200, 8, 18))
    np.testing.assert_allclose(got, dense(edges, payload(200, 8, 18)), **TIGHT)


def test_raw_mul_two_layers_with_order():
    """raw_mul on the operand's tables composes a two-layer forward in the
    original order (``test_halo.py``'s raw-mul case)."""
    edges = random_edges(128, 128, 900, seed=19)
    jg, tg = graphs(edges)
    tp = prepare_spmm_halo(tg, make_node_mesh(4, ["cpu"] * 4),
                           tspmm.SpmmConfig(n_blocks=1), exchange="ring",
                           order="rcm")
    dev = tp.dev_arrays
    assert "order" in dev and "inv_order" in dev
    x = payload(128, 8, 20)
    got = tp.raw_mul(torch.relu(tp.raw_mul(torch.from_numpy(x), dev)), dev)
    rows, cols, vals, n, m = edges
    a = np.zeros((n, m))
    np.add.at(a, (rows, cols), vals)
    np.testing.assert_allclose(got.numpy(), a @ np.maximum(a @ x, 0),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_phase_times_keys(exchange):
    """phase_times' keys are the reference's for each exchange and tier
    set (``pygim_tpu/parallel/halo.py:846-950``)."""
    edges = community_edges(21, n=256, blk=64, deg=8)
    tp = prepare_spmm_halo(
        graphs(edges)[1], make_node_mesh(4, ["cpu"] * 4),
        tspmm.SpmmConfig(backend="hybrid", hybrid_k=16, bcsr_bytes=1 << 20,
                         bcsr_tile=8, bcsr_min_edges=2), exchange=exchange)
    assert tp.has_bcsr
    ph = tp.phase_times(torch.from_numpy(payload(256, 8, 22)), iters=1)
    want = {"mul_time(ms)", "local_time(ms)", "exchange_time(ms)"}
    if exchange != "all_gather":
        want |= {"core_time(ms)", "bcsr_time(ms)"}
    assert set(ph) == want and all(v >= 0 for v in ph.values())


@pytest.mark.parametrize("exchange", ["all_to_all", "ring"])
def test_phase_times_local_runs_no_exchange(exchange, monkeypatch):
    """``local_time`` times the local ELL tables on ``x_loc`` alone, as the
    reference's ``local_only`` (``pygim_tpu/parallel/halo.py:866-891``):
    no exchange runs under it, and no halo table; the core's part runs
    only its hub all_gather, the tier's none. The local-only product is
    A's same-shard edges times x."""
    from pygim_tpu_torch.parallel import halo as thalo

    edges = community_edges(21, n=256, blk=64, deg=8)
    tp = prepare_spmm_halo(
        graphs(edges)[1], make_node_mesh(4, ["cpu"] * 4),
        tspmm.SpmmConfig(backend="hybrid", hybrid_k=16, bcsr_bytes=1 << 20,
                         bcsr_tile=8, bcsr_min_edges=2), exchange=exchange)
    assert tp.hybrid_k_eff and tp.has_bcsr
    calls = []
    for name in ("all_gather", "all_to_all", "ppermute"):
        real = getattr(thalo, name)
        monkeypatch.setattr(thalo, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    timed = []

    def fake_device_time(fn, *args, iters=1):
        del calls[:]
        fn(*args)
        timed.append(sorted(set(calls)))
        return 1e-3

    monkeypatch.setattr(thalo, "device_time", fake_device_time)
    ph = tp.phase_times(torch.from_numpy(payload(256, 8, 22)), iters=1)
    ring = "ppermute" if exchange == "ring" else "all_to_all"
    # mul, local, core, bcsr
    assert timed == [["all_gather", ring], [], ["all_gather"], []]
    assert set(ph) == {"mul_time(ms)", "local_time(ms)", "core_time(ms)",
                       "bcsr_time(ms)", "exchange_time(ms)"}

    edges = random_edges(256, 256, 2000, seed=30)
    tp = prepare_spmm_halo(graphs(edges)[1], make_node_mesh(4, ["cpu"] * 4),
                           tspmm.SpmmConfig(n_blocks=2), exchange=exchange)
    x = payload(256, 8, 23)
    x_loc = tp._x_loc(torch.from_numpy(x), tp.dev_arrays)
    del calls[:]
    got = torch.cat(tp._shards(x_loc, tp.dev_arrays, parts=("local",)))
    assert calls == []
    rows, cols, vals, n, m = edges
    same = rows // tp.rows_per_dev == cols // tp.rows_per_dev
    assert 0 < same.sum() < same.size
    want = dense((rows[same], cols[same], vals[same], n, m), x)
    np.testing.assert_allclose(got.numpy()[:n], want, **TIGHT)


def test_transpose_tables_match_reference(same_partitioner):
    """Aᵀ in A's resolved order, exchange and config: its tables are the
    reference's prepare of the transposed graph in that order."""
    edges = community_edges(23, n=256, blk=64, deg=8, shuffle=True)
    rows, cols, vals, n, m = edges
    kw = dict(backend="hybrid", hybrid_k=16, hybrid_dtype="int8")
    jg, tg = graphs(edges)
    tp = prepare_spmm_halo(tg, make_node_mesh(4, ["cpu"] * 4),
                           tspmm.SpmmConfig(**kw), exchange="ring",
                           order="auto")
    with pytest.raises(ValueError, match="not prepared"):
        tp.transpose()
    tt = tp.transpose(tg)
    assert tp.transpose() is tt and tt.exchange == "ring"
    np.testing.assert_array_equal(tt.order, tp.order)
    o = np.lexsort((rows, cols))
    jt = jgraph.CooGraph.from_edges(cols[o], rows[o], vals[o], nrows=m,
                                    ncols=n)
    jp = jprepare_halo(jt, jmake_node_mesh(4), jspmm.SpmmConfig(**kw),
                       exchange="ring", order=tp.order)
    same_order(jp, tt)
    if same_partitioner:
        host_equal(jp, tt)
    x = payload(256, 8, 24)
    got = tt.mul(torch.from_numpy(x)).numpy()
    a = np.zeros((n, m))
    np.add.at(a, (rows, cols), vals)
    np.testing.assert_allclose(got, a.T @ x.astype(np.float64), **LOOSE)


def test_merge_duplicates_off():
    rng = np.random.default_rng(25)
    n = 100
    rows, cols = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    o = np.lexsort((cols, rows))
    edges = (rows[o], cols[o], rng.standard_normal(1500), n, n)
    jp, tp = both(edges, 4, "all_to_all", backend="hybrid", hybrid_k=24,
                  merge_duplicates=False)
    host_equal(jp, tp)
    got, _ = products(tp, payload(n, 8, 26))
    np.testing.assert_allclose(got, dense(edges, payload(n, 8, 26)), **TIGHT)


def test_refusals_match_reference():
    edges = random_edges(50, 40, 100, seed=27)
    jg, tg = graphs(edges)
    with pytest.raises(ValueError, match="square"):
        jprepare_halo(jg, jmake_node_mesh(2))
    with pytest.raises(ValueError, match="square"):
        prepare_spmm_halo(tg, make_node_mesh(2, ["cpu"] * 2))
    with pytest.raises(ValueError, match="unknown exchange"):
        prepare_spmm_halo(tg, make_node_mesh(2, ["cpu"] * 2),
                          exchange="bogus")
    sq = graphs(random_edges(40, 40, 100, seed=28))[1]
    tp = prepare_spmm_halo(sq, make_node_mesh(2, ["cpu"] * 2))
    with pytest.raises(ValueError, match="x shape"):
        tp.mul(torch.zeros(39, 4))
    with pytest.raises(TypeError, match="payload"):
        tp.mul(torch.zeros(40, 4, dtype=torch.float64))


def test_make_node_mesh(monkeypatch):
    mesh = make_node_mesh(4, ["cpu"] * 8)
    assert mesh.shape == {"nodes": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4
    # fewer devices than asked: a smaller mesh, as the reference's slice
    assert make_node_mesh(8, ["cpu"] * 3).shape == {"nodes": 3}
    assert jmake_node_mesh(16).shape["nodes"] == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="at least one device"):
        make_node_mesh(2)


def test_compat_describes_halo():
    tp = prepare_spmm_halo(graphs(random_edges(64, 64, 300, seed=29))[1],
                           make_node_mesh(4, ["cpu"] * 4))
    assert isinstance(tp, PreparedSpmmHalo)
    assert tcompat.describe_layout(tp) == "halo nd=4"
    assert tp.supports_fused_quant is False
    assert tspmm.PreparedAggregate(tp).quantized(
        torch.zeros(64, 4), "int32") is None
    assert tp.device_bytes > 0


def test_collectives_layouts():
    """The three exchanges in the reference's buffer layouts."""
    g = torch.Generator().manual_seed(0)
    devs = ["cpu"] * 4
    parts = [torch.randn(3, 2, generator=g) for _ in range(4)]
    for got in all_gather(parts, devs):
        assert torch.equal(got, torch.cat(parts))
    send = [torch.randn(4, 5, 2, generator=g) for _ in range(4)]
    recv = all_to_all(send, devs)
    for d in range(4):
        assert torch.equal(recv[d], torch.cat([send[p][d] for p in range(4)]))
    for s in (1, 3):
        got = ppermute(parts, s, devs)
        for j in range(4):
            assert torch.equal(got[(j + s) % 4], parts[j])
