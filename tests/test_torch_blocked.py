"""The ``blocked`` backend against the JAX reference: its row-block plan and
padded tables byte for byte, its float and integer products, and the
runners' default configuration, which is the reference's
``SpmmConfig()``: the blocked backend.

Float products: both packages gather, weight and sum each block's rows
in f32, in different orders; within 1e-5 of the sum of |terms|. Integer
payloads on integer weights accumulate in int32 in both: bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import partition as jpart
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.bench import runners
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import partition as tpart
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import GRAPHS, N, by_row_col, make_graph

REL = 1e-5


def csrs(kind, dtype="float32", edges=None):
    """Both packages' CSR of a test graph. ``make_graph`` has loaded the
    reference's native planner (``reference_planner``), or, where none
    can be built, ordered the edges so that the reference's fallback
    gives the port's order."""
    rows, cols, vals = make_graph(kind) if edges is None else edges
    vals = vals.astype(dtype)
    j = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N,
                                   dtype=dtype).to_csr()
    t = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N,
                                   dtype=dtype).to_csr()
    return j, t


@pytest.mark.parametrize("balance", ["nnz", "row"])
@pytest.mark.parametrize("n_blocks", [1, 7, 64])
@pytest.mark.parametrize("kind", GRAPHS)
def test_plan_and_tables_byte_equal(kind, n_blocks, balance):
    assert_plans_equal(*csrs(kind), n_blocks, balance)


@pytest.mark.parametrize("balance", ["nnz", "row"])
@pytest.mark.parametrize("kind", GRAPHS)
def test_plan_matches_reference_without_native(kind, balance, monkeypatch):
    """The reference without its native planner (its NumPy fallback, a
    (row, col) sort) on (row, col)-ordered edges: the same plans and
    tables as the port's."""
    from pygim_tpu.core import native

    edges = by_row_col(*make_graph(kind))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    j, t = csrs(kind, edges=edges)
    assert native.get_lib() is None
    assert_plans_equal(j, t, 7, balance)


def assert_plans_equal(j, t, n_blocks, balance):
    """Row-block plans and ELL block tables of both packages' CSR ``j``,
    ``t``, byte for byte."""
    jp = jpart.make_row_block_plan(j, n_blocks, balance=balance)
    tp = tpart.make_row_block_plan(t, n_blocks, balance=balance)
    np.testing.assert_array_equal(tp.bounds, jp.bounds)
    assert tp.bounds.dtype == jp.bounds.dtype
    assert (tp.rows_pad, tp.nnz_pad, tp.n_blocks) == \
        (jp.rows_pad, jp.nnz_pad, jp.n_blocks)
    np.testing.assert_array_equal(tpart.row_slot_table(tp),
                                  jpart.row_slot_table(jp))
    je, te = jpart.build_ell_blocks(j, jp), tpart.build_ell_blocks(t, tp)
    for f in ("colind", "vals", "rowloc", "row_start"):
        a, b = getattr(te, f), getattr(je, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (te.rows_pad, te.nnz_pad, te.nrows, te.ncols) == \
        (je.rows_pad, je.nnz_pad, je.nrows, je.ncols)


def test_with_padding_grows_only():
    _j, t = csrs("simple")
    p = tpart.make_row_block_plan(t, 5)
    q = tpart.with_padding(p, p.rows_pad + 8, p.nnz_pad + 16)
    assert (q.rows_pad, q.nnz_pad) == (p.rows_pad + 8, p.nnz_pad + 16)
    with pytest.raises(ValueError):
        tpart.with_padding(p, p.rows_pad - 8, p.nnz_pad)


@pytest.mark.parametrize("n_blocks", [None, 3])
@pytest.mark.parametrize("kind", GRAPHS)
def test_device_tables_and_products_match_jax(kind, n_blocks):
    rows, cols, vals = make_graph(kind)
    kw = dict(backend="blocked", n_blocks=n_blocks, block_nnz_budget=4096)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**kw), device="cpu")
    assert tp.rows_pad == jp.rows_pad
    jdev = {k: np.asarray(v) for k, v in jp.dev_arrays.items()}
    assert set(tp.dev_arrays) == set(jdev)
    for k, v in jdev.items():
        got = tp.dev_arrays[k].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, 20)).astype(np.float32)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    assert np.all(np.abs(got - want)
                  <= REL * (dense @ np.abs(x.astype(np.float64))) + 1e-30)
    assert torch.equal(tp.mul_plain(torch.from_numpy(x)), torch.from_numpy(got))


@pytest.mark.parametrize("xdtype", [np.int8, np.int32])
def test_integer_products_match_jax(xdtype):
    """Integer weights and payload: int32 accumulation (wrapping), equal
    bit for bit; the payload at int32's ends so sums wrap."""
    rows, cols, vals = make_graph("multigraph")
    g = dict(nrows=N, ncols=N, dtype="int32")
    vals = vals.astype(np.int32)
    kw = dict(backend="blocked", block_nnz_budget=8192)
    jp = jspmm.prepare_spmm(jgraph.CooGraph.from_edges(rows, cols, vals, **g),
                            jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(tgraph.CooGraph.from_edges(rows, cols, vals, **g),
                            tspmm.SpmmConfig(**kw), device="cpu")
    info = np.iinfo(xdtype)
    x = np.random.default_rng(1).integers(info.min, info.max, (N, 16),
                                          endpoint=True).astype(xdtype)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_float_graph_int32_payload_accumulates_in_f32():
    """A float32 graph with an int32 payload (the unfused quantize round
    trip of the int32 forward): f32, as ``accum_dtype`` of the two."""
    rows, cols, vals = make_graph("wide")
    kw = dict(backend="blocked")
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**kw), device="cpu")
    x = np.random.default_rng(2).integers(-500, 500, (N, 8)).astype(np.int32)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    mag = dense @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(got.numpy() - want) <= REL * mag + 1e-30)


def test_empty_operand_is_zeros():
    g = tgraph.CooGraph.from_edges(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                   np.zeros(0, np.float32), nrows=5, ncols=5)
    tp = tspmm.prepare_spmm(g, tspmm.SpmmConfig(), device="cpu")
    out = tp.mul(torch.ones(5, 3))
    assert torch.equal(out, torch.zeros(5, 3))


def test_runners_default_is_the_reference_default():
    assert runners.default_config() == tspmm.SpmmConfig()
    assert runners.default_config().backend == "blocked"
    assert tspmm.SpmmConfig().backend == jspmm.SpmmConfig().backend


def test_run_spmm_benchmark_default_config(capsys):
    """With ``config=None`` the SpMM runs on the blocked backend and its
    sampled-row check passes."""
    ds = load_dataset("rmat-2000-40000")
    res = runners.run_spmm_benchmark(ds, hidden=16, repeat=1, device="cpu")
    assert res["verify"] == "OK"
    assert "pim_time_spmm(ms)" in res


def test_run_inference_benchmark_default_config():
    """The int32 forward on the default (blocked) operand: the unfused
    quantize round trip, since blocked does not fuse."""
    ds = load_dataset("rmat-2000-40000")
    res = runners.run_inference_benchmark(ds, hidden=16, repeat=1,
                                          device="cpu")
    assert res["infer_time(ms)"] > 0
    prep = tspmm.prepare_spmm(ds.graph, runners.default_config(),
                              device="cpu")
    assert not prep.supports_fused_quant
    assert tspmm.PreparedAggregate(prep).quantized(
        torch.zeros(ds.graph.nrows, 4), "int32") is None
