"""The core↔tail interleave (``PYGIM_HYBRID_INTERLEAVE=1``) of the port
against the JAX reference, the twin of ``tests/test_spmm.py``'s
``TestInterleavedHybrid``: the plan tuple ``(slabs, steps, k)`` equal to
the reference's, the rule that skips it, and the interleaved products
against the port's serial ones and against the reference's interleaved
ones.

Tolerances: a float payload within rtol 1e-4 and atol 1e-4 (the
reference test's bar; the cores round x to bf16 and both packages sum in
f32 in their own orders); integer payloads, and the interleaved port
against its serial self, bit-equal (the compact buffer holds ``0 +
core[r]`` exactly, so ``out[r] + buf[r]`` is the serial sum); the fused
int8 aggregate against the reference's within rtol 1e-5, atol 1e-5 (the
reference test's bar)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import spmm as tspmm

ENV = "PYGIM_HYBRID_INTERLEAVE"
N = 800
CORE_DTYPES = [None, "bfloat16", "int8", "int4"]


def zipf_edges(n=N, about_nnz=12000, seed=7):
    """A power-law graph (``tests/test_spmm.py:_zipf_coo``'s shape), unit
    weights, edges in (row, col) order so both CSR builders agree."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.4, n), 400)
    deg = (deg * (about_nnz / deg.sum())).astype(np.int64) + 1
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    o = np.lexsort((cols, rows))
    return rows[o], cols[o], np.ones(rows.size, np.float32)


def config_kw(**kw):
    # a large step budget: few scan steps, so slabs of >= 8 rows at k 128
    base = dict(backend="hybrid", hybrid_k=128, block_nnz_budget=4096)
    return {**base, **kw}


def preps(monkeypatch, on: bool, edges=None, **kw):
    """(reference, port) operands of the zipf graph with the gate ``on``
    or unset."""
    rows, cols, vals = edges if edges is not None else zipf_edges()
    if on:
        monkeypatch.setenv(ENV, "1")
    else:
        monkeypatch.delenv(ENV, raising=False)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**config_kw(**kw)))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**config_kw(**kw)), device="cpu")
    return jp, tp


def as_tuple(plan):
    if plan is None:
        return None
    slabs, steps, k = plan
    return ([int(s) for s in slabs], [int(n) for n in steps], int(k))


def payload(dtype, h=16, seed=1):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.standard_normal((N, h)).astype(np.float32)
    return rng.integers(-100, 101, (N, h)).astype(dtype)


@pytest.mark.parametrize("core_dtype", CORE_DTYPES)
def test_plan_matches_reference(monkeypatch, core_dtype):
    jp, tp = preps(monkeypatch, True, hybrid_dtype=core_dtype)
    assert jp.interleave is not None, "the reference's plan engages here"
    assert tp.interleave == as_tuple(jp.interleave)
    slabs, steps, k = tp.interleave
    assert k == tp.hybrid_k_eff
    assert steps == [c.shape[0] for c, *_ in tp.ell_tables(tp.dev_arrays)]
    assert sum(s * n for s, n in zip(slabs, steps)) >= k
    # the core stays 2-D on the port's side
    assert "core" in tp.dev_arrays


@pytest.mark.parametrize("core_dtype", CORE_DTYPES)
def test_gate_unset_changes_nothing(monkeypatch, core_dtype):
    jp, tp = preps(monkeypatch, False, hybrid_dtype=core_dtype)
    assert getattr(jp, "interleave", None) is None and tp.interleave is None
    monkeypatch.setattr(tp, "_interleaved", None)  # never called
    xn = payload("float32")
    np.testing.assert_allclose(tp.mul(torch.from_numpy(xn)).numpy(),
                               np.asarray(jp.mul(jnp.asarray(xn))),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["tiny-core", "stair", "no-core"])
def test_skip_rule(monkeypatch, case):
    kw = {"tiny-core": dict(hybrid_k=16, block_nnz_budget=64),
          "stair": dict(hybrid_k=None, hybrid_shape="stair",
                        hybrid_dtype="int8", hybrid_core_bytes=64 << 10),
          "no-core": dict(hybrid_k=0)}[case]
    jp, tp = preps(monkeypatch, True, **kw)
    assert getattr(jp, "interleave", None) is None
    assert tp.interleave is None
    if case == "stair":
        assert len(tp.stair) > 1
    x = payload("float32", h=4)
    want = jp.mul(jnp.asarray(x))
    np.testing.assert_allclose(tp.mul(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


# an f32 core (None on this float graph) with a float payload; the integer
# cores and the bf16 core with every payload
PRODUCT_CASES = [(None, "float32")] + [
    (c, x) for c in CORE_DTYPES[1:]
    for x in ("float32", "int8", "int16", "int32")]


@pytest.mark.parametrize("core_dtype,x_dtype", PRODUCT_CASES)
def test_interleaved_matches_serial_and_reference(monkeypatch, core_dtype,
                                                  x_dtype):
    _js, serial = preps(monkeypatch, False, hybrid_dtype=core_dtype)
    jp, tp = preps(monkeypatch, True, hybrid_dtype=core_dtype)
    assert tp.interleave is not None
    xn = payload(x_dtype)
    x = torch.from_numpy(xn)
    calls = []
    real = tp._interleaved
    monkeypatch.setattr(tp, "_interleaved",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tp.mul(x)
    assert calls, "the interleaved schedule ran"
    assert torch.equal(got, serial.mul(x))
    want = np.asarray(jp.mul(jnp.asarray(xn)))
    if x_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("agg", ["int8", "int16"])
def test_fused_table_path(monkeypatch, agg):
    _js, serial = preps(monkeypatch, False, hybrid_dtype="int8")
    jp, tp = preps(monkeypatch, True, hybrid_dtype="int8")
    xn = payload("float32", h=8)
    x = torch.from_numpy(xn)
    calls = []
    real = tp._interleaved
    monkeypatch.setattr(tp, "_interleaved",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tp.mul_quantized(x, agg)
    assert calls, "the fused table path interleaves"
    assert torch.equal(got, serial.mul_quantized(x, agg))
    want = np.asarray(jp.mul_quantized(jnp.asarray(xn), agg))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("core_dtype", ["int8", "int4"])
def test_int32_path_stays_serial(monkeypatch, core_dtype):
    _js, serial = preps(monkeypatch, False, hybrid_dtype=core_dtype)
    jp, tp = preps(monkeypatch, True, hybrid_dtype=core_dtype)
    assert tp.interleave is not None

    def refuse(*_a, **_k):
        raise AssertionError("the int32 quantized path interleaved")

    monkeypatch.setattr(tp, "_interleaved", refuse)
    xn = payload("float32", h=8)
    x = torch.from_numpy(xn)
    got = tp.mul_quantized(x, "int32")
    assert torch.equal(got, serial.mul_quantized(x, "int32"))
    want = np.asarray(jp.mul_quantized(jnp.asarray(xn), "int32"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_stays_serial(monkeypatch):
    _jp, tp = preps(monkeypatch, True, hybrid_dtype="int8")
    monkeypatch.setattr(tp, "_interleaved", None)  # never called
    x = torch.from_numpy(payload("int8"))
    assert torch.equal(tp.mul_plain(x), tp.mul_plain(x))


@pytest.mark.parametrize("core_dtype", ["int8", "bfloat16"])
def test_transpose_follows_rule(monkeypatch, core_dtype):
    rows, cols, vals = zipf_edges()
    t_edges = (cols, rows, vals)
    o = np.lexsort((t_edges[1], t_edges[0]))
    t_edges = tuple(a[o] for a in t_edges)
    jt, _tt = preps(monkeypatch, True, edges=t_edges, hybrid_dtype=core_dtype)
    _jp, tp = preps(monkeypatch, True, hybrid_dtype=core_dtype)
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    tt = tp.transpose(g)
    assert tt.interleave == as_tuple(jt.interleave)
    x = torch.from_numpy(payload("float32"))
    np.testing.assert_allclose(tt.mul(x).numpy(),
                               tt.mul_plain(x).numpy(), rtol=0, atol=0)


def test_interleave_beside_bcsr_tier(monkeypatch):
    """A square core with a BCSR tier: the tier runs after the join, as
    the reference's hybrid run adds it after the interleaved tail and
    core."""
    rng = np.random.default_rng(9)
    n, blk, deg = N, 100, 12
    rows = np.repeat(np.arange(n), deg)
    cols = (rows // blk) * blk + rng.integers(0, blk, rows.size)
    o = np.lexsort((cols, rows))
    edges = (rows[o], cols[o], np.ones(rows.size, np.float32))
    kw = dict(hybrid_dtype="int8", bcsr_bytes=8 << 20, bcsr_tile=8,
              bcsr_min_edges=2)
    _js, serial = preps(monkeypatch, False, edges=edges, **kw)
    jp, tp = preps(monkeypatch, True, edges=edges, **kw)
    assert tp.has_bcsr and tp.interleave == as_tuple(jp.interleave)
    for xn in (payload("float32"), payload("int16")):
        x = torch.from_numpy(xn)
        got = tp.mul(x)
        assert torch.equal(got, serial.mul(x))
        want = np.asarray(jp.mul(jnp.asarray(xn)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
