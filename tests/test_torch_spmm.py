"""The port's whole hybrid SpMM against the JAX hybrid and a float64
product (CPU: the kernels' plain versions run).

Tolerances, per element, against ``mag = |A| @ |x|`` in float64:
- port vs JAX: both round the core payload to bf16 the same way, so
  only f32 summation order differs: 1e-5 · mag (see
  test_torch_kernels_plain.py);
- either vs the float64 product: the core's bf16 payload errs by
  ≤ 2^-9 relative per term, so 4e-3 · mag (2^-8, with margin for the
  f32 sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import reference as jref
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import reference as tref
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import GRAPHS, KW, N, make_graph


def dense64(rows, cols, vals):
    a = np.zeros((N, N))
    np.add.at(a, (rows, cols), vals.astype(np.float64))
    return a


# 41 and 1100: widths K-core takes padded to a multiple of 8 on the card
@pytest.mark.parametrize("h", [32, 64, 41, 1100])
@pytest.mark.parametrize("kind", GRAPHS)
def test_hybrid_mul_matches_jax_and_float64(kind, h):
    rows, cols, vals = make_graph(kind)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    x = np.random.default_rng(h).standard_normal((N, h)).astype(np.float32)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    plain = tp.mul_plain(torch.from_numpy(x)).numpy()
    a = dense64(rows, cols, vals)
    mag = np.abs(a) @ np.abs(x.astype(np.float64))
    exact = a @ x.astype(np.float64)
    np.testing.assert_array_equal(got, plain)  # CPU: wrappers = plain
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-30)
    assert np.all(np.abs(got - exact) <= 4e-3 * mag + 1e-30)
    assert np.all(np.abs(want - exact) <= 4e-3 * mag + 1e-30)


def test_payload_exact_in_bf16_is_exact():
    """With a bf16-representable payload and small-integer cells the
    product is exact sums of exact terms: only f32 order remains."""
    rows, cols, vals = make_graph("multigraph")
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    x = np.random.default_rng(0).integers(-8, 9, (N, 16)).astype(np.float32)
    got = tp.mul(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, dense64(rows, cols, vals) @ x)


@pytest.mark.parametrize("over", [
    dict(backend="coo"), dict(hybrid_shape="diagonal"),
    dict(hybrid_dtype="bfloat16"), dict(hybrid_dtype="float32"),
    dict(hybrid_dtype=None), dict(hybrid_shape="square", bcsr_bytes=1 << 20),
    dict(hybrid_k=256, bcsr_bytes=1 << 20),
    dict(hybrid_core_bytes=0, bcsr_bytes=1 << 20),
])
def test_unported_configs_raise(over):
    """The configurations the port does not run raise (a shape outside
    square and stair); the bf16, f32 and graph-dtype (None) cores,
    refused until their slice, now prepare with their cells; the ``coo``
    backend and ``bcsr_bytes`` on a square build, refused until theirs,
    prepare and equal the float64 product."""
    rows, cols, vals = make_graph("multigraph")
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    cfg = tspmm.SpmmConfig(**{**KW, **over})
    if set(over) == {"hybrid_dtype"}:
        tp = tspmm.prepare_spmm(g, cfg, device="cpu")
        assert tp.core_dtype == (over["hybrid_dtype"] or "float32")
        assert tp.stair
        return
    if over.get("backend") == "coo" or "bcsr_bytes" in over:
        tp = tspmm.prepare_spmm(g, cfg, device="cpu")
        x = torch.from_numpy(np.random.default_rng(1).integers(
            -8, 9, (N, 16)).astype(np.float32))
        want = dense64(rows, cols, vals) @ x.numpy().astype(np.float64)
        np.testing.assert_allclose(tp.mul(x).numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return
    with pytest.raises(NotImplementedError):
        tspmm.prepare_spmm(g, cfg, device="cpu")


def test_config_defaults_match_reference():
    import dataclasses

    j = {f.name: f.default for f in dataclasses.fields(jspmm.SpmmConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tspmm.SpmmConfig)}
    assert t == j


def test_mul_rejects_other_payloads():
    """A float64 or float16 x and a wrong row count raise; the bfloat16
    and int64 payloads, refused before PR 11, now run
    (``tests/test_torch_float_payloads.py`` holds them to JAX), and so
    does the quantized float passthrough, refused until it was ported:
    the reference's within 1e-5 of its largest magnitude."""
    rows, cols, vals = make_graph("multigraph")
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            tp.mul(torch.zeros(N, 8, dtype=dtype))
    with pytest.raises(ValueError):
        tp.mul(torch.zeros(N - 1, 8))
    assert not tp.mul(torch.zeros(N, 8, dtype=torch.bfloat16)).any()
    assert not tp.mul(torch.zeros(N, 8, dtype=torch.int64)).any()
    x = np.random.default_rng(6).standard_normal((N, 8)).astype(np.float32)
    want = np.asarray(jp.raw_mul_quantized(jnp.asarray(x), jp.dev_arrays,
                                           "bfloat16"))
    got = tspmm.PreparedAggregate(tp).quantized(torch.from_numpy(x),
                                                "bfloat16").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("oracle", ["coo", "coo_chunked", "csr"])
def test_oracles_match_reference(oracle):
    rows, cols, vals = make_graph("multigraph")
    x = np.random.default_rng(2).standard_normal((N, 24)).astype(np.float32)
    if oracle == "csr":
        c = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N).to_csr()
        want = jref.spmm_csr_oracle(jnp.asarray(c.rowptr), jnp.asarray(c.colind),
                                    jnp.asarray(c.vals), jnp.asarray(x), N)
        got = tref.spmm_csr_oracle(torch.from_numpy(c.rowptr),
                                   torch.from_numpy(c.colind),
                                   torch.from_numpy(c.vals),
                                   torch.from_numpy(x), N)
    else:
        ja = [jnp.asarray(a) for a in (rows, cols, vals)]
        ta = [torch.from_numpy(a) for a in (rows, cols, vals)]
        if oracle == "coo":
            want = jref.spmm_coo_oracle(*ja, jnp.asarray(x), N)
            got = tref.spmm_coo_oracle(*ta, torch.from_numpy(x), N)
        else:
            want = jref.spmm_coo_oracle_chunked(*ja, jnp.asarray(x), N, 4096)
            got = tref.spmm_coo_oracle_chunked(*ta, torch.from_numpy(x), N, 4096)
    mag = np.abs(dense64(rows, cols, vals)) @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-5 * mag + 1e-30)


@pytest.mark.parametrize("vdt,xdt,want", [
    (torch.int8, torch.int8, torch.int32), (torch.int64, torch.int8, torch.int64),
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32, torch.float32, torch.float32),
])
def test_accum_dtype_rules(vdt, xdt, want):
    assert tref.accum_dtype(torch.promote_types(vdt, xdt)) == want
