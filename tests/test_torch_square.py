"""The hybrid's square and stair cores of int8 and int4 cells against the
JAX reference: the host tables byte for byte (the core, its nodes, the
demoted tail), the products and the configurations the port refuses.

Tolerance of the float products: both packages round x to bf16 for the
core and sum exact int × bf16 products in f32 in different orders, so
they differ by at most ~1e-5 of the sum of |terms| (test_torch_spmm.py);
integer payloads are exact and bit-equal."""

import tracemalloc

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import native
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import banded
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import GRAPHS, N, make_graph, reference_planner

REL = 1e-5
SHAPES = ["square", "stair"]
DTYPES = ["int8", "int4"]
# a budget that gives a core of several bands (stair) or a k below N
# (square) at either cell width
BUDGET = {"int8": 256 << 10, "int4": 512 << 10}
# the cases: the budget's core, no core, and a pinned k (odd: an int4
# core drops one rank, and the port pads the stored width to the kernels'
# rule)
CASES = {"budget": None, "no-core": dict(hybrid_core_bytes=0),
         "pinned-k": dict(hybrid_k=601)}


def config_kw(shape, dtype, case):
    kw = dict(backend="hybrid", hybrid_shape=shape, hybrid_dtype=dtype,
              hybrid_core_bytes=BUDGET[dtype])
    return {**kw, **(CASES[case] or {})}


def both_preps(kind, kw):
    rows, cols, vals = make_graph(kind)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**kw), device="cpu")
    return (rows, cols, vals), jp, tp


def stored_core(tp, key, jcore):
    """The port's core table ``key`` as the reference stores it: the port
    appends zero cells to reach the kernels' width rule."""
    got = tp.dev_arrays[key].numpy()
    assert not got[:, jcore.shape[1]:].any()
    return got[:, :jcore.shape[1]]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", GRAPHS)
def test_host_tables_byte_equal(kind, shape, dtype, case):
    _g, jp, tp = both_preps(kind, config_kw(shape, dtype, case))
    assert tp.hybrid_k_eff == jp.hybrid_k_eff
    assert tp.ell_meta == [tuple(m) for m in jp.ell_meta]
    jdev = {k: np.asarray(v) for k, v in jp.dev_arrays.items()}
    assert set(tp.dev_arrays) == set(jdev)
    for k, want in jdev.items():
        got = (stored_core(tp, k, want) if k == "core" or k.startswith("stair")
               else tp.dev_arrays[k].numpy())
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    if case == "no-core":
        assert tp.stair is None and "core_nodes" not in tp.dev_arrays
    elif shape == "stair" and case == "budget":
        assert tp.stair == [tuple(b) for b in jp.stair] and len(tp.stair) > 1
    else:  # a square core: the one band (0, k, w)
        k = tp.hybrid_k_eff
        q = 32 if dtype == "int4" else 16
        assert tp.stair == [(0, k, -(-k // q) * q)]
        cells = jdev["core"].shape[1] * (2 if dtype == "int4" else 1)
        assert cells == k and jdev["core"].shape[0] == k
        assert jdev["core"].dtype == (np.uint8 if dtype == "int4" else np.int8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pinned_k_is_padded_to_the_width_rule(dtype):
    _g, jp, tp = both_preps("multigraph", config_kw("square", dtype,
                                                    "pinned-k"))
    k = jp.hybrid_k_eff
    assert k == (600 if dtype == "int4" else 601)
    w = tp.stair[0][2]
    assert w % (32 if dtype == "int4" else 16) == 0 and w > k
    assert tp.dev_arrays["core"].shape[1] == w // (2 if dtype == "int4" else 1)


def test_stair_band_as_wide_as_the_graph_is_padded():
    """At 1 MiB the int4 stair's first band spans all 2000 columns, which
    misses the int4 width rule (32): the port pads its stored width and
    the product still equals the reference's."""
    kw = dict(config_kw("stair", "int4", "budget"), hybrid_core_bytes=1 << 20)
    (rows, cols, vals), jp, tp = both_preps("multigraph", kw)
    assert jp.stair[0][2] == N
    assert tp.stair == [(*jp.stair[0][:2], 2016), *map(tuple, jp.stair[1:])]
    np.testing.assert_array_equal(tp.dev_arrays["stair0"].numpy()[:, :N // 2],
                                  np.asarray(jp.dev_arrays["stair0"]))
    xi = np.random.default_rng(2).integers(-99, 99, (N, 8)).astype(np.int32)
    np.testing.assert_array_equal(tp.mul(torch.from_numpy(xi)).numpy(),
                                  np.asarray(jp.mul(jnp.asarray(xi))))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", GRAPHS)
def test_products_match_jax(kind, shape, dtype, case):
    """Float payloads within REL of the sum of |terms|; int8, int16 and
    int32 payloads bit-equal (the core's wrapped int32 product and the
    f32 tail, in both packages)."""
    (rows, cols, vals), jp, tp = both_preps(kind, config_kw(shape, dtype,
                                                            case))
    rng = np.random.default_rng(len(kind) + len(case))
    x = rng.standard_normal((N, 24)).astype(np.float32)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    mag = dense @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)
    for dt, m in ((np.int8, 16), (np.int16, 1 << 9), (np.int32, 1 << 19)):
        xi = rng.integers(-m, m + 1, (N, 24)).astype(dt)
        want = np.asarray(jp.mul(jnp.asarray(xi)))
        got = tp.mul(torch.from_numpy(xi)).numpy()
        # the core's int32 product is exact in both; the tail sums in f32,
        # exact below 2^24 on integer weights, else in each package's order
        mag = dense @ np.abs(xi.astype(np.float64))
        exact = (mag < 2 ** 24) if kind != "wide" else np.zeros_like(mag, bool)
        assert exact.any() or kind == "wide"
        np.testing.assert_array_equal(got[exact], want[exact])
        assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_quantized_matches_jax(shape, dtype):
    """The fused int8 aggregate (config 4's) on each core: bit-equal on
    integer weights (|q| <= 16, every sum exact); the int32 one, whose
    tail sums of |q| <= 2^19 pass 2^24 in f32, within REL."""
    (rows, cols, vals), jp, tp = both_preps(
        "multigraph", config_kw(shape, dtype, "budget"))
    x = np.random.default_rng(3).standard_normal((N, 40)).astype(np.float32)
    want = np.asarray(jp.mul_quantized(jnp.asarray(x), "int8"))
    got = tp.mul_quantized(torch.from_numpy(x), "int8").numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jp.mul_quantized(jnp.asarray(x), "int32"))
    got = tp.mul_quantized(torch.from_numpy(x), "int32").numpy()
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    mag = dense @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


def test_wide_graph_demotes_int4_cells():
    """The wide graph's hub cell (300 parallel edges) and its fractional
    weights leave an int4 core; cells in [-8, 7] stay."""
    _g, _jp, tp = both_preps("wide", config_kw("square", "int4", "budget"))
    tail_vals = np.concatenate([
        tp.dev_arrays[k].numpy().ravel() for k in tp.dev_arrays
        if k.startswith("vals2d")])
    assert np.any(tail_vals % 1 != 0) and tail_vals.max() > 7
    cells = torch.cat([(tp.dev_arrays["core"] & 0xF).flatten(),
                       (tp.dev_arrays["core"] >> 4).flatten()])
    assert int(cells.max()) <= 15 and bool((cells > 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [256, 1000, 1998])
def test_core_build_banded_matches_native(dtype, k):
    """``core/banded.py`` against the reference's native planner, with
    bands of a few rows, so several bands and demotions are crossed."""
    if not reference_planner():
        pytest.skip("the reference's native planner cannot be built here")
    rng = np.random.default_rng(k)
    e = 60_000
    rows = rng.integers(0, N, e).astype(np.int32)
    cols = rng.integers(0, N, e).astype(np.int32)
    vals = rng.choice(np.array([1, 1, 1, 0.5, 2, -3, 7, -8, 9, 200],
                               np.float32), e)
    rank = rng.permutation(N).astype(np.int32)
    want = native.core_build_banded(rows, cols, vals, rank, k, dtype)
    got = banded.core_build_banded(rows, cols, vals, rank, k, dtype,
                                   band_bytes=64 * k * 4)
    for name, a, b in zip(("core", "tail_mask", "bad_flat"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2].size > 0


def test_square_build_never_allocates_dense_f32():
    """At k = 12,000 a (k, k) float32 core would be 576 MB; the banded
    build's peak stays near the packed core (72 MB) and its band."""
    k = 12_000
    rng = np.random.default_rng(0)
    e = 200_000
    rows = rng.integers(0, k, e).astype(np.int32)
    cols = rng.integers(0, k, e).astype(np.int32)
    vals = np.ones(e, np.float32)
    rank = np.arange(k, dtype=np.int32)
    tracemalloc.start()
    try:
        core, _mask, _bad = banded.core_build_banded(
            rows, cols, vals, rank, k, "int4", band_bytes=32 << 20)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert core.shape == (k, k // 2)
    assert peak < k * k  # a quarter of the dense f32 core


@pytest.mark.parametrize("over,error", [
    (dict(hybrid_dtype="bfloat16"), None),
    (dict(hybrid_dtype="float32"), None),
    (dict(hybrid_dtype=None), None),
    (dict(hybrid_shape="square", bcsr_bytes=1 << 20), None),
    (dict(hybrid_shape="stair", hybrid_k=512, bcsr_bytes=1 << 20), None),
    (dict(hybrid_shape="diagonal"), NotImplementedError),
], ids=["bf16", "f32", "float-None", "square-bcsr", "pinned-stair-bcsr",
        "unknown-shape"])
def test_check_supported_raises(over, error):
    """The configurations the port still refuses raise; the bf16, f32
    and graph-dtype (None) cores and the BCSR tier on a square build
    (also a stair with a pinned k), refused before their slices, now pass
    (``tests/test_torch_float_cores.py`` and ``test_torch_bcsr.py`` run
    them)."""
    cfg = tspmm.SpmmConfig(**{**config_kw("square", "int8", "budget"),
                              **over})
    if error is None:
        cfg.check_supported()
        return
    with pytest.raises(error):
        cfg.check_supported()


def test_stair_ignores_bcsr_bytes():
    """The stair shape ignores the tile tier (the reference logs it), so
    a budget with ``bcsr_bytes`` still runs."""
    tspmm.SpmmConfig(**config_kw("stair", "int4", "budget"),
                     bcsr_bytes=1 << 20).check_supported()


def test_integer_graph_with_no_core_dtype_raises():
    """The reference turns ``hybrid_dtype=None`` on an integer graph into
    a bf16 core, written back into the operand's config; the port, which
    refused it before it had a bf16 core, does the same, with the
    reference's tables. A float32 core on an integer graph still raises
    the reference's ValueError."""
    rows, cols, vals = make_graph("multigraph")
    kw = dict(nrows=N, ncols=N, dtype="int32")
    g = tgraph.CooGraph.from_edges(rows, cols, vals.astype(np.int32), **kw)
    tp = tspmm.prepare_spmm(g, tspmm.SpmmConfig(backend="hybrid"),
                            device="cpu")
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals.astype(np.int32), **kw),
        jspmm.SpmmConfig(backend="hybrid"))
    assert tp.config.hybrid_dtype == jp.config.hybrid_dtype == "bfloat16"
    assert tp.core_dtype == "bfloat16"
    assert tp.dev_arrays["core"].dtype == torch.bfloat16
    k = jp.hybrid_k_eff
    np.testing.assert_array_equal(
        tp.dev_arrays["core"].view(torch.int16).numpy().view(np.uint16)[:, :k],
        np.asarray(jp.dev_arrays["core"]).view(np.uint16))
    with pytest.raises(ValueError, match="bfloat16, int8 or int4"):
        tspmm.prepare_spmm(g, tspmm.SpmmConfig(backend="hybrid",
                                               hybrid_dtype="float32"),
                           device="cpu")
