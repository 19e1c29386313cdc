"""The port's ``ell`` and ``oracle`` backends, float64 edge values, a
2-layer int32 GCN on every backend and ``phase_times``, against the JAX
package on the same numpy inputs (CPU: the kernels' plain versions run).

Tolerances. The ell backend sums f32 terms in another order than the
reference's grouped scan: 1e-5 of each element's sum of |terms| (the bar
of test_torch_spmm.py). Where the weights are integers and every sum
stays under 2^24, every f32 sum is exact in any order, so the quantized
products are held bit-equal, as test_torch_quant_spmm.py does. The
oracle sums in f32 with ``index_add_`` where JAX uses ``segment_sum``:
1e-5 of the sum of |terms|; integer payloads on integer weights are
exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.nn.layers import quantized_aggregate
from pygim_tpu_torch.nn.models import GNN, params_from_jax
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.quant import symmetric_dequantize, symmetric_quantize

from test_torch_prepare import GRAPHS, KW, N, make_graph
from test_torch_quant_spmm import small_features

REL = 1e-5
QDTYPES = ["int8", "int16", "int32"]


def dense_abs(rows, cols, vals, n=N):
    a = np.zeros((n, n))
    np.add.at(a, (rows, cols), np.abs(vals.astype(np.float64)))
    return a


def both(kind, dtype="float32", **cfg):
    """The JAX and the port operand of graph ``kind`` under ``cfg``."""
    rows, cols, vals = make_graph(kind)
    vals = vals.astype(dtype)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N,
                                   dtype=dtype), jspmm.SpmmConfig(**cfg))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N,
                                   dtype=dtype), tspmm.SpmmConfig(**cfg),
        device="cpu")
    return (rows, cols, vals), jp, tp


def close(got, want, mag):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= REL * mag + 1e-30), float((err - REL * mag).max())


@pytest.mark.parametrize("h", [16, 41])
@pytest.mark.parametrize("kind", GRAPHS)
def test_ell_mul_matches_jax(kind, h):
    (rows, cols, vals), jp, tp = both(kind, backend="ell")
    assert tp.ell_meta == jp.ell_meta
    assert tp.stair is None and set(tp.dev_arrays) == set(jp.dev_arrays)
    for k, v in jp.dev_arrays.items():
        np.testing.assert_array_equal(tp.dev_arrays[k].numpy(), np.asarray(v))
    x = np.random.default_rng(h).standard_normal((N, h)).astype(np.float32)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x))
    assert torch.equal(got, tp.mul_plain(torch.from_numpy(x)))
    close(got.numpy(), want, dense_abs(rows, cols, vals) @ np.abs(x))


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("kind", GRAPHS)
def test_ell_mul_quantized_matches_jax(kind, dtype):
    """Integer weights: bit-equal to JAX (the integer sums are exact, so
    the dequantized outputs are the same f32 products); fractional
    weights (``wide``): f32 order only."""
    (rows, cols, vals), jp, tp = both(kind, backend="ell")
    x = small_features(len(kind))
    want = np.asarray(jp.mul_quantized(jnp.asarray(x), dtype))
    got = tp.mul_quantized(torch.from_numpy(x), dtype)
    assert torch.equal(got, tp.mul_quantized_plain(torch.from_numpy(x), dtype))
    agg = tspmm.PreparedAggregate(tp).quantized(torch.from_numpy(x), dtype)
    assert torch.equal(agg, got)
    if kind != "wide":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        scale, q = symmetric_quantize(torch.from_numpy(x), dtype)
        mag = dense_abs(rows, cols, vals) @ np.abs(q.numpy().astype(np.float64))
        close(got.numpy(), want, mag * float(scale))


@pytest.mark.parametrize("dtype", QDTYPES)
def test_ell_integer_payload_matches_jax(dtype):
    """An integer x on an integer-valued graph: the reference accumulates
    in int32, the port in f32 (K-tail's weights are f32); below 2^24 the
    values are equal."""
    (_r, _c, _v), jp, tp = both("multigraph", dtype="int32", backend="ell")
    x = np.random.default_rng(3).integers(-10, 11, (N, 24)).astype(dtype)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_ell_takes_a_csr_graph():
    rows, cols, vals = make_graph("simple")
    csr = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N,
                                     ncols=N).to_csr()
    cfg = tspmm.SpmmConfig(backend="ell", merge_duplicates=False)
    tp = tspmm.prepare_spmm(csr, cfg, device="cpu")
    jp = jspmm.prepare_spmm(jgraph.CooGraph.from_edges(
        rows, cols, vals, nrows=N, ncols=N).to_csr(),
        jspmm.SpmmConfig(backend="ell", merge_duplicates=False))
    x = np.random.default_rng(5).standard_normal((N, 8)).astype(np.float32)
    close(tp.mul(torch.from_numpy(x)).numpy(),
          np.asarray(jp.mul(jnp.asarray(x))),
          dense_abs(rows, cols, vals) @ np.abs(x))


@pytest.mark.parametrize("chunk", [None, 4096, 999])
@pytest.mark.parametrize("kind", GRAPHS)
def test_oracle_matches_jax(kind, chunk):
    (rows, cols, vals), jp, tp = both(kind, backend="oracle",
                                      oracle_edge_chunk=chunk)
    assert tp.nnz == jp.nnz == rows.size  # the oracle merges nothing
    for k, v in jp.dev_arrays.items():
        np.testing.assert_array_equal(tp.dev_arrays[k].numpy(), np.asarray(v))
    x = np.random.default_rng(7).standard_normal((N, 24)).astype(np.float32)
    got = tp.mul(torch.from_numpy(x))
    assert torch.equal(got, tp.mul_plain(torch.from_numpy(x)))
    close(got.numpy(), np.asarray(jp.mul(jnp.asarray(x))),
          dense_abs(rows, cols, vals) @ np.abs(x))


@pytest.mark.parametrize("chunk", [None, 4096])
def test_oracle_integer_product_is_exact(chunk):
    """int32 weights and payload accumulate in int32 in both packages."""
    (_r, _c, _v), jp, tp = both("multigraph", dtype="int32",
                                backend="oracle", oracle_edge_chunk=chunk)
    x = np.random.default_rng(8).integers(-10, 11, (N, 16)).astype(np.int32)
    got = tp.mul(torch.from_numpy(x))
    want = np.asarray(jp.mul(jnp.asarray(x)))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_oracle_does_not_fuse_quantization():
    """The oracle has no fused hook (``PreparedAggregate.quantized`` is
    None), so the layers quantize around the plain aggregate."""
    _g, jp, tp = both("multigraph", backend="oracle")
    assert not tp.supports_fused_quant and not jp.supports_fused_quant
    x = torch.from_numpy(small_features(3))
    agg = tspmm.PreparedAggregate(tp)
    assert agg.quantized(x, "int32") is None
    with pytest.raises(ValueError):
        tp.mul_quantized(x, "int32")
    scale, xq = symmetric_quantize(x, "int32")
    want = symmetric_dequantize(tp.mul(xq), 1.0, scale)
    assert torch.equal(quantized_aggregate(agg, x, "int32"), want)


@pytest.mark.parametrize("backend,error", [
    ("coo", NotImplementedError), ("no-such-backend", ValueError)])
def test_unported_backends_raise(backend, error):
    rows, cols, vals = make_graph("multigraph")
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    with pytest.raises(error):
        tspmm.prepare_spmm(g, tspmm.SpmmConfig(backend=backend), device="cpu")


@pytest.mark.parametrize("backend", ["ell", "oracle", "blocked"])
def test_ell_and_oracle_are_supported(backend):
    tspmm.SpmmConfig(backend=backend).check_supported()
    # the hybrid fields do not apply to them
    tspmm.SpmmConfig(backend=backend, hybrid_shape="square",
                     hybrid_dtype="int4").check_supported()


def float64_graph():
    """The input of the fault once recorded in ROADMAP.md (Queue 3): 300
    nodes, 8 edges a row, columns from ``default_rng(0)``, float64
    values of 1."""
    n = 300
    rows = np.repeat(np.arange(n), 8)
    cols = np.random.default_rng(0).integers(0, n, rows.size)
    return n, rows, cols


F64_KW = dict(backend="hybrid", hybrid_shape="stair", hybrid_dtype="int8",
              hybrid_core_bytes=1 << 14, stair_max_bands=4)


@pytest.mark.parametrize("cfg", [
    F64_KW, dict(F64_KW, hybrid_core_bytes=1 << 16), dict(backend="ell"),
    dict(backend="oracle")], ids=["hybrid-recorded", "hybrid-core", "ell",
                                  "oracle"])
def test_float64_edge_values_match_jax(cfg):
    """At the recorded budget the stair is empty (every edge in the
    tail); at 64 KiB three bands hold edges, the port's stored as wide as
    the reference's rounded up to the int8 width rule (16 cells). Both
    packages give the float32 graph's product exactly."""
    n, rows, cols = float64_graph()
    x = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    outs, stairs = {}, {}
    for dtype in ("float64", "float32"):
        jp = jspmm.prepare_spmm(jgraph.CooGraph.from_edges(
            rows, cols, nrows=n, ncols=n, dtype=dtype),
            jspmm.SpmmConfig(**cfg))
        tp = tspmm.prepare_spmm(tgraph.CooGraph.from_edges(
            rows, cols, nrows=n, ncols=n, dtype=dtype),
            tspmm.SpmmConfig(**cfg), device="cpu")
        for k, v in tp.dev_arrays.items():
            if k.startswith("vals"):
                assert v.dtype == torch.float32, k
        jstair = getattr(jp, "stair", None)
        stairs[dtype] = (tp.stair, jstair and [
            (lo, hi, -(-w // 16) * 16) for lo, hi, w in jstair])
        outs[dtype] = (np.asarray(jp.mul(jnp.asarray(x))),
                       tp.mul(torch.from_numpy(x)).numpy())
    assert stairs["float64"] == stairs["float32"]
    assert stairs["float64"][0] == stairs["float64"][1]
    if cfg.get("hybrid_core_bytes") == 1 << 16:
        assert len(stairs["float64"][0]) == 3
    (j64, t64), (j32, t32) = outs["float64"], outs["float32"]
    np.testing.assert_array_equal(j64, j32)  # the reference's own finding
    np.testing.assert_array_equal(t64, t32)
    mag = dense_abs(rows, cols, np.ones(rows.size), n) @ np.abs(x)
    close(t64, j64, mag)


BACKEND_CFGS = {"hybrid": KW, "ell": dict(backend="ell"),
                "oracle": dict(backend="oracle"),
                "oracle-chunked": dict(backend="oracle",
                                       oracle_edge_chunk=999)}


@pytest.mark.parametrize("backend", list(BACKEND_CFGS))
def test_int32_gcn_matches_jax_on_each_backend(backend):
    """The reference's default inference: a 2-layer GCN with int32
    aggregation, the port's weights copied from JAX's. Fused on hybrid
    and ell (K-tail-quant, K-int), the unfused round trip on the oracle
    in both packages; 1e-4 of the logits' scale, the bar of
    test_torch_model.py."""
    f, h, c = 24, 64, 7
    (_r, _c, _v), jp, tp = both("multigraph", **BACKEND_CFGS[backend])
    jgnn = jmake_gnn(jax.random.key(2), "gcn", f, h, c, num_layers=2,
                     agg_dtype="int32")
    port = GNN("gcn", f, h, c, num_layers=2, agg_dtype="int32")
    port.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgnn.params)))
    port.eval()
    x = np.random.default_rng(11).standard_normal((N, f)).astype(np.float32)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), tspmm.PreparedAggregate(tp)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


@pytest.mark.parametrize("backend", ["hybrid", "ell", "oracle"])
def test_phase_times_keys_match_jax(backend):
    (_r, _c, _v), jp, tp = both("multigraph", **BACKEND_CFGS[backend])
    x = np.random.default_rng(4).standard_normal((N, 16)).astype(np.float32)
    want = jp.phase_times(jnp.asarray(x), iters=1)
    got = tp.phase_times(torch.from_numpy(x), iters=1)
    assert set(got) == set(want)
    assert all(v > 0 for v in got.values())
    if backend == "hybrid":
        assert set(got) == {"mul_time(ms)", "gather_time(ms)",
                            "tail_time(ms)", "core_time(ms)"}


def test_gather_only_sums_every_step():
    x = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    cols = torch.tensor([[0, 1, 1], [5, 0, 2]])
    want = x[cols.reshape(-1)].sum(0)
    assert torch.equal(tspmm.gather_only(x, cols), want)


def test_run_spmm_benchmark_phases_match_jax_keys(capsys):
    """``run_spmm_benchmark(phases=True)`` reports the reference's
    ``[DATA]`` keys (and ``device``), the phase times among them; the
    prepare phases, which differ, aside."""
    from pygim_tpu.bench.runners import run_spmm_benchmark as jrun
    from pygim_tpu.data import load_dataset as jload
    from pygim_tpu_torch.bench.runners import run_spmm_benchmark as trun
    from pygim_tpu_torch.data import load_dataset as tload

    kw = dict(hidden=16, dtype="float32", repeat=1, phases=True)
    got = trun(tload("tiny", use_cache=False),
               config=tspmm.SpmmConfig(**KW), device="cpu", **kw)
    want = jrun(jload("tiny", use_cache=False),
                config=jspmm.SpmmConfig(**KW), **kw)
    assert got.pop("device") == "cpu"

    def keys(d):  # prepare's phases differ (the port's merge, upload)
        return {k for k in d if not k.startswith("prepare_")}

    assert keys(got) == keys(want)
    assert {"gather_time(ms)", "tail_time(ms)", "core_time(ms)",
            "ref_time(ms)"} <= set(got)
