"""The whole slice on the CPU: the port's 2-layer GCN with parameters
carried over from the JAX model, its aggregate hook, and the benchmark
bodies' [DATA] output.

Tolerance for logits: the two packages' SpMMs differ only in f32
summation order (1e-5 of the sum of |terms|, test_torch_spmm.py), and
that difference passes through two layers of dense f32 products whose
own sums also run in other orders. We allow 1e-4 of the logits' largest
magnitude; a wrong weight, layout or bias is off by O(1) of it."""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn import layers as jlayers
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import reference as jref
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.bench.runners import evaluate_predictions as jeval
from pygim_tpu.utils.metrics import data_print as jdata_print
from pygim_tpu_torch.bench.runners import (
    evaluate_predictions,
    run_inference_benchmark,
    run_spmm_benchmark,
)
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.nn import layers as tlayers
from pygim_tpu_torch.nn.models import GNN, gnn_apply, make_gnn, params_from_jax
from pygim_tpu_torch.ops import reference as tref
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.utils.metrics import DataReporter, data_print, parse_data_lines
from pygim_tpu_torch.utils.timers import PhaseTimer, device_time

from test_torch_prepare import KW, N, make_graph

F, H, C = 24, 64, 7


def jax_model(num_layers=2, seed=0):
    return jmake_gnn(jax.random.key(seed), "gcn", F, H, C,
                     num_layers=num_layers)


def port_model(jgnn, num_layers=2):
    m = GNN("gcn", F, H, C, num_layers=num_layers)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jgnn.params)))
    return m.eval()


def features():
    return np.random.default_rng(11).standard_normal((N, F)).astype(np.float32)


def assert_logits_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


@pytest.mark.parametrize("kind", ["multigraph", "simple"])
def test_gcn_logits_match_jax_through_hybrid(kind):
    rows, cols, vals = make_graph(kind)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    jgnn = jax_model()
    x = features()
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    with torch.inference_mode():
        got = port_model(jgnn)(torch.from_numpy(x),
                               tspmm.PreparedAggregate(tp)).numpy()
    assert_logits_close(got, want)


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_gcn_logits_match_jax_through_oracle(num_layers):
    """The dense layers alone: both sides aggregate with their oracle."""
    rows, cols, vals = make_graph("multigraph")
    jgnn = jax_model(num_layers, seed=num_layers)
    x = features()
    ja = [jnp.asarray(a) for a in (rows, cols, vals)]
    ta = [torch.from_numpy(a) for a in (rows, cols, vals)]
    want = np.asarray(jgnn.apply(
        jnp.asarray(x), lambda v: jref.spmm_coo_oracle(*ja, v, N)))
    with torch.inference_mode():
        got = port_model(jgnn, num_layers)(
            torch.from_numpy(x), lambda v: tref.spmm_coo_oracle(*ta, v, N)
        ).numpy()
    assert_logits_close(got, want)


def test_params_from_jax_keys_and_layout():
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model().params))
    m = GNN("gcn", F, H, C)
    assert set(sd) == set(m.state_dict())
    assert tuple(sd["ln1.w"].shape) == (F, H)  # JAX (din, dout) layout
    assert tuple(sd["ln2.w"].shape) == (H, C)


def test_make_gnn_is_seeded_glorot():
    a, b, c = (make_gnn(s, "gcn", F, H, C, device="cpu") for s in (3, 3, 4))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not torch.equal(a.ln1.w, c.ln1.w)
    lim = np.sqrt(6.0 / (F + H))
    assert float(a.ln1.w.detach().abs().max()) <= lim
    assert float(a.ln1.w.detach().abs().max()) > 0.9 * lim
    assert not a.training
    assert not a.ln1.b.any() and a.convs[0].lin.b is None


def test_unported_model_paths_raise():
    """GIN, SAGE and training mode are ported; what stays refused is an
    unknown conv, training without a generator where dropout draws, and
    a gradient through the quantized aggregate (training aggregates the
    float payload)."""
    with pytest.raises(ValueError, match="unknown conv"):
        make_gnn(0, "gat", F, H, C, device="cpu")
    m = make_gnn(0, "gcn", F, H, C, device="cpu").train()
    with pytest.raises(ValueError, match="Generator"):
        gnn_apply(m, torch.zeros(5, F), lambda v: v)
    rows, cols, vals = make_graph("multigraph")
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    with pytest.raises(NotImplementedError, match="float payload"):
        tspmm.PreparedAggregate(tp).quantized(
            torch.zeros(N, H, requires_grad=True), "int32")


@pytest.mark.parametrize("agg_dtype", [None, "int8", "int16", "int32"])
def test_quantized_aggregate_unfused_matches(agg_dtype):
    """A plain callable aggregate takes the unfused quantize round trip
    in both packages; the integer sums are exact, so results agree."""
    rows, cols, vals = make_graph("multigraph")
    x = features()
    ja = [jnp.asarray(a) for a in (rows, cols, vals)]
    ta = [torch.from_numpy(a) for a in (rows, cols, vals)]
    want = np.asarray(jlayers.quantized_aggregate(
        lambda v: jref.spmm_coo_oracle(*ja, v, N), jnp.asarray(x), agg_dtype))
    got = tlayers.quantized_aggregate(
        lambda v: tref.spmm_coo_oracle(*ta, v, N), torch.from_numpy(x),
        agg_dtype).numpy()
    mag = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * mag)


def test_integer_aggregate_on_hybrid_names_kint_slice():
    """The int32 aggregate on the hybrid runs the K-int slice's fused hook
    (``PreparedAggregate.quantized``), bit-identical to the unfused round
    trip through ``prep.mul``; int64 is the int32 path (x64 off, as the
    reference), bit for bit; the float passthrough, which no entry point
    reaches, is the reference's within 1e-5 of its largest magnitude."""
    rows, cols, vals = make_graph("multigraph")
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    m = make_gnn(0, "gcn", F, H, C, agg_dtype="int32", device="cpu")
    x = torch.from_numpy(features())
    with torch.inference_mode():
        fused = m(x, tspmm.PreparedAggregate(tp))
        unfused = m(x, tp.mul)
    assert fused.shape == (N, C) and torch.isfinite(fused).all()
    assert torch.equal(fused, unfused)
    agg = tspmm.PreparedAggregate(tp)
    assert torch.equal(agg.quantized(x, "int64"), agg.quantized(x, "int32"))
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    want = np.asarray(jp.raw_mul_quantized(jnp.asarray(features()),
                                           jp.dev_arrays, "float32"))
    np.testing.assert_allclose(agg.quantized(x, "float32").numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


def run_captured(capsys, fn, *a, **kw):
    capsys.readouterr()
    means = fn(*a, **kw)
    return means, parse_data_lines(capsys.readouterr().out.splitlines())


def test_run_inference_benchmark_cpu(capsys):
    ds = load_dataset("rmat-2000-40000")
    means, parsed = run_captured(
        capsys, run_inference_benchmark, ds, hidden=32,
        config=tspmm.SpmmConfig(**KW), repeat=1, device="cpu",
    )
    for k in ("infer_time(ms)", "test_acc", "prepare_pim_time(ms)",
              "edges_per_s", "prepare_core_fill_time(ms)"):
        assert k in parsed and isinstance(parsed[k][0], float), k
    assert parsed["layout"] == ["single-chip"]
    assert 0.0 <= means["test_acc"] <= 1.0


def test_run_spmm_benchmark_cpu(capsys):
    ds = load_dataset("rmat-2000-40000")
    means, parsed = run_captured(
        capsys, run_spmm_benchmark, ds, hidden=32,
        config=tspmm.SpmmConfig(**KW), repeat=1, device="cpu",
    )
    assert parsed["verify"] == ["OK"]
    for k in ("pim_time_spmm(ms)", "spmm_effective_GBps",
              "spmm_effective_GBps_unique", "load_sparse_time(ms)"):
        assert k in parsed, k
    # int64, refused before PR 11 ported it, runs as int32; float16,
    # which the reference does not take either, is refused
    assert run_spmm_benchmark(ds, dtype="int64", hidden=8,
                              config=tspmm.SpmmConfig(**KW), repeat=1,
                              device="cpu")["verify"] == "OK"
    with pytest.raises(ValueError):
        run_spmm_benchmark(ds, dtype="float16", device="cpu")


@pytest.mark.parametrize("key,value", [("pim_time_spmm(ms)", 12.345678),
                                       ("verify", "OK"), ("edges_per_s", 3)])
def test_data_lines_byte_compatible(key, value):
    a, b = io.StringIO(), io.StringIO()
    data_print(key, value, stream=a)
    jdata_print(key, value, stream=b)
    assert a.getvalue() == b.getvalue()


def test_evaluate_predictions_matches():
    ds = load_dataset("tiny")
    logits = np.random.default_rng(3).standard_normal((ds.num_nodes, 4))
    assert evaluate_predictions(ds, logits) == jeval(ds, logits)


def test_timers_and_reporter():
    pt = PhaseTimer()
    for _ in range(2):
        pt.start("a")
        pt.stop("a")
    assert list(pt.acc) == ["a"] and pt.acc["a"] >= 0.0
    assert device_time(lambda: torch.ones(3), iters=2) >= 0.0
    rep = DataReporter(echo=False)
    rep.report("t(ms)", 1.0)
    rep.report("t(ms)", 3.0)
    rep.report("verify", "OK")
    assert rep.means() == {"t(ms)": 2.0, "verify": "OK"}
