"""The bfloat16 and int64 payloads and the models on the bf16 and f32
cores, against the JAX reference on the CPU: ``mul`` with a bf16 or an
int64 x on every backend (int64 values past 2^31, which both packages
take as int32, wrapping, with x64 off), ``mul_quantized(..., "int64")``
(the int32 path), GCN, GIN and SAGE forwards on both new cores with the
JAX parameters carried across, and the runners on the new payloads.

Tolerances: the two packages differ only in the order of f32 sums (a
bf16 payload is widened exactly in the tail and multiplied exactly in a
core), so products are held within 1e-5 of the sum of |terms| (REL) and
logits within 1e-5 of their largest magnitude, the bar of
``tests/test_torch_convs.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.bench.runners import run_spmm_benchmark
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_convs import carried
from test_torch_prepare import N, make_graph
from test_torch_train import C, F, H, N as N_SMALL, small_graph

REL = 1e-5
BUDGET = 1 << 20
BACKENDS = {
    "stair-int8": dict(backend="hybrid", hybrid_shape="stair",
                       hybrid_dtype="int8", hybrid_core_bytes=BUDGET),
    "square-bf16": dict(backend="hybrid", hybrid_dtype="bfloat16",
                        hybrid_core_bytes=BUDGET),
    "stair-bf16": dict(backend="hybrid", hybrid_shape="stair",
                       hybrid_dtype="bfloat16", hybrid_core_bytes=BUDGET),
    "square-f32": dict(backend="hybrid", hybrid_core_bytes=BUDGET),
    "ell": dict(backend="ell"),
    "oracle": dict(backend="oracle"),
    "blocked": dict(backend="blocked", n_blocks=3),
}


def both(rows, cols, vals, n, kw):
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n),
        jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n),
        tspmm.SpmmConfig(**kw), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def preps():
    rows, cols, vals = make_graph("wide")
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    return dense, {b: both(rows, cols, vals, N, kw)
                   for b, kw in BACKENDS.items()}


def assert_close(got, want, mag):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_bf16_payload_matches_jax(preps, backend):
    """A bf16 x: K-tail's bf16 rows (widened exactly) and the cores'
    products of it, against the reference's."""
    dense, ps = preps
    jp, tp = ps[backend]
    x = np.random.default_rng(3).standard_normal((N, 24)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jp.mul(jnp.asarray(x, jnp.bfloat16)), np.float32)
    got = tp.mul(xb).float().numpy()
    assert_close(got, want, dense @ np.abs(xb.float().numpy()))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_int64_payload_matches_jax(preps, backend):
    """An int64 x with values past 2^31: both packages take it as int32
    (wrapping), then as the int32 payload."""
    dense, ps = preps
    jp, tp = ps[backend]
    rng = np.random.default_rng(4)
    x = rng.integers(-(1 << 40), 1 << 40, (N, 16))
    x[:, :8] = rng.integers(-(1 << 19), 1 << 19, (N, 8))
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    wrapped = torch.from_numpy(x).to(torch.int32).numpy()
    assert_close(got.astype(np.float64), want.astype(np.float64),
                 dense @ np.abs(wrapped.astype(np.float64)))


@pytest.mark.parametrize("backend", ["stair-int8", "square-bf16",
                                     "square-f32", "ell"])
def test_mul_quantized_int64_matches_jax(preps, backend):
    """``mul_quantized(x, "int64")``: the reference's int32 quantization
    (scale exponent 20, x64 off), fused, bit for bit the port's int32
    path; against JAX within REL (its rounded rows reach 2^19, so the f32
    sums round)."""
    dense, ps = preps
    jp, tp = ps[backend]
    x = np.random.default_rng(5).standard_normal((N, 24)).astype(np.float32)
    want = np.asarray(jp.mul_quantized(jnp.asarray(x), "int64"))
    got = tp.mul_quantized(torch.from_numpy(x), "int64")
    assert torch.equal(got, tp.mul_quantized(torch.from_numpy(x), "int32"))
    assert_close(got.numpy(), want, dense @ np.abs(x.astype(np.float64)))


FORWARDS = [(conv, core, None) for conv in ("gcn", "gin", "sage")
            for core in ("square-bf16", "square-f32")] + [
    ("gcn", "square-bf16", "int32"), ("gcn", "square-bf16", "int8"),
    ("gcn", "square-bf16", "bfloat16"), ("gcn", "stair-bf16", None),
    ("gcn", "square-f32", "int64")]


@pytest.mark.parametrize("conv,core,agg_dtype", FORWARDS, ids=[
    f"{c}-{k}-{a or 'float'}" for c, k, a in FORWARDS])
def test_forwards_on_the_new_cores_match_jax(conv, core, agg_dtype):
    """2-layer evaluation forwards through the bf16 and f32 cores: float
    aggregation, the fused int32 and int8 aggregates, and the unfused
    bfloat16 and int64 round trips (inference_cuda.py's --data_type)."""
    rows, cols, vals = small_graph()
    kw = dict(BACKENDS[core], hybrid_core_bytes=128 << 10)
    jp, tp = both(rows, cols, vals, N_SMALL, kw)
    assert tp.stair
    jgnn = jmake_gnn(jax.random.key(7), conv, F, H, C, num_layers=2,
                     agg_dtype=agg_dtype)
    x = np.random.default_rng(2).standard_normal((N_SMALL, F)).astype(
        np.float32)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    model = carried(jgnn, conv)
    model.agg_dtype = agg_dtype
    with torch.inference_mode():
        got = model(torch.from_numpy(x), tspmm.PreparedAggregate(tp)).numpy()
    mag = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape == (N_SMALL, C)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5 * mag


@pytest.mark.parametrize("dtype,config", [
    ("bfloat16", dict(backend="hybrid", hybrid_dtype="bfloat16",
                      hybrid_core_bytes=BUDGET)),
    ("bfloat16", dict(backend="ell")),
    ("int64", dict(backend="hybrid", hybrid_dtype="bfloat16",
                   hybrid_core_bytes=BUDGET)),
    ("int64", dict(backend="hybrid", hybrid_shape="stair",
                   hybrid_dtype="int8", hybrid_core_bytes=BUDGET)),
], ids=["bf16-hybrid", "bf16-ell", "int64-bf16-core", "int64-int8-core"])
def test_runner_payloads(dtype, config):
    """``run_spmm_benchmark`` on the new payloads: its sampled rows
    against float64 (rtol 1e-2 on a bf16 core or a float payload on an
    int8 core, 1e-4 elsewhere), and the payload's bytes in the traffic
    model."""
    ds = load_dataset("rmat-2000-40000")
    means = run_spmm_benchmark(ds, hidden=32, dtype=dtype, repeat=1,
                               config=tspmm.SpmmConfig(**config),
                               device="cpu")
    assert means["verify"] == "OK"
    assert means["pim_time_spmm(ms)"] > 0
