"""The flagship forward step on the CPU: the port's ``entry()`` against
the reference's ``__graft_entry__.entry()`` with the JAX weights carried
across, and 2-layer GCNs with int8, int16 and int32 aggregation through
the hybrid's fused hook.

The bar for logits. Each quantized aggregate is bit-equal to the
reference's on identical inputs (held exactly below). The dense layers
(x @ w in f32, XLA's dot against torch's matmul) may sum in other
orders, so the input of the next aggregate can differ in its last bits,
and where it lands next to a half step, round(h / scale) moves by one
quantization step (2^-19 of max|h| at int32, 2^-9 at int16, 2^-4 at
int8) for that element; at these sizes about one element a layer is
close enough for that. The bar is a few such steps carried through the
output layer: 1e-4 of the logits' largest magnitude at int32, 5e-3 at
int16 and 5e-2 at int8. (With these seeds the two agree to 1.1e-6 of
it at every dtype on the CPU.) A wrong weight, layout, limb or rounding is off by O(1)
of the scale."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn import layers as jlayers
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch import entry as tentry
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.nn import layers as tlayers
from pygim_tpu_torch.nn.models import GNN, params_from_jax
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import KW, N, make_graph

BARS = {"int32": 1e-4, "int16": 5e-3, "int8": 5e-2}


def close(got, want, rel):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= rel * scale


def jax_entry_params():
    """The weights ``__graft_entry__.entry()`` builds (key 0)."""
    m = jmake_gnn(jax.random.key(0), "gcn", tentry.F_IN, tentry.HIDDEN,
                  tentry.F_OUT, agg_dtype="int32")
    return params_from_jax(jax.tree_util.tree_map(np.asarray, m.params))


def test_toy_graph_and_config_match_the_reference():
    j = jentry._toy_graph(tentry.N)
    t = tentry.toy_graph()
    for a in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(t, a), np.asarray(getattr(j, a)))
    assert (t.nrows, t.ncols) == (j.nrows, j.ncols)
    jcfg = jspmm.SpmmConfig(backend="hybrid", hybrid_shape="stair",
                            hybrid_core_bytes=1 << 16, hybrid_dtype="int8",
                            stair_max_bands=4)
    assert dataclasses.asdict(tentry.CONFIG) == dataclasses.asdict(jcfg)


def test_entry_matches_graft_entry():
    jfwd, (jx,) = jentry.entry()
    fwd, (x,) = tentry.entry(device="cpu", state_dict=jax_entry_params())
    assert x.shape == tuple(jx.shape) and x.dtype == torch.float32
    assert x.device.type == "cpu" and not x.any()
    want = np.asarray(jfwd(jx))
    got = fwd(x).numpy()
    assert got.shape == want.shape == (tentry.N, tentry.F_OUT)
    close(got, want, BARS["int32"])
    # and on features that are not zero, through every layer
    xr = np.random.default_rng(1).standard_normal(
        (tentry.N, tentry.F_IN)).astype(np.float32)
    close(fwd(torch.from_numpy(xr)).numpy(), np.asarray(jfwd(jnp.asarray(xr))),
          BARS["int32"])


def test_entry_weights_default_to_seed_zero():
    fwd, (x,) = tentry.entry(device="cpu")
    out = fwd(x)
    assert out.shape == (tentry.N, tentry.F_OUT) and torch.isfinite(out).all()


@pytest.mark.parametrize("agg_dtype", ["int8", "int16", "int32"])
@pytest.mark.parametrize("fused", [True, False])
def test_quantized_aggregate_is_exact(agg_dtype, fused):
    """One aggregate on identical inputs: bit-equal to the reference, by
    the fused hook (PreparedAggregate) and by the unfused round trip
    (prep.mul on the quantized payload)."""
    rows, cols, vals = make_graph("multigraph")
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    h = np.random.default_rng(4).standard_normal((N, 16)).astype(np.float32)
    h *= np.float32(1e-3)
    h[0, 0] = 1.0  # every int32 sum stays under 2^24
    jagg = jspmm.PreparedAggregate(jp) if fused else jp.mul
    tagg = tspmm.PreparedAggregate(tp) if fused else tp.mul
    want = np.asarray(jlayers.quantized_aggregate(jagg, jnp.asarray(h),
                                                  agg_dtype))
    got = tlayers.quantized_aggregate(tagg, torch.from_numpy(h),
                                      agg_dtype).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("agg_dtype", ["int8", "int16", "int32"])
def test_gcn_with_quantized_aggregation_matches_jax(agg_dtype):
    rows, cols, vals = make_graph("multigraph")
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    f, h, c = 24, 64, 7
    jgnn = jmake_gnn(jax.random.key(3), "gcn", f, h, c, num_layers=2,
                     agg_dtype=agg_dtype)
    m = GNN("gcn", f, h, c, num_layers=2, agg_dtype=agg_dtype)
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgnn.params)))
    m.eval()
    x = np.random.default_rng(11).standard_normal((N, f)).astype(np.float32)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    with torch.inference_mode():
        got = m(torch.from_numpy(x), tspmm.PreparedAggregate(tp)).numpy()
    close(got, want, BARS[agg_dtype])
