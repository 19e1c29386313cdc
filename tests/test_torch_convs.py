"""The GIN and SAGE convs of the PyTorch port against the JAX package on
the CPU: evaluation forwards of the 2-layer models through the oracle,
ell, blocked and stair-int8 backends with the JAX parameters carried
across, with float and with int8, int16 and int32 aggregation, the
state-dict layout of their pytrees, and the planted dataset the training
parity runs on.

Tolerance for logits: the two packages' products differ only in f32
summation order (the hybrid's core rounds its payload to bf16 on both
sides alike), carried through two conv blocks and the dense layers:
1e-5 of the logits' largest magnitude, the bar of
``tests/test_torch_model.py``'s aggregate check; a wrong weight, layout
or bias is off by O(1) of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.data import datasets as jdata
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import datasets as tdata
from pygim_tpu_torch.nn.models import GNN, make_gnn, params_from_jax
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_train import BACKENDS, C, F, H, N, small_graph


def carried(jgnn, conv, num_layers=2):
    m = GNN(conv, F, H, C, num_layers=num_layers)
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgnn.params)))
    return m.eval()


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("conv", ["gin", "sage"])
def test_eval_forward_matches_jax(conv, backend):
    rows, cols, vals = small_graph()
    cfg = BACKENDS[backend]
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**cfg))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**cfg), device="cpu")
    jgnn = jmake_gnn(jax.random.key(4), conv, F, H, C, num_layers=2)
    x = np.random.default_rng(2).standard_normal((N, F)).astype(np.float32)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    with torch.inference_mode():
        got = carried(jgnn, conv)(torch.from_numpy(x),
                                  tspmm.PreparedAggregate(tp)).numpy()
    mag = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape == (N, C)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5 * mag


@pytest.mark.parametrize("agg_dtype", ["int8", "int16", "int32"])
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("conv", ["gin", "sage"])
def test_eval_forward_quantized_matches_jax(conv, backend, agg_dtype):
    """The same forwards with quantized aggregation: the fused hook on
    the ell and hybrid backends, the unfused round trip on the oracle and
    blocked ones, in both packages. A reordered f32 sum can move a
    rounded value by one quantization step (2^-k of 2·max|h|), which the
    dense layers carry: the same 1e-5 of the logits' magnitude."""
    rows, cols, vals = small_graph()
    cfg = BACKENDS[backend]
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**cfg))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**cfg), device="cpu")
    jgnn = jmake_gnn(jax.random.key(4), conv, F, H, C, num_layers=2,
                     agg_dtype=agg_dtype)
    x = np.random.default_rng(2).standard_normal((N, F)).astype(np.float32)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    model = carried(jgnn, conv)
    model.agg_dtype = agg_dtype
    with torch.inference_mode():
        got = model(torch.from_numpy(x), tspmm.PreparedAggregate(tp)).numpy()
    mag = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape == (N, C)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-5 * mag


@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
def test_params_from_jax_keys_and_shapes(conv):
    """Every leaf of the JAX pytree lands on a state-dict entry of the
    same shape, and the state dict has no other entry."""
    jgnn = jmake_gnn(jax.random.key(0), conv, F, H, C, num_layers=3)
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jgnn.params))
    m = GNN(conv, F, H, C, num_layers=3)
    own = m.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    assert len(jax.tree_util.tree_leaves(jgnn.params)) == len(sd)


def test_gin_and_sage_layouts():
    gin = make_gnn(0, "gin", F, H, C, device="cpu")
    assert tuple(gin.convs[1].eps.shape) == ()
    assert set(dict(gin.convs[0].mlp.named_children())) == {"lin1", "bn",
                                                            "lin2"}
    sage = make_gnn(0, "sage", F, H, C, device="cpu")
    assert sage.convs[0].lin_r.b is None and sage.convs[0].lin_l.b is not None
    assert not sage.training and not gin.training
    with pytest.raises(ValueError, match="unknown conv"):
        make_gnn(0, "gat", F, H, C, device="cpu")


def test_sage_normalize_matches_jax():
    """SAGEConv's optional L2 normalisation of each output row."""
    from pygim_tpu.nn import layers as jlayers
    from pygim_tpu_torch.nn.layers import SAGEConv

    jp = jlayers.sage_conv_init(jax.random.key(1), H, H)
    conv = SAGEConv(H, H, normalize=True)
    conv.load_state_dict({
        "lin_l.w": torch.from_numpy(np.asarray(jp["lin_l"]["w"])),
        "lin_l.b": torch.from_numpy(np.asarray(jp["lin_l"]["b"])),
        "lin_r.w": torch.from_numpy(np.asarray(jp["lin_r"]["w"]))})
    x = np.random.default_rng(3).standard_normal((50, H)).astype(np.float32)
    agg = np.random.default_rng(4).standard_normal((50, H)).astype(np.float32)
    want = np.asarray(jlayers.sage_conv_apply(
        jp, jnp.asarray(x), lambda v: jnp.asarray(agg), normalize=True))
    with torch.no_grad():
        got = conv(torch.from_numpy(x), lambda v: torch.from_numpy(agg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name,seed", [("planted-2000-24000-4", 0),
                                       ("planted-500-3000-3", 5),
                                       ("planted-300-2000-1", 1)])
def test_planted_dataset_matches_reference(name, seed):
    """``planted-<n>-<e>-<c>``: graph, features, labels and masks equal,
    array for array, to the reference's for the same name and seed (the
    class count is at least 2, as there)."""
    j = jdata.load_dataset(name, seed=seed)
    t = tdata.load_dataset(name, seed=seed)
    assert (t.name, t.num_classes, t.synthetic, t.metric) == (
        j.name, j.num_classes, j.synthetic, "acc")
    for a in ("x", "y", "train_mask", "test_mask"):
        got, want = getattr(t, a), getattr(j, a)
        assert got.dtype == want.dtype, a
        np.testing.assert_array_equal(got, want, err_msg=a)
    for a in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(t.graph, a),
                                      getattr(j.graph, a), err_msg=a)
    assert (t.graph.nrows, t.graph.ncols) == (j.graph.nrows, j.graph.ncols)
