"""Training on the bf16 and f32 cores against the JAX reference on the
CPU: every parameter's gradient of a masked cross-entropy through the
hybrid on each core (the port's backward on the prepared Aᵀ, JAX's
autodiff through its operand), and the twin of the reference's hybrid
trained-accuracy parity test (``tests/test_training_parity.py:39-49``,
a bf16 core at 64 KiB, ``acc_tol`` 0.03).

Tolerances, as ``tests/test_torch_train.py``: on the bf16 core the two
packages round the core's gradient at different points (the reference
after each band's transposed product, K-core on Aᵀ the cotangent before
it), carried through the batch statistics, so a leaf is held within
``HYBRID_GRAD_TOL`` (2e-2) of its largest |grad|; the f32 core rounds
nothing, so its leaves are held to the float backends' ``FLOAT_GRAD_TOL``
(1e-4; GIN's cancelling leaves 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.bench.runners import run_training_benchmark
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.nn import train as ttrain
from pygim_tpu_torch.nn.models import gnn_apply, params_from_jax
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_train import (
    CONVS,
    FLOAT_GRAD_TOL,
    GIN_CANCELLING,
    GIN_CANCELLING_TOL,
    HYBRID_GRAD_TOL,
    N,
    both_models,
    close,
    inputs,
    jax_loss_fn,
    small_graph,
    torch_inputs,
)

CORES = {"bf16": dict(backend="hybrid", hybrid_dtype="bfloat16",
                      hybrid_core_bytes=128 << 10),
         "f32": dict(backend="hybrid", hybrid_core_bytes=256 << 10)}


@pytest.mark.parametrize("core", list(CORES))
@pytest.mark.parametrize("conv", CONVS)
def test_gradients_match_jax(conv, core):
    rows, cols, vals = small_graph()
    kw = CORES[core]
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**kw))
    graph = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    tp = tspmm.prepare_spmm(graph, tspmm.SpmmConfig(**kw), device="cpu")
    assert tp.stair and tp.core_dtype == {"bf16": "bfloat16",
                                          "f32": "float32"}[core]
    tp.transpose(graph)
    assert tp.transpose().core_dtype == tp.core_dtype
    jgnn, model = both_models(conv)
    x, y, mask = inputs()
    (jloss, _), g = jax.value_and_grad(
        jax_loss_fn(jgnn, jspmm.PreparedAggregate(jp), jnp.asarray(x),
                    jnp.asarray(y), jnp.asarray(mask)),
        has_aux=True)(jgnn.params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
    xt, yt, mt = torch_inputs(x, y, mask)
    logits = gnn_apply(model, xt, tspmm.PreparedAggregate(tp), training=True)
    loss = ttrain.softmax_cross_entropy(logits, yt, mt)
    loss.backward()
    close(float(loss.detach()), float(jloss), 1e-5, "loss")
    named = dict(model.named_parameters())
    for key, gw in want.items():
        gw = gw.numpy()
        if key not in named:  # a running statistic: no gradient in JAX
            assert not gw.any(), key
            continue
        scale = float(np.abs(gw).max())
        if core == "bf16":
            tol = HYBRID_GRAD_TOL
        elif conv == "gin" and key in GIN_CANCELLING:
            tol = GIN_CANCELLING_TOL
        else:
            tol = FLOAT_GRAD_TOL
        err = float(np.abs(named[key].grad.numpy() - gw).max())
        assert err <= tol * scale + 1e-6, (key, err, scale)


def test_training_parity_hybrid_bf16():
    """The twin of the reference's ``test_training_parity_hybrid``: GCN,
    hidden 32, 10 epochs on ``planted-2000-24000-4`` through a bf16 core
    at 64 KiB (square, k 256), against the oracle arm."""
    planted = load_dataset("planted-2000-24000-4")
    cfg = tspmm.SpmmConfig(backend="hybrid", hybrid_core_bytes=1 << 16,
                           hybrid_dtype="bfloat16")
    assert tspmm.prepare_spmm(planted.graph, cfg, device="cpu").stair
    res = run_training_benchmark(planted, hidden=32, epochs=10, config=cfg,
                                 acc_tol=0.03, device="cpu")
    assert res["acc_delta"] <= 0.03
    assert res["validate"] == "OK"
