"""Training over the port's meshes against the JAX reference: gradients
through the 2D ``sp × ds`` operand and the halo operand (``SpmmFunction``
on their prepared ``transpose()``) against JAX's autodiff through the
reference's same operands on the conftest's 8-device virtual CPU mesh;
trained-accuracy parity over a (2, 2) mesh (the twin of
``tests/test_training_parity.py``'s mesh case); the threaded step over
the halo hybrid (the twin of ``tests/test_halo.py``'s training case);
``train_cuda.py --sp_parts 2 --ds_parts 2``; and
``dryrun_multichip(8)``, the twin of ``__graft_entry__``'s.

Bars are ``tests/test_torch_train.py``'s (its module docstring):
``FLOAT_GRAD_TOL`` 1e-4 of a leaf's largest |grad| (+1e-6) where both
packages aggregate in f32 (ell shards, f32 slabs and tiles; GIN's three
cancelling leaves 1e-3), ``HYBRID_GRAD_TOL`` 2e-2 where a core rounds
the payload to bf16 (int8 slabs), losses within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.parallel import make_mesh as jmake_mesh
from pygim_tpu.parallel import prepare_spmm_2d as jprepare_2d
from pygim_tpu.parallel.halo import make_node_mesh as jmake_node_mesh
from pygim_tpu.parallel.halo import prepare_spmm_halo as jprepare_halo
from pygim_tpu_torch.bench.runners import run_training_benchmark
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.entry import dryrun_multichip
from pygim_tpu_torch.nn import train as ttrain
from pygim_tpu_torch.nn.models import gnn_apply, params_from_jax
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.parallel import (
    make_mesh,
    make_node_mesh,
    prepare_spmm_2d,
    prepare_spmm_halo,
)
from pygim_tpu_torch.utils.metrics import parse_data_lines

from test_torch_train import (
    C,
    F,
    FLOAT_GRAD_TOL,
    GIN_CANCELLING,
    GIN_CANCELLING_TOL,
    HYBRID_GRAD_TOL,
    both_models,
    close,
    jax_loss_fn,
)

N, E = 300, 5000
CPUS = ["cpu"] * 8
# layout -> (kind, mesh argument, exchange, config)
LAYOUTS = {
    "2d-ell": ("2d", (2, 2), None, dict(backend="ell")),
    "2d-hybrid-f32": ("2d", (4, 2), None, dict(backend="hybrid",
                                               hybrid_k=48)),
    "halo-ell-a2a": ("halo", 4, "all_to_all", dict(backend="ell")),
    "halo-int8-ring": ("halo", 4, "ring", dict(
        backend="hybrid", hybrid_k=32, hybrid_dtype="int8")),
    "halo-f32-gather-bcsr": ("halo", 8, "all_gather", dict(
        backend="hybrid", hybrid_k=32, bcsr_bytes=1 << 20, bcsr_tile=8,
        bcsr_min_edges=2)),
}


def mesh_graph():
    """(rows, cols, vals): a 300-node graph with 16 dense hub rows and
    columns and random edges, unit weights, distinct pairs in (row, col)
    order."""
    rng = np.random.default_rng(31)
    r = np.concatenate([rng.integers(0, 16, 2000), rng.integers(0, N, E)])
    c = np.concatenate([rng.integers(0, N, 2000), rng.integers(0, N, E)])
    flat = np.unique(r.astype(np.int64) * N + c)
    return flat // N, flat % N, np.ones(flat.size, np.float32)


def both_operands(layout):
    """(reference operand, port operand, port graph) of ``layout``, the
    port's Aᵀ prepared."""
    kind, shape, exchange, cfg = LAYOUTS[layout]
    rows, cols, vals = mesh_graph()
    jg = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    tg = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    if kind == "2d":
        jp = jprepare_2d(jg, jmake_mesh(*shape), jspmm.SpmmConfig(**cfg))
        tp = prepare_spmm_2d(tg, make_mesh(*shape, CPUS),
                             tspmm.SpmmConfig(**cfg))
    else:
        jp = jprepare_halo(jg, jmake_node_mesh(shape), jspmm.SpmmConfig(**cfg),
                           exchange=exchange)
        tp = prepare_spmm_halo(tg, make_node_mesh(shape, CPUS),
                               tspmm.SpmmConfig(**cfg), exchange=exchange)
    tp.transpose(tg)
    return jp, tp, tg


def inputs(seed=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    mask = (rng.random(N) < 0.4).astype(np.float32)
    return x, y, mask


def jax_loss_and_grads(jgnn, agg, x, y, mask):
    """JAX's loss and gradients through ``agg``, in one jitted program."""
    fn = jax.jit(jax.value_and_grad(jax_loss_fn(
        jgnn, agg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)),
        has_aux=True))
    (loss, _), grads = fn(jgnn.params)
    return loss, params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("layout", ["2d-hybrid-f32", "halo-int8-ring",
                                    "halo-f32-gather-bcsr"])
def test_gradients_match_jax(layout):
    """d(masked cross-entropy)/d(every parameter) over the mesh: JAX's
    autodiff through the reference's operand against the port's backward
    on the mesh's Aᵀ (the SAGE conv on the 2D hybrid, GCN on the halo)."""
    jp, tp, _ = both_operands(layout)
    conv = "sage" if layout == "2d-hybrid-f32" else "gcn"
    jgnn, model = both_models(conv)
    x, y, mask = inputs()
    jloss, want = jax_loss_and_grads(jgnn, jp.mul, x, y, mask)
    agg = tspmm.PreparedAggregate(tp)
    logits = gnn_apply(model, torch.from_numpy(x), agg, training=True)
    loss = ttrain.softmax_cross_entropy(
        logits, torch.from_numpy(y.astype(np.int64)), torch.from_numpy(mask))
    loss.backward()
    close(float(loss.detach()), float(jloss), 1e-5, "loss")
    named = dict(model.named_parameters())
    loose = LAYOUTS[layout][3].get("hybrid_dtype") == "int8"
    for key, g in want.items():
        g = g.numpy()
        if key not in named:
            assert not g.any(), key
            continue
        if loose:
            tol = HYBRID_GRAD_TOL
        elif conv == "gin" and key in GIN_CANCELLING:
            tol = GIN_CANCELLING_TOL
        else:
            tol = FLOAT_GRAD_TOL
        scale = float(np.abs(g).max())
        err = float(np.abs(named[key].grad.numpy() - g).max())
        assert err <= tol * scale + 1e-6, (key, err, scale)


@pytest.mark.parametrize("layout", ["2d-ell", "halo-ell-a2a",
                                    "halo-f32-gather-bcsr"])
def test_spmm_function_matches_plain_autograd(layout):
    """The aggregate's own backward (SpmmFunction on the mesh's Aᵀ)
    against autograd through the plain versions on A, both f32, within
    1e-5 of the sum of |terms|; a gradient before Aᵀ is prepared
    raises."""
    _jp, tp, tg = both_operands(layout)
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
    xa = x.clone().requires_grad_()
    y = tspmm.PreparedAggregate(tp)(xa)
    assert "SpmmFunction" in y.grad_fn.name()
    (ga,) = torch.autograd.grad((y * w).sum(), xa)
    xb = x.clone().requires_grad_()
    (gb,) = torch.autograd.grad((tp.mul_plain(xb) * w).sum(), xb)
    mag = tp.transpose().mul_plain(w.abs())
    assert bool(((ga - gb).abs() <= 1e-5 * mag + 1e-6).all())
    kind, shape, exchange, cfg = LAYOUTS[layout]
    fresh = (prepare_spmm_2d(tg, make_mesh(*shape, CPUS),
                             tspmm.SpmmConfig(**cfg)) if kind == "2d" else
             prepare_spmm_halo(tg, make_node_mesh(shape, CPUS),
                               tspmm.SpmmConfig(**cfg), exchange=exchange))
    with pytest.raises(ValueError, match="not prepared"):
        tspmm.PreparedAggregate(fresh)(x.clone().requires_grad_())


@pytest.fixture(scope="module")
def planted():
    return load_dataset("planted-2000-24000-4")


def test_training_parity_2d_mesh(planted):
    """The twin of ``test_training_parity.py``'s 2D mesh case (ell, hidden
    32, 10 epochs over a (2, 2) mesh): the trained accuracy within 0.01 of
    the oracle's, the trained activations within 1e-4."""
    res = run_training_benchmark(planted, hidden=32, epochs=10,
                                 mesh=make_mesh(2, 2, CPUS),
                                 config=tspmm.SpmmConfig(backend="ell"),
                                 device="cpu")
    assert res["acc_delta"] <= 0.01
    assert res["validate"] == "OK"
    assert res["transpose_bytes"] > 0
    assert res["layout"] == "mesh sp=2 ds=2"


def test_train_step_over_halo_hybrid():
    """The threaded step over the halo hybrid (all_to_all, a 12-hub f32
    slab; ``test_halo.py``'s training case): a finite loss equal to the
    same step's through the plain versions (dropout 0, the same
    parameters), and parameters the step moved."""
    rng = np.random.default_rng(34)
    n = 96
    r = np.concatenate([rng.integers(0, 12, 1500), rng.integers(0, n, 600)])
    c = np.concatenate([rng.integers(0, 12, 1500), rng.integers(0, n, 600)])
    v = rng.standard_normal(r.size)
    tg = tgraph.CooGraph.from_edges(r, c, v, nrows=n, ncols=n)
    tp = prepare_spmm_halo(tg, make_node_mesh(4, CPUS),
                           tspmm.SpmmConfig(backend="hybrid", hybrid_k=12))
    tp.transpose(tg)
    x = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, C, n))
    mask = torch.ones(n)
    losses, moved = [], []
    for agg in ("kernels", "plain"):
        _jgnn, model = both_models("gcn")
        before = [p.detach().clone() for p in model.parameters()]
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        if agg == "kernels":
            step, dev = ttrain.make_train_step_threaded(model, tp, opt)
            loss = step(x, y, mask, torch.Generator().manual_seed(1), dev)
        else:
            loss = ttrain.make_train_step(model, tp.mul_plain, opt)(
                x, y, mask, torch.Generator().manual_seed(1))
        losses.append(float(loss))
        moved.append(any(not torch.equal(a, b)
                         for a, b in zip(before, model.parameters())))
    assert np.isfinite(losses).all() and all(moved)
    close(losses[0], losses[1], 1e-5, "loss")


def test_train_cuda_over_mesh(capsys):
    """``train_cuda.py --sp_parts 2 --ds_parts 2`` on the CPU: the same
    [DATA] lines as on one device, and the same losses (the same
    parameters and dropout draws; only the f32 sums' order differs)."""
    import train_cuda

    def run(extra):
        capsys.readouterr()
        train_cuda.main(["--dataset", "tiny", "--epochs", "3",
                         "--hidden_size", "16", *extra], device="cpu")
        return parse_data_lines(capsys.readouterr().out.splitlines())

    mesh = run(["--sp_parts", "2", "--ds_parts", "2"])
    one = run([])
    assert set(mesh) == set(one) and mesh["epoch"] == one["epoch"]
    np.testing.assert_allclose(mesh["train_loss"], one["train_loss"],
                               rtol=1e-4)


def test_dryrun_multichip():
    """The twin of ``__graft_entry__.dryrun_multichip(8)`` completes on a
    virtual CPU mesh of eight."""
    dryrun_multichip(8, device="cpu")
