"""The training path of the PyTorch port against the JAX package on the
CPU: the training-mode forward, the gradients of a masked cross-entropy
with respect to every parameter, one Adam step, three whole train steps,
the GIN quirk of the reference, the prepared transpose the aggregate's
backward runs on, and the guards that keep a gradient from being dropped
at a kernel.

Tolerances. Float backends (oracle, ell, blocked, coo) differ from JAX only
in the order of f32 sums, carried through BatchNorm and the dense
layers: 1e-5 of the magnitude for forwards and losses, and 1e-4 of each
leaf's largest |grad| for gradients (readings here: at most 2.1e-5 on
every GCN and SAGE leaf, 5.8e-5 on GIN's other leaves). GIN's
second-layer MLP is the exception (``GIN_CANCELLING``): the backward
subtracts the batch means of BatchNorm's gradient, a cancellation of
terms ~10^3 times the result there, so the two packages' plain f32
backwards differ on ``convs.1.mlp.bn.scale``, ``bn.var`` and ``lin2.w``
by 9.3e-4, 9.3e-4 and 8.6e-4 of the leaf on the oracle, 1.4e-4 on ell
and 6.0e-4 on blocked; those three leaves are held within 1e-3. A wrong
transpose is off by O(1). The stair-int8 hybrid rounds the core's
payload to bf16 in the forward on both sides (a reordered f32 sum can
flip a rounding there), and its backward rounds at other points: the
reference rounds each band's share of the core's gradient to bf16 after
its transposed product and adds the shares in bf16, K-core on Aᵀ rounds
the cotangent to bf16 before its product and sums in f32. The batch
statistics of the layers below amplify both: the two packages differ by
up to 1.485e-2 of a leaf's largest |grad| here (SAGE's ``ln1.w``; GCN
6.7e-3, GIN 7.2e-3), so a hybrid leaf is held within
``HYBRID_GRAD_TOL`` = 2e-2 of it. The bar tells the rounded core's
gradient from a float one: JAX's float gradients sit 5.0e-2 (GCN),
6.8e-1 (GIN) and 4.1e-2 (SAGE) from its hybrid ones, and the test
checks that they fail it. It cannot tell where a backward rounds: with
the port's forward, a backward in plain f32 came within 9.5e-3 of JAX's
hybrid gradient and one rounding its input and output to bf16 within
1.6e-2, because the forward's rounding flips dominate;
``test_spmm_function_gradient_matches_plain_autograd`` holds the
aggregate's own backward."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.data import datasets as jdata
from pygim_tpu.nn import models as jmodels
from pygim_tpu.nn import train as jtrain
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.nn import train as ttrain
from pygim_tpu_torch.nn.models import (
    GNN,
    gnn_apply,
    merge_bn_stats,
    params_from_jax,
)
from pygim_tpu_torch.ops import core_dot, core_int, ell_tail
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import (
    KW,
    N as N_PREP,
    by_row_col,
    make_graph,
    reference_planner,
)

N, E, F, H, C = 1000, 40_000, 12, 16, 5
CONVS = ["gcn", "gin", "sage"]
BACKENDS = {
    "oracle": dict(backend="oracle"),
    "ell": dict(backend="ell"),
    "blocked": dict(backend="blocked", n_blocks=3),
    "coo": dict(backend="coo", n_blocks=3),
    "stair-int8": dict(backend="hybrid", hybrid_shape="stair",
                       hybrid_dtype="int8", hybrid_core_bytes=64 << 10),
}
FLOAT_GRAD_TOL = 1e-4
GIN_CANCELLING = ("convs.1.mlp.bn.scale", "convs.1.mlp.bn.var",
                  "convs.1.mlp.lin2.w")
GIN_CANCELLING_TOL = 1e-3
HYBRID_GRAD_TOL = 2e-2


def small_graph():
    """(rows, cols, vals) of a 1000-node R-MAT multigraph (the stand-ins'
    generator), unit weights, numpy, from a fixed seed."""
    rows, cols = jdata.rmat_edges(N, E, seed=3)
    vals = np.ones(E, np.float32)
    if not reference_planner():
        rows, cols, vals = by_row_col(rows, cols, vals)
    return rows, cols, vals


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, F)).astype(np.float32)
    y = rng.integers(0, C, N).astype(np.int32)
    mask = (rng.random(N) < 0.3).astype(np.float32)
    return x, y, mask


def both_aggregates(backend, transpose=True):
    """Both packages' aggregates of the small graph on ``backend``, and
    the port's operand; on the kernel backends (ell, the hybrid, blocked,
    coo) its Aᵀ is prepared (training needs it) unless ``transpose`` is
    False."""
    rows, cols, vals = small_graph()
    cfg = BACKENDS[backend]
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**cfg))
    graph = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    tp = tspmm.prepare_spmm(graph, tspmm.SpmmConfig(**cfg), device="cpu")
    if backend == "stair-int8":
        assert tp.stair, "the test graph must fill stair bands"
    if transpose and tp.config.backend in tspmm.KERNEL_BACKENDS:
        tp.transpose(graph)
    return jspmm.PreparedAggregate(jp), tspmm.PreparedAggregate(tp), tp


def both_models(conv, seed=0, dropout=0.0):
    jgnn = jmodels.make_gnn(jax.random.key(seed), conv, F, H, C,
                            num_layers=2, dropout=dropout)
    model = GNN(conv, F, H, C, num_layers=2, dropout=dropout)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgnn.params)))
    return jgnn, model.train()


def jax_loss_fn(jgnn, agg, x, y, mask):
    def loss_fn(params):
        logits, stats = jmodels.gnn_apply(
            params, x, agg, conv=jgnn.conv, num_layers=2, dropout_rate=0.0,
            agg_dtype=None, training=True, rng=jax.random.key(0),
            return_bn_stats=True)
        return jtrain.softmax_cross_entropy(logits, y, mask), (logits, stats)
    return loss_fn


def torch_inputs(x, y, mask):
    return (torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
            torch.from_numpy(mask))


def close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    assert err <= rel * mag, f"{what}: {err} > {rel} × {mag}"


@pytest.mark.parametrize("conv", CONVS)
def test_training_forward_and_bn_stats_match_jax(conv):
    """Dropout 0: batch statistics in every BatchNorm of the model, the
    updated running statistics, and the logits, rtol 1e-5 (2e-5 for the
    variances: a square doubles the relative error of the activation it
    is taken of)."""
    jagg, tagg, _ = both_aggregates("oracle")
    jgnn, model = both_models(conv)
    x, y, mask = inputs()
    _, (want, jstats) = jax_loss_fn(jgnn, jagg, jnp.asarray(x),
                                    jnp.asarray(y), jnp.asarray(mask))(
        jgnn.params)
    with torch.no_grad():
        got, stats = gnn_apply(model, torch.from_numpy(x), tagg,
                               training=True, return_bn_stats=True)
    close(got.numpy(), want, 1e-5, "logits")
    for name, s, js in [("bn0", stats["bn0"], jstats["bn0"])] + [
            (f"bns.{i}", s, js) for i, (s, js) in
            enumerate(zip(stats["bns"], jstats["bns"]))]:
        close(s["mean"].numpy(), js["mean"], 1e-5, f"{name}.mean")
        close(s["var"].numpy(), js["var"], 2e-5, f"{name}.var")


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("conv", CONVS)
def test_gradients_match_jax(conv, backend):
    """d(masked cross-entropy)/d(every parameter) through each backend:
    JAX's autodiff through its prepared operand against the port's
    backward (on ell and the hybrid, the prepared Aᵀ); tolerances in the
    module docstring, plus 1e-6 (a few f32 ulps of a loss near 1) for
    the leaves whose gradient is 0 in exact arithmetic and rounding noise
    in both packages (a bias right before a BatchNorm). A parameter JAX
    gets a zero gradient for (the running statistics of bn0/bns) has
    none in the port. On the hybrid, JAX's float gradients must fail the
    hybrid's bar on some leaf."""
    jagg, tagg, tp = both_aggregates(backend)
    jgnn, model = both_models(conv)
    x, y, mask = inputs()

    def jax_grads(agg):
        (loss, _), g = jax.value_and_grad(
            jax_loss_fn(jgnn, agg, jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(mask)), has_aux=True)(jgnn.params)
        return loss, params_from_jax(jax.tree_util.tree_map(np.asarray, g))

    def bar(key, scale):
        if backend == "stair-int8":
            tol = HYBRID_GRAD_TOL
        elif conv == "gin" and key in GIN_CANCELLING:
            tol = GIN_CANCELLING_TOL
        else:
            tol = FLOAT_GRAD_TOL
        return tol * scale + 1e-6

    jloss, want = jax_grads(jagg)
    xt, yt, mt = torch_inputs(x, y, mask)
    logits = gnn_apply(model, xt, tagg, training=True)
    loss = ttrain.softmax_cross_entropy(logits, yt, mt)
    loss.backward()
    close(float(loss), float(jloss), 1e-5, "loss")
    named = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(named) | set(buffers) == set(want)
    for key, g in want.items():
        g = g.numpy()
        if key in buffers:
            assert not g.any(), key
            continue
        got = named[key].grad
        assert got is not None, key
        scale = float(np.abs(g).max())
        err = float(np.abs(got.numpy() - g).max())
        assert err <= bar(key, scale), (key, err, scale)
    if backend == "stair-int8":
        _, float_grads = jax_grads(both_aggregates("oracle")[0])
        assert any(
            float((float_grads[k] - want[k]).abs().max())
            > bar(k, float(want[k].abs().max())) for k in named), \
            "the hybrid's bar passes JAX's float gradients"


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax(steps):
    """torch.optim.Adam(lr) from identical parameters and gradients
    against optax.adam(lr): ``mhat / (sqrt(vhat) + 1e-8)``, within 1e-6
    of each parameter's scale (both round in f32, each within 2e-7 of a
    float64 Adam here)."""
    rng = np.random.default_rng(5)
    shapes = [(7, 3), (3,), ()]
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    grads = [[np.asarray(rng.standard_normal(s) * 10.0 ** -k, np.float32)
              for s in shapes] for k in range(steps)]
    lr = 1e-2
    tx = optax.adam(lr)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = torch.optim.Adam(tp, lr=lr)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, a in zip(tp, g):
            t.grad = torch.from_numpy(a)
        opt.step()
    for i, (t, want) in enumerate(zip(tp, jp)):
        close(t.detach().numpy(), want, 1e-6, f"parameter {i}")


@pytest.mark.parametrize("conv", CONVS)
def test_three_train_steps_match_jax(conv):
    """Three steps of make_train_step on the oracle (dropout 0) against
    JAX's make_train_step with optax.adam: losses within 1e-5. (Adam
    moves an element by about ``lr`` whatever its gradient's size, so an
    element whose gradient is rounding noise, a bias before a BatchNorm,
    moves by ±lr in either package: parameters are not compared.)"""
    jagg, tagg, _ = both_aggregates("oracle")
    jgnn, model = both_models(conv)
    x, y, mask = inputs()
    lr = 1e-2
    tx = optax.adam(lr)
    jstep = jax.jit(jtrain.make_train_step(jgnn, jagg, tx))
    params, state = jgnn.params, tx.init(jgnn.params)
    step = ttrain.make_train_step(model, tagg,
                                  torch.optim.Adam(model.parameters(), lr=lr))
    xt, yt, mt = torch_inputs(x, y, mask)
    for i in range(3):
        params, state, jloss = jstep(params, state, jnp.asarray(x),
                                     jnp.asarray(y), jnp.asarray(mask),
                                     jax.random.key(i))
        loss = step(xt, yt, mt)
        close(float(loss), float(jloss), 1e-5, f"loss {i}")


def test_gin_quirk_matches_jax():
    """GIN's eps and its MLP's BatchNorm mean/var are leaves of the
    reference's parameters: one Adam step moves them as JAX's does,
    while merge_bn_stats sets bn0/bns (rtol 1e-5) and leaves the MLP's
    alone. Adam's first step is ``lr · g / (|g| + 1e-8)``, about ``lr``
    in the gradient's direction: an element whose gradient is rounding
    noise (a unit ReLU keeps at 0) steps either way in either package, so
    the Adam-moved leaves are held within 1e-6 of their scale (a few f32
    ulps) where JAX's step is above 0.9 lr, and most of their elements
    must be."""
    jagg, tagg, _ = both_aggregates("ell")
    jgnn, model = both_models("gin")
    x, y, mask = inputs()
    lr = 1e-2
    tx = optax.adam(lr)
    params, _, _ = jtrain.make_train_step(jgnn, jagg, tx)(
        jgnn.params, tx.init(jgnn.params), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(mask), jax.random.key(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ttrain.make_train_step(model, tagg, torch.optim.Adam(
        model.parameters(), lr=lr))(*torch_inputs(x, y, mask))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    sd = model.state_dict()
    for i in range(2):
        for k in (f"bns.{i}.mean", f"bns.{i}.var"):
            assert not torch.equal(sd[k], before[k]), f"{k} did not move"
            close(sd[k].numpy(), want[k].numpy(), 1e-5, k)
        for k in (f"convs.{i}.eps", f"convs.{i}.mlp.bn.mean",
                  f"convs.{i}.mlp.bn.var"):
            step = (want[k] - before[k]).abs()
            sure = step > 0.9 * lr
            assert sure.float().mean() > 0.5, k
            close(sd[k][sure].numpy(), want[k][sure].numpy(), 1e-6, k)
    assert isinstance(model.convs[0].eps, torch.nn.Parameter)
    assert isinstance(model.convs[0].mlp.bn.mean, torch.nn.Parameter)
    assert not isinstance(model.bn0.mean, torch.nn.Parameter)


def test_merge_bn_stats_writes_running_stats():
    _, model = both_models("gcn")
    x = torch.from_numpy(inputs()[0])
    _, stats = gnn_apply(model, x, lambda v: v, training=True,
                         return_bn_stats=True)
    merge_bn_stats(model, stats)
    assert torch.equal(model.bn0.mean, stats["bn0"]["mean"])
    assert torch.equal(model.bns[1].var, stats["bns"][1]["var"])
    _, none = gnn_apply(model, x, lambda v: v, training=False,
                        return_bn_stats=True)
    assert none["bn0"] is None and none["bns"] == [None, None]


def test_dropout_draws_from_the_generator():
    """Training at rate 0.5 needs a generator; the same seed gives the
    same masks, another seed others; evaluation ignores dropout."""
    _, model = both_models("sage", dropout=0.5)
    x = torch.from_numpy(inputs()[0])
    with pytest.raises(ValueError, match="Generator"):
        gnn_apply(model, x, lambda v: v, training=True)
    outs = [gnn_apply(model, x, lambda v: v, training=True,
                      generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    ev = gnn_apply(model, x, lambda v: v, training=False)
    assert torch.equal(ev, gnn_apply(model, x, lambda v: v, training=False))


@pytest.mark.parametrize("kind", ["multigraph", "simple"])
@pytest.mark.parametrize("backend", ["stair-int8", "ell"])
def test_transpose_tables_match_reference(kind, backend):
    """PreparedSpmm.transpose(): the host tables of the graph with rows
    and cols swapped under the same configuration, byte-equal to the
    reference's prepare of that graph (with K-core's stair rule, widths
    a multiple of 256, coming out of the same planner)."""
    rows, cols, vals = make_graph(kind)
    if not reference_planner():
        # without the native planner the reference lexsorts each CSR row;
        # feed the transposed graph in (row, col) order of its own
        o = np.lexsort((rows, cols))
        rows, cols, vals = rows[o], cols[o], vals[o]
    cfg = KW if backend == "stair-int8" else dict(backend="ell")
    graph = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N_PREP,
                                       ncols=N_PREP)
    tp = tspmm.prepare_spmm(graph, tspmm.SpmmConfig(**cfg), device="cpu")
    assert tp._transpose is None  # built only when asked for
    with pytest.raises(ValueError, match="not prepared"):
        tp.transpose()  # the operand keeps no host graph
    with pytest.raises(ValueError, match="edges"):
        tp.transpose(tgraph.CooGraph.from_edges(
            rows[1:], cols[1:], vals[1:], nrows=N_PREP, ncols=N_PREP))
    tt = tp.transpose(graph)
    assert tp.transpose() is tt and tp.transpose(graph) is tt
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(cols, rows, vals, nrows=N_PREP,
                                   ncols=N_PREP),
        jspmm.SpmmConfig(**cfg))
    assert tt.stair == getattr(jp, "stair", None)
    assert tt.ell_meta == jp.ell_meta
    if backend == "stair-int8":
        assert tt.stair and all(w % 16 == 0 for *_, w in tt.stair)
    jdev = {k: np.asarray(v) for k, v in jp.dev_arrays.items()}
    assert set(tt.dev_arrays) == set(jdev)
    for k, v in jdev.items():
        got = tt.dev_arrays[k].numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


@pytest.mark.parametrize("backend", ["stair-int8", "ell", "blocked", "coo"])
def test_spmm_function_gradient_matches_plain_autograd(backend):
    """The aggregate's gradient through SpmmFunction (backward: the
    kernels' plain versions on the CPU, on Aᵀ) against autograd through
    mul_plain on A. ell, blocked, coo: f32 on both sides, 1e-5 of the sum
    of |terms|; the hybrid's core rounds to bf16 (comment below). The
    aggregate refuses a gradient before Aᵀ is prepared, and inference
    needs none."""
    _, agg, tp = both_aggregates(backend, transpose=False)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32))
    with torch.inference_mode():
        agg(x)
    assert tp._transpose is None
    with pytest.raises(ValueError, match="not prepared"):
        agg(x.clone().requires_grad_())
    rows, cols, vals = small_graph()
    tp.transpose(tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N,
                                            ncols=N))
    xa = x.clone().requires_grad_()
    y = agg(xa)
    assert "SpmmFunction" in y.grad_fn.name()
    (ga,) = torch.autograd.grad((y * w).sum(), xa)
    xb = x.clone().requires_grad_()
    (gb,) = torch.autograd.grad((tp.mul_plain(xb) * w).sum(), xb)
    torch.testing.assert_close(y.detach(), tp.mul_plain(x), rtol=0,
                               atol=1e-5 * float(tp.mul_plain(x.abs()).max()))
    mag = tp.transpose().mul_plain(w.abs())
    if backend != "stair-int8":
        assert bool(((ga - gb).abs() <= 1e-5 * mag + 1e-6).all())
    else:
        # SpmmFunction: one bf16 rounding of each core term's cotangent
        # (2^-9), against the float64 Aᵀ w; autograd through mul_plain
        # rounds each band's share to bf16 and adds the shares in bf16
        exact = torch.zeros(N, H, dtype=torch.float64).index_add_(
            0, torch.from_numpy(cols).long(),
            w.double()[torch.from_numpy(rows).long()]
            * torch.from_numpy(vals).double()[:, None])
        assert bool(((ga - exact).abs() <= 2.0 ** -8 * mag + 1e-6).all())
        n = len(tp.stair) + 2
        assert bool(((ga - gb).abs() <= n * 2.0 ** -9 * mag + 1e-6).all())


def test_kernel_wrappers_refuse_grad():
    """Each kernel wrapper raises on an operand that requires grad under
    grad mode (on the card its ctypes write would cut the graph without a
    word), on the CPU as on the card; under no_grad it runs."""
    _, agg, tp = both_aggregates("stair-int8")
    d = tp.dev_arrays
    bands = [d[k] for k in tp._band_keys]
    cn = d["core_nodes"]
    w_max = max(w for *_, w in tp.stair)
    out = torch.zeros(N, H)
    xc = torch.zeros(w_max, H, dtype=torch.bfloat16, requires_grad=True)
    x = torch.zeros(N, H, requires_grad=True)
    tables = tp.ell_tables(d)
    calls = [
        lambda: core_dot.core_bands_scatter_add(bands, xc, cn, tp.stair, out),
        lambda: ell_tail.ell_tables_add(x, tables, out),
        lambda: core_int.core_int_scatter_add(
            bands, torch.zeros(w_max, H, dtype=torch.int32), cn, tp.stair,
            torch.zeros(N, H, requires_grad=True)),
        lambda: tp.mul(x),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()


def test_quantized_aggregate_refuses_grad():
    """Training aggregates the float payload: the fused quantized hook
    raises under grad on a payload that requires grad, and runs without
    it."""
    _, agg, _ = both_aggregates("stair-int8")
    x = torch.randn(N, H, requires_grad=True)
    with pytest.raises(NotImplementedError, match="float payload"):
        agg.quantized(x, "int32")
    with torch.no_grad():
        assert agg.quantized(x, "int32").shape == (N, H)


def test_threaded_step_and_eval_step():
    """make_train_step_threaded is the same step over prep.raw_mul(v,
    dev), one step closure for every call; make_eval_step returns
    (accuracy, logits) without autograd."""
    _, agg, tp = both_aggregates("ell")
    x, y, mask = torch_inputs(*inputs())
    losses = []
    for threaded in (False, True):
        _, model = both_models("gcn")
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        if threaded:
            step, dev = ttrain.make_train_step_threaded(model, tp, opt)
            assert dev is tp.dev_arrays
            losses.append([float(step(x, y, mask, None, dev))
                           for _ in range(2)])
        else:
            step = ttrain.make_train_step(model, agg, opt)
            losses.append([float(step(x, y, mask)) for _ in range(2)])
    assert losses[0] == losses[1]
    acc, logits = ttrain.make_eval_step(model, agg)(x, y, mask)
    assert logits.shape == (N, C) and not logits.requires_grad
    assert 0.0 <= float(acc) <= 1.0


def test_step_split_times_each_phase():
    """make_train_step with a StepSplit: the same losses as without it,
    one time per phase and step, and each phase's launches (none on the
    CPU, where the wrappers run the plain versions)."""
    _, agg, _ = both_aggregates("ell")
    x, y, mask = torch_inputs(*inputs())
    losses = []
    for split in (None, ttrain.StepSplit()):
        _, model = both_models("sage")
        step = ttrain.make_train_step(
            model, agg, torch.optim.Adam(model.parameters(), lr=1e-2), split)
        losses.append([float(step(x, y, mask)) for _ in range(3)])
    assert losses[0] == losses[1]
    assert set(split.ms) == set(ttrain.StepSplit.PHASES)
    assert all(len(v) == 3 and min(v) >= 0.0 for v in split.ms.values())
    assert set(split.launches) == set(ttrain.StepSplit.PHASES)
    assert not any(n for v in split.launches.values() for n in v.values())
