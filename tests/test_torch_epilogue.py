"""K-epi (``ops/epilogue.py``) and the fused evaluation forward against the
JAX package on the CPU.

The evaluation forward (``nn/models.py:gnn_apply`` where no gradient is
needed) ends every block in one K-epi pass; on the CPU the wrapper runs
its plain version, so these tests hold the fused forward's route and
arithmetic, and the card holds the kernel to the plain version
(``chip_smoke.py:epilogue_checks``).

Tolerances: the fused forward's logits against JAX's ``gnn_apply`` at
1e-5 of their largest magnitude, the bar of ``tests/test_torch_convs.py``
(the two packages' products differ in f32 summation order only, and a
reordered sum can move a rounded value by one quantization step); the
fused forward against the port's own unfused one bit for bit
(``torch.equal``: the same ops, in the same order); K-epi's plain version
against JAX's ``relu(batchnorm_apply(p, out * scale + bias))`` within 8
f32 ulps of the largest term behind each value (six roundings, and XLA
may contract a multiply and an add into one), NaN and ±inf where JAX has
them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn import layers as jlayers
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.bench import validate as tvalidate
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.nn import layers as tlayers
from pygim_tpu_torch.nn.models import (
    GNN,
    forward_block,
    forward_stem,
    gnn_apply,
    params_from_jax,
)
from pygim_tpu_torch.ops import epilogue as tepi
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.utils.metrics import DataReporter

from test_torch_train import C, F, H, N, small_graph

BACKENDS = {
    "hybrid": dict(backend="hybrid", hybrid_shape="stair",
                   hybrid_dtype="int8", hybrid_core_bytes=64 << 10),
    "ell": dict(backend="ell"),
    "blocked": dict(backend="blocked", n_blocks=3),
    "oracle": dict(backend="oracle"),
}
AGG_DTYPES = [None, "int8", "int16", "int32"]


def random_params(params, rng):
    """The JAX pytree with every BatchNorm statistic and affine, and every
    bias, drawn at random (make_gnn leaves them at 0 and 1)."""
    def walk(p):
        if isinstance(p, dict):
            out = {}
            for k, v in p.items():
                v = np.asarray(v) if not isinstance(v, (dict, list)) else v
                if k == "var":
                    out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
                elif k == "scale":
                    out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                elif k in ("mean", "bias", "b"):
                    out[k] = (0.2 * rng.standard_normal(v.shape)).astype(
                        np.float32)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(p, list):
            return [walk(v) for v in p]
        return np.asarray(p)
    return walk(jax.tree_util.tree_map(np.asarray, params))


_OPERANDS = {}


def operands(backend):
    """Both packages' prepared operands of the small graph on
    ``backend``, built once a test process."""
    if backend not in _OPERANDS:
        rows, cols, vals = small_graph()
        cfg = BACKENDS[backend]
        jp = jspmm.prepare_spmm(
            jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
            jspmm.SpmmConfig(**cfg))
        tp = tspmm.prepare_spmm(
            tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
            tspmm.SpmmConfig(**cfg), device="cpu")
        if backend == "hybrid":
            assert tp.stair, "the test graph must fill stair bands"
        _OPERANDS[backend] = jp, tp
    return _OPERANDS[backend]


def both_models(conv, agg_dtype, seed=4):
    jgnn = jmake_gnn(jax.random.key(seed), conv, F, H, C, num_layers=2,
                     agg_dtype=agg_dtype)
    params = random_params(jgnn.params, np.random.default_rng(seed))
    jgnn = dataclasses.replace(
        jgnn, params=jax.tree_util.tree_map(jnp.asarray, params))
    model = GNN(conv, F, H, C, num_layers=2, agg_dtype=agg_dtype)
    model.load_state_dict(params_from_jax(params))
    return jgnn, model.eval()


class Spy:
    """Counts the calls of a module function (and of the hooks below)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


class RawHookCount(tspmm.PreparedAggregate):
    """A PreparedAggregate that counts the fused hooks' calls and the raw
    hook's non-None answers."""

    def __init__(self, prep):
        super().__init__(prep)
        self.raw_calls = self.raw_fused = self.quantized_calls = 0

    def quantized_raw(self, v, agg_dtype):
        self.raw_calls += 1
        got = super().quantized_raw(v, agg_dtype)
        self.raw_fused += got is not None
        return got

    def quantized(self, v, agg_dtype):
        self.quantized_calls += 1
        return super().quantized(v, agg_dtype)


@pytest.mark.parametrize("agg_dtype", AGG_DTYPES)
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
def test_fused_forward_matches_jax(conv, backend, agg_dtype, monkeypatch):
    """The fused evaluation forward against JAX's ``gnn_apply``, its route
    (one K-epi pass a block, GIN's MLP one more; the quantized aggregate
    through the raw hook where the backend fuses) and its values against
    the port's unfused forward, bit for bit."""
    jp, tp = operands(backend)
    jgnn, model = both_models(conv, agg_dtype)
    x = np.random.default_rng(2).standard_normal((N, F)).astype(np.float32)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))

    spy = Spy(tepi.epilogue_plain)
    monkeypatch.setattr(tepi, "epilogue_plain", spy)
    agg = RawHookCount(tp)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), agg)
    mag = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape == (N, C)
    assert np.isfinite(got.numpy()).all()
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * mag

    assert spy.calls == (5 if conv == "gin" else 3)
    # every conv asks the raw hook; a backend that does not fuse answers
    # None to it and to ``quantized`` (which asks the raw one again), and
    # the round trip runs
    fuses = agg_dtype is not None and backend in ("hybrid", "ell")
    asked = 0 if agg_dtype is None else 2
    assert agg.raw_calls == (asked if fuses else 2 * asked)
    assert agg.quantized_calls == (0 if fuses else asked)
    assert agg.raw_fused == (2 if fuses else 0)

    # stage by stage, fused against the separate ops: equal bit for bit
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        h1, h0 = forward_stem(model, xt, True), forward_stem(model, xt, False)
        assert torch.equal(h1, h0)
        for i in range(2):
            a = forward_block(model, i, h0, agg, True)
            b = forward_block(model, i, h0, agg, False)
            assert torch.equal(a, b), i
            h0 = b


def test_grad_mode_takes_the_separate_ops(monkeypatch):
    """Where a gradient can flow (grad mode on, parameters that require
    grad) the evaluation forward keeps the ops, which autograd follows,
    and gives the same logits."""
    _jp, tp = operands("oracle")
    _jgnn, model = both_models("gcn", None)
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((N, F)).astype(np.float32))
    agg = tspmm.PreparedAggregate(tp)
    with torch.inference_mode():
        want = gnn_apply(model, x, agg)
    spy = Spy(tepi.epilogue_plain)
    monkeypatch.setattr(tepi, "epilogue_plain", spy)
    assert not tlayers.fusable(x, *model.parameters())
    x.requires_grad_(True)
    got = gnn_apply(model, x, agg)
    assert spy.calls == 0 and got.requires_grad
    got.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert torch.equal(got.detach(), want)


def np_epilogue(a, p, scale, bias):
    """The reference's chain in JAX: dequantize, bias, batchnorm_apply,
    relu."""
    y = jnp.asarray(a)
    if scale is not None:
        y = y * jnp.float32(scale)
    if bias is not None:
        y = y + jnp.asarray(bias)
    return np.asarray(jax.nn.relu(jlayers.batchnorm_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, y)))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("h", [1, 41, 64])
def test_plain_epilogue_matches_jax(h, with_scale, with_bias):
    rng = np.random.default_rng(h)
    n = 257
    a = (3 * rng.standard_normal((n, h))).astype(np.float32)
    a[0, 0], a[1, h - 1], a[2, h // 2] = np.nan, np.inf, -np.inf
    a[3, 0] = -0.0
    p = {"scale": rng.uniform(-1.5, 1.5, h).astype(np.float32),
         "bias": rng.standard_normal(h).astype(np.float32),
         "mean": rng.standard_normal(h).astype(np.float32),
         "var": rng.uniform(0.1, 3.0, h).astype(np.float32)}
    scale = np.float32(0.0625) if with_scale else None
    bias = rng.standard_normal(h).astype(np.float32) if with_bias else None
    want = np_epilogue(a, p, scale, bias)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tepi.epilogue(
        torch.from_numpy(a), t["mean"], t["var"], t["scale"], t["bias"], 1e-5,
        scale=None if scale is None else torch.tensor(scale),
        bias=None if bias is None else torch.from_numpy(bias)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert nan.any()  # the NaN row stays NaN through the ReLU
    assert np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
    # six roundings, each within half an ulp of the largest term it sees
    y = a.astype(np.float64) * (1.0 if scale is None else float(scale))
    y = y + (0.0 if bias is None else bias.astype(np.float64))
    inv = 1.0 / np.sqrt(p["var"].astype(np.float64) + 1e-5)
    mag = (np.abs(y) + np.abs(p["mean"])) * np.abs(inv * p["scale"]) \
        + np.abs(p["bias"])
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= 8 * 2.0 ** -24 * mag[fin])


def test_plain_epilogue_is_the_chain_of_ops():
    """The plain version is ``a * s``, ``+ c``, ``batchnorm_apply``,
    ``torch.relu``, bit for bit; the wrapper computes ``inv`` once."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(100, 24, generator=g)
    a[5, 3] = float("nan")
    mean, gamma, beta, c = (torch.randn(24, generator=g) for _ in range(4))
    var = torch.rand(24, generator=g) + 0.5
    s = torch.tensor(0.3)
    want = torch.relu(tlayers.batchnorm_apply(gamma, beta, mean, var,
                                              a * s + c, 1e-5))
    got = tepi.epilogue(a, mean, var, gamma, beta, 1e-5, scale=s, bias=c)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


def test_wrapper_refuses_grad_and_other_devices():
    h = 8
    mean, var, gamma, beta = (torch.zeros(h), torch.ones(h), torch.ones(h),
                              torch.zeros(h))
    a = torch.randn(4, h, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        tepi.epilogue(a, mean, var, gamma, beta, 1e-5)
    with torch.no_grad():
        assert tepi.epilogue(a, mean, var, gamma, beta, 1e-5).shape == (4, h)
    m = torch.empty(4, h, device="meta")
    with pytest.raises(ValueError, match="no K-epi kernel"):
        tepi.epilogue(m, *(t.to("meta") for t in (mean, var, gamma, beta)),
                      1e-5)


class PerturbedRaw:
    """An aggregate whose undequantized product (the raw hook the fused
    forward takes) has one row moved by ``delta`` in dequantized units
    (100: above the check's 1e-2 of any row's magnitude on this graph)."""

    def __init__(self, agg, row, delta):
        self.agg, self.row, self.delta = agg, row, delta
        self.raw_calls = 0

    def __call__(self, v):
        return self.agg(v)

    def quantized(self, v, agg_dtype):
        return self.agg.quantized(v, agg_dtype)

    def quantized_raw(self, v, agg_dtype):
        self.raw_calls += 1
        got = self.agg.quantized_raw(v, agg_dtype)
        if got is not None:
            out, scale = got
            out = out.clone()
            out[self.row] += self.delta / scale
            got = out, scale
        return got


@pytest.mark.parametrize("backend", ["hybrid", "ell"])
def test_validation_fails_a_perturbed_row_on_the_fused_route(backend):
    """``bench/validate.py`` walks the fused forward and captures the raw
    hook's product: a perturbed sampled row fails the per-layer check, an
    unsampled one passes unseen, as on the unfused route."""
    rows, cols, vals = small_graph()
    tg = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    _jp, tp = operands(backend)
    _jgnn, model = both_models("gcn", "int8")
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((N, F)).astype(np.float32))
    rep = DataReporter(echo=False)
    assert tvalidate.validate_inference_sampled(
        tg, model, x, tvalidate.JittedAggregate(tp), reporter=rep)
    assert max(rep.records["agg0_max_rel_err"][0],
               rep.records["agg1_max_rel_err"][0]) <= 1e-5
    sampled = np.sort(np.random.default_rng(0).choice(N, 128, replace=False))
    bad = PerturbedRaw(tvalidate.JittedAggregate(tp), int(sampled[5]), 100.0)
    rep = DataReporter(echo=False)
    assert not tvalidate.validate_inference_sampled(tg, model, x, bad,
                                                    reporter=rep)
    assert bad.raw_calls == 2
    assert rep.records["validate"] == ["ERROR"]
    assert rep.records["agg0_max_rel_err"][0] > 1e-2
    spare = int(np.setdiff1d(np.arange(N), sampled)[0])
    assert tvalidate.validate_inference_sampled(
        tg, model, x, PerturbedRaw(tvalidate.JittedAggregate(tp), spare, 100.0))
