"""Per-layer validation of the forward (``bench/validate.py``) against the
reference's (``pygim_tpu/bench/validate.py``): the sampled check passes
on the real aggregates with errors close to the reference's on the same
inputs, and fails on one perturbed row; the whole-activation checks; and
``run_inference_benchmark(validate=True)``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygim_tpu.bench import validate as jvalidate
from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.bench import validate as tvalidate
from pygim_tpu_torch.bench.runners import run_inference_benchmark
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.nn.models import GNN, params_from_jax
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.utils.metrics import DataReporter

from test_torch_prepare import N, make_graph

F, H, C = 24, 64, 7
CONFIGS = {
    "square-int4": dict(backend="hybrid", hybrid_shape="square",
                        hybrid_dtype="int4", hybrid_core_bytes=512 << 10),
    "stair-int8": dict(backend="hybrid", hybrid_shape="stair",
                       hybrid_dtype="int8", hybrid_core_bytes=256 << 10),
    "blocked": dict(backend="blocked"),
    "ell": dict(backend="ell"),
}


def setup(cfg, agg_dtype, kind="multigraph"):
    rows, cols, vals = make_graph(kind)
    jg = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    tg = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    jp = jspmm.prepare_spmm(jg, jspmm.SpmmConfig(**CONFIGS[cfg]))
    tp = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(**CONFIGS[cfg]),
                            device="cpu")
    jgnn = jmake_gnn(jax.random.key(1), "gcn", F, H, C, num_layers=2,
                     agg_dtype=agg_dtype)
    m = GNN("gcn", F, H, C, agg_dtype=agg_dtype)
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jgnn.params)))
    x = np.random.default_rng(4).standard_normal((N, F)).astype(np.float32)
    return (jg, jp, jgnn), (tg, tp, m.eval()), x


@pytest.mark.parametrize("agg_dtype", ["int8", "int32", None])
@pytest.mark.parametrize("cfg", ["square-int4", "stair-int8", "blocked"])
def test_sampled_validation_matches_reference(cfg, agg_dtype):
    (jg, jp, jgnn), (tg, tp, m), x = setup(cfg, agg_dtype)
    jrep, trep = DataReporter(echo=False), DataReporter(echo=False)
    assert jvalidate.validate_inference_sampled(
        jg, jgnn, jnp.asarray(x), jvalidate.JittedAggregate(jp),
        reporter=jrep)
    assert tvalidate.validate_inference_sampled(
        tg, m, torch.from_numpy(x), tvalidate.JittedAggregate(tp),
        reporter=trep)
    assert trep.records["validate"] == ["OK"]
    # an integer aggregate (quantized, or a float one on the blocked
    # backend) is exact but for the f32 rounding of its sums; a float x
    # through an int core is rounded to bf16 (2^-9), as in the reference
    exact = agg_dtype is not None or cfg == "blocked"
    for i in range(2):
        j = jrep.records[f"agg{i}_max_rel_err"][0]
        t = trep.records[f"agg{i}_max_rel_err"][0]
        assert t <= (1e-5 if exact else 1e-2), (i, t)
        assert abs(t - j) <= 1e-5, (i, t, j)


class Perturbed:
    """An aggregate whose fused output has one row moved by ``delta``."""

    def __init__(self, agg, row, delta):
        self.agg, self.row, self.delta = agg, row, delta

    def __call__(self, v):
        out = self.agg(v).clone()
        out[self.row] += self.delta
        return out

    def quantized(self, v, agg_dtype):
        out = self.agg.quantized(v, agg_dtype)
        if out is not None:
            out = out.clone()
            out[self.row] += self.delta
        return out


@pytest.mark.parametrize("agg_dtype", ["int8", None])
def test_one_perturbed_sampled_row_fails(agg_dtype):
    _j, (tg, tp, m), x = setup("square-int4", agg_dtype)
    rows = np.sort(np.random.default_rng(0).choice(N, 128, replace=False))
    rep = DataReporter(echo=False)
    bad = Perturbed(tvalidate.JittedAggregate(tp), int(rows[5]), 0.5)
    assert not tvalidate.validate_inference_sampled(
        tg, m, torch.from_numpy(x), bad, reporter=rep)
    assert rep.records["validate"] == ["ERROR"]
    assert max(rep.records["agg0_max_rel_err"][0],
               rep.records["agg1_max_rel_err"][0]) > 1e-2
    # a row the check does not sample passes unseen, as in the reference
    spare = int(np.setdiff1d(np.arange(N), rows)[0])
    assert tvalidate.validate_inference_sampled(
        tg, m, torch.from_numpy(x),
        Perturbed(tvalidate.JittedAggregate(tp), spare, 0.5))


@pytest.mark.parametrize("cfg", ["blocked", "ell"])
def test_validate_model_against_the_oracle(cfg):
    """Exact-in-f32 backends against the oracle at the reference's
    defaults (1e-4), and a perturbed aggregate caught."""
    _j, (tg, tp, m), x = setup(cfg, None)
    oracle = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(backend="oracle"),
                                device="cpu")
    rep = DataReporter(echo=False)
    assert tvalidate.validate_model(
        m, torch.from_numpy(x), tspmm.PreparedAggregate(tp),
        tspmm.PreparedAggregate(oracle), reporter=rep)
    assert rep.records["validate"] == ["OK"]
    assert len([k for k in rep.records if k.startswith("layer")]) == 4
    assert not tvalidate.validate_model(
        m, torch.from_numpy(x), Perturbed(tspmm.PreparedAggregate(tp), 3, 5.0),
        tspmm.PreparedAggregate(oracle))


@pytest.mark.parametrize("cfg", ["blocked", "ell"])
def test_validate_backend(cfg):
    rows, cols, vals = make_graph("simple")
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    assert tvalidate.validate_backend(g, 64, tspmm.SpmmConfig(**CONFIGS[cfg]),
                                      device="cpu")


def test_run_inference_benchmark_validates():
    ds = load_dataset("rmat-2000-40000")
    cfg = tspmm.SpmmConfig(**CONFIGS["square-int4"])
    res = run_inference_benchmark(ds, hidden=32, agg_dtype="int8",
                                  config=cfg, repeat=1, validate=True,
                                  device="cpu")
    assert res["validate"] == "OK"
    assert res["agg0_max_rel_err"] <= 1e-5 and res["agg1_max_rel_err"] <= 1e-5


def test_run_inference_benchmark_raises_on_a_failed_check(monkeypatch):
    ds = load_dataset("rmat-2000-40000")
    cfg = tspmm.SpmmConfig(**CONFIGS["square-int4"])
    real = tspmm.PreparedSpmm.raw_mul_quantized

    def off(self, x, dev, agg_dtype, plain=False):
        out = real(self, x, dev, agg_dtype, plain)
        out[::7] += 1.0
        return out

    monkeypatch.setattr(tspmm.PreparedSpmm, "raw_mul_quantized", off)
    with pytest.raises(AssertionError, match="validation"):
        run_inference_benchmark(ds, hidden=32, agg_dtype="int8", config=cfg,
                                repeat=1, validate=True, device="cpu")
