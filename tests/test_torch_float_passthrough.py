"""The float passthrough of the quantized aggregate
(``PreparedSpmm.raw_mul_quantized`` with a float ``agg_dtype``) against
the JAX package's on the CPU: the ell backend, square int8, int4, bf16
and f32 cores, the stair int8 core and two BCSR tiers (f32 tiles, and
bf16 tiles beside an int8 core), for "float32" and "bfloat16".

Both packages round x once to ``round(x / safe)`` (``k = 20``) in
float32, the reference inside the tail's gather and on the core's and
the tier's gathered rows, the port before its gathers, so the payload is
the same in every tier, and a reduced core or bf16 tiles round it to
bf16 on both sides. Only the f32 summation order differs: within 1e-5 of
the output's largest magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu_torch.ops import spmm as tspmm

import test_torch_bcsr as bcsr
import test_torch_prepare as prep

REL = 1e-5
AGG = ["float32", "bfloat16"]
CONFIGS = {
    "ell": ("multigraph", dict(backend="ell")),
    "square int8": ("multigraph", dict(hybrid_shape="square")),
    "square int4": ("multigraph", dict(hybrid_shape="square",
                                       hybrid_dtype="int4")),
    "square bf16": ("wide", dict(hybrid_shape="square",
                                 hybrid_dtype="bfloat16")),
    "square f32": ("wide", dict(hybrid_shape="square", hybrid_dtype=None)),
    "stair int8": ("wide", {}),
}
TIERS = {
    "f32 tiles": bcsr.TIER_CONFIGS["core-tiles-tail"],
    "bf16 tiles": bcsr.TIER_CONFIGS["int8-core-bf16-tiles"],
}


def both(name):
    if name in TIERS:
        make, kw = TIERS[name]
        g = make()
        jp, tp = bcsr.both_preps(g, **kw)
        assert jp.has_bcsr and tp.has_bcsr
        return jp, tp, g[3]
    kind, over = CONFIGS[name]
    rows, cols, vals = prep.make_graph(kind)
    kw = {**prep.KW, **over}
    jp = prep.jspmm.prepare_spmm(prep.jgraph.CooGraph.from_edges(
        rows, cols, vals, nrows=prep.N, ncols=prep.N),
        prep.jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(prep.tgraph.CooGraph.from_edges(
        rows, cols, vals, nrows=prep.N, ncols=prep.N),
        tspmm.SpmmConfig(**kw), device="cpu")
    if over.get("backend") != "ell":
        assert tp.hybrid_k_eff > 0
    return jp, tp, prep.N


@pytest.fixture(scope="module")
def operands():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = both(name)
        return cache[name]
    return get


@pytest.mark.parametrize("agg", AGG)
@pytest.mark.parametrize("name", list(CONFIGS) + list(TIERS))
def test_passthrough_matches_reference(name, agg, operands, monkeypatch):
    """The port's passthrough within 1e-5 of the reference's largest
    magnitude, on the float path: the integer core product and the tail's
    rounding mode are never called."""
    jp, tp, n = operands(name)
    x = np.random.default_rng(3).standard_normal((n, 16)).astype(np.float32)
    want = np.asarray(jp.raw_mul_quantized(jnp.asarray(x), jp.dev_arrays,
                                           agg))

    def no_int(*a, **k):
        raise AssertionError("the integer core product ran")

    tail = tspmm.ell_tables_plain

    def float_tail(x_, tables, out, safe=None):
        assert safe is None and x_.dtype == torch.float32
        return tail(x_, tables, out)

    monkeypatch.setattr(tspmm, "core_int_plain", no_int)
    monkeypatch.setattr(tspmm, "ell_tables_plain", float_tail)
    got = tp.raw_mul_quantized(torch.from_numpy(x), tp.dev_arrays, agg,
                               plain=True).numpy()
    mag = np.abs(want).max()
    assert mag > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * mag)
    monkeypatch.undo()
    agg_out = tspmm.PreparedAggregate(tp).quantized(torch.from_numpy(x), agg)
    assert torch.equal(agg_out, torch.from_numpy(got))


@pytest.mark.parametrize("agg", ["float16", "float64", torch.float32])
def test_every_float_name_is_the_float32_passthrough(agg, operands):
    """Any float dtype is the reference's one float32 passthrough
    (``qdt = x.dtype``): the same scale exponent, the same result."""
    _jp, tp, n = operands("square int8")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, 8)).astype(np.float32))
    assert torch.equal(tp.mul_quantized(x, agg),
                       tp.mul_quantized(x, "float32"))


def test_zero_payload_gives_zeros(operands):
    """``scale == 0``: ``safe = 1``, every tier multiplies zeros."""
    jp, tp, n = operands("f32 tiles")
    out = tp.mul_quantized(torch.zeros(n, 8), "float32")
    assert out.shape == (n, 8) and not out.any()
    want = np.asarray(jp.raw_mul_quantized(jnp.zeros((n, 8)), jp.dev_arrays,
                                           "float32"))
    assert not want.any()


def test_other_names_are_refused(operands):
    _jp, tp, n = operands("ell")
    with pytest.raises(ValueError, match="float dtype"):
        tp.mul_quantized(torch.zeros(n, 8), "uint8")
    with pytest.raises(ValueError, match="float dtype"):
        tp.mul_quantized(torch.zeros(n, 8), "notadtype")
