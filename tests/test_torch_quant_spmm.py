"""The integer-quantized aggregate on the CPU: K-tail-quant's plain
version in each payload mode against the reference's ELL bodies
(``ell_scan_spmm_quant`` and ``ell_scan_spmm`` on integer rows), and the
port's ``mul_quantized`` and integer ``mul`` against the JAX package's on
stair configs. The CUDA kernels are held against the plain versions on
the card by chip_smoke.py.

Tolerances. Where the edge weights are integers and every sum stays
under 2^24, every f32 sum is exact in any order, so the two packages are
held bit-equal. Elsewhere (fractional weights, int32 payloads whose sums
pass 2^24) only the f32 summation order differs: 1e-5 of each element's
sum of |terms|, the reference's own bar for a quantized product
(tests/test_spmm.py)."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.quant import symmetric_quantize as jquantize
from pygim_tpu_torch.bench.runners import run_spmm_benchmark, spmm_model_bytes
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.ops import ell_tail
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.quant import quant_scale, symmetric_quantize
from pygim_tpu_torch.utils.metrics import parse_data_lines

from test_torch_prepare import GRAPHS, KW, N, make_graph
from test_torch_tail_grouped import ragged_graph, tables_of

REL = 1e-5
QDTYPES = ["int8", "int16", "int32"]


def both_preps(kind):
    rows, cols, vals = make_graph(kind)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    return (rows, cols, vals), jp, tp


def small_features(seed, h=24):
    """Features whose int32 quantization stays small except at one
    element, so every int32 sum of the test graphs stays under 2^24."""
    x = np.random.default_rng(seed).standard_normal((N, h)).astype(np.float32)
    x *= np.float32(1e-3)
    x[5, 3] = 1.0
    return x


def step_tables(seed, integer_weights):
    rows, cols, vals = ragged_graph(300, seed)
    if integer_weights:
        vals = np.round(vals * 2).astype(np.float32)
    return tables_of(rows, cols, vals, 300), 300


def jax_tail(fn, x, tables, n, *args):
    out = None
    for c, v, r, d in tables:
        out = fn(jnp.asarray(x), *args, jnp.asarray(c), jnp.asarray(v),
                 jnp.asarray(r), r.shape[1], d, n, out=out)
    return np.asarray(out)


def port_tables(tables):
    return [(*(torch.from_numpy(a) for a in t[:3]), t[3]) for t in tables]


def magnitude(q, tables, n):
    mag = np.zeros((n, q.shape[1]))
    for c, v, r, d in tables:
        terms = np.abs(q[c.reshape(-1)].astype(np.float64)) \
            * np.abs(v.reshape(-1, 1).astype(np.float64))
        np.add.at(mag, np.repeat(r.reshape(-1), d), terms)
    return mag


@pytest.mark.parametrize("integer_weights", [True, False])
@pytest.mark.parametrize("h", [8, 41])
def test_rounded_rows_match_ell_scan_spmm_quant(h, integer_weights):
    """Mode (iii): f32 rows rounded to round(x / safe) in the gather."""
    tables, n = step_tables(h, integer_weights)
    x = (np.random.default_rng(h).standard_normal((n, h)) * 3).astype(np.float32)
    js, _ = jquantize(jnp.asarray(x), "int32")
    jsafe = jnp.where(js == 0, jnp.ones_like(js), js)
    want = jax_tail(jspmm.ell_scan_spmm_quant, x, tables, n, jsafe, "int32")
    _s, safe = quant_scale(torch.from_numpy(x), "int32")
    assert float(safe) == float(jsafe)
    got = ell_tail.ell_tables_plain(torch.from_numpy(x), port_tables(tables),
                                    torch.zeros(n, h), safe).numpy()
    if integer_weights:
        np.testing.assert_array_equal(got, want)
    else:
        q = np.round(x / np.float32(float(safe)))
        assert np.all(np.abs(got - want) <= REL * magnitude(q, tables, n)
                      + 1e-30)


def test_rounded_rows_half_step_ties_round_to_even():
    """x / safe lands exactly on k + 1/2 (safe a power of two): the port's
    rounding and the reference's agree, and both round half to even."""
    tables, n = step_tables(3, True)
    h = 16
    k = np.random.default_rng(0).integers(-6, 6, (n, h))
    safe = np.float32(2.0 ** -10)
    x = ((k + 0.5) * safe).astype(np.float32)
    want = jax_tail(jspmm.ell_scan_spmm_quant, x, tables, n,
                    jnp.float32(safe), "int32")
    tsafe = torch.tensor(safe)
    got = ell_tail.ell_tables_plain(torch.from_numpy(x), port_tables(tables),
                                    torch.zeros(n, h), tsafe).numpy()
    np.testing.assert_array_equal(got, want)
    q = torch.round(torch.from_numpy(x) / tsafe).numpy()
    np.testing.assert_array_equal(q, np.round(k + 0.5))  # half to even
    assert np.any(q != np.floor(k + 0.5) + 1)


def _rn32(v: Fraction) -> np.float32:
    """An exact rational rounded to the nearest float32, ties to even
    (subnormals included)."""
    if v == 0:
        return np.float32(0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if a < Fraction(2) ** e:
        e -= 1  # 2^e <= a < 2^(e + 1)
    quantum = Fraction(2) ** (max(e, -126) - 23)
    m = round(a / quantum)  # a Fraction rounds half to even
    return np.float32(float(m * quantum) * (1 if v > 0 else -1))


def _fma32(a, b, c) -> np.float32:
    """fma(a, b, c) in float32: the exact a · b + c, rounded once."""
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def kernel_rounding(v: np.ndarray, safe: np.float32) -> np.ndarray:
    """K-tail-quant's rounding of f32 rows (csrc/ell_tail.cu, QuantRcp),
    step by step: r = RN(1 / safe); y0 = RN(v · r); the correction y =
    fma(fma(-y0, safe, v), r, y0); the residual rem = fma(-y, safe, v) and
    q = fma(rem, r, y), each fma an exact Fraction rounded once; then half
    to even. The model asserts what the kernel's comment claims: y lies
    within an ulp of v / safe, so rem is exact."""
    r = np.float32(1) / safe
    out = np.empty_like(v)
    for i, x in enumerate(v.tolist()):
        x = np.float32(x)
        y0 = x * r
        y = _fma32(_fma32(-y0, safe, x), r, y0)
        exact = Fraction(float(x)) - Fraction(float(y)) * Fraction(float(safe))
        rem = _fma32(-y, safe, x)
        assert Fraction(float(rem)) == exact, (x, safe)
        out[i] = np.rint(_fma32(rem, r, y))
    return out


def _safe(kind: str) -> np.float32:
    if kind == "quant":  # quant_scale of seeded activations
        x = np.random.default_rng(21).standard_normal((64, 32)) * 3
        return np.float32(float(quant_scale(
            torch.from_numpy(x.astype(np.float32)), "int32")[1]))
    return np.float32({"pow2": 2.0 ** -10, "ones": float.fromhex("0x1.fffffep-8"),
                       "one": 1.0, "low": float.fromhex("0x1.7ffffep-100"),
                       "high": float.fromhex("0x1.fffffep99")}[kind])


@pytest.mark.parametrize("kind", ["quant", "pow2", "ones", "one", "low",
                                  "high"])
def test_reciprocal_rounding_is_the_true_division(kind):
    """The kernel's division-free rounding (Markstein's correction of v ·
    RN(1 / safe)) equals round(v / safe) of PyTorch and of the reference,
    on random activations and on every value within 4 ulps of a few
    hundred half-steps (k + 1/2) · safe, for a safe from quant_scale, a
    power of two, an all-ones mantissa, 1, and the reciprocal route's
    limits (2^-100 <= safe <= 2^100)."""
    safe = _safe(kind)
    rng = np.random.default_rng(len(kind))
    k = np.r_[rng.integers(-(1 << 19) - 1, (1 << 19) + 2, 250),
              0, -1, 1, (1 << 19), -(1 << 19) - 1, (1 << 19) + 1]
    c = ((k + 0.5) * np.float64(safe)).astype(np.float32)  # (k + 1/2) safe
    near = (c.view(np.int32)[:, None]
            + np.arange(-4, 5, dtype=np.int32)).view(np.float32)
    rand = (rng.uniform(-1, 1, 2000) * (1 << 19) * np.float64(safe))
    v = np.r_[near.ravel(), rand.astype(np.float32)]
    if kind == "quant":  # the activations themselves
        x = np.random.default_rng(21).standard_normal((64, 32)) * 3
        v = np.r_[v, x.astype(np.float32).ravel()]
    v = v.astype(np.float32)
    got = kernel_rounding(v, safe)
    want = torch.round(torch.from_numpy(v) / torch.tensor(safe)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jnp.round(jnp.asarray(v) / jnp.float32(safe)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("integer_weights", [True, False])
def test_integer_rows_match_ell_scan_spmm(dtype, integer_weights):
    """Mode (ii): int8 / int16 / int32 rows widened to f32; the
    reference's accumulation dtype on integer rows is f32 too."""
    tables, n = step_tables(11, integer_weights)
    h = 24
    m = {"int8": 128, "int16": 512, "int32": 1 << 14}[dtype]
    x = np.random.default_rng(5).integers(-m, m, (n, h)).astype(dtype)
    want = jax_tail(jspmm.ell_scan_spmm, x, tables, n)
    assert want.dtype == np.float32
    got = ell_tail.ell_tables_plain(torch.from_numpy(x), port_tables(tables),
                                    torch.zeros(n, h)).numpy()
    if integer_weights:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= REL * magnitude(x, tables, n)
                      + 1e-30)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_tail_wrapper_on_cpu_is_the_plain_version(dtype):
    tables, n = step_tables(2, False)
    tt = port_tables(tables)
    h = 20
    out0 = torch.randn(n, h)
    if dtype == "int32":  # the int32 aggregate rounds f32 rows
        x = torch.randn(n, h) * 3
        _s, safe = quant_scale(x, "int32")
        kw = {"safe": safe}
    else:
        x = torch.randint(-100, 100, (n, h)).to(getattr(torch, dtype))
        kw = {}
    before = (ell_tail.launches, ell_tail.quant_launches)
    got = ell_tail.ell_tables_add(x, tt, out0.clone(), **kw)
    want = ell_tail.ell_tables_plain(x, tt, out0.clone(), kw.get("safe"))
    assert torch.equal(got, want)
    assert (ell_tail.launches, ell_tail.quant_launches) == before


@pytest.mark.parametrize("bad", ["int_rounded", "safe_shape", "safe_dtype",
                                 "x_int64"])
def test_tail_wrapper_rejects_payloads(bad):
    tables, n = step_tables(2, False)
    tt = port_tables(tables)
    x, out, safe = torch.randn(n, 8), torch.zeros(n, 8), torch.tensor(0.5)
    if bad == "int_rounded":
        x = x.to(torch.int32)
    elif bad == "safe_shape":
        safe = safe.reshape(1)
    elif bad == "safe_dtype":
        safe = safe.double()
    else:
        x, safe = x.long(), None
    with pytest.raises(TypeError):
        ell_tail.ell_tables_add(x, tt, out, safe=safe)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("kind", GRAPHS)
def test_mul_quantized_matches_jax(kind, dtype):
    (rows, cols, vals), jp, tp = both_preps(kind)
    x = small_features(len(kind))
    want = np.asarray(jp.mul_quantized(jnp.asarray(x), dtype))
    got = tp.mul_quantized(torch.from_numpy(x), dtype).numpy()
    agg = tspmm.PreparedAggregate(tp).quantized(torch.from_numpy(x), dtype)
    assert torch.equal(agg, torch.from_numpy(got))
    plain = tp.mul_quantized_plain(torch.from_numpy(x), dtype)
    assert torch.equal(plain, torch.from_numpy(got))
    if kind != "wide":  # integer weights: every sum exact
        np.testing.assert_array_equal(got, want)
    else:
        scale, q = symmetric_quantize(torch.from_numpy(x), dtype)
        dense = np.zeros((N, N))
        np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
        mag = dense @ np.abs(q.numpy().astype(np.float64)) * float(scale)
        assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_mul_quantized_is_the_unfused_round_trip(dtype):
    """The fused path equals quantize → mul → dequantize in the port, as
    the reference's docstring promises for its own."""
    _g, _jp, tp = both_preps("multigraph")
    x = torch.from_numpy(small_features(9))
    scale, q = symmetric_quantize(x, dtype)
    assert torch.equal(tp.mul_quantized(x, dtype), tp.mul(q) * scale)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("kind", ["multigraph", "wide"])
def test_integer_mul_matches_jax(kind, dtype):
    """``prep.mul`` on the reference's quantized payload x_q."""
    (rows, cols, vals), jp, tp = both_preps(kind)
    x = small_features(3)
    _s, jq = jquantize(jnp.asarray(x), dtype)
    want = np.asarray(jp.mul(jq))
    _s, q = symmetric_quantize(torch.from_numpy(x), dtype)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    got = tp.mul(q).numpy()
    assert got.dtype == want.dtype == np.float32
    if kind != "wide":
        np.testing.assert_array_equal(got, want)
    else:
        dense = np.zeros((N, N))
        np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
        mag = dense @ np.abs(q.numpy().astype(np.float64))
        assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("dtype", ["int16", "int32"])
def test_integer_mul_full_range_matches_jax(dtype):
    """Raw payloads over their dtype's whole range: the core's int32
    sums wrap, in both packages alike, and the tail sums their f32
    conversions."""
    (rows, cols, vals), jp, tp = both_preps("multigraph")
    info = np.iinfo(dtype)
    q = np.random.default_rng(1).integers(info.min, info.max, (N, 8),
                                          endpoint=True).astype(dtype)
    want = np.asarray(jp.mul(jnp.asarray(q)))
    got = tp.mul(torch.from_numpy(q)).numpy()
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    mag = dense @ np.abs(q.astype(np.float64))
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


def test_quantized_hook_raises_on_unported_dtypes():
    """A float64 x still raises. The float passthrough (a float
    ``agg_dtype``), refused before it was ported, is the reference's
    within 1e-5 of its largest magnitude; int64, refused before the int64
    payload was ported, is the int32 path (x64 off, as the reference) in
    the hook and in ``mul``."""
    _g, jp, tp = both_preps("multigraph")
    agg = tspmm.PreparedAggregate(tp)
    xn = np.random.default_rng(1).standard_normal((N, 8)).astype(np.float32)
    x = torch.from_numpy(xn)
    want = np.asarray(jp.raw_mul_quantized(jnp.asarray(xn), jp.dev_arrays,
                                           "float32"))
    np.testing.assert_allclose(agg.quantized(x, "float32").numpy(), want,
                               rtol=0, atol=REL * np.abs(want).max())
    assert torch.equal(agg.quantized(x, "int64"), agg.quantized(x, "int32"))
    with pytest.raises(TypeError):
        agg.quantized(torch.zeros(N, 8, dtype=torch.float64), "int8")
    xi = torch.randint(-99, 99, (N, 8), dtype=torch.int64)
    assert torch.equal(tp.mul(xi), tp.mul(xi.to(torch.int32)))
    assert tp.supports_fused_quant


@pytest.mark.parametrize("dtype", ["float32", *QDTYPES])
def test_run_spmm_benchmark_payloads(dtype, capsys):
    ds = load_dataset("rmat-2000-40000")
    capsys.readouterr()
    means = run_spmm_benchmark(ds, hidden=16, dtype=dtype,
                               config=tspmm.SpmmConfig(**KW), repeat=1,
                               device="cpu")
    parsed = parse_data_lines(capsys.readouterr().out.splitlines())
    assert parsed["verify"] == ["OK"]
    itemsize = np.dtype(dtype).itemsize
    dt = means["pim_time_spmm(ms)"] / 1e3
    want = spmm_model_bytes(ds.graph.nnz, ds.graph.nrows, 16, itemsize) / dt / 1e9
    assert means["spmm_effective_GBps"] == pytest.approx(want, rel=1e-9)


def test_run_spmm_benchmark_rejects_unported_payloads():
    """bfloat16 and int64, refused before they were ported, now run with
    their sampled-row check; a payload the reference does not take
    (float16) is refused."""
    ds = load_dataset("tiny")
    for dtype in ("bfloat16", "int64"):
        means = run_spmm_benchmark(ds, dtype=dtype, repeat=1, device="cpu")
        assert means["verify"] == "OK"
    with pytest.raises(ValueError, match="float16"):
        run_spmm_benchmark(ds, dtype="float16", device="cpu")
