"""The ``coo`` backend, SDDMM and the dense and SDDMM oracles of the
PyTorch port against the JAX package on the CPU.

Tolerances: integer payloads on integer weights accumulate in int32 on
both sides, wrapping alike, so they are bit-equal; float payloads differ
in f32 summation order only (the reference adds each chunk's segment
sums into the output, the port adds the chunk's rows into it): 1e-5 of
the sum of |terms| per element (1e-5 of the largest |output| for the
forwards, as ``test_torch_convs.py``). SDDMM sums each edge's D products
in f32 on both sides: the reference's own 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import partition as jpartition
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import reference as jref
from pygim_tpu.ops import sddmm as jsddmm
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.bench.experiment import Experiment
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import partition as tpartition
from pygim_tpu_torch.ops import reference as tref
from pygim_tpu_torch.ops import sddmm as tsddmm
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_convs import carried
from test_torch_train import F, N, small_graph

REL = 1e-5


def random_edges(nrows, ncols, nnz, dtype="float32", seed=0):
    """The reference's ``random_coo`` draw (tests/conftest.py:43-58):
    distinct pairs, integer weights in [-4, 4] or normal ones; numpy."""
    rng = np.random.default_rng(seed)
    flat = np.unique(rng.integers(0, nrows, nnz).astype(np.int64) * ncols
                     + rng.integers(0, ncols, nnz))
    rows, cols = flat // ncols, flat % ncols
    vals = (rng.integers(-4, 5, rows.size) if dtype.startswith("int")
            else rng.standard_normal(rows.size))
    return rows, cols, vals


def both_graphs(rows, cols, vals, nrows, ncols, dtype="float32"):
    kw = dict(nrows=nrows, ncols=ncols, dtype=dtype)
    return (jgraph.CooGraph.from_edges(rows, cols, vals, **kw),
            tgraph.CooGraph.from_edges(rows, cols, vals, **kw))


@pytest.mark.parametrize("n_chunks", [1, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int8"])
def test_build_coo_chunks_matches_reference(dtype, n_chunks):
    rows, cols, vals = random_edges(150, 120, 900, dtype, seed=n_chunks)
    jg, tg = both_graphs(rows, cols, vals, 150, 120, dtype)
    want = jpartition.build_coo_chunks(jg, n_chunks)
    got = tpartition.build_coo_chunks(tg, n_chunks)
    for f in ("rows", "cols", "vals"):
        w, g = getattr(want, f), getattr(got, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.n_chunks, got.chunk_nnz, got.nrows, got.ncols) == \
        (want.n_chunks, want.chunk_nnz, want.nrows, want.ncols)
    assert got.rows[-1, -1] == 149 and got.vals.reshape(-1)[tg.nnz:].sum() == 0


@pytest.mark.parametrize("n_blocks", [None, 1, 4, 13])
@pytest.mark.parametrize("payload", ["float32", "bfloat16", "int8", "int16",
                                     "int32"])
def test_coo_backend_matches_jax(payload, n_blocks):
    """Float and bf16 payloads on float weights; integer payloads on
    integer weights, exact int32 with the reference's wraparound (int32
    payloads large enough that sums pass 2^31)."""
    integer = payload.startswith("int")
    rows, cols, vals = random_edges(150, 120, 900,
                                    "int32" if integer else "float32",
                                    seed=len(payload))
    jg, tg = both_graphs(rows, cols, vals, 150, 120,
                         "int32" if integer else "float32")
    kw = dict(backend="coo", n_blocks=n_blocks, block_nnz_budget=256)
    jp = jspmm.prepare_spmm(jg, jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(**kw), device="cpu")
    assert tp.dev_arrays["rows"].shape[0] == (n_blocks or 4)
    rng = np.random.default_rng(3)
    if integer:
        hi = {"int8": 127, "int16": 1 << 14, "int32": 1 << 29}[payload]
        x = rng.integers(-hi, hi + 1, (120, 24)).astype(payload)
        want = np.asarray(jp.mul(jnp.asarray(x)))
        got = tp.mul(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        if payload == "int32":  # the int32 sums wrapped
            exact = (tg.to_dense().astype(np.int64) @ x.astype(np.int64))
            assert (np.abs(exact) >= 1 << 31).any()
            np.testing.assert_array_equal(got, exact.astype(np.int32))
        return
    x = rng.standard_normal((120, 24)).astype(np.float32)
    if payload == "bfloat16":
        want = np.asarray(jp.mul(jnp.asarray(x, jnp.bfloat16)))
        xt = torch.from_numpy(x).to(torch.bfloat16)
        x = xt.float().numpy()
    else:
        want = np.asarray(jp.mul(jnp.asarray(x)))
        xt = torch.from_numpy(x)
    got = tp.mul(xt).numpy()
    assert got.dtype == want.dtype == np.float32
    mag = np.abs(jg.to_dense().astype(np.float64)) @ np.abs(x.astype(
        np.float64))
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("backend", ["oracle", "blocked", "ell", "coo"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_backend_matches_dense(backend, dtype):
    """The reference's backend-parametrised case (tests/test_spmm.py:
    14-25) on the port, ``spmm_dense_oracle`` the ground truth."""
    rng = np.random.default_rng(5)
    rows, cols, vals = random_edges(150, 120, 900, dtype, seed=6)
    _jg, tg = both_graphs(rows, cols, vals, 150, 120, dtype)
    x = (rng.integers(-3, 4, size=(120, 48)).astype(np.int32)
         if dtype == "int32"
         else rng.standard_normal((120, 48)).astype(np.float32))
    prep = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(backend=backend,
                                                   n_blocks=4), device="cpu")
    out = prep.mul(torch.from_numpy(x)).numpy()
    ref = tref.spmm_dense_oracle(tg.to_dense(), x)
    assert out.shape == (150, 48)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_spmm_dense_oracle_matches_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((20, 30)).astype(np.float32)
    x = rng.integers(-5, 6, (30, 7)).astype(np.int8)
    got = tref.spmm_dense_oracle(a, x)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jref.spmm_dense_oracle(a, x))


@pytest.mark.parametrize("agg_dtype", [None, "int8", "int32"])
@pytest.mark.parametrize("conv", ["gin", "sage"])
def test_gin_and_sage_forwards_on_coo_match_jax(conv, agg_dtype):
    """Tracked config 3's models on the coo backend (quantized
    aggregation takes the unfused round trip there, as in the
    reference)."""
    rows, cols, vals = small_graph()
    jg, tg = both_graphs(rows, cols, vals, N, N)
    jp = jspmm.prepare_spmm(jg, jspmm.SpmmConfig(backend="coo"))
    tp = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(backend="coo"),
                            device="cpu")
    assert not tp.supports_fused_quant
    jgnn = jmake_gnn(jax.random.key(4), conv, F, 16, 5, num_layers=2,
                     agg_dtype=agg_dtype)
    x = np.random.default_rng(2).standard_normal((N, F)).astype(np.float32)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    model = carried(jgnn, conv)
    model.agg_dtype = agg_dtype
    with torch.inference_mode():
        got = model(torch.from_numpy(x), tspmm.PreparedAggregate(tp)).numpy()
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= REL * max(
        1.0, float(np.abs(want).max()))


def test_coo_gradient_is_autograd_through_the_ops():
    """The coo aggregate's gradient (the name is the old route's: autograd
    through the plain ops) now runs K-rows' backward, ``SpmmFunction`` on
    the prepared Aᵀ: the aggregate refuses a gradient before Aᵀ is
    prepared, then equals the dense ``Aᵀ w``."""
    rows, cols, vals = random_edges(60, 60, 400, seed=1)
    _jg, tg = both_graphs(rows, cols, vals, 60, 60)
    tp = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(backend="coo", n_blocks=3),
                            device="cpu")
    x = torch.randn(60, 5, dtype=torch.float32, requires_grad=True)
    w = torch.randn(60, 5)
    agg = tspmm.PreparedAggregate(tp)
    with pytest.raises(ValueError, match="not prepared"):
        agg(x)
    tp.transpose(tg)
    y = agg(x)
    assert "SpmmFunction" in y.grad_fn.name()
    (g,) = torch.autograd.grad((y * w).sum(), x)
    want = torch.from_numpy(tg.to_dense().T.astype(np.float32)) @ w
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)


def test_experiment_coo_runs_on_the_cpu(tmp_path):
    exp = Experiment(dataset="tiny", backend="coo", sp_format="coo",
                     hidden=8, repeat=1)
    assert exp.refusal() is None
    means = exp.run(tmp_path / "r", data_root=str(tmp_path / "d"),
                    device="cpu")
    assert means["pim_time_spmm(ms)"] > 0
    out = (tmp_path / "r" / f"{exp.frozen_name()}.out").read_text()
    assert "[DATA]verify: OK" in out and "[DATA]device: cpu" in out


@pytest.mark.parametrize("chunk", [8, 128, 1 << 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sddmm_matches_reference(dtype, chunk):
    """``prepare_sddmm(...).run`` against the reference's and against
    both ``sddmm_coo_oracle``s on the row-sorted edges
    (tests/test_spmm.py:97-106, 215-226)."""
    rows, cols, vals = random_edges(120, 90, 700, seed=chunk)
    jg, tg = both_graphs(rows, cols, vals, 120, 90)
    rng = np.random.default_rng(4)
    if dtype == "int8":
        a = rng.integers(-128, 128, (120, 32)).astype(np.int8)
        b = rng.integers(-128, 128, (90, 32)).astype(np.int8)
        ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), *map(
            torch.from_numpy, (a, b))
    else:
        a = rng.standard_normal((120, 32)).astype(np.float32)
        b = rng.standard_normal((90, 32)).astype(np.float32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        tdt = getattr(torch, dtype)
        ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
        ta, tb = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    jprep = jsddmm.prepare_sddmm(jg, jsddmm.SddmmConfig(edge_chunk=chunk))
    tprep = tsddmm.prepare_sddmm(tg, tsddmm.SddmmConfig(edge_chunk=chunk),
                                 device="cpu")
    assert tprep.chunk == jprep.chunk
    want = np.asarray(jprep.run(ja, jb))
    got = tprep.run(ta, tb).numpy()
    assert got.shape == (tg.nnz,) and got.dtype == want.dtype
    s = tg.sort_by_row()
    oracle = tref.sddmm_coo_oracle(torch.from_numpy(s.rows).long(),
                                   torch.from_numpy(s.cols).long(), ta,
                                   tb).numpy()
    joracle = np.asarray(jref.sddmm_coo_oracle(s.rows, s.cols, ja, jb))
    if dtype == "int8":  # exact int32 sums
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(oracle, joracle)
        np.testing.assert_array_equal(got, oracle)
        return
    af, bf = ta.float().numpy(), tb.float().numpy()
    exact = np.einsum("kd,kd->k", af[s.rows].astype(np.float64),
                      bf[s.cols].astype(np.float64))
    for name, v in (("run", got), ("jax run", want), ("oracle", oracle),
                    ("jax oracle", joracle)):
        np.testing.assert_allclose(v, exact, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_sddmm_empty_graph():
    _jg, tg = both_graphs(np.zeros(0, int), np.zeros(0, int),
                          np.zeros(0), 5, 4)
    prep = tsddmm.prepare_sddmm(tg, device="cpu")
    out = prep.run(torch.randn(5, 3), torch.randn(4, 3))
    assert out.shape == (0,)
