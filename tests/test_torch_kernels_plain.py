"""The kernels' plain PyTorch versions against the JAX functions they
replace (CPU). The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.

Tolerance: every int8 × bf16 product is exact in f32, and the JAX and
torch sums run in different orders; a reordered f32 sum of K terms errs
by ~2^-24·sqrt(K) of the sum of |terms| (worst case K·2^-24). We allow
1e-5 of the sum of |terms| per element (``mag`` below)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.ops.pallas_core import dequant_core_dot
from pygim_tpu.quant import symmetric_quantize as jquant
from pygim_tpu_torch.core.graph import CooGraph
from pygim_tpu_torch.core.partition import build_ell_rows
from pygim_tpu_torch.ops import core_dot, ell_tail
from pygim_tpu_torch.ops.spmm import ell_step_tables
from pygim_tpu_torch.quant import symmetric_dequantize, symmetric_quantize

REL = 1e-5


def bf16_np(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (nearest even), back in f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def assert_close(got, want, mag):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= REL * mag + 1e-30), float((err - REL * mag).max())


# (rows, width, H): rows not a multiple of 256, w > rows, H small
BANDS = [(72, 1280, 64), (120, 768, 32), (8, 256, 16), (232, 256, 64),
         (1000, 512, 8)]


@pytest.mark.parametrize("r,w,h", BANDS)
def test_core_plain_matches_xla_core_matmul(r, w, h, monkeypatch):
    monkeypatch.delenv("PYGIM_CORE_PALLAS", raising=False)
    rng = np.random.default_rng(r + w)
    band = rng.integers(-128, 128, (r, w)).astype(np.int8)
    xg = rng.standard_normal((w + 7, h)).astype(np.float32)  # x[core_nodes]
    want = np.asarray(jspmm._core_matmul(
        jnp.asarray(band), jnp.asarray(xg[:w]), jnp.float32))
    n = 3 * r
    rows = rng.permutation(n)[:r].astype(np.int32)
    out = torch.zeros(n, h)
    xc = torch.from_numpy(xg).to(torch.bfloat16)
    core_dot.core_band_plain(torch.from_numpy(band), xc,
                             torch.from_numpy(rows), out)
    mag = np.abs(band.astype(np.float64)) @ np.abs(bf16_np(xg[:w]))
    assert_close(out.numpy()[rows], want, mag)
    untouched = np.setdiff1d(np.arange(n), rows)
    assert not out.numpy()[untouched].any()


@pytest.mark.parametrize("k", [512, 768])
def test_core_plain_matches_pallas_interpret(k):
    rng = np.random.default_rng(0)
    core = rng.integers(-128, 128, (k, k)).astype(np.int8)
    x = rng.standard_normal((k, 128)).astype(np.float32)
    want = np.asarray(dequant_core_dot(jnp.asarray(core), jnp.asarray(x)))
    out = torch.zeros(k, 128)
    core_dot.core_band_plain(
        torch.from_numpy(core), torch.from_numpy(x).to(torch.bfloat16),
        torch.arange(k, dtype=torch.int32), out,
    )
    mag = np.abs(core.astype(np.float64)) @ np.abs(bf16_np(x))
    assert_close(out.numpy(), want, mag)


def test_core_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    band = torch.from_numpy(rng.integers(-128, 128, (40, 300)).astype(np.int8))
    xc = torch.randn(310, 24).to(torch.bfloat16)
    rows = torch.arange(40, dtype=torch.int32) * 2
    out0 = torch.randn(80, 24)
    before = core_dot.launches
    got = core_dot.core_band_scatter_add(band, xc, rows, out0.clone())
    want = core_dot.core_band_plain(band, xc, rows, out0.clone())
    assert torch.equal(got, want)
    assert core_dot.launches == before  # the plain version is no launch


@pytest.mark.parametrize("bad", ["band_dtype", "xc_dtype", "rows_len",
                                 "xc_short", "out_width", "noncontig"])
def test_core_wrapper_rejects(bad):
    band = torch.zeros(16, 64, dtype=torch.int8)
    xc = torch.zeros(64, 16, dtype=torch.bfloat16)
    rows = torch.arange(16, dtype=torch.int32)
    out = torch.zeros(32, 16)
    if bad == "band_dtype":
        band = band.float()
    elif bad == "xc_dtype":
        xc = xc.float()
    elif bad == "rows_len":
        rows = rows[:8]
    elif bad == "xc_short":
        xc = xc[:32]
    elif bad == "out_width":
        out = torch.zeros(32, 8)
    else:
        out = torch.zeros(16, 32).t()
    with pytest.raises((TypeError, ValueError)):
        core_dot.core_band_scatter_add(band, xc, rows, out)


def hub_tables(degree: int, chunk: int, h: int, seed: int):
    """ELL tables of a graph with a hub row spanning many virtual rows."""
    rng = np.random.default_rng(seed)
    n = 300
    rows = rng.integers(0, n, 2000)
    rows[:400] = 17  # hub row: 400 edges, ceil(400 / degree) virtual rows
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    csr = CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n).to_csr()
    t = build_ell_rows(csr, degree, row_chunk=chunk)
    assert np.sum(t.vrow_to_row == 17) > 1
    c3, v3, r3 = ell_step_tables(t.cols, t.vals, t.vrow_to_row, chunk)
    x = rng.standard_normal((n, h)).astype(np.float32)
    return n, c3, v3, r3, x


@pytest.mark.parametrize("degree,chunk,h", [(2, 64, 16), (6, 40, 32),
                                            (32, 8, 24), (4, 1024, 8)])
def test_tail_plain_matches_ell_scan_spmm(degree, chunk, h):
    n, c3, v3, r3, x = hub_tables(degree, chunk, h, seed=degree)
    want = np.asarray(jspmm.ell_scan_spmm(
        jnp.asarray(x), jnp.asarray(c3), jnp.asarray(v3), jnp.asarray(r3),
        chunk, degree, n,
    ))
    out = torch.zeros(n, h)
    ell_tail.ell_tail_plain(torch.from_numpy(x), torch.from_numpy(c3),
                            torch.from_numpy(v3), torch.from_numpy(r3),
                            degree, out)
    mag = np.zeros((n, h))
    np.add.at(mag, r3.ravel(), (np.abs(v3.reshape(-1, degree, 1))
                                * np.abs(x[c3.reshape(-1, degree)])).sum(1))
    assert_close(out.numpy(), want, mag)


def test_tail_wrapper_on_cpu_is_the_plain_version():
    n, c3, v3, r3, x = hub_tables(6, 40, 32, seed=9)
    args = [torch.from_numpy(a) for a in (x, c3, v3, r3)]
    out0 = torch.randn(n, 32)
    before = ell_tail.launches
    got = ell_tail.ell_tail_add(*args, 6, out0.clone())
    want = ell_tail.ell_tail_plain(*args, 6, out0.clone())
    assert torch.equal(got, want)
    assert ell_tail.launches == before


@pytest.mark.parametrize("bad", ["x_dtype", "degree", "vals_shape", "out_width"])
def test_tail_wrapper_rejects(bad):
    n, c3, v3, r3, x = hub_tables(6, 40, 32, seed=4)
    x, c3, v3, r3 = (torch.from_numpy(a) for a in (x, c3, v3, r3))
    out, degree = torch.zeros(n, 32), 6
    if bad == "x_dtype":
        x = x.double()
    elif bad == "degree":
        degree = 4
    elif bad == "vals_shape":
        v3 = v3[:, :-1].contiguous()
    else:
        out = torch.zeros(n, 16)
    with pytest.raises((TypeError, ValueError)):
        ell_tail.ell_tail_add(x, c3, v3, r3, degree, out)


@pytest.mark.parametrize("dtype", [None, "int8", "int16", "int32",
                                   "float32", "bfloat16"])
def test_symmetric_quantize_bit_compatible(dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((200, 16)) * 3).astype(np.float32)
    js, jq = jquant(jnp.asarray(x), dtype)
    ts, tq = symmetric_quantize(torch.from_numpy(x), dtype)
    jq = np.asarray(jq.astype(jnp.float32) if dtype == "bfloat16" else jq)
    tq = (tq.float() if dtype == "bfloat16" else tq).numpy()
    assert tq.dtype == jq.dtype
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(js))
    back = symmetric_dequantize(torch.from_numpy(tq.astype(np.float32)), 1.0, ts)
    assert back.dtype == torch.float32


def test_symmetric_quantize_zero_input():
    s, q = symmetric_quantize(torch.zeros(4, 3), "int8")
    assert float(s) == 0.0 and q.dtype == torch.int8 and not q.any()
