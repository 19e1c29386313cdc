"""The hybrid's bf16 and f32 cores against the JAX reference: the host
tables byte for byte (the core's cells, its nodes, the tail; bf16 cells
as their uint16 bits), the graph-dtype core (``hybrid_dtype=None``: f32
cells on a float32 graph, the float64 graph's quirk, bf16 on an integer
graph), the banded build against the reference's native planner, the
plain versions of K-core's bf16 mode and of K-f32 against the branches of
``_core_matmul`` they replace, which kernel each core and payload takes,
and the prepare cache of a bf16 core.

Tolerances of the products: bf16 × bf16 and the f32-promoted products
are exact in f32 term by term, so the port and the reference differ only
in the order of their f32 sums. Where every partial sum is an integer
below 2^24 the sums are exact in any order and the two are bit-equal;
elsewhere they are held within 1e-5 of the sum of |terms| (REL), the
bound of a reordered f32 sum at these depths with a wide margin."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import native
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import banded
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import core_dot, core_f32
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import GRAPHS, N, make_graph, reference_planner

REL = 1e-5
SHAPES = ["square", "stair"]
DTYPES = ["bfloat16", "float32"]
BUDGET = 1 << 20  # several stair bands, a square core of k 512 (bf16)


def both_preps(kind, kw, vals_dtype="float32"):
    rows, cols, vals = make_graph(kind)
    vals = vals.astype(vals_dtype)
    args = dict(nrows=N, ncols=N, dtype=vals_dtype)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, **args),
        jspmm.SpmmConfig(**kw))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, **args),
        tspmm.SpmmConfig(**kw), device="cpu")
    return (rows, cols, vals), jp, tp


def stored_bits(t):
    """A device table as numpy, bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def reference_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def assert_tables_equal(jp, tp):
    """Every device table of the two operands equal byte for byte (the
    port's core may carry zero cells past the reference's width, to the
    kernels' width rule)."""
    assert tp.hybrid_k_eff == jp.hybrid_k_eff
    assert tp.ell_meta == [tuple(m) for m in jp.ell_meta]
    jdev = {k: reference_bits(v) for k, v in jp.dev_arrays.items()}
    assert set(tp.dev_arrays) == set(jdev)
    for k, want in jdev.items():
        got = stored_bits(tp.dev_arrays[k])
        if k == "core" or k.startswith("stair"):
            assert not got[:, want.shape[1]:].any(), k
            got = got[:, :want.shape[1]]
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", GRAPHS)
def test_host_tables_byte_equal(kind, shape, dtype):
    _g, jp, tp = both_preps(kind, dict(
        backend="hybrid", hybrid_shape=shape, hybrid_dtype=dtype,
        hybrid_core_bytes=BUDGET))
    assert_tables_equal(jp, tp)
    assert tp.core_dtype == dtype
    cell = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert all(tp.dev_arrays[k].dtype == cell for k in tp._band_keys)
    if shape == "stair":
        assert tp.stair == [tuple(b) for b in jp.stair] and len(tp.stair) > 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("vals_dtype,core", [("float32", "float32"),
                                             ("float64", "float64"),
                                             ("int32", "bfloat16")],
                         ids=["float32", "float64", "int32"])
def test_graph_dtype_core(shape, vals_dtype, core):
    """``hybrid_dtype=None``: the graph's own dtype; a float64 graph's
    core is sized at 8 bytes a cell and stored as f32 cells (the
    reference's quirk); an integer graph's is bf16, written back into the
    operand's config as the reference's."""
    kw = dict(backend="hybrid", hybrid_shape=shape, hybrid_core_bytes=BUDGET)
    _g, jp, tp = both_preps("multigraph", kw, vals_dtype)
    assert_tables_equal(jp, tp)
    assert tp.core_dtype == core
    assert tp.config.hybrid_dtype == jp.config.hybrid_dtype == (
        "bfloat16" if vals_dtype == "int32" else None)
    if shape == "square":
        cell = {"float32": 4, "float64": 8, "bfloat16": 2}[core]
        k = int(np.sqrt(BUDGET / cell)) // 256 * 256
        assert tp.hybrid_k_eff == k
        assert tp.dev_arrays["core"].dtype == (
            torch.bfloat16 if core == "bfloat16" else torch.float32)


CASES = {"pinned-k": dict(hybrid_k=601), "no-core": dict(hybrid_core_bytes=0),
         "pinned-stair": dict(hybrid_shape="stair", hybrid_k=333)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [*DTYPES, None])
def test_pinned_k_and_no_core(dtype, case):
    """A pinned odd ``hybrid_k`` (a square core, also under the stair
    shape, as the reference builds it) padded to the width rule on the
    port's side, and no core at all: tables byte-equal, products within
    REL (float payload) and bit-equal (an integer payload whose sums stay
    below 2^24)."""
    kw = {**dict(backend="hybrid", hybrid_dtype=dtype,
                 hybrid_core_bytes=BUDGET), **CASES[case]}
    (rows, cols, vals), jp, tp = both_preps("wide", kw)
    assert_tables_equal(jp, tp)
    if case == "no-core":
        assert tp.stair is None
    else:
        k = jp.hybrid_k_eff
        q = tspmm.WIDTH_RULE[tp.core_dtype]
        assert tp.stair == [(0, k, -(-k // q) * q)]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((N, 8)).astype(np.float32)
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    assert np.all(np.abs(got - want) <= REL * (dense @ np.abs(x)) + 1e-30)
    xi = rng.integers(-1000, 1000, (N, 8)).astype(np.int32)
    np.testing.assert_array_equal(tp.mul(torch.from_numpy(xi)).numpy(),
                                  np.asarray(jp.mul(jnp.asarray(xi))))


def test_float64_graph_products_match_jax():
    """The float64 graph's f32-celled core, and its float64 ELL weights
    cast to f32 as the reference's ``jnp.asarray``: products within REL."""
    (rows, cols, vals), jp, tp = both_preps(
        "wide", dict(backend="hybrid", hybrid_core_bytes=BUDGET), "float64")
    x = np.random.default_rng(1).standard_normal((N, 12)).astype(np.float32)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals))
    assert np.all(np.abs(got - want) <= REL * (dense @ np.abs(x)) + 1e-30)


def test_integer_graph_refuses_a_float32_core():
    rows, cols, vals = make_graph("multigraph")
    g = tgraph.CooGraph.from_edges(rows, cols, vals.astype(np.int32),
                                   nrows=N, ncols=N, dtype="int32")
    with pytest.raises(ValueError, match="bfloat16, int8 or int4"):
        tspmm.prepare_spmm(g, tspmm.SpmmConfig(
            backend="hybrid", hybrid_dtype="float32"), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [256, 1000])
def test_core_build_banded_matches_native(dtype, k):
    """``core/banded.py``'s float cores against the reference's native
    planner: bf16 against ``core_build_banded`` (its RNE of the f32
    CSR-order sums), f32 against ``core_fill_native`` (the same sums,
    unrounded). Fractional weights, so the sums round, in bands of a few
    rows."""
    if not reference_planner():
        pytest.skip("the reference's native planner cannot be built here")
    rng = np.random.default_rng(k)
    e = 60_000
    rows = rng.integers(0, N, e).astype(np.int32)
    cols = rng.integers(0, N, e).astype(np.int32)
    vals = rng.standard_normal(e).astype(np.float32) * 3
    rank = rng.permutation(N).astype(np.int32)
    got = banded.core_build_banded(rows, cols, vals, rank, k, dtype,
                                   band_bytes=64 * k * 4)
    if dtype == "bfloat16":
        core, mask, bad = native.core_build_banded(rows, cols, vals, rank, k,
                                                   dtype)
        core = core.view(np.uint16)
    else:
        core, mask = native.core_fill_native(rows, cols, vals, rank, k)
        bad = np.empty(0, np.int64)
    for name, a, b in zip(("core", "tail_mask", "bad_flat"), got,
                          (core, mask, bad)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[0].any()


def test_bf16_rounding_of_special_values():
    """The port's RNE against ``ml_dtypes`` (canonical NaN) and the
    native fill's (the NaN's top bits kept, quiet bit set): ties to even,
    overflow to inf, subnormals, signed zeros, quiet and signalling
    NaNs."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x7F7FFFFF,
                     0xFF7FFFFF, 0x00008000, 0x00018000, 0x80000000,
                     0x7F800000, 0xFF800000, 0x7FC00000, 0x7FA00001,
                     0xFFE12345, 0x7F800001], np.uint32)
    f = bits.view(np.float32)
    with np.errstate(invalid="ignore"):
        want = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(banded.f32_to_bf16_bits(f), want)
    rng = np.random.default_rng(0)
    r = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    with np.errstate(invalid="ignore"):
        want = r.view(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(banded.f32_to_bf16_bits(r.view(np.float32)),
                                  want)
    nan = np.array([0x7FA00001, 0xFFE12345], np.uint32).view(np.float32)
    np.testing.assert_array_equal(
        banded.f32_to_bf16_bits(nan, keep_nan_payload=True),
        np.array([0x7FE0, 0xFFE1], np.uint16))


def core_matmul(core, xq):
    """The reference's ``_core_matmul`` (f32 accumulation) as numpy."""
    return np.asarray(jspmm._core_matmul(core, xq, jnp.float32))


def band_plain(fn, band, xc):
    """``fn`` (a plain version) on one band into a zero output, rows in
    order: the band's product itself."""
    r = band.shape[0]
    out = torch.zeros(r, xc.shape[1])
    return fn([band], xc, torch.arange(r, dtype=torch.int32),
              [(0, r, band.shape[1])], out).numpy()


@pytest.mark.parametrize("crossing", [False, True],
                         ids=["below-2^24", "crossing-2^24"])
def test_kcore_bf16_plain_matches_core_matmul(crossing):
    """K-core's bf16 mode (plain) against ``_core_matmul``'s bf16 branch
    (``dot(bf16 core, bf16(x))``, f32 accumulation): integer cells and
    payload whose partial sums stay below 2^24, bit-equal; payload rows
    of 2^12 with cells up to 127 and 1024 terms, crossing 2^24, within
    REL of the sum of |terms|."""
    rng = np.random.default_rng(5)
    r, w, h = 300, 1024, 24
    cells = rng.integers(-127 if crossing else -8, 128 if crossing else 9,
                         (r, w)).astype(np.float32)
    x = rng.integers(-16, 17, (w, h)).astype(np.float32)
    if crossing:
        x *= 256.0  # 2^12 at most: bf16 holds these exactly
    want = core_matmul(jnp.asarray(cells, jnp.bfloat16),
                       jnp.asarray(x, jnp.bfloat16))
    got = band_plain(core_dot.core_bands_plain,
                     torch.from_numpy(cells).to(torch.bfloat16),
                     torch.from_numpy(x).to(torch.bfloat16))
    mag = np.abs(cells).astype(np.float64) @ np.abs(x)
    assert (mag.max() >= 2 ** 24) == crossing
    if crossing:
        assert np.all(np.abs(got - want) <= REL * mag)
    else:
        np.testing.assert_array_equal(got, want)


KF32_CASES = [(c, p, x) for c, p in (
    ("float32", "float32"), ("float32", "bfloat16"), ("float32", "int8"),
    ("float32", "int32"), ("bfloat16", "int16"), ("bfloat16", "int32"))
    for x in (False, True) if not (x and p == "int8")]


@pytest.mark.parametrize("cell,payload,crossing", KF32_CASES, ids=[
    f"{'crossing' if x else 'below'}-2^24-{c}-{p}" for c, p, x in KF32_CASES])
def test_kf32_plain_matches_core_matmul(cell, payload, crossing):
    """K-f32 (plain) against the branches it replaces: an f32 core's
    ``dot(core, f32(x))`` and a bf16 core's wide-integer branch (both
    operands in f32). Integer inputs below 2^24, bit-equal; crossing it
    (|x| up to 2^15 or 2^19, the int16 and int32 ranges, or float rows
    scaled by 2^12; 700 terms), within REL. An int8 payload cannot cross
    2^24 at 700 terms."""
    rng = np.random.default_rng(len(cell) + len(payload))
    r, w, h = 200, 700, 20
    cells = rng.integers(-100, 101, (r, w)).astype(np.float32)
    m = {"int8": 1 << 7, "int16": 1 << 15, "int32": 1 << 19}.get(payload,
                                                                 1 << 7)
    if not crossing:
        m = min(m, 128)
    xi = rng.integers(-m, m, (w, h))
    if payload in ("float32", "bfloat16"):
        x_np = xi.astype(np.float32)
        if crossing:
            x_np *= 4096.0
    else:
        x_np = xi.astype(payload)
    jcore = jnp.asarray(cells, jnp.bfloat16 if cell == "bfloat16"
                        else jnp.float32)
    jx = jnp.asarray(x_np, jnp.bfloat16) if payload == "bfloat16" \
        else jnp.asarray(x_np)
    want = core_matmul(jcore, jx)
    tx = torch.from_numpy(np.ascontiguousarray(x_np))
    if payload == "bfloat16":
        tx = tx.to(torch.bfloat16)
    got = band_plain(core_f32.core_f32_plain,
                     torch.from_numpy(cells).to(getattr(torch, cell)), tx)
    mag = np.abs(cells).astype(np.float64) @ np.abs(x_np.astype(np.float64))
    assert (mag.max() >= 2 ** 24) == crossing
    if crossing:
        assert np.all(np.abs(got - want) <= REL * mag)
    else:
        np.testing.assert_array_equal(got, want)


# (core, payload) -> the kernel the hybrid's core tier takes
DISPATCH = [
    ("int8", torch.float32, "K-core"), ("int8", torch.bfloat16, "K-core"),
    ("int8", torch.int16, "K-int"), ("int8", torch.int64, "K-int"),
    ("bfloat16", torch.float32, "K-core"),
    ("bfloat16", torch.bfloat16, "K-core"),
    ("bfloat16", torch.int8, "K-core"), ("bfloat16", torch.int16, "K-f32"),
    ("bfloat16", torch.int32, "K-f32"), ("bfloat16", torch.int64, "K-f32"),
    ("float32", torch.float32, "K-f32"), ("float32", torch.bfloat16, "K-f32"),
    ("float32", torch.int8, "K-f32"), ("float32", torch.int32, "K-f32"),
]


@pytest.mark.parametrize("core,dtype,kernel", DISPATCH,
                         ids=[f"{c}-{str(d)[6:]}" for c, d, _k in DISPATCH])
def test_core_dispatch(monkeypatch, core, dtype, kernel):
    """Which kernel the core tier of ``mul`` calls, and with which
    payload: ``_core_matmul``'s branches one for one (a float payload
    reaches K-core as bf16; an int8 payload reaches K-core bf16 as bf16,
    exactly; int64 is int32)."""
    _g, _jp, tp = both_preps("multigraph", dict(
        backend="hybrid", hybrid_dtype=core, hybrid_core_bytes=BUDGET))
    seen = []

    def record(name, fn):
        def wrapped(bands, xc, *a, **k):
            if xc is None:  # K-int's ready payload: its limbs give x's dtype
                raw = {v: d for d, v in tspmm.RAW_LIMBS.items()}
                seen.append((name, raw[k["payload"].shape[0]]))
            else:
                seen.append((name, xc.dtype))
            return fn(bands, xc, *a, **k)
        return wrapped

    monkeypatch.setattr(tspmm, "core_bands_scatter_add",
                        record("K-core", tspmm.core_bands_scatter_add))
    monkeypatch.setattr(tspmm, "core_f32_scatter_add",
                        record("K-f32", tspmm.core_f32_scatter_add))
    monkeypatch.setattr(tspmm, "core_int_scatter_add",
                        record("K-int", tspmm.core_int_scatter_add))
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -5, 6, (N, 8))).to(dtype)
    tp.mul(x)
    want_dtype = {"K-core": torch.bfloat16, "K-int": dtype,
                  "K-f32": dtype}[kernel]
    if dtype == torch.int64:
        want_dtype = torch.int32
    assert seen == [(kernel, want_dtype)]


def test_kernel_contracts_of_the_new_cells():
    """On the card K-core's bf16 mode takes widths of whole 16-deep steps
    (the host pads bf16 cores to 16) and K-f32 any width; bands of one
    call share their cell type."""
    band = torch.zeros(64, 40, dtype=torch.bfloat16)
    xc = torch.zeros(40, 8, dtype=torch.bfloat16)
    rows = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="% 16"):
        core_dot._check_kernel_contract([band], xc, rows, [(0, 64, 40)],
                                        torch.zeros(64, 8))
    assert tspmm.WIDTH_RULE["bfloat16"] == 16
    assert tspmm.WIDTH_RULE["float32"] == tspmm.WIDTH_RULE["float64"] == 4
    with pytest.raises(TypeError, match="share"):
        core_f32._check([band, band.float()], xc, rows,
                        [(0, 64, 40), (0, 64, 40)], torch.zeros(64, 8))


def test_split_schedule_weighs_the_cell_size():
    """A bf16 stage moves a 16 KB A box beside the 32 KB B stage, so the
    schedule weighs it 1.2 int8 stages; an int4 stage counts as one."""
    assert core_dot.step_cost(1.0) == core_dot.step_cost(0.5) == 1.0
    assert core_dot.step_cost(2.0) == pytest.approx(1.2)
    stair = [(0, 640, 4096)]
    counts = {1: 8, 2: 4, 4: 2}
    tiles, starts = core_dot.cluster_schedule(stair, 256, 256, counts,
                                              split=1, cell_bytes=2.0)
    loads = core_dot.schedule_loads(tiles, starts, cell_bytes=2.0)
    assert loads.sum() == pytest.approx(5 * (64 * 1.2 + 12))


def test_bf16_core_through_the_prepare_cache(tmp_path, monkeypatch):
    """A bf16 core goes through the prepare cache as its uint16 bits and
    comes back equal, with the reference's cache key."""
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path))
    monkeypatch.setattr(tspmm, "CACHED_DEVICES", ("cuda", "cpu"))
    rows, cols, vals = make_graph("multigraph")
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N)
    cfg = tspmm.SpmmConfig(backend="hybrid", hybrid_dtype="bfloat16",
                           hybrid_core_bytes=BUDGET)
    cold = tspmm.prepare_spmm(g, cfg, device="cpu")
    warm = tspmm.prepare_spmm(g, cfg, device="cpu")
    assert "cache_save" in cold.prepare_timer.acc
    assert "cache_load" in warm.prepare_timer.acc
    (path,) = tmp_path.glob("hybrid-torch-*.npz")
    with np.load(path) as z:
        assert z["core"].dtype == np.uint16
    for k, v in cold.dev_arrays.items():
        assert torch.equal(v, warm.dev_arrays[k]), k
    merged, _ = tgraph.merge_duplicate_edges(g)
    assert path.name == (f"hybrid-torch-"
                         f"{tspmm.prepare_cache_key(merged, cfg)}.npz")
    assert dataclasses.asdict(cold.config) == dataclasses.asdict(cfg)
