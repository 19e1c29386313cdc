"""The BCSR tile tier against the JAX reference: the host builders and the
prepare's ``bcsr_*`` tables byte for byte, the hybrid's products with a
tier (twins of the reference's own BCSR tests at their tolerances), the
fused quantized products, the cache, the phases, the gradients and the
reading of pads.

Tolerances. The tier's bf16 mode rounds x to bf16 on both sides and sums
exact products in f32 in another order, and so does the f32 mode: port
and JAX differ by f32 order only, 1e-5 of the sum of |terms| per element
(``mag``). Integer payloads on integer weights are exact on both sides
(every partial sum an integer below 2^24), so those products are
bit-equal; the int32 aggregate (|q| up to 2^19) rounds in f32 on both
sides, within 1e-5 of ``mag``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.core import bcsr as jbcsr
from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import bcsr as tbcsr
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.nn.models import gnn_apply, params_from_jax
from pygim_tpu_torch.nn import train as ttrain
from pygim_tpu_torch.ops import bcsr as kbcsr
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.quant import quant_scale
from pygim_tpu_torch.utils.timers import PhaseTimer

from test_torch_prepare import reference_planner

REL = 1e-5
BRMAT = "brmat-4000-120000-64"


def mid_degree(n=512, deg=24, seed=1234, int_vals=False):
    """The reference's ``_mid_degree_coo`` (tests/test_spmm.py:511-524):
    every node has ``deg`` neighbours in a 64-node window, so rank-space
    tiles are dense. ``(rows, cols, vals, n)``, numpy."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = (rows + rng.integers(0, 64, size=rows.size)) % n
    vals = (np.ones(rows.size, np.float32) if int_vals
            else rng.standard_normal(rows.size).astype(np.float32))
    return rows.astype(np.int32), cols.astype(np.int32), vals, n


def with_hubs(n=400, deg=12):
    """The mid-degree graph with 8 heavy hub rows: all three tiers live
    (tests/test_spmm.py:545-566)."""
    rows, cols, vals, n = mid_degree(n, deg)
    rng = np.random.default_rng(9)
    hub_rows = np.repeat(np.arange(8), 200).astype(np.int32)
    hub_cols = rng.integers(0, n, size=hub_rows.size).astype(np.int32)
    return (np.concatenate([rows, hub_rows]),
            np.concatenate([cols, hub_cols]),
            np.concatenate([vals, rng.standard_normal(hub_rows.size)
                            .astype(np.float32)]), n)


def brmat():
    g = load_dataset(BRMAT, use_cache=False).graph
    return g.rows, g.cols, g.vals, g.nrows


GRAPHS = {"mid": mid_degree, "brmat": brmat}


def graphs(rows, cols, vals, n):
    return (jgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n),
            tgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n))


def both_preps(g, **kw):
    jg, tg = graphs(*g)
    jp = jspmm.prepare_spmm(jg, jspmm.SpmmConfig(backend="hybrid", **kw))
    tp = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(backend="hybrid", **kw),
                            device="cpu")
    return jp, tp


def mag_of(rows, cols, vals, n, x):
    a = np.zeros((n, n))
    np.add.at(a, (rows, cols), np.abs(vals.astype(np.float64)))
    return a @ np.abs(x.astype(np.float64))


def dense_of(rows, cols, vals, n):
    a = np.zeros((n, n))
    np.add.at(a, (rows, cols), vals.astype(np.float64))
    return a


def rank_space(rows, cols, n):
    """The prepare's degree rank (``order``, ``rank``) and the edges'
    rank coordinates."""
    deg = np.bincount(rows, minlength=n).astype(np.int64)
    deg += np.bincount(cols, minlength=n)
    order = np.argsort(-deg).astype(np.int32)
    rank = np.empty(n, dtype=np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    return order, rank


# --- host builders --------------------------------------------------------

def assert_same_tier(got, want, in_got, in_want):
    np.testing.assert_array_equal(in_got, in_want)
    if want is None:
        assert got is None
        return
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        if f.name == "tiles":
            w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    assert got.dtype == str(want.tiles.dtype)


# budgets: room for every tile, half the slots of that selection (the
# densest-first cut), and a cutoff no tile reaches
CASES = {"room": dict(budget_bytes=64 << 20, min_edges=0),
         "cut": dict(budget_bytes=None, min_edges=0),
         "none": dict(budget_bytes=64 << 20, min_edges=10_000)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tr", [8, 16, 32])
@pytest.mark.parametrize("layout", ["row", "panel"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_builders_match_reference(graph, layout, tr, dtype, case):
    rows, cols, vals, n = GRAPHS[graph]()
    order, rank = rank_space(rows, cols, n)
    kw = dict(n=n, tile_rows=tr, hidden=16, dtype=dtype, **CASES[case])
    fn = "build_bcsr_panels" if layout == "panel" else "build_bcsr_tiles"
    room, _ = getattr(tbcsr, fn)(rank[rows], rank[cols], vals, order,
                                 **{**kw, **CASES["room"]})
    if case == "cut":
        kw["budget_bytes"] = room.tiles.nbytes // 2
    want, in_want = getattr(jbcsr, fn)(rank[rows], rank[cols], vals, order,
                                       **kw)
    got, in_got = getattr(tbcsr, fn)(rank[rows], rank[cols], vals, order,
                                     **kw)
    assert_same_tier(got, want, in_got, in_want)
    if case == "none":
        assert got is None
    else:
        assert got is not None and got.n_edges > 0
    if case == "cut":
        assert got.n_edges < room.n_edges


@pytest.mark.parametrize("method", ["rcm", "lp"])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_tail_tile_order_matches_reference(graph, method):
    rows, cols, _vals, n = GRAPHS[graph]()
    order, rank = rank_space(rows, cols, n)
    k = 64
    want = jbcsr.tail_tile_order(rows, cols, order, rank, k, n, method)
    got = tbcsr.tail_tile_order(rows, cols, order, rank, k, n, method)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], order)  # the tail was re-ranked
    np.testing.assert_array_equal(got[0][:k], order[:k])


def test_cutoff_models_match_reference():
    for tr in (8, 16, 24, 32):
        for h in (8, 16, 64, 256, 1100):
            for item in (2, 4):
                assert tbcsr.min_edges_per_tile(tr, h, item) \
                    == jbcsr.min_edges_per_tile(tr, h, item)
                assert tbcsr.panel_tile_cutoffs(tr, h, item) \
                    == jbcsr.panel_tile_cutoffs(tr, h, item)
    for counts in ([1], [3, 5, 9], [40, 1, 1, 17], [64] * 5):
        c = np.asarray(counts)
        assert tbcsr._choose_tiles_per_vblock(c) \
            == jbcsr._choose_tiles_per_vblock(c)


# --- the prepare's tables ---------------------------------------------------

def host_tables(g, **kw):
    """The reference's and the port's host dicts of the hybrid prepare."""
    jg, tg = graphs(*g)
    jg = jgraph.merge_duplicate_edges(jg)[0]
    tg = tgraph.merge_duplicate_edges(tg)[0]
    ref = object.__new__(jspmm.PreparedSpmm)
    want = ref._prepare_hybrid_build(jg, jspmm.SpmmConfig(backend="hybrid",
                                                          **kw))
    tp = object.__new__(tspmm.PreparedSpmm)
    tp.prepare_timer = PhaseTimer()
    got = tp._prepare_hybrid_build(tg, tspmm.SpmmConfig(backend="hybrid",
                                                        **kw))
    return got, want


# the core's cells choose the tiles': int8 and bf16 cores bf16 tiles,
# int4 and the graph's f32 core f32 tiles
CORES = {"int8": "bfloat16", "bfloat16": "bfloat16", "int4": "float32",
         None: "float32"}


@pytest.mark.parametrize("core", list(CORES))
@pytest.mark.parametrize("order", ["rank", "rcm", "lp"])
@pytest.mark.parametrize("layout", ["row", "panel"])
def test_prepare_bcsr_tables_byte_equal(layout, order, core):
    if not reference_planner():
        pytest.skip("the reference's square build needs its native planner")
    got, want = host_tables(with_hubs(), hybrid_k=64, hybrid_dtype=core,
                            bcsr_bytes=1 << 20, bcsr_tile=8,
                            bcsr_min_edges=3, hidden_hint=16,
                            bcsr_layout=layout, bcsr_order=order)
    assert set(got) == set(want)
    assert str(want["bcsr_kind"]) == layout
    assert str(want["bcsr_dtype"]) == CORES[core]
    assert int(want["bcsr_edges"]) > 0
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


# --- products ---------------------------------------------------------------

def product_check(g, jp, tp, x, rel=REL):
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    mag = mag_of(*g, x)
    assert np.all(np.abs(got - want) <= rel * mag + 1e-30)
    return got


TIER_CONFIGS = {
    # tests/test_spmm.py:525-540, 542-566, 568-587, 677-697, 728-748, 880
    "tiles-only": (mid_degree, dict(hybrid_k=0, bcsr_bytes=64 << 20,
                                    bcsr_tile=8, bcsr_min_edges=4,
                                    hidden_hint=16)),
    "core-tiles-tail": (with_hubs, dict(hybrid_k=64, bcsr_bytes=16 << 20,
                                        bcsr_tile=8, bcsr_min_edges=3,
                                        hidden_hint=16)),
    "bf16-tiles": (lambda: mid_degree(256, 16),
                   dict(hybrid_k=0, hybrid_dtype="bfloat16",
                        bcsr_bytes=32 << 20, bcsr_tile=8, bcsr_min_edges=4,
                        hidden_hint=8)),
    "int8-core-bf16-tiles": (with_hubs, dict(
        hybrid_k=64, hybrid_dtype="int8", bcsr_bytes=16 << 20, bcsr_tile=16,
        bcsr_min_edges=3, hidden_hint=16)),
    "panel": (mid_degree, dict(hybrid_k=0, bcsr_bytes=64 << 20, bcsr_tile=8,
                               bcsr_min_edges=3, hidden_hint=16,
                               bcsr_layout="panel")),
    "rcm": (with_hubs, dict(hybrid_k=64, bcsr_bytes=32 << 20, bcsr_tile=8,
                            bcsr_min_edges=3, hidden_hint=16,
                            bcsr_order="rcm")),
    "lp-panel": (brmat, dict(hybrid_k=0, bcsr_bytes=64 << 20, bcsr_tile=16,
                             bcsr_order="lp", bcsr_layout="panel",
                             hidden_hint=16, bcsr_min_edges=24)),
    "tr32-row": (brmat, dict(hybrid_k=256, hybrid_dtype="int8",
                             bcsr_bytes=8 << 20, bcsr_tile=32,
                             bcsr_order="lp", hidden_hint=16,
                             bcsr_min_edges=8)),
}


@pytest.mark.parametrize("name", list(TIER_CONFIGS))
def test_products_match_jax(name):
    make, kw = TIER_CONFIGS[name]
    g = make()
    jp, tp = both_preps(g, **kw)
    assert jp.has_bcsr and tp.has_bcsr and tp.bcsr_edges == jp.bcsr_edges
    assert tp.bcsr_kind == jp.bcsr_kind
    x = np.random.default_rng(7).standard_normal((g[3], 16)).astype(
        np.float32)
    got = product_check(g, jp, tp, x)
    # within the bf16 rounding of x and of the cells (2^-9 each a term) of
    # the float64 product
    exact = dense_of(*g) @ x.astype(np.float64)
    bar = 2 ** -7 if tp.dev_arrays["tiles"].dtype == torch.bfloat16 else REL
    assert np.all(np.abs(got - exact) <= bar * mag_of(*g, x) + 1e-30)
    # the plain versions are the wrappers on the CPU
    np.testing.assert_array_equal(
        got, tp.mul_plain(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int16", "int32",
                                   "int64"])
def test_payload_products_match_jax(dtype):
    """Every payload through a bf16 tier: bf16 and int8 in the tier's
    bf16 mode (exact), int16 / int32 in its f32 mode, int64 as int32."""
    g = with_hubs()
    g = (g[0], g[1], np.round(g[2] * 2).astype(np.float32), g[3])
    jp, tp = both_preps(g, hybrid_k=64, hybrid_dtype="bfloat16",
                        bcsr_bytes=16 << 20, bcsr_tile=8, bcsr_min_edges=3,
                        hidden_hint=16)
    # integers: exact in bf16 and in every partial sum
    x = np.random.default_rng(11).integers(-100, 101, (g[3], 12))
    if dtype == "bfloat16":
        x = x.astype(np.float32)
        want = np.asarray(jp.mul(jnp.asarray(x, jnp.bfloat16)))
        xt, xm = torch.from_numpy(x).to(torch.bfloat16), x
    else:
        x = x.astype(dtype)
        want = np.asarray(jp.mul(jnp.asarray(x)))
        xt, xm = torch.from_numpy(x), x
    got = tp.mul(xt).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got, dense_of(*g) @ xm.astype(np.float64))


@pytest.mark.parametrize("layout", ["row", "panel"])
def test_mul_quantized_matches_jax(layout):
    """int8 and int16 (the integer tables) bit-equal to JAX on integer
    weights; int32 (rounded in the consumer, f32 mode) within REL."""
    rows, cols, vals, n = mid_degree(400, 14, seed=77, int_vals=True)
    g = (rows, cols, vals, n)
    jp, tp = both_preps(g, hybrid_k=64, hybrid_dtype="int8",
                        bcsr_bytes=32 << 20, bcsr_tile=8, bcsr_min_edges=3,
                        hidden_hint=16, bcsr_layout=layout)
    assert tp.has_bcsr and tp.hybrid_k_eff == 64
    x = np.random.default_rng(4).standard_normal((n, 16)).astype(np.float32)
    for agg in ("int8", "int16", "int32"):
        want = np.asarray(jp.mul_quantized(jnp.asarray(x), agg))
        got = tp.mul_quantized(torch.from_numpy(x), agg).numpy()
        if agg == "int32":
            assert np.all(np.abs(got - want) <= REL * mag_of(*g, x) + 1e-30)
        else:
            np.testing.assert_array_equal(got, want, err_msg=agg)


def test_wide_quant_computes_f32():
    """int16 / int32 quantized payloads (|q| up to 2^19) pass bf16's exact
    integers: the tier computes in f32 and stays exact against the true
    integer aggregation (tests/test_spmm.py:699-726)."""
    rows, cols, vals, n = mid_degree(int_vals=True, seed=5)
    g = tgraph.CooGraph(rows=rows, cols=cols, vals=vals.astype(np.int32),
                        nrows=n, ncols=n)
    tp = tspmm.prepare_spmm(g, tspmm.SpmmConfig(
        backend="hybrid", hybrid_k=0, bcsr_bytes=64 << 20, bcsr_tile=8,
        bcsr_min_edges=4, hidden_hint=16), device="cpu")
    assert tp.has_bcsr and tp.dev_arrays["tiles"].dtype == torch.bfloat16
    x = np.random.default_rng(5).standard_normal((n, 16)).astype(np.float32)
    for dt, k in (("int16", 10), ("int32", 20)):
        scale = np.abs(x).max() * 2.0 / 2.0 ** k
        q = np.round(x / np.float32(scale)).astype(np.float64)
        ref = (dense_of(rows, cols, vals, n) @ q) * scale
        got = tp.mul_quantized(torch.from_numpy(x), dt).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_panel_covers_more_at_lower_cutoff():
    """The panel layout's lower per-tile bar captures at least the row
    layout's edges at the same budget (tests/test_spmm.py:772-786)."""
    g = mid_degree(1024, 10, seed=77)
    common = dict(hybrid_k=0, bcsr_bytes=256 << 20, bcsr_tile=8,
                  hidden_hint=64)
    _, row = both_preps(g, bcsr_layout="row", **common)
    _, panel = both_preps(g, bcsr_layout="panel", **common)
    row_edges = row.bcsr_edges if row.has_bcsr else 0
    assert panel.has_bcsr and panel.bcsr_edges >= row_edges


def test_no_tile_qualifies():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 300, 400).astype(np.int32)
    cols = rng.integers(0, 300, 400).astype(np.int32)
    g = (rows, cols, np.ones(400, np.float32), 300)
    jp, tp = both_preps(g, hybrid_k=32, bcsr_bytes=1 << 20, bcsr_tile=8,
                        bcsr_min_edges=50, hidden_hint=8)
    assert not tp.has_bcsr and not jp.has_bcsr
    assert "tiles" not in tp.dev_arrays
    product_check(g, jp, tp, rng.standard_normal((300, 8)).astype(
        np.float32))


# --- the operand --------------------------------------------------------------

def test_cache_round_trip_with_a_tier(tmp_path, monkeypatch):
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path))
    monkeypatch.setattr(tspmm, "CACHED_DEVICES", ("cuda", "cpu"))
    _, tg = graphs(*with_hubs())
    cfg = tspmm.SpmmConfig(backend="hybrid", hybrid_k=64,
                           hybrid_dtype="int8", bcsr_bytes=16 << 20,
                           bcsr_tile=8, bcsr_min_edges=3, hidden_hint=16,
                           bcsr_layout="panel", bcsr_order="rcm")
    cold = tspmm.prepare_spmm(tg, cfg, device="cpu")
    warm = tspmm.prepare_spmm(tg, cfg, device="cpu")
    assert "bcsr" in cold.prepare_timer.acc
    assert "cache_load" in warm.prepare_timer.acc
    assert "bcsr" not in warm.prepare_timer.acc
    assert (warm.has_bcsr, warm.bcsr_kind, warm.bcsr_step, warm.bcsr_n_rb,
            warm.bcsr_edges) == (cold.has_bcsr, cold.bcsr_kind,
                                 cold.bcsr_step, cold.bcsr_n_rb,
                                 cold.bcsr_edges)
    assert set(warm.dev_arrays) == set(cold.dev_arrays)
    for k, v in cold.dev_arrays.items():
        assert torch.equal(warm.dev_arrays[k], v), k
    x = torch.randn(tg.nrows, 8)
    assert torch.equal(warm.mul(x), cold.mul(x))


def test_phase_times_has_bcsr_time(monkeypatch):
    from pygim_tpu_torch.ops import spmm as spmm_mod

    calls = []

    def fake_device_time(fn, *a, iters=3):
        fn(*a)
        calls.append(fn)
        return 1e-3

    monkeypatch.setattr(spmm_mod, "device_time", fake_device_time)
    _, tp = both_preps(with_hubs(), hybrid_k=64, bcsr_bytes=16 << 20,
                       bcsr_tile=8, bcsr_min_edges=3, hidden_hint=16)
    phases = tp.phase_times(torch.randn(tp.nrows, 8), iters=1)
    assert {"mul_time(ms)", "tail_time(ms)", "core_time(ms)",
            "bcsr_time(ms)"} <= set(phases)


def test_transpose_builds_its_own_tier():
    """Aᵀ of a directed graph captures other tiles; its product is the
    transpose's."""
    rows, cols, vals, n = with_hubs()
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n)
    tp = tspmm.prepare_spmm(g, tspmm.SpmmConfig(
        backend="hybrid", hybrid_k=64, bcsr_bytes=16 << 20, bcsr_tile=8,
        bcsr_min_edges=3, hidden_hint=16), device="cpu")
    tt = tp.transpose(g)
    assert tt.has_bcsr and tt.bcsr_edges != tp.bcsr_edges
    x = np.random.default_rng(2).standard_normal((n, 8)).astype(np.float32)
    want = dense_of(rows, cols, vals, n).T @ x.astype(np.float64)
    got = tt.mul(torch.from_numpy(x)).numpy()
    mag = np.abs(dense_of(rows, cols, vals, n)).T @ np.abs(x)
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


def test_gradients_match_jax():
    """d(masked cross-entropy)/d(every parameter) of a GCN through a
    hybrid with an int8 square core and a bf16 tier: JAX's autodiff
    against the port's backward on the prepared Aᵀ (its own tier), at
    ``test_torch_train.py``'s hybrid bar."""
    import test_torch_train as tt

    rows, cols, vals = tt.small_graph()
    n = tt.N
    cfg = dict(backend="hybrid", hybrid_dtype="int8",
               hybrid_core_bytes=64 << 10, bcsr_bytes=4 << 20, bcsr_tile=8,
               bcsr_min_edges=3, hidden_hint=tt.H, bcsr_order="rcm")
    jg, tg = graphs(rows, cols, vals, n)
    jp = jspmm.prepare_spmm(jg, jspmm.SpmmConfig(**cfg))
    tp = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(**cfg), device="cpu")
    assert tp.has_bcsr and tp.stair
    assert tp.transpose(tg).has_bcsr
    jgnn, model = tt.both_models("gcn")
    x, y, mask = tt.inputs()
    (jloss, _), g = jax.value_and_grad(
        tt.jax_loss_fn(jgnn, jspmm.PreparedAggregate(jp), jnp.asarray(x),
                       jnp.asarray(y), jnp.asarray(mask)),
        has_aux=True)(jgnn.params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, g))
    xt, yt, mt = tt.torch_inputs(x, y, mask)
    logits = gnn_apply(model, xt, tspmm.PreparedAggregate(tp), training=True)
    loss = ttrain.softmax_cross_entropy(logits, yt, mt)
    loss.backward()
    tt.close(float(loss.detach()), float(jloss), 1e-5, "loss")
    named = dict(model.named_parameters())
    for key, w in want.items():
        if key not in named:
            continue
        w = w.numpy()
        err = float(np.abs(named[key].grad.numpy() - w).max())
        assert err <= tt.HYBRID_GRAD_TOL * float(np.abs(w).max()) + 1e-6, key


# --- pads ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["row", "panel"])
def test_pads_read_x_as_the_reference(layout):
    """The quirk kept: pad virtual blocks (panel 0, the last row block),
    panel-kind pad slots (row block 0) and the clamped panel rows multiply
    x rows by zero tiles, so a NaN there spreads into rows no edge links
    to it, in the reference and in the port's plain version alike (the
    kernel computes the pads too; ``chip_smoke.py`` holds its NaN rows to
    the plain version's)."""
    g = mid_degree(300, 16, seed=12)
    jp, tp = both_preps(g, hybrid_k=0, bcsr_bytes=64 << 20, bcsr_tile=16,
                        bcsr_min_edges=4, hidden_hint=4096,
                        bcsr_layout=layout)
    tiles = tp.dev_arrays["tiles"]
    assert tp.has_bcsr and not tiles[-1].any()  # a pad at the end
    x = np.random.default_rng(0).standard_normal((300, 4)).astype(np.float32)
    x[int(tp.dev_arrays["panel_nodes"][0])] = np.nan
    want = np.asarray(jp.mul(jnp.asarray(x)))
    got = tp.mul(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    linked = dense_of(*g)[:, int(tp.dev_arrays["panel_nodes"][0])] != 0
    assert np.isnan(got).any(axis=1)[~linked].any()  # reached by pads only
    # the kernel's walk of its plan (test_torch_bcsr_plan.py:emulate), pads
    # and zero-skipping adds included, has the plain version's NaN rows
    from test_torch_bcsr_plan import emulate

    tables = tp.bcsr_tables(tp.dev_arrays)
    xt = torch.from_numpy(x)
    plan = kbcsr.bcsr_plan(tables[0], tables[2], tables[3],
                           tables[1].shape[2], 4)
    walk = emulate(xt, *tables, torch.zeros(300, 4), plan)
    plain = kbcsr.bcsr_plain(xt, *tables, torch.zeros(300, 4))
    assert torch.equal(walk.isnan(), plain.isnan()) and walk.isnan().any()


def test_wrapper_refuses():
    _, tp = both_preps(with_hubs(), hybrid_k=64, bcsr_bytes=16 << 20,
                       bcsr_tile=8, bcsr_min_edges=3, hidden_hint=16)
    kind, tiles, pidx, rb, pn, rn = tp.bcsr_tables(tp.dev_arrays)
    x = torch.randn(tp.nrows, 8)
    out = torch.zeros(tp.nrows, 8)
    with pytest.raises(TypeError):
        kbcsr.bcsr_add(x.double(), kind, tiles, pidx, rb, pn, rn, out)
    with pytest.raises(TypeError):
        kbcsr.bcsr_add(x, kind, tiles, pidx.long(), rb, pn, rn, out)
    with pytest.raises(ValueError):
        kbcsr.bcsr_add(x, "diagonal", tiles, pidx, rb, pn, rn, out)
    with pytest.raises(RuntimeError):  # no autograd node through a kernel
        kbcsr.bcsr_add(x.requires_grad_(), kind, tiles, pidx, rb, pn, rn,
                       out)
    assert kbcsr.compute_mode(torch.bfloat16, torch.float32) == "bf16"
    assert kbcsr.compute_mode(torch.bfloat16, torch.int16) == "f32"
    assert kbcsr.compute_mode(torch.bfloat16, torch.float32,
                              torch.tensor(1.0)) == "f32"
    assert kbcsr.compute_mode(torch.float32, torch.int8) == "f32"


@pytest.mark.parametrize("kind", ["row", "panel"])
def test_bound_counts(kind):
    """``bcsr_traffic`` counts what one launch must move at least: every
    tile cell, the distinct x rows of the panels the work items read, the
    distinct output rows of the row blocks they add into, and the index
    entries of those panels and row blocks; panels and row blocks of the
    tables that no work item uses (here most of them, as on a random
    tier) are not counted. ``bcsr_bound`` is the larger of its bytes and
    its operations at the route's rate."""
    from pygim_tpu_torch.utils.device import bcsr_bound, bcsr_traffic

    tr, n, slots = 16, 3, 2
    tiles = torch.zeros(n, slots, tr, 128, dtype=torch.bfloat16)
    # 8 panels and 6 row blocks in the tables; nodes repeat inside them
    pn = torch.arange(8 * 128, dtype=torch.int32) % 700
    rn = torch.arange(6 * tr, dtype=torch.int32) // 2
    if kind == "row":  # panels 1, 1, 5 / 1, 5, 5 read; row blocks 2, 2, 4
        pidx = torch.tensor([[1, 5], [1, 5], [5, 1]], dtype=torch.int32)
        rb = torch.tensor([2, 2, 4], dtype=torch.int32)
    else:  # panels 1, 1, 5; row blocks 2, 4, 2, 4, 2, 2
        pidx = torch.tensor([1, 1, 5], dtype=torch.int32)
        rb = torch.tensor([[2, 4], [2, 4], [2, 2]], dtype=torch.int32)
    c = bcsr_traffic(tiles, pidx, rb, pn, rn)
    # panel 1 is nodes 128..255, panel 5 is 640..699 then 0..67: 256 nodes;
    # row blocks 2 and 4 are nodes 16..23 and 32..39
    assert c == dict(cells=n * slots * tr * 128, x_rows=256, out_rows=16,
                     index_entries=pidx.numel() + rb.numel() + 2 * 128
                     + 2 * tr)
    peaks = (1e12, 1e15, 1e11, 2e15)
    ms, by = bcsr_bound(**c, h=256, peaks_=peaks)
    nbytes = (c["cells"] * 2 + c["x_rows"] * 256 * 4
              + c["index_entries"] * 4 + 2 * c["out_rows"] * 256 * 4)
    assert by == "bytes" and ms == pytest.approx(nbytes / 1e12 * 1e3)
    # 3xTF32 (three products a term at half the bf16 rate) on a slow card
    slow = (1e12, 1e11, 1e11, 2e15)
    ms, by = bcsr_bound(**c, h=256, peaks_=slow, products=3, tf32=True)
    assert by == "operations"
    assert ms == pytest.approx(3 * 2 * c["cells"] * 256 / 5e10 * 1e3)


# --- the kernel's routes (csrc/bcsr.cu) --------------------------------------
#
# Every case runs on the tensor cores. bf16 tiles: x as one bf16 part (the
# reference's bf16 cdt) or as two / three bf16 parts of its f32 value,
# every product of a part and a bf16 cell exact in f32; f32 tiles: 3xTF32
# (``cvt.rna`` hi and lo of both operands, a_lo b_lo dropped: at most about
# 3 * 2^-22 of the sum of |terms|), two products where x is exact in TF32.
# The emulations below repeat that arithmetic in NumPy bit operations and
# sum in float64, so only the split's error remains.

TF32_X3_BOUND = 3.01 * 2.0 ** -22  # a_lo b_lo and the TF32 rounding of lo
TF32_X2_BOUND = 1.01 * 2.0 ** -22  # the tile's lo rounded to TF32


def bf16_rne(v):
    """float32 values rounded to bf16 (nearest, ties to even) by bit
    operations on their 16 low bits; NaN kept."""
    v = np.asarray(v, np.float32)
    b = v.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    return np.where(np.isnan(v), v, r.view(np.float32))


def tf32_rna(v):
    """``cvt.rna.tf32.f32`` by bit operations: 13 low bits dropped,
    nearest with ties away from zero (half an ulp added to the magnitude
    bits); non-finite values kept."""
    v = np.asarray(v, np.float32)
    b = v.view(np.uint32).astype(np.uint64)
    r = ((b + 0x1000) & np.uint64(0xFFFFE000)).astype(np.uint32)
    return np.where(np.isfinite(v), r.view(np.float32), v)


def bf16_parts(v, parts):
    """The kernel's bf16 parts of f32 values: b0 = bf16(v), then each
    remainder (exact in f32) rounded again; a remainder after a non-finite
    part is 0."""
    r, out = np.asarray(v, np.float32), []
    for _ in range(parts):
        b = bf16_rne(r)
        out.append(b)
        r = np.where(np.isfinite(b), r - b, np.float32(0)).astype(np.float32)
    return out


def tf32_split(v):
    """The kernel's TF32 hi and lo: hi = rna(v), lo = rna(v - hi)."""
    v = np.asarray(v, np.float32)
    hi = tf32_rna(v)
    lo = np.where(np.isfinite(hi), tf32_rna((v - hi).astype(np.float32)),
                  np.float32(0))
    return hi, lo


@pytest.mark.parametrize("scale", [1.0, 2.0 ** -60, 2.0 ** 60])
def test_tf32_rna_emulation(scale):
    """The bit emulation of ``cvt.rna.tf32.f32`` keeps 11 significant bits
    (the 13 low bits zero), lies within half an ulp of 11 bits of v, and
    agrees with the arithmetic definition: |v| / ulp rounded half away
    from zero, ulp = 2^(e - 10) for |v| in [2^e, 2^(e + 1)); ties (the
    dropped bits exactly 0x1000) go away from zero."""
    g = np.random.default_rng(3)
    v = (g.standard_normal(20000) * scale).astype(np.float32)
    ties = (v.view(np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    v = np.concatenate([v, ties.view(np.float32)])
    hi = tf32_rna(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    v64, h64 = v.astype(np.float64), hi.astype(np.float64)
    assert np.all(np.abs(v64 - h64) <= 2.0 ** -11 * np.abs(v64))
    e = np.floor(np.log2(np.abs(v64)))
    ulp = 2.0 ** (e - 10)
    want = np.sign(v64) * np.floor(np.abs(v64) / ulp + 0.5) * ulp
    np.testing.assert_array_equal(h64, want)
    t = ties.view(np.float32).astype(np.float64)
    assert np.all(np.abs(tf32_rna(ties.view(np.float32))) > np.abs(t))


def test_parts_rebuild_every_payload():
    """Two bf16 parts rebuild every int16 exactly and three parts every
    f32 (so every int32's f32 value and every rounded payload); each part
    is a bf16 value, and its product with any bf16 cell is exact in f32.
    The TF32 hi and lo rebuild an int16 exactly (22 bits)."""
    g = np.random.default_rng(8)
    i16 = np.arange(-(1 << 15), 1 << 15).astype(np.float32)
    i32 = np.concatenate([g.integers(-(1 << 31), 1 << 31, 50000),
                          [-(1 << 31), (1 << 31) - 1, 0, 1, -1,
                           (1 << 24) + 1]]).astype(np.float32)
    f32 = (g.standard_normal(50000) * 2.0 ** g.integers(-40, 40, 50000)
           ).astype(np.float32)
    q = np.round(g.standard_normal(50000) * 2 ** 17).astype(np.float32)
    cells = bf16_rne(g.standard_normal(257).astype(np.float32))
    for v, parts in ((i16, 2), (i32, 3), (f32, 3), (q, 3)):
        ps = bf16_parts(v, parts)
        np.testing.assert_array_equal(
            np.sum([p.astype(np.float64) for p in ps], axis=0),
            v.astype(np.float64))
        for p in ps:
            assert not (p.view(np.uint32) & 0xFFFF).any()  # bf16 values
            prod = p[:, None].astype(np.float64) * cells[None, :]
            np.testing.assert_array_equal(prod, prod.astype(np.float32))
    hi, lo = tf32_split(i16)
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, i16)


def dense_tier(kind, tiles, pidx, rb, pn, rn, nodes):
    """The tier as a dense float64 (nodes, nodes) matrix of the tile
    values ``tiles`` (numpy, the tables' shape), duplicates summed."""
    n, slots, tr, tc = tiles.shape
    panel, rows = kbcsr._flat(kind, pidx, rb)
    r = rn.long().view(-1, tr).numpy()[rows]
    c = pn.long().view(-1, tc).numpy()[panel]
    a = np.zeros((nodes, nodes))
    np.add.at(a, (r[:, :, None], c[:, None, :]),
              tiles.reshape(n * slots, tr, tc).astype(np.float64))
    return a


def route_product(x, kind, tiles, pidx, rb, pn, rn, nodes, safe=None):
    """The kernel's arithmetic on these operands in float64: the payload
    as f32 (rounded where ``safe`` is given, then to the compute dtype),
    split as its route splits it, the tiles split likewise on f32 tiles,
    each product exact, the sums in float64. Returns (product, the exact
    product of the plain version's values, the sum of |terms|)."""
    route, parts = kbcsr.kernel_route(tiles.dtype, x.dtype, safe)
    cdt = (torch.bfloat16 if kbcsr.compute_mode(tiles.dtype, x.dtype, safe)
           == "bf16" else torch.float32)
    xv = kbcsr._payload(x, safe, cdt).numpy().astype(np.float32)
    t = tiles.float().numpy()
    tables = (kind, pidx, rb, pn, rn, nodes)
    exact = dense_tier(kind, t, *tables[1:])
    want = exact @ xv.astype(np.float64)
    mag = np.abs(exact) @ np.abs(xv.astype(np.float64))
    if route.startswith("bf16"):
        got = sum(exact @ p.astype(np.float64) for p in bf16_parts(xv, parts))
    else:
        th, tl = (dense_tier(kind, p, *tables[1:]) for p in tf32_split(t))
        xh, xl = tf32_split(xv)
        got = th @ xh.astype(np.float64) + tl @ xh.astype(np.float64)
        if route == "tf32x3":
            got = got + th @ xl.astype(np.float64)
        else:
            assert not xl.any()
    return got, want, mag, route


ROUTE_CASES = [
    # kind, tile dtype, payload, the quantized aggregate a rounded x is
    # scaled for (None: not rounded), H, the route
    ("row", "float32", "float32", None, 24, "tf32x3"),
    ("panel", "float32", "float32", None, 40, "tf32x3"),
    ("panel", "float32", "int16", None, 16, "tf32x3"),
    ("row", "float32", "int32", None, 16, "tf32x3"),
    ("row", "float32", "int8", None, 16, "tf32x2"),
    ("panel", "float32", "bfloat16", None, 16, "tf32x2"),
    ("panel", "float32", "float32", "int32", 16, "tf32x3"),
    ("row", "bfloat16", "int16", None, 24, "bf16x2"),
    ("panel", "bfloat16", "int32", None, 24, "bf16x3"),
    ("row", "bfloat16", "float32", "int32", 16, "bf16x3"),
    ("panel", "bfloat16", "float32", None, 16, "bf16"),
]


def route_inputs(kind, tdt, xdt, q, h, nodes=700, integer_tiles=False):
    """A random tier (``test_torch_bcsr_plan.random_tier``) and x for a
    route case: x of ``xdt`` (integers of its range), ``safe`` for a
    rounded x (the quantized aggregate's scale of ``q``)."""
    from test_torch_bcsr_plan import payload, random_tier

    tier = random_tier(kind, 24, 3, 16, nodes, 5 + h, getattr(torch, tdt))
    if integer_tiles:
        t = torch.from_numpy(np.random.default_rng(h).integers(
            -3, 4, tier[1].shape).astype(np.float32))
        tier = (tier[0], (t * (tier[1] != 0)).to(tier[1].dtype), *tier[2:])
    x = payload(nodes, h, xdt, 7 * h)
    safe = None
    if q is not None:
        safe = quant_scale(x, q)[1].reshape(())
    return tier, x, safe


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_route_arithmetic_matches_f64_and_jax(case):
    """Each route's arithmetic (:func:`route_product`) against the exact
    product of the plain version's payload values, within the route's
    stated error (bf16 parts: exact products, so only float64's sums;
    tf32x3 3.01 · 2^-22, tf32x2 1.01 · 2^-22 of the sum of |terms|), and
    against the reference's scan body of the layout (its cdt, its
    ``q_scale``) and ``bcsr_plain`` within REL of the sum of |terms|."""
    kind, tdt, xdt, q, h, route = case
    nodes = 700
    tier, x, safe = route_inputs(kind, tdt, xdt, q, h, nodes)
    got, want, mag, r = route_product(x, *tier, nodes, safe)
    assert r == route
    bound = {"tf32x3": TF32_X3_BOUND, "tf32x2": TF32_X2_BOUND}.get(
        route, 2.0 ** -40)
    assert np.all(np.abs(got - want) <= bound * mag + 1e-30)
    plain = kbcsr.bcsr_plain(x, *tier, torch.zeros(nodes, h), safe).numpy()
    assert np.all(np.abs(got - plain) <= REL * mag + 1e-30)
    kind, tiles, pidx, rb, pn, rn = tier
    jt = jnp.asarray(tiles.float().numpy())
    if tiles.dtype == torch.bfloat16:
        jt = jt.astype(jnp.bfloat16)
    jx = jnp.asarray(x.float().numpy() if x.dtype == torch.bfloat16
                     else x.numpy())
    if x.dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    mode = kbcsr.compute_mode(tiles.dtype, x.dtype, safe)
    body = (jspmm.bcsr_panel_scan_spmm if kind == "panel"
            else jspmm.bcsr_scan_spmm)
    ref = body(jx, jnp.asarray(pn.numpy()), jt, jnp.asarray(pidx.numpy()),
               jnp.asarray(rb.numpy()), jnp.asarray(rn.numpy()),
               jnp.zeros((nodes, h), jnp.float32), step=1,
               q_scale=None if safe is None else jnp.float32(float(safe)),
               compute_dtype=jnp.float32 if mode == "f32" else None)
    assert np.all(np.abs(got - np.asarray(ref)) <= REL * mag + 1e-30)


@pytest.mark.parametrize("layout", ["row", "panel"])
def test_int8_table_route_bit_equal_to_jax(layout):
    """The int8 quantized aggregate's tier reads the int8 table
    ``round(x / safe)`` (|q| <= 127), as the reference's does
    (``pygim_tpu/ops/spmm.py:1632-1641``: no wide payload, bf16 cdt): on
    bf16 tiles it takes the one-part bf16 route, and on integer tiles
    every partial sum is an integer below 2^24, so the route,
    ``bcsr_add``'s plain version and JAX's tier body are bit-equal."""
    nodes, h = 700, 16
    tier, x, _ = route_inputs(layout, "bfloat16", "float32", None, h, nodes,
                              integer_tiles=True)
    xq = torch.round(x / quant_scale(x, "int8")[1]).to(torch.int8)
    assert 0 < int(xq.abs().max()) <= 127
    assert kbcsr.kernel_route(torch.bfloat16, xq.dtype) == ("bf16", 1)
    got = kbcsr.bcsr_add(xq, *tier, torch.zeros(nodes, h)).numpy()
    kind, tiles, pidx, rb, pn, rn = tier
    body = (jspmm.bcsr_panel_scan_spmm if kind == "panel"
            else jspmm.bcsr_scan_spmm)
    ref = body(jnp.asarray(xq.numpy()), jnp.asarray(pn.numpy()),
               jnp.asarray(tiles.float().numpy()).astype(jnp.bfloat16),
               jnp.asarray(pidx.numpy()), jnp.asarray(rb.numpy()),
               jnp.asarray(rn.numpy()), jnp.zeros((nodes, h), jnp.float32),
               step=1)
    np.testing.assert_array_equal(got, np.asarray(ref))
    emu, want, _mag, _r = route_product(xq, *tier, nodes)
    np.testing.assert_array_equal(emu, want)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_three_parts_needed_past_17_bits():
    """Two bf16 parts rebuild every integer of at most 17 bits (the first
    part's rounding leaves a remainder of at most 2^8) but not those of 18
    bits, which three parts rebuild: so ``chip_smoke.py``'s bit-equal case
    for ``bf16x3`` (|x| in [2^17, 2^18), cells in {-1, 0, 1}, at most 48
    terms a row, every partial sum below 2^24) fails a kernel that drops
    the third part."""
    v17 = np.arange(1 << 16, 1 << 17).astype(np.float32)
    np.testing.assert_array_equal(np.sum(bf16_parts(v17, 2), axis=0), v17)
    g = np.random.default_rng(5)
    v18 = (g.integers(1 << 17, 1 << 18, 4096)
           * g.choice([-1, 1], 4096)).astype(np.float32)
    two = np.sum([p.astype(np.float64) for p in bf16_parts(v18, 2)], axis=0)
    assert (two != v18).mean() > 0.2
    three = np.sum([p.astype(np.float64) for p in bf16_parts(v18, 3)],
                   axis=0)
    np.testing.assert_array_equal(three, v18)
    assert 48 * (1 << 18) <= 1 << 24


def test_kernel_route_table():
    """The routes by tile dtype, payload and rounding, with the
    reference's cdt beside each (``compute_mode``), and the launch
    counter's keys."""
    bf, f32 = torch.bfloat16, torch.float32
    one = torch.tensor(1.0)
    table = [
        # tiles, x, safe, cdt, route, parts
        (bf, f32, None, "bf16", "bf16", 1),
        (bf, bf, None, "bf16", "bf16", 1),
        (bf, torch.int8, None, "bf16", "bf16", 1),
        (bf, torch.int16, None, "f32", "bf16x2", 2),
        (bf, torch.int32, None, "f32", "bf16x3", 3),
        (bf, f32, one, "f32", "bf16x3", 3),
        (f32, f32, None, "f32", "tf32x3", 2),
        (f32, bf, None, "f32", "tf32x2", 1),
        (f32, torch.int8, None, "f32", "tf32x2", 1),
        (f32, torch.int16, None, "f32", "tf32x3", 2),
        (f32, torch.int32, None, "f32", "tf32x3", 2),
        (f32, f32, one, "f32", "tf32x3", 2),
    ]
    keys = set()
    for tiles, x, safe, cdt, route, parts in table:
        assert kbcsr.compute_mode(tiles, x, safe) == cdt
        assert kbcsr.kernel_route(tiles, x, safe) == (route, parts)
        key = kbcsr.route_key(tiles, x, safe)
        assert key == route + (" rounded" if safe is not None else "")
        keys.add(key)
    assert keys == set(kbcsr.route_keys())
