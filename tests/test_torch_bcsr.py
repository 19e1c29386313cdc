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
    its operations at the mode's rate."""
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
    ms, by = bcsr_bound(**c, h=256, peaks_=peaks, mma=False)
    assert by == "operations"
    assert ms == pytest.approx(2 * c["cells"] * 256 / 1e11 * 1e3)
