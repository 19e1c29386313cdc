"""The 2D ``sp × ds`` mesh SpMM of the port against the JAX reference, the
twin of the 2D cases of ``tests/test_parallel.py``: the reference's
``prepare_spmm_2d`` on the conftest's 8-device virtual CPU mesh beside
the port's on ``["cpu"] * 8``, inputs made from a seed with numpy.

Each case holds the port's host tables byte for byte to the reference's
(stacked ELL tables, cores, ``core_rows``, ``core_nodes``, BCSR), and
its product to the reference's and to a float64 dense product.
Tolerances are the reference tests' own: rtol 1e-4, atol 1e-4 for a
float payload on the ell backend and on f32 cores (the same bar between
the two packages: only the order of the f32 sums differs); rtol 3e-2,
atol 1e-1 against the dense product where a float payload goes through a
bf16, int8 or int4 core (x rounded to bf16), and there rtol 1e-4, atol
1e-4 against the reference, which rounds the same way; integer payloads
bit-equal. GCN logits within 1e-4 of their scale
(``test_torch_model.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.parallel import make_mesh as jmake_mesh
from pygim_tpu.parallel import prepare_spmm_2d as jprepare_2d
from pygim_tpu_torch import compat as tcompat
from pygim_tpu_torch.bench import Experiment
from pygim_tpu_torch.bench.runners import (
    run_inference_benchmark,
    run_spmm_benchmark,
    run_training_benchmark,
)
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import partition as tpart
from pygim_tpu_torch.data import load_dataset
from pygim_tpu_torch.nn.models import GNN, params_from_jax
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.parallel import PreparedSpmm2D, make_mesh, prepare_spmm_2d
from pygim_tpu_torch.parallel.collectives import psum, psum_scatter
from pygim_tpu_torch.utils.metrics import DataReporter

CPUS = ["cpu"] * 8
SHAPES = [(1, 1), (2, 4), (4, 2), (8, 1), (1, 8)]


def random_edges(n, m, nnz, seed, integer=False):
    """Distinct (row, col) pairs in (row, col) order and their values:
    standard normal, or integers in [-4, 4] (``tests/conftest.py``'s
    ``random_coo``)."""
    rng = np.random.default_rng(seed)
    flat = np.unique(rng.integers(0, n, nnz).astype(np.int64) * m
                     + rng.integers(0, m, nnz))
    rows, cols = flat // m, flat % m
    vals = (rng.integers(-4, 5, rows.size) if integer
            else rng.standard_normal(rows.size))
    return rows, cols, vals, n, m


def graphs(edges, dtype="float32"):
    rows, cols, vals, n, m = edges
    return (jgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=m,
                                       dtype=dtype),
            tgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=m,
                                       dtype=dtype))


def both(edges, sp, ds, dtype="float32", scatter=False, **kw):
    """(reference, port) 2D operands of ``edges`` on an (sp, ds) mesh."""
    jg, tg = graphs(edges, dtype)
    jp = jprepare_2d(jg, jmake_mesh(sp, ds), jspmm.SpmmConfig(**kw),
                     scatter_output=scatter)
    tp = prepare_spmm_2d(tg, make_mesh(sp, ds, CPUS), tspmm.SpmmConfig(**kw),
                         scatter_output=scatter)
    return jg, jp, tp


def host_equal(jp, tp):
    """The port's host tables are the reference's, byte for byte."""
    jdev = {k: np.asarray(v) for k, v in jp.dev_arrays.items()}
    assert set(tp.host_arrays) == set(jdev)
    for k, want in jdev.items():
        got = tp.host_arrays[k]
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert tp.ell_meta == [tuple(m) for m in jp.ell_meta]
    assert tp.hybrid_k_eff == jp.hybrid_k_eff
    assert tp.has_bcsr == jp.has_bcsr


def dense(edges, x):
    rows, cols, vals, n, m = edges
    a = np.zeros((n, m))
    np.add.at(a, (rows, cols), vals.astype(np.float64))
    return a @ x.astype(np.float64)


def products(jp, tp, x):
    got = tp.mul(torch.from_numpy(x)).numpy()
    want = np.asarray(jp.mul(jnp.asarray(x)))
    assert got.shape == want.shape
    assert torch.equal(tp.mul_plain(torch.from_numpy(x)),
                       torch.from_numpy(got))
    return got, want


@pytest.mark.parametrize("sp,ds", SHAPES)
def test_ell_matches_reference(sp, ds):
    edges = random_edges(130, 117, 1200, seed=sp * 10 + ds)
    x = np.random.default_rng(1).standard_normal((117, 40)).astype(np.float32)
    _jg, jp, tp = both(edges, sp, ds, n_blocks=3)
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense(edges, x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("core_dtype", [None, "int8", "int4", "bfloat16"])
@pytest.mark.parametrize("sp,ds", [(2, 2), (4, 2), (2, 4)])
def test_hybrid_matches_reference(sp, ds, core_dtype):
    """The column-sharded core of each dtype; an integer-valued graph with
    a 40-fold parallel edge (a cell the integer cores demote)."""
    n = 150
    rng = np.random.default_rng(sp * 100 + ds)
    rows = np.concatenate([rng.integers(0, n, 2500), np.zeros(40, np.int64)])
    cols = np.concatenate([rng.integers(0, n, 2500), np.ones(40, np.int64)])
    edges = (rows, cols, np.ones(rows.size, np.float32), n, n)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    _jg, jp, tp = both(edges, sp, ds, backend="hybrid", hybrid_k=48,
                       hybrid_dtype=core_dtype)
    assert tp.hybrid_k_eff == 48
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    loose = core_dtype is not None
    np.testing.assert_allclose(got, dense(edges, x),
                               rtol=3e-2 if loose else 1e-4,
                               atol=1e-1 if loose else 1e-4)


@pytest.mark.parametrize("core_dtype", ["int8", "int4", "bfloat16", None])
def test_hybrid_integer_payload_exact(core_dtype):
    """An int32 payload through each core over a (2, 2) mesh: every tier's
    integer sums are exact, so the product equals the reference's and
    the dense product bit for bit."""
    n = 120
    rng = np.random.default_rng(5)
    rows = np.concatenate([rng.integers(0, n, 4000), np.zeros(40, np.int64)])
    cols = np.concatenate([rng.integers(0, n, 4000), np.ones(40, np.int64)])
    edges = (rows, cols, np.ones(rows.size, np.float32), n, n)
    x = rng.integers(-9, 10, (n, 16)).astype(np.int32)
    _jg, jp, tp = both(edges, 2, 2, backend="hybrid", hybrid_k=32,
                       hybrid_dtype=core_dtype)
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got, dense(edges, x))


def test_hybrid_hub_heavy():
    rng = np.random.default_rng(3)
    n = 120
    rows = np.concatenate([rng.integers(0, 10, 3000), rng.integers(0, n, 300)])
    cols = np.concatenate([rng.integers(0, 10, 3000), rng.integers(0, n, 300)])
    edges = (rows, cols, rng.standard_normal(3300), n, n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    _jg, jp, tp = both(edges, 4, 2, backend="hybrid", hybrid_k=16)
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense(edges, x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sp,ds,kw", [
    (2, 2, {}), (4, 2, {}),
    (2, 2, dict(backend="hybrid", hybrid_k=24)),
    (4, 2, dict(backend="hybrid", hybrid_k=16)),
], ids=["ell-2x2", "ell-4x2", "hybrid-2x2", "hybrid-4x2"])
def test_scatter_output(sp, ds, kw):
    """The reduce-scatter merge: each sp shard's row block, rows padded to
    a multiple of sp and cut back; the same values."""
    edges = random_edges(130, 130, 1500, seed=sp + ds)
    x = np.random.default_rng(2).standard_normal((130, 16)).astype(np.float32)
    _jg, jp, tp = both(edges, sp, ds, scatter=True, **kw)
    assert tp.nrows_pad == -(-130 // sp) * sp
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense(edges, x), rtol=1e-4, atol=1e-4)


def community_edges(seed, n=512, blk=128, deg=12, shuffle=False):
    """A block-community graph (``tests/test_parallel.py``'s)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = (rows // blk) * blk + rng.integers(0, blk, rows.size)
    if shuffle:
        relabel = rng.permutation(n)
        rows, cols = relabel[rows], relabel[cols]
    return rows, cols, rng.standard_normal(rows.size), n, n


BCSR = dict(backend="hybrid", hybrid_k=32, bcsr_bytes=8 << 20, bcsr_tile=8,
            bcsr_min_edges=2)


@pytest.mark.parametrize("sp,ds", [(2, 2), (4, 2)])
def test_bcsr_matches_reference(sp, ds):
    edges = community_edges(sp * 7 + ds)
    x = np.random.default_rng(4).standard_normal((512, 24)).astype(np.float32)
    _jg, jp, tp = both(edges, sp, ds, **BCSR)
    assert tp.has_bcsr and tp.bcsr_edges == jp.bcsr_edges > 0
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense(edges, x), rtol=1e-4, atol=1e-4)


def test_bcsr_lp_order():
    edges = community_edges(11, shuffle=True)
    x = np.random.default_rng(5).standard_normal((512, 16)).astype(np.float32)
    _jg, jp, tp = both(edges, 4, 1, **{**BCSR, "bcsr_order": "lp"})
    assert tp.has_bcsr
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense(edges, x), rtol=1e-4, atol=1e-4)


def test_bcsr_tileless_shards():
    """A dense community in shard 0's columns only: the other shards hold
    zero-padded tables that add nothing."""
    rng = np.random.default_rng(6)
    n = 512
    rows = np.concatenate([rng.integers(0, 64, 6000), rng.integers(0, n, 800)])
    cols = np.concatenate([rng.integers(0, 64, 6000), rng.integers(0, n, 800)])
    edges = (rows, cols, rng.standard_normal(6800), n, n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    _jg, jp, tp = both(edges, 4, 2, backend="hybrid", hybrid_k=8,
                       bcsr_bytes=8 << 20, bcsr_tile=8, bcsr_min_edges=24)
    assert tp.has_bcsr
    host_equal(jp, tp)
    assert not tp.host_arrays["tiles"][1:].view(np.uint16).any()
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense(edges, x), rtol=1e-4, atol=1e-4)


def test_bcsr_wide_int_exact():
    rows, cols, _v, n, m = community_edges(12)
    vals = np.random.default_rng(7).integers(-3, 4, rows.size).astype(
        np.float32)
    edges = (rows, cols, vals, n, m)
    x = np.random.default_rng(8).integers(-5, 6, (n, 16)).astype(np.int32)
    _jg, jp, tp = both(edges, 2, 2, **BCSR)
    assert tp.has_bcsr
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dense(edges, x))


def test_multi_degree_tables():
    """A power-law graph: the shared planner takes more than one table,
    every shard holds every table."""
    rng = np.random.default_rng(9)
    n = 800
    deg = np.minimum(rng.zipf(1.4, n), 400)
    deg = (deg * (12000 / deg.sum())).astype(np.int64) + 1
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    edges = (rows, cols, np.ones(rows.size, np.float32), n, n)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    _jg, jp, tp = both(edges, 4, 2, block_nnz_budget=512)
    assert len(tp.ell_meta) >= 2
    host_equal(jp, tp)
    assert tspmm.shared_ell_keys(tp.ell_meta, "p_") == \
        jspmm.shared_ell_keys(jp.ell_meta, "p_")
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense(edges, x), rtol=1e-4, atol=1e-4)


def test_int32_graph_int32_payload():
    edges = random_edges(64, 64, 500, seed=13, integer=True)
    x = np.random.default_rng(14).integers(-5, 6, (64, 16)).astype(np.int32)
    _jg, jp, tp = both(edges, 4, 2, dtype="int32")
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_array_equal(got, np.asarray(want, np.float64))
    np.testing.assert_array_equal(got, dense(edges, x))


@pytest.mark.parametrize("agg_dtype", [None, "int32"])
def test_gcn_over_mesh(agg_dtype):
    """A 2-layer GCN over a (2, 2) mesh, parameters carried over from the
    reference's model: its logits against the reference's over its mesh
    and against the port's single-card operand."""
    n, f, h, c = 80, 16, 32, 4
    edges = random_edges(n, n, 600, seed=15)
    jg, jp, tp = both(edges, 2, 2)
    x = np.random.default_rng(16).standard_normal((n, f)).astype(np.float32)
    jgnn = jmake_gnn(jax.random.key(0), "gcn", f, h, c, agg_dtype=agg_dtype)
    want = np.asarray(jgnn.apply(jnp.asarray(x), jp.mul))
    m = GNN("gcn", f, h, c, agg_dtype=agg_dtype)
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgnn.params)))
    m.eval()
    single = tspmm.prepare_spmm(graphs(edges)[1], tspmm.SpmmConfig(),
                                device="cpu")
    with torch.inference_mode():
        got = m(torch.from_numpy(x), tspmm.PreparedAggregate(tp)).numpy()
        one = m(torch.from_numpy(x), tspmm.PreparedAggregate(single)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    assert float(np.abs(got - one).max()) <= 1e-4 * scale


def test_make_mesh_too_small_raises(monkeypatch):
    with pytest.raises(ValueError) as want:
        jmake_mesh(4, 4)  # 16 > 8 virtual devices
    with pytest.raises(ValueError) as got:
        make_mesh(4, 4, CPUS)
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 4 devices for sp=2 ds=2, "
                                         "have 0"):
        make_mesh(2, 2)
    mesh = make_mesh(2, 3, CPUS)
    assert mesh.shape == {"sp": 2, "ds": 3}
    assert mesh.devices == ((torch.device("cpu"),) * 3,) * 2


def test_splits_and_strip_match_reference():
    from pygim_tpu.core import partition as jpart

    edges = random_edges(50, 37, 400, seed=17)
    jg, tg = graphs(edges)
    jc, tc = jg.to_csr(), tg.to_csr()
    for nparts in (1, 3, 5):
        for jp, tp in zip(jc.col_split(nparts), tc.col_split(nparts)):
            for a in ("rowptr", "colind", "vals"):
                np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
            assert tp.ncols == jp.ncols
        for jp, tp in zip(jg.col_split(nparts), tpart.split_columns(tg, nparts)):
            for a in ("rows", "cols", "vals"):
                np.testing.assert_array_equal(getattr(tp, a), getattr(jp, a))
        assert tpart.split_features(41, nparts) == jpart.split_features(
            41, nparts)
    keep = np.random.default_rng(18).random(tc.nnz) < 0.5
    js, ts = jpart.strip_csr(jc, keep), tpart.strip_csr(tc, keep)
    for a in ("rowptr", "colind", "vals"):
        np.testing.assert_array_equal(getattr(ts, a), getattr(js, a))
    with pytest.raises(ValueError, match="cannot split"):
        tc.col_split(40)


def test_collectives_sum_in_shard_order():
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(12, 5, generator=g) for _ in range(4)]
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(psum([p.clone() for p in parts]), want)
    blocks = psum_scatter([p.clone() for p in parts])
    assert torch.equal(torch.cat(blocks), want)
    with pytest.raises(ValueError, match="equal blocks"):
        psum_scatter([torch.zeros(5, 2)] * 2)


def test_phase_times_and_grad_refusal():
    """phase_times' keys; a gradient through the mesh before and after
    its Aᵀ is prepared."""
    edges = random_edges(96, 96, 700, seed=19)
    _jg, _jp, tp = both(edges, 4, 2, scatter=True, backend="hybrid",
                        hybrid_k=16)
    x = torch.from_numpy(np.random.default_rng(20).standard_normal(
        (96, 8)).astype(np.float32))
    ph = tp.phase_times(x, iters=1)
    assert set(ph) == {"mul_time(ms)", "local_time(ms)", "psum_time(ms)"}
    assert ph["psum_time(ms)"] >= 0 and ph["local_time(ms)"] > 0
    # training over the mesh: a gradient needs the prepared Aᵀ, then runs
    # through it (against autograd through the plain versions on A, both
    # f32 here on an f32 core, within 1e-5 of the largest |grad|)
    xg = x.clone().requires_grad_()
    with pytest.raises(ValueError, match="not prepared"):
        tspmm.PreparedAggregate(tp)(xg)
    with pytest.raises(ValueError, match="not prepared"):
        tp.transpose()
    tt = tp.transpose(graphs(edges)[1])
    assert tp.transpose() is tt and tt.mesh == tp.mesh
    assert tt.scatter_output and tt.config == tp.config
    w = torch.randn(96, 8, generator=torch.Generator().manual_seed(0))
    y = tspmm.PreparedAggregate(tp)(xg)
    (ga,) = torch.autograd.grad((y * w).sum(), xg)
    xb = x.clone().requires_grad_()
    (gb,) = torch.autograd.grad((tp.mul_plain(xb) * w).sum(), xb)
    assert float((ga - gb).abs().max()) <= 1e-5 * float(gb.abs().max())
    assert tp.supports_fused_quant is False
    assert tspmm.PreparedAggregate(tp).quantized(x, "int32") is None


def test_tables_once_per_device():
    """A virtual mesh holds one copy of each sp shard's tables, not sp ·
    ds."""
    edges = random_edges(96, 96, 700, seed=21)
    _jg, _jp, tp = both(edges, 2, 4, backend="hybrid", hybrid_k=16)
    assert sorted(s for s, _d in tp.dev_arrays) == [0, 1]


def test_compat_routing(monkeypatch):
    _jg, tg = graphs(random_edges(64, 64, 400, seed=22))
    warns = []
    single = tcompat.prepare_for_version("spmm", tg, sp_parts=2, ds_parts=2,
                                         warn=warns.append, device="cpu")
    assert tcompat.describe_layout(single) == "single-chip"
    assert warns == ["[WARN] sp×ds=4 exceeds 1 devices; running single-chip"]
    monkeypatch.setattr(tcompat, "visible_devices", lambda device: 8)
    for version, layout in (("spmm", "mesh sp=2 ds=2"),
                            ("grande", "mesh sp=1 ds=4"),
                            ("spmv", "mesh sp=2 ds=4")):
        prep = tcompat.prepare_for_version(version, tg, hidden_size=16,
                                           sp_parts=2, ds_parts=2,
                                           device="cpu")
        assert isinstance(prep, PreparedSpmm2D)
        assert tcompat.describe_layout(prep) == layout


@pytest.mark.parametrize("kind", ["spmm", "inference"])
def test_experiment_mesh_on_cpu(tmp_path, kind):
    exp = Experiment(dataset="tiny", kind=kind, sp_parts=2, ds_parts=2,
                     hidden=16, repeat=1, dtype="int32")
    means = exp.run(tmp_path / "r", data_root=str(tmp_path / "data"),
                    device="cpu")
    rec = (tmp_path / "r" / f"{exp.frozen_name()}.out").read_text()
    assert "[DATA]layout: mesh sp=2 ds=2" in rec
    if kind == "spmm":
        assert "[DATA]verify: OK" in rec and means["pim_time_spmm(ms)"] > 0
    else:
        assert means["infer_time(ms)"] > 0


def test_runners_mesh(tmp_path, monkeypatch):
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path))
    ds = load_dataset("tiny")
    mesh = make_mesh(2, 2, CPUS)
    rep = DataReporter(echo=False)
    run_spmm_benchmark(ds, hidden=16, repeat=1, reporter=rep, device="cpu",
                       mesh=mesh, phases=True,
                       config=tspmm.SpmmConfig(backend="hybrid", hybrid_k=32))
    assert rep.records["layout"] == ["mesh sp=2 ds=2"]
    assert rep.records["verify"] == ["OK"]
    assert rep.records["psum_time(ms)"][0] >= 0
    run_inference_benchmark(ds, hidden=16, repeat=1, reporter=rep,
                            device="cpu", mesh=mesh, validate=True)
    assert rep.records["validate"] == ["OK"]
    # training over the mesh (ROADMAP.md Queue 1 item 6c): its backward
    # on the mesh's Aᵀ, the trained model against the oracle's
    res = run_training_benchmark(ds, hidden=16, epochs=2, device="cpu",
                                 mesh=mesh, reporter=rep)
    assert rep.records["validate"][-1] == "OK" and res["acc_delta"] <= 0.01
    assert rep.records["layout"][-1] == "mesh sp=2 ds=2"


def test_merge_duplicates_off():
    """With duplicates kept, each duplicate enters the core's f32 cell
    sum and the tail in storage order, as the reference's."""
    rng = np.random.default_rng(23)
    n = 100
    rows, cols = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    o = np.lexsort((cols, rows))  # the order both CSR builders keep
    edges = (rows[o], cols[o], rng.standard_normal(1500), n, n)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    _jg, jp, tp = both(edges, 2, 2, backend="hybrid", hybrid_k=24,
                       merge_duplicates=False)
    host_equal(jp, tp)
    got, want = products(jp, tp, x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
