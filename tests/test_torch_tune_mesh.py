"""The port's tuner over a device budget above one card against the JAX
package's on the CPU: ``enumerate_dist``, ``halo_statistics``, the
``2d`` and ``halo`` statistics of ``plan_statistics`` (every reference
key but ``device_bytes``) and their predictions with the reference's
constants within 1e-12, the model-mode ``autotune`` at ``n_devices=4``
(the same ranked candidates and pick), measure mode and ``prepare_tuned``
over ``["cpu"] * 4``, the collectives' fit and its cache, and the CLIs'
``--tune`` over a patched device count.

The graphs are the reference's ``_block_diag`` and ``_dense_cut``
(``tests/test_tune.py:240-255``, copied) and this directory's R-MAT pair.
The reference's results are computed once a module (fixtures); its
``measure_ici_constants``, which compiles ``shard_map`` bodies, is never
called. The metis order's partitions agree where the reference's native
planner is loaded; without it both packages take the label-propagation
packing (``tests/test_torch_halo.py:same_partitioner``)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.tune import autotuner as jtune
from pygim_tpu.tune import cost_model as jcost
from pygim_tpu.tune import dist as jdist
from pygim_tpu_torch import compat
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import native as tnative
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.tune import autotuner as ttune
from pygim_tpu_torch.tune import cost_model as tcost
from pygim_tpu_torch.tune import dist as tdist

import inference_cuda
import spmm_test_cuda
from test_torch_prepare import reference_planner
from test_torch_tune import graph_pair, reference_constants, reference_model

CPU4 = ["cpu"] * 4
ELL_ONLY = [dict(backend="ell", balance="nnz")]
TIGHT = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' tune caches in the test's own directory."""
    monkeypatch.setenv("PYGIM_TPU_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path / "data"))
    monkeypatch.setattr(jcost, "_CACHE", tmp_path / "ref" / "c.json")
    monkeypatch.setattr(jtune, "_CACHE_DIR", tmp_path / "ref")


@pytest.fixture(scope="module")
def partitioner():
    """The partitioner both packages take (module docstring): where the
    reference's native planner is not loaded, the port's label-propagation
    packing. Yields whether the native ones are used."""
    native = reference_planner()
    mp = pytest.MonkeyPatch()
    if not native:
        mp.setenv(tnative.NO_NATIVE_ENV, "1")
    yield native
    mp.undo()


def block_diag(n=4096, nd=4, deg=8, seed=0):
    """Edges inside each device's contiguous row range: a tiny cut."""
    rng = np.random.default_rng(seed)
    rpd = n // nd
    rows = np.repeat(np.arange(n), deg)
    cols = (rows // rpd) * rpd + rng.integers(0, rpd, rows.size)
    return rows, cols, np.ones(rows.size, np.float32), n


def dense_cut(n=4096, deg=8, seed=1):
    """Uniform random neighbours: nearly every remote row requested."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    return rows, cols, np.ones(rows.size, np.float32), n


def pair(kind, merged=True):
    """(reference, port) graphs of ``kind``: merged CSRs, or the COO
    graphs."""
    if kind in ("rmat", "planted"):
        return graph_pair(kind, merged)
    rows, cols, vals, n = {"block_diag": block_diag,
                           "dense_cut": dense_cut}[kind]()
    o = np.lexsort((cols, rows))
    rows, cols, vals = rows[o], cols[o], vals[o]
    jg = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n)
    tg = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n)
    if not merged:
        return jg, tg
    return (jgraph.merge_duplicate_edges(jg)[0].to_csr(),
            tgraph.merge_duplicate_edges(tg)[0].to_csr())


# ---------------------------------------------------------------- dist


@pytest.mark.parametrize("layouts", [("single", "2d", "halo"), ("2d", "halo"),
                                     ("single", "halo"), ("2d",)])
@pytest.mark.parametrize("nd", [1, 2, 4, 6, 8])
def test_enumerate_dist_matches_reference(nd, layouts):
    want = jdist.enumerate_dist(nd, layouts)
    got = tdist.enumerate_dist(nd, layouts)
    assert [dataclasses.asdict(p) for p in got] == [
        dataclasses.asdict(p) for p in want]
    assert [p.describe() for p in got] == [p.describe() for p in want]
    assert tdist.enumerate_dist(nd, layouts, orders=("none",)) == [
        tdist.DistPlan(**dataclasses.asdict(p))
        for p in jdist.enumerate_dist(nd, layouts, orders=("none",))]


@pytest.mark.parametrize("mode", ["contiguous", "keep", "metis"])
@pytest.mark.parametrize("nd", [2, 4, 8])
@pytest.mark.parametrize("kind", ["block_diag", "rmat"])
def test_halo_statistics_match_reference(kind, nd, mode, partitioner):
    """Equal dicts: the contiguous partition, a hub-core mask (the top
    256 ranked nodes' edges stripped), and each package's own
    ``partition_kway`` as ``dev_of``."""
    from pygim_tpu.core import cluster as jcluster
    from pygim_tpu_torch.core import cluster as tcluster

    jcsr, tcsr = pair(kind)
    jkw, tkw = {}, {}
    if mode == "keep":
        deg = np.diff(tcsr.rowptr) + np.bincount(tcsr.colind,
                                                 minlength=tcsr.nrows)
        rank = np.empty(tcsr.nrows, np.int64)
        rank[np.argsort(-deg, kind="stable")] = np.arange(tcsr.nrows)
        rows_of = np.repeat(np.arange(tcsr.nrows), np.diff(tcsr.rowptr))
        keep = ~((rank[rows_of] < 256) & (rank[tcsr.colind] < 256))
        jkw = tkw = {"keep": keep}
    elif mode == "metis":
        jkw = {"dev_of": jcluster.partition_kway(jcsr, nd)}
        tkw = {"dev_of": tcluster.partition_kway(tcsr, nd)}
        np.testing.assert_array_equal(tkw["dev_of"], jkw["dev_of"])
    want = jdist.halo_statistics(jcsr, nd, **jkw)
    got = tdist.halo_statistics(tcsr, nd, **tkw)
    assert got == want
    if kind == "block_diag" and mode == "contiguous" and nd == 4:
        assert got["local_edge_fraction"] > 0.99
        assert got["halo_k"] * 4 < got["ag_recv_rows"]


# ------------------------------------------------------ plan_statistics

MESH_PLANS = (
    [dict(layout="2d", sp=sp, ds=ds, scatter_output=so)
     for sp, ds in ((2, 2), (4, 1), (1, 4)) for so in (False, True)
     if sp > 1 or not so]
    + [dict(layout="halo", sp=4, exchange=e, order=o)
       for o in ("none", "metis")
       for e in ("all_gather", "all_to_all", "ring")
       if e != "all_gather" or o == "none"]
)
MESH_CONFIGS = [
    dict(backend="ell"),
    dict(backend="hybrid", hybrid_dtype="int8", hybrid_core_bytes=1 << 20),
    dict(backend="hybrid", hybrid_dtype=None, hybrid_core_bytes=1 << 20),
    dict(backend="hybrid", hybrid_dtype="int4", hybrid_core_bytes=1 << 18,
         bcsr_bytes=1 << 20, bcsr_tile=16),
]
COLL = {"psum": {"bw": 3.1e11, "fixed_us": 7.0},
        "all_gather": {"bw": 2.2e11, "fixed_us": 11.0},
        "all_to_all": {"bw": 1.7e11, "fixed_us": 13.0},
        "ring": {"bw": 2.9e11, "fixed_us": 4.0},
        "__meta": {"platform": "cpu", "n_devices": 4}}


def plan_id(p):
    return "-".join(str(v) for v in p.values())


@pytest.fixture(scope="module")
def mesh_stats(partitioner):
    """The reference's statistics of every (graph, config, plan) case,
    computed once, one memo a graph as in its autotune."""
    out = {}
    for kind in ("rmat", "planted"):
        jcsr, _ = pair(kind)
        memo = {}
        for ci, cfg in enumerate(MESH_CONFIGS):
            for p in MESH_PLANS:
                out[kind, ci, plan_id(p)] = jtune.plan_statistics(
                    jcsr, 64, jspmm.SpmmConfig(**cfg),
                    plan=jdist.DistPlan(**p), _memo=memo)
    return out


@pytest.mark.parametrize("plan", MESH_PLANS, ids=plan_id)
@pytest.mark.parametrize("ci", range(len(MESH_CONFIGS)),
                         ids=["ell", "int8", "f32", "int4-bcsr"])
@pytest.mark.parametrize("kind", ["rmat", "planted"])
def test_mesh_plan_statistics_match_reference(kind, ci, plan, mesh_stats):
    """Every reference key equal (``device_bytes`` is the port's own
    residency of its largest shard), and ``predict_spmm_time`` on the
    port's statistics with the reference's constants equal to the
    reference's, with and without measured collective constants."""
    want = mesh_stats[kind, ci, plan_id(plan)]
    _, tcsr = pair(kind)
    got = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig(**MESH_CONFIGS[ci]),
                                plan=tdist.DistPlan(**plan))
    for k, v in want.items():
        if k != "device_bytes":
            assert got[k] == v, k
    assert got["device_bytes"] > 0 and got["launches"] > 0
    single = ttune.plan_statistics(tcsr, 64,
                                   tspmm.SpmmConfig(**MESH_CONFIGS[ci]))
    nd = tdist.DistPlan(**plan).n_devices
    # every shard issues at least the single-card run path's launches
    assert got["launches"] >= nd * single["launches"]
    for coll in (None, COLL):
        r = jcost.predict_spmm_time(want, dataclasses.replace(
            reference_constants(), coll=coll))
        for stats in (want, got):
            t = tcost.predict_spmm_time(stats, reference_model(coll=coll))
            assert abs(t - r) <= 1e-12 * r


def test_halo_stats_argument_overrides_the_cut():
    """A given ``halo_stats`` prices the exchange, as the reference."""
    jcsr, tcsr = pair("rmat")
    hs = dict(halo_k=64, a2a_recv_rows=256, ring_recv_rows=200,
              ag_recv_rows=1536, cut_rows_total=10, local_edge_fraction=0.5)
    for ex in ("all_gather", "all_to_all", "ring"):
        plan = dict(layout="halo", sp=4, exchange=ex)
        want = jtune.plan_statistics(jcsr, 32, jspmm.SpmmConfig(backend="ell"),
                                     plan=jdist.DistPlan(**plan),
                                     halo_stats=hs)
        got = ttune.plan_statistics(tcsr, 32, tspmm.SpmmConfig(backend="ell"),
                                    plan=tdist.DistPlan(**plan),
                                    halo_stats=hs)
        assert got["psum_bytes"] == want["psum_bytes"]
        assert got["n_dispatch"] == want["n_dispatch"]


def test_mesh_core_bytes_are_a_shards():
    """A 2d core's slab, priced per device, is the sp-th of its core."""
    _, tcsr = pair("rmat")
    cfg = tspmm.SpmmConfig(backend="hybrid", hybrid_dtype="int8",
                           hybrid_k=1024)
    st = {sp: ttune.plan_statistics(tcsr, 16, cfg,
                                    plan=tdist.DistPlan("2d", sp, 1))
          for sp in (1, 2, 4)}
    assert st[2]["core_bytes"] == st[1]["core_bytes"] // 2
    assert st[4]["core_bytes"] == st[1]["core_bytes"] // 4


# ------------------------------------------------------------- autotune


AUTOTUNE_CASES = {
    "rmat": dict(kind="rmat", hidden=64),
    "block_diag": dict(kind="block_diag", hidden=64),
    "dense_cut": dict(kind="dense_cut", hidden=64),
    "block_diag halo ell": dict(kind="block_diag", hidden=64,
                                layouts=("halo",), space=ELL_ONLY),
    "dense_cut halo ell": dict(kind="dense_cut", hidden=64,
                               layouts=("halo",), space=ELL_ONLY),
}


@pytest.fixture(scope="module")
def ref_autotune(partitioner):
    """The reference's model-mode autotune of each case at n_devices 4."""
    out = {}
    for name, case in AUTOTUNE_CASES.items():
        jg, _ = pair(case["kind"], merged=False)
        kw = {k: v for k, v in case.items() if k in ("layouts", "space")}
        out[name] = jtune.autotune(jg, case["hidden"], n_devices=4,
                                   model=reference_constants(),
                                   use_cache=False, **kw)
    return out


@pytest.mark.parametrize("name", list(AUTOTUNE_CASES))
def test_autotune_four_devices_matches_reference(name, ref_autotune):
    """The same ranked (point, plan) candidates with the same predictions
    and the same pick; the reference's exchange checks hold: all_to_all
    on the block-diagonal graph, all_gather on the dense cut."""
    case = AUTOTUNE_CASES[name]
    want = ref_autotune[name]
    _, tg = pair(case["kind"], merged=False)
    kw = {k: v for k, v in case.items() if k in ("layouts", "space")}
    got = ttune.autotune(tg, case["hidden"], n_devices=4,
                         model=reference_model(), use_cache=False,
                         device="cpu", devices=CPU4, **kw)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    assert len(got.candidates) == len(want.candidates)
    for g, w in zip(got.candidates, want.candidates):
        assert g[0] == w[0] and g[1] == w[1]
        assert abs(g[2] - w[2]) <= 1e-12 * w[2]
    assert {c[1]["layout"] for c in got.candidates} >= set(
        kw.get("layouts", ("single", "2d", "halo")))
    if name == "block_diag halo ell":
        assert got.plan.layout == "halo" and got.plan.exchange == "all_to_all"
    if name == "dense_cut halo ell":
        assert got.plan.exchange == "all_gather"


def test_mesh_candidates_follow_the_references_rules():
    """No halo plan on a rectangular graph, no blocked or stair candidate
    on a mesh, no int core on a weighted graph."""
    rng = np.random.default_rng(3)
    g = tgraph.CooGraph.from_edges(rng.integers(0, 300, 3000),
                                   rng.integers(0, 200, 3000),
                                   rng.standard_normal(3000).astype(
                                       np.float32), nrows=300, ncols=200)
    res = ttune.autotune(g, 16, n_devices=4, model=reference_model(),
                         use_cache=False, device="cpu", devices=CPU4)
    for point, plan, *_ in res.candidates:
        assert plan["layout"] != "halo"
        assert point.get("hybrid_dtype") not in ("int8", "int4")
        if plan["layout"] != "single":
            assert point["backend"] == "ell"
    _, tg = pair("rmat", merged=False)
    res = ttune.autotune(tg, 16, n_devices=4, model=reference_model(),
                         use_cache=False, device="cpu", devices=CPU4)
    for point, plan, *_ in res.candidates:
        if plan["layout"] != "single":
            assert point["backend"] in ("ell", "hybrid")
            assert point.get("hybrid_shape", "square") == "square"
            assert not point.get("bcsr_bytes")


def test_cache_key_names_the_devices(tmp_path):
    """A mesh budget's result files under its devices' kind, count and
    virtuality, so a virtual mesh's pick is not served for real cards."""
    _, tg = pair("rmat", merged=False)
    ttune.autotune(tg, 16, n_devices=4, model=reference_model(),
                   device="cpu", devices=CPU4, space=ELL_ONLY)
    (path,) = (tmp_path / "tune").glob("tune-*.json")
    assert path.name.endswith("-cpu4v.json")
    assert json.loads(path.read_text())["plan"]["layout"] in (
        "single", "2d", "halo")


# ------------------------------------------------------- measure mode


@pytest.fixture
def measured_model(monkeypatch):
    """The port's measured constants replaced by the reference's (the
    CPU has none); the collectives are measured over the CPU mesh."""
    monkeypatch.setattr(tcost.CardCostModel, "measured",
                        classmethod(lambda cls, device="cuda":
                                    reference_model()))


def test_measure_mode_over_a_cpu_mesh(measured_model):
    """A measured pick among the three best of the four-device budget,
    the virtual tag in ``constants``."""
    _, tg = pair("block_diag", merged=False)
    tg = tgraph.CooGraph.from_edges(tg.rows[tg.rows < 256] % 256,
                                    tg.cols[tg.rows < 256] % 256,
                                    nrows=256, ncols=256)
    res = ttune.autotune(tg, 8, n_devices=4, mode="measure", repeats=1,
                         use_cache=False, device="cpu", devices=CPU4)
    assert res.measured_s is not None and res.measured_s > 0
    assert res.constants.endswith("+ici:cpux4")
    assert res.skipped == []
    timed = [c for c in res.candidates if c[3] is not None]
    assert len(timed) == 3 and [c[:3] for c in timed] == [
        c[:3] for c in res.candidates[:3]]


def test_measure_mode_records_broken_mesh_candidates(measured_model,
                                                     monkeypatch):
    """A candidate whose prepare raises is recorded, never dropped: all
    three, with their plans and messages (the reference's
    ``test_measure_mode_reports_broken_candidates``)."""
    def broken(graph, result, device="cuda", devices=None):
        raise RuntimeError("deliberately broken candidate")

    monkeypatch.setattr(ttune, "prepare_tuned", broken)
    _, tg = pair("rmat", merged=False)
    res = ttune.autotune(tg, 8, n_devices=4, mode="measure", repeats=1,
                         use_cache=False, device="cpu", devices=CPU4)
    assert res.measured_s is None and len(res.skipped) == 3
    for _point, plan, err in res.skipped:
        assert isinstance(plan, dict) and "layout" in plan
        assert err == "RuntimeError: deliberately broken candidate"


# ------------------------------------------------------- prepare_tuned


PREPARED = {
    "2d ell": (dict(backend="ell"), dict(layout="2d", sp=2, ds=2)),
    "2d int8 scatter": (dict(backend="hybrid", hybrid_dtype="int8",
                             hybrid_k=256),
                        dict(layout="2d", sp=4, ds=1, scatter_output=True)),
    "halo ell ring": (dict(backend="ell"),
                      dict(layout="halo", sp=4, exchange="ring")),
    "halo int8 a2a metis": (dict(backend="hybrid", hybrid_dtype="int8",
                                 hybrid_k=256),
                            dict(layout="halo", sp=4, exchange="all_to_all",
                                 order="metis")),
}


@pytest.mark.parametrize("name", list(PREPARED))
def test_prepare_tuned_meshes_match_reference(name, partitioner):
    """``prepare_tuned`` of a ``2d`` and a ``halo`` plan over ``["cpu"] *
    4``: the operand's layout, and its product the reference's
    ``prepare_tuned`` product (``tests/test_torch_mesh.py`` /
    ``test_torch_halo.py``'s bars: 1e-4 on ell, and on a bf16-rounded
    core too, which both packages round alike); an int32 payload equal to
    the plain arm's."""
    cfg, plan = PREPARED[name]
    jg, tg = pair("rmat", merged=False)
    jres = jtune.TuneResult(jspmm.SpmmConfig(**cfg), jdist.DistPlan(**plan),
                            0.0, None, [])
    tres = ttune.TuneResult(tspmm.SpmmConfig(**cfg), tdist.DistPlan(**plan),
                            0.0, None, [])
    jp = jtune.prepare_tuned(jg, jres)
    tp = ttune.prepare_tuned(tg, tres, device="cpu", devices=CPU4)
    want_layout = ("halo nd=4" if plan["layout"] == "halo"
                   else f"mesh sp={plan['sp']} ds={plan['ds']}")
    assert compat.describe_layout(tp) == want_layout
    x = np.random.default_rng(5).standard_normal((tg.ncols, 16)).astype(
        np.float32)
    np.testing.assert_allclose(tp.mul(torch.from_numpy(x)).numpy(),
                               np.asarray(jp.mul(jnp.asarray(x))), **TIGHT)
    xi = torch.randint(-9, 10, (tg.ncols, 16), dtype=torch.int32,
                       generator=torch.Generator().manual_seed(6))
    assert torch.equal(tp.mul(xi), tp.mul_plain(xi))


def test_prepare_tuned_needs_its_devices():
    _, tg = pair("rmat", merged=False)
    res = ttune.TuneResult(tspmm.SpmmConfig(backend="ell"),
                           tdist.DistPlan("halo", 4, 1), 0.0, None, [])
    with pytest.raises(ValueError, match="4 devices, 2 given"):
        ttune.prepare_tuned(tg, res, device="cpu", devices=["cpu"] * 2)
    assert compat.describe_layout(ttune.prepare_tuned(
        tg, res, device="cpu")) == "halo nd=4"


# ------------------------------------------------------ ICI constants


@pytest.mark.parametrize("name", tcost.COLLECTIVES)
@pytest.mark.parametrize("nd", [2, 4, 8])
def test_collective_fit_recovers_its_constants(name, nd):
    """Times made from a bandwidth and a fixed cost in the reference's
    volume units give them back by the reference's two-point formula;
    a large call not slower than the small one takes its degenerate
    branch."""
    frac = (nd - 1) / nd
    unit = {"psum": lambda r: r * 256 * 4 * frac * 2,
            "all_gather": lambda r: (nd - 1) * r * 256 * 4,
            "all_to_all": lambda r: nd * r * 256 * 4,
            "ring": lambda r: r * 256 * 4}[name]
    v1, v2 = (tcost.collective_volume(name, nd, r, 256) for r in (8, 4096))
    assert (v1, v2) == (unit(8), unit(4096))
    bw, fixed = 1.3e11, 9.5e-6
    t1, t2 = fixed + v1 / bw, fixed + v2 / bw
    fit = tcost.fit_collective(t1, t2, v1, v2)
    assert fit["bw"] == pytest.approx(bw, rel=1e-9)
    assert fit["fixed_us"] == pytest.approx(fixed * 1e6, rel=1e-6)
    flat = tcost.fit_collective(3e-5, 2e-5, v1, v2)
    assert flat == {"bw": v2 / 2e-5, "fixed_us": 0.0}


def test_ici_constants_over_a_cpu_mesh(measured_model, tmp_path):
    """Every collective's constants over ``["cpu"] * 4``, finite, with
    the ``__meta`` entry; cached per tag and count and read back; a file
    of another card is measured again; ``for_topology`` tags its
    provenance."""
    coll = tcost.measure_ici_constants(CPU4)
    assert set(coll) == {*tcost.COLLECTIVES, "__meta"}
    assert coll["__meta"]["platform"] == "cpu"
    assert coll["__meta"]["n_devices"] == 4 and coll["__meta"]["virtual"]
    for name in tcost.COLLECTIVES:
        assert coll[name]["bw"] > 0 and np.isfinite(coll[name]["bw"])
        assert coll[name]["fixed_us"] >= 0
    path = tmp_path / "tune" / "ici-cpu-n4.json"
    assert path.exists()
    assert tcost.measure_ici_constants(CPU4) == coll
    other = dict(coll, __meta={**coll["__meta"], "card": "another card"},
                 psum={"bw": 1.0, "fixed_us": 1.0})
    path.write_text(json.dumps(other))
    assert tcost.measure_ici_constants(CPU4)["psum"] != other["psum"]
    m = tcost.CardCostModel.for_topology(4, CPU4)
    assert m.provenance == reference_model().provenance + "+ici:cpux4"
    assert set(m.coll) == set(coll)
    assert tcost.CardCostModel.for_topology(4, ["cpu"] * 2) == \
        reference_model()


def test_mesh_tags():
    """``cuda`` for distinct cards, ``cuda-virtual`` for one card
    repeated, ``cpu``: three cache files."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert tcost.mesh_tag(cuda) == "cuda"
    assert tcost.mesh_tag([torch.device("cuda", 0)] * 4) == "cuda-virtual"
    assert tcost.mesh_tag(CPU4) == "cpu"
    names = {tcost._ici_path(t, 4, 4096, 256).name
             for t in ("cuda", "cuda-virtual", "cpu")}
    assert len(names) == 3


# ---------------------------------------------------------------- CLIs


@pytest.mark.parametrize("nd", [2, 4])
@pytest.mark.parametrize("main", [spmm_test_cuda.main, inference_cuda.main],
                         ids=["spmm", "infer"])
def test_cli_tune_runs_a_mesh_pick(main, nd, capsys, monkeypatch):
    """``--tune`` with ``nd`` visible devices (copies of the CPU): a mesh
    ``tuned_plan``, its ``layout`` line, and the run checked."""
    from pygim_tpu_torch.utils.metrics import parse_data_lines

    monkeypatch.setattr(compat, "visible_devices", lambda device: nd)
    capsys.readouterr()
    main(["--dataset", "tiny", "--tune", "--repeat", "1", "--sp_parts", "2",
          "--ds_parts", str(nd // 2)], device="cpu")
    got = parse_data_lines(capsys.readouterr().out.splitlines())
    plan = got["tuned_plan"][0]
    assert plan.startswith(("2d ", "halo ")), plan
    layout = got["layout"][0]
    if plan.startswith("2d"):
        sp, ds = (int(t.split("=")[1].rstrip("+scatter"))
                  for t in plan.split()[1:3])
        assert layout == f"mesh sp={sp} ds={ds}" and sp * ds == nd
    else:
        assert layout == f"halo nd={nd}"
    assert got["tuned_constants"][0].startswith("datasheet:")
    assert got.get("verify", ["OK"]) == ["OK"]
    assert (got.get("pim_time_spmm(ms)") or got["infer_time(ms)"])[0] > 0
