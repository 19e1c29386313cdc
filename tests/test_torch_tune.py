"""The port's tuner (``pygim_tpu_torch/tune``) against the JAX package's
(``pygim_tpu/tune``) on the CPU: ``plan_statistics`` key for key (all but
``device_bytes``), ``predict_spmm_time`` on the reference's statistics
with the reference's constants (``launch_us = 0``) within 1e-12, the
same ``autotune`` pick, candidates, order and predictions,
``calibrate_from_phases`` and ``_fingerprint``; measure mode's skipped
list, the cache, ``Experiment(tune=True)``'s ``tuned_*`` lines, the
compat adapters, ``ell_issue_seconds`` and ``staircase_coverage``. The reference's constants are read from it at run
time. The budgets above one card are ``tests/test_torch_tune_mesh.py``'s."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from pygim_tpu import compat as jcompat
from pygim_tpu.core import graph as jgraph
from pygim_tpu.core import partition as jpart
from pygim_tpu.core import stair as jstair
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu.tune import autotuner as jtune
from pygim_tpu.tune import cost_model as jcost
from pygim_tpu_torch import compat as tcompat
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core import partition as tpart
from pygim_tpu_torch.core import stair as tstair
from pygim_tpu_torch.ops import seg_rows as tseg
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.tune import autotuner as ttune
from pygim_tpu_torch.tune import cost_model as tcost
from pygim_tpu_torch.tune import dist as tdist


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' tune caches and the port's data cache in the test's
    own directory; the reference's constants file out of reach."""
    monkeypatch.setenv("PYGIM_TPU_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path / "data"))
    monkeypatch.setattr(jcost, "_CACHE", tmp_path / "ref" / "c.json")
    monkeypatch.setattr(jtune, "_CACHE_DIR", tmp_path / "ref")


def reference_constants():
    return jcost.TpuCostModel(**jcost._DEFAULTS)


def reference_model(**over) -> tcost.CardCostModel:
    """The port's model with the reference's constants: its roofline (the
    scatter at the stream rate), its planner's ELL issue constants, f32
    cells and tiles at its one tensor rate, no launch cost, core
    efficiency 1, the tail's byte floor on."""
    r = reference_constants()
    return dataclasses.replace(tcost.CardCostModel(
        hbm_bw=r.hbm_bw, ici_bw=r.ici_bw, gather_eff=r.gather_eff,
        stream_eff=r.stream_eff, scatter_eff=r.stream_eff,
        fixed_us=r.fixed_us, tensor_bf16=r.mxu_bf16,
        tensor_f32=r.mxu_bf16,
        ell_slot_ns=jpart._ELL_SLOT_NS,
        ell_vrow_fixed_ns=jpart._ELL_VROW_FIXED_NS,
        ell_vrow_ns_per_h=jpart._ELL_VROW_NS_PER_H, launch_us=0.0,
        core_eff=1.0, coll=r.coll, ell_slot_factor=r.ell_slot_factor,
        provenance=r.provenance), **over)


def graph_edges(kind: str):
    """(rows, cols, vals, n) in (row, col) order, so both packages' CSR
    agree: a small R-MAT, a planted partition, a zipf-skewed graph (all
    unweighted), and a weighted R-MAT."""
    rng = np.random.default_rng(7)
    if kind in ("rmat", "weighted"):
        from pygim_tpu_torch.data.datasets import rmat_edges

        n = 2048
        rows, cols = rmat_edges(n, 30_000, seed=5)
    elif kind == "planted":
        n, c = 3000, 6
        label = rng.integers(0, c, n)
        rows = rng.integers(0, n, 40_000)
        cols = rng.integers(0, n, 40_000)
        keep = (label[rows] == label[cols]) | (rng.random(40_000) < 0.1)
        rows, cols = rows[keep], cols[keep]
    else:  # skewed
        n = 3000
        deg = np.minimum(rng.zipf(1.4, n), 400)
        deg = (deg * (40_000 / deg.sum())).astype(np.int64) + 1
        rows = np.repeat(np.arange(n), deg)
        cols = rng.integers(0, n, rows.size)
    vals = (rng.standard_normal(rows.size).astype(np.float32)
            if kind == "weighted" else np.ones(rows.size, np.float32))
    o = np.lexsort((cols, rows))
    return rows[o], cols[o], vals[o], n


def graph_pair(kind: str, merged: bool = True):
    rows, cols, vals, n = graph_edges(kind)
    jg = jgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n)
    tg = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n)
    if not merged:
        return jg, tg
    return (jgraph.merge_duplicate_edges(jg)[0].to_csr(),
            tgraph.merge_duplicate_edges(tg)[0].to_csr())


GRAPHS = ["rmat", "planted", "skewed"]
CONFIGS = (
    [dict(backend="blocked", balance=b, block_nnz_budget=bb)
     for b in ("nnz", "row") for bb in (1 << 10, 1 << 12, 1 << 14)]
    + [dict(backend="ell")]
    + [dict(backend="hybrid", hybrid_shape=s, hybrid_dtype=d,
            hybrid_core_bytes=1 << 20)
       for s in ("square", "stair") for d in (None, "bfloat16", "int8", "int4")]
    + [dict(backend="hybrid", hybrid_dtype="int8", hybrid_core_bytes=1 << 18,
            bcsr_bytes=1 << 20, bcsr_tile=16, bcsr_order=o)
       for o in ("rank", "lp")]
)


def config_id(c):
    return "-".join(f"{v}" for k, v in c.items() if k != "backend"
                    ) or c["backend"]


@pytest.mark.parametrize("hidden", [16, 64])
@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=[f"{c['backend']}-{config_id(c)}"
                              for c in CONFIGS])
@pytest.mark.parametrize("kind", GRAPHS)
def test_plan_statistics_match_reference(kind, cfg, hidden):
    """Every reference key equal (``device_bytes`` is the port's own
    residency), and the port's keys present; the prediction on the port's
    statistics with the reference's constants equal to the reference's."""
    jcsr, tcsr = graph_pair(kind)
    want = jtune.plan_statistics(jcsr, hidden, jspmm.SpmmConfig(**cfg))
    got = ttune.plan_statistics(tcsr, hidden, tspmm.SpmmConfig(**cfg))
    for k, v in want.items():
        if k != "device_bytes":
            assert got[k] == v, k
    assert got["device_bytes"] > 0 and got["launches"] > 0
    assert set(got) - set(want) == {"launches", "core_cell",
                                    "bcsr_tile_dtype"}
    r = jcost.predict_spmm_time(want, reference_constants())
    for stats in (want, got):
        t = tcost.predict_spmm_time(stats, reference_model())
        assert abs(t - r) <= 1e-12 * r


def test_bcsr_candidates_capture_tiles():
    """The BCSR cases above price a tier that captures edges."""
    jcsr, tcsr = graph_pair("planted")
    for cfg in CONFIGS[-2:]:
        st = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig(**cfg))
        assert st["bcsr_captured"] > 0 and st["bcsr_tile_dtype"] == "bfloat16"


@pytest.mark.parametrize("kind", GRAPHS + ["weighted"])
def test_autotune_matches_reference(kind):
    """Model mode with the reference's constants: the same pick, and the
    same candidates in the same order with the same predictions."""
    jg, tg = graph_pair(kind, merged=False)
    want = jtune.autotune(jg, 64, model=reference_constants(),
                          use_cache=False)
    got = ttune.autotune(tg, 64, model=reference_model(), use_cache=False,
                         device="cpu")
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert got.plan == tdist.DistPlan() and got.measured_s is None
    assert len(got.candidates) == len(want.candidates)
    for g, w in zip(got.candidates, want.candidates):
        assert g[0] == w[0] and g[1] == w[1]
        assert abs(g[2] - w[2]) <= 1e-12 * w[2]
    assert got.constants == want.constants
    if kind == "weighted":
        assert not {p.get("hybrid_dtype") for p, *_ in got.candidates} & {
            "int8", "int4"}


def test_launch_term_prices_blocked():
    """With a launch cost, a blocked candidate pays K-rows' one launch,
    and one more that zeroes the hub rows where a row holds more than a
    unit's entries, whatever its block count."""
    _, tcsr = graph_pair("rmat")
    cfg = tspmm.SpmmConfig(backend="blocked", block_nnz_budget=1 << 10)
    st = ttune.plan_statistics(tcsr, 64, cfg)
    longest = int(np.diff(tcsr.rowptr).max())
    assert longest > tseg.UNIT_ENTRIES and st["n_blocks"] > 2
    assert st["launches"] == ttune.blocked_launches(longest) == 2
    assert ttune.blocked_launches(tseg.UNIT_ENTRIES) == 1
    base = tcost.predict_spmm_time(st, reference_model())
    priced = tcost.predict_spmm_time(st, reference_model(launch_us=10.0))
    assert priced - base == pytest.approx(st["launches"] * 1e-5, rel=1e-9)


def test_rows_factor_prices_blocked_as_k_rows():
    """With ``rows_factor`` (the measured model) a blocked candidate costs
    that factor times K-tail's fitted issue time of its entries and rows,
    no scatter pass; ell and the hybrids do not move; ``rows_factor = 0``
    is the reference's bytes."""
    _, tcsr = graph_pair("skewed")
    m = reference_model(rows_factor=0.75)
    blocked = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig())
    issue = tpart.ell_issue_seconds(
        blocked["n_blocks"] * blocked["nnz_pad"],
        blocked["n_blocks"] * blocked["rows_pad"], 64,
        slot_ns=m.ell_slot_ns * m.ell_slot_factor,
        vrow_fixed_ns=m.ell_vrow_fixed_ns,
        vrow_ns_per_h=m.ell_vrow_ns_per_h)
    assert issue > 0 and blocked["scatter_bytes"] > 0
    assert tcost.predict_spmm_time(blocked, m) == pytest.approx(
        0.75 * issue + m.fixed_us * 1e-6)
    for cfg in (dict(backend="ell"), dict(backend="hybrid",
                                          hybrid_dtype="int8",
                                          hybrid_core_bytes=1 << 20)):
        st = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig(**cfg))
        assert tcost.predict_spmm_time(st, m) == \
            tcost.predict_spmm_time(st, reference_model())
    assert reference_model().rows_factor == 0.0


def test_fitted_tail_is_priced_by_its_fit():
    """With ``tail_roofline`` off (the measured model: the ELL constants
    fitted to K-tail) an ELL tail costs its issue time alone, the byte
    roofline left out; blocked keeps its bytes; ``core_eff`` divides the
    core's roofline."""
    _, tcsr = graph_pair("rmat")
    m = reference_model(tail_roofline=False)
    ell = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig(backend="ell"))
    issue = tpart.ell_issue_seconds(
        ell["ell_slots"], ell["ell_vrows"], 64, slot_ns=m.ell_slot_ns
        * m.ell_slot_factor)
    assert tcost.predict_spmm_time(ell, m) == pytest.approx(
        issue + m.fixed_us * 1e-6)
    blocked = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig())
    assert tcost.predict_spmm_time(blocked, m) == \
        tcost.predict_spmm_time(blocked, reference_model())
    hyb = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig(
        backend="hybrid", hybrid_dtype="int8", hybrid_core_bytes=1 << 20))
    core = max(hyb["core_bytes"] / (m.hbm_bw * m.stream_eff),
               hyb["core_flops"] / m.tensor_bf16)
    half = dataclasses.replace(m, core_eff=0.5)
    assert tcost.predict_spmm_time(hyb, half) - tcost.predict_spmm_time(
        hyb, m) == pytest.approx(core, rel=1e-9)


def test_f32_core_cells_priced_at_their_rate():
    """An f32 core's products at ``tensor_f32``, an int8 core's at
    ``tensor_bf16``."""
    _, tcsr = graph_pair("skewed")
    for dtype, rate in ((None, "tensor_f32"), ("int8", "tensor_bf16")):
        st = ttune.plan_statistics(tcsr, 64, tspmm.SpmmConfig(
            backend="hybrid", hybrid_dtype=dtype, hybrid_core_bytes=1 << 20))
        m = reference_model(hbm_bw=1e30)  # the core bound by operations
        slow = dataclasses.replace(m, **{rate: getattr(m, rate) / 10})
        t0 = tcost.predict_spmm_time(st, m)
        t1 = tcost.predict_spmm_time(st, slow)
        assert t1 - t0 == pytest.approx(
            9 * st["core_flops"] / getattr(m, rate), rel=1e-6)


@pytest.mark.parametrize("phases", [
    {"gather_time(ms)": 0.5, "tail_time(ms)": 2.0},
    {"gather_time(ms)": 3.0, "tail_time(ms)": 2.0},
    {"tail_time(ms)": 2.0},
    {"gather_time(ms)": 1e-9, "tail_time(ms)": 1e-6},
    {},
])
def test_calibrate_from_phases_matches_reference(phases):
    jcsr, tcsr = graph_pair("rmat")
    cfg = dict(backend="hybrid", hybrid_dtype="int8", hybrid_core_bytes=1 << 18)
    stats = jtune.plan_statistics(jcsr, 64, jspmm.SpmmConfig(**cfg))
    want = jcost.calibrate_from_phases(stats, phases,
                                       base=reference_constants())
    got = tcost.calibrate_from_phases(stats, phases, base=reference_model())
    assert (got.gather_eff, got.stream_eff) == (want.gather_eff,
                                               want.stream_eff)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("hidden", [16, 256])
def test_fingerprint_matches_reference(kind, hidden):
    jcsr, tcsr = graph_pair(kind)
    assert ttune._fingerprint(tcsr, hidden) == jtune._fingerprint(jcsr,
                                                                   hidden)


def test_measure_mode_records_a_raising_candidate(monkeypatch):
    """Measure mode on the CPU: the three best-predicted candidates are
    prepared and timed; one made to raise lands in ``skipped`` with its
    message, and the pick is the fastest of the others."""
    _, tg = graph_pair("rmat", merged=False)
    ranked = ttune.autotune(tg, 16, model=reference_model(), use_cache=False,
                            device="cpu").candidates
    bad = ranked[0][0]
    real = ttune.prepare_tuned

    def prepare(graph, result, device="cuda", devices=None):
        if dataclasses.asdict(result.config) == dataclasses.asdict(
                tspmm.SpmmConfig(**bad)):
            raise ValueError("made to fail")
        return real(graph, result, device=device, devices=devices)

    monkeypatch.setattr(ttune, "prepare_tuned", prepare)
    res = ttune.autotune(tg, 16, mode="measure", model=reference_model(),
                         use_cache=False, device="cpu")
    assert [s[0] for s in res.skipped] == [
        p for p, *_ in ranked[:3] if p == bad]
    assert all(s[2] == "ValueError: made to fail" for s in res.skipped)
    timed = [c for c in res.candidates if c[3] is not None]
    assert 1 <= len(timed) <= 2 and res.measured_s == min(c[3] for c in timed)
    assert dataclasses.asdict(res.config) != dataclasses.asdict(
        tspmm.SpmmConfig(**bad))


def test_measure_mode_needs_constants_of_a_card():
    """Measure mode without a model calibrates on a card: on the CPU it
    raises, never falls back."""
    _, tg = graph_pair("rmat", merged=False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ttune.autotune(tg, 16, mode="measure", use_cache=False, device="cpu")


def test_cache_round_trip_and_provenance(tmp_path, monkeypatch):
    """A result comes back from the cache without planning again; a model
    of another provenance files under another key."""
    _, tg = graph_pair("rmat", merged=False)
    first = ttune.autotune(tg, 16, model=reference_model(), device="cpu")
    files = sorted((tmp_path / "tune").glob("tune-*.json"))
    assert len(files) == 1

    def boom(*a, **k):
        raise AssertionError("planned again")

    monkeypatch.setattr(ttune, "plan_statistics", boom)
    again = ttune.autotune(tg, 16, model=reference_model(), device="cpu")
    assert again.config == first.config
    assert again.predicted_s == first.predicted_s
    assert [list(c[:3]) for c in again.candidates] == [
        [c[0], c[1], c[2]] for c in first.candidates]
    with pytest.raises(AssertionError, match="planned again"):
        ttune.autotune(tg, 16, model=reference_model(provenance="measured:x"),
                       device="cpu")


def test_constants_file_of_another_card_is_not_read(monkeypatch):
    """``default`` reads the measured constants only where the file is
    this card's line; otherwise it gives the data sheet, uncalibrated.
    ``measured`` on no card raises."""
    measured = dataclasses.replace(tcost.datasheet(None), gather_eff=0.5,
                                   provenance="measured:card A, 700.00 W")
    tcost.save_measured(measured, "card A, 700.00 W", {"note": 1})
    monkeypatch.setattr(tcost, "visible_card", lambda: "card A, 700.00 W")
    assert tcost.CardCostModel.default() == measured
    assert tcost.CardCostModel.measured() == measured
    monkeypatch.setattr(tcost, "visible_card",
                        lambda: "NVIDIA H100 PCIe, 350.00 W")
    other = tcost.CardCostModel.default()
    assert other.gather_eff == other.scatter_eff == 1.0
    assert other.tail_roofline and "uncalibrated" in other.provenance
    assert other.hbm_bw == 2.0e12  # the PCIe part's data sheet
    monkeypatch.setattr(tcost, "visible_card", lambda: None)
    sheet = tcost.CardCostModel.default()
    assert sheet.provenance.startswith("datasheet:NVIDIA H100")
    from pygim_tpu_torch.utils.device import peaks

    assert (sheet.hbm_bw, sheet.tensor_bf16) == peaks(tcost.DEFAULT_CARD)[:2]
    with pytest.raises(RuntimeError, match="CUDA card"):
        tcost.CardCostModel.measured("cpu")


def test_constants_file_before_k_rows_is_measured_again(monkeypatch):
    """A constants file written before the blocked family ran on K-rows
    (no ``version``, no ``rows_factor``; ``scatter_eff`` and ``launch_us``
    fitted on the plain blocked body) is not read, though its card line
    matches: ``load_measured`` gives None and ``default`` the data sheet.
    The file ``save_measured`` writes now is read back."""
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    old = dataclasses.asdict(tcost.datasheet(None))
    del old["rows_factor"]
    old.update(scatter_eff=0.226, launch_us=9.8, provenance=f"measured:{card}")
    path = tcost.cache_dir() / tcost.CONSTANTS_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": card, "model": old, "readings": {}}))
    monkeypatch.setattr(tcost, "visible_card", lambda: card)
    assert tcost.load_measured(card) is None
    assert "uncalibrated" in tcost.CardCostModel.default().provenance
    path.write_text(json.dumps({"card": card, "version": 1, "model": old,
                                "readings": {}}))
    assert tcost.load_measured(card) is None
    now = dataclasses.replace(tcost.datasheet(None), rows_factor=0.19,
                              provenance=f"measured:{card}")
    tcost.save_measured(now, card)
    assert json.loads(path.read_text())["version"] == tcost.CONSTANTS_VERSION
    assert tcost.load_measured(card) == now


def test_constants_file_before_tf32_tiles_is_measured_again(monkeypatch):
    """A version-2 constants file (f32 tiles priced at the FFMA mode's
    data-sheet ``simt_f32``; ``rows_factor`` fitted before K-rows' wrapper
    was trimmed) is not read, though its card line matches:
    ``load_measured`` gives None and ``default`` the data sheet, which
    prices f32 tiles at K-bcsr's three TF32 products a term
    (``tensor_f32``, a sixth of the bf16 rate)."""
    from pygim_tpu_torch.utils.device import peaks

    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    old = dataclasses.asdict(tcost.datasheet(None))
    old.update(simt_f32=6.7e13, rows_factor=0.1884,
               provenance=f"measured:{card}")
    path = tcost.cache_dir() / tcost.CONSTANTS_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": card, "version": 2, "model": old,
                                "readings": {}}))
    monkeypatch.setattr(tcost, "visible_card", lambda: card)
    assert tcost.CONSTANTS_VERSION == 3
    assert tcost.load_measured(card) is None
    sheet = tcost.CardCostModel.default()
    assert "uncalibrated" in sheet.provenance
    assert sheet.tensor_f32 == peaks(tcost.DEFAULT_CARD)[1] / 6
    assert not hasattr(sheet, "simt_f32")
    stats = dict(gather_bytes=0, stream_bytes=0, psum_bytes=0,
                 n_dispatch=0, bcsr_flops=1e12, bcsr_tile_dtype="float32")
    f32 = tcost.predict_spmm_time(stats, sheet)
    bf16 = tcost.predict_spmm_time(dict(stats, bcsr_tile_dtype="bfloat16"),
                                   sheet)
    assert f32 == pytest.approx(6 * bf16) and f32 > 0


def test_fit_tail_recovers_its_constants():
    """K-tail's fit: times made from known constants give them back, and
    the fourth point checks the fit."""
    s, f, p = 0.31, 4.5, 0.02
    times = {(d, h): d * s + f + h * p
             for d in tcost.TAIL_DEGREES for h in tcost.TAIL_WIDTHS}
    fit = tcost.fit_tail(times)
    assert fit["ell_slot_ns"] == pytest.approx(s)
    assert fit["ell_vrow_fixed_ns"] == pytest.approx(f)
    assert fit["ell_vrow_ns_per_h"] == pytest.approx(p)
    d2, h2 = fit["check_point"]
    assert fit["check_ns"] == pytest.approx(times[(d2, h2)])


def test_one_card_plan_matches_reference():
    assert tdist.enumerate_dist(1) == [tdist.DistPlan()]
    for plan in (tdist.DistPlan(), tdist.DistPlan("2d", 2, 4, True),
                 tdist.DistPlan("halo", 4, 1, "ring", order="metis")):
        from pygim_tpu.tune.dist import DistPlan as JPlan

        assert plan.describe() == JPlan(**dataclasses.asdict(plan)).describe()


def test_autotune_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ttune.autotune(graph_pair("rmat")[1], 16, model=reference_model())


def test_prepare_tuned_is_prepare_spmm():
    jg, tg = graph_pair("rmat", merged=False)
    res = ttune.autotune(tg, 16, model=reference_model(), use_cache=False,
                         device="cpu")
    prep = ttune.prepare_tuned(tg, res, device="cpu")
    assert prep.config == res.config
    x = np.random.default_rng(1).standard_normal((tg.ncols, 16))
    want = np.asarray(jspmm.prepare_spmm(jg, jspmm.SpmmConfig(
        **dataclasses.asdict(res.config))).mul(x.astype(np.float32)))
    got = prep.mul(torch.as_tensor(x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("kind", ["spmm", "inference"])
def test_experiment_tune_records_the_references_pick(kind, tmp_path,
                                                     monkeypatch):
    """``Experiment(tune=True)`` with the reference's constants as the
    port's default model writes the reference's ``tuned_*`` lines."""
    from pygim_tpu.bench.experiment import Experiment as JExp
    from pygim_tpu_torch.bench.experiment import Experiment as TExp
    from pygim_tpu_torch.utils.metrics import parse_data_lines

    monkeypatch.setattr(tcost.CardCostModel, "default",
                        classmethod(lambda cls: reference_model()))
    fields = dict(dataset="tiny", kind=kind, tune=True, repeat=1, hidden=16)
    want = JExp(**fields)
    want.run(tmp_path / "ref", data_root=str(tmp_path / "refdata"))
    got = TExp(**fields)
    got.run(tmp_path / "port", device="cpu")
    keys = ("tuned_backend", "tuned_balance", "tuned_block_nnz_budget")

    def tuned(d, exp):
        rec = parse_data_lines((d / f"{exp.frozen_name()}.out").read_text()
                               .splitlines())
        return {k: rec[k] for k in keys}

    assert tuned(tmp_path / "port", got) == tuned(tmp_path / "ref", want)
    assert got.frozen_name() == want.frozen_name()


def adapters(mod, device_kw):
    return {
        "spmm": lambda g: mod.prepare_pim_spmm(g, 16, **device_kw),
        "spmm-coo-blocked": lambda g: mod.prepare_pim_spmm(
            g, 16, sp_format="coo", backend="blocked", **device_kw),
        "grande": lambda g: mod.prepare_pim_spmm_grande(g, 16, **device_kw),
        "spmv": lambda g: mod.prepare_pim_spmv(g, 16, **device_kw),
        "config": lambda g: mod.prepare_pim_spmm(
            g, 16, config=mod.SpmmConfig(backend="hybrid",
                                                 hybrid_dtype="int8",
                                                 hybrid_core_bytes=1 << 16),
            **device_kw),
    }


@pytest.mark.parametrize("name", ["spmm", "spmm-coo-blocked", "grande",
                                  "spmv", "config"])
def test_compat_adapters_match_reference(name):
    """Each adapter prepares the reference's config (where the reference
    lays a mesh over its virtual devices, the port runs that config on one
    card) and multiplies as the reference does."""
    jg, tg = graph_pair("rmat", merged=False)
    want = adapters(jcompat, {})[name](jg)
    got = adapters(tcompat, {"device": "cpu"})[name](tg)
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    x = np.random.default_rng(2).standard_normal((tg.ncols, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        got.mul(torch.as_tensor(x)).numpy(), np.asarray(want.mul(x)),
        rtol=1e-2 if name == "config" else 1e-5, atol=1e-3)
    assert tcompat.describe_layout(got) == "single-chip"


def test_compat_shims_and_mesh_refusal(monkeypatch):
    """The ``dpu_*`` shims answer as the reference's (a list a rank of the
    visible devices, nothing to release); a mesh that fits several
    visible devices is the reference's 2D mesh (until it was ported the
    port refused it): ``spmm`` (2, 1), ``grande`` (1, 2), ``spmv`` (1, 4)
    over four copies of the CPU, each product equal to the single-card
    operand's within 1e-5."""
    jg, tg = graph_pair("rmat", merged=False)
    assert tcompat.describe_layout(tspmm.prepare_spmm(
        tg, tspmm.SpmmConfig(backend="ell"), device="cpu")) == \
        jcompat.describe_layout(jspmm.prepare_spmm(
            jg, jspmm.SpmmConfig(backend="ell")))
    assert tcompat.dpu_init_ranks(3, device="cpu") == [1, 1, 1]
    assert len(jcompat.dpu_init_ranks(3)) == 3
    assert tcompat.dpu_init_dpus(device="cpu") == [1]
    assert tcompat.dpu_release() is None and jcompat.dpu_release() is None
    monkeypatch.setattr(tcompat, "visible_devices", lambda device: 4)
    assert tcompat.dpu_init_ranks(2, device="cpu") == [4, 4]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (tg.ncols, 16)).astype(np.float32))
    single = tspmm.prepare_spmm(tg, tspmm.SpmmConfig(backend="ell"),
                                device="cpu").mul(x).numpy()
    for call, layout in (
            (lambda: tcompat.prepare_pim_spmm(tg, 16, sp_parts=2,
                                              device="cpu"), "sp=2 ds=1"),
            (lambda: tcompat.prepare_pim_spmm_grande(tg, 16, device="cpu"),
             "sp=1 ds=2"),
            (lambda: tcompat.prepare_pim_spmv(tg, 16, device="cpu"),
             "sp=1 ds=4")):
        got = call()
        assert tcompat.describe_layout(got) == f"mesh {layout}"
        np.testing.assert_allclose(got.mul(x).numpy(), single, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("hidden", [None, 64, 256])
def test_ell_issue_seconds_matches_reference(hidden):
    assert tpart.ell_issue_seconds(123_456, 7_890, hidden) == \
        jpart.ell_issue_seconds(123_456, 7_890, hidden)
    got = tpart.ell_issue_seconds(1000, 10, hidden, slot_ns=0.5,
                                  vrow_fixed_ns=3.0, vrow_ns_per_h=0.25)
    h = 256 if hidden is None else hidden
    assert got == pytest.approx((1000 * 0.5 + 10 * (3.0 + h * 0.25)) * 1e-9)


@pytest.mark.parametrize("budget", [1 << 16, 1 << 20])
def test_staircase_coverage_matches_reference(budget):
    """On the prepare tests' graphs, the bands of ``plan_staircase`` and
    their exact coverage, both packages; a row past the last band is not
    covered."""
    from test_torch_prepare import GRAPHS as PREP_GRAPHS
    from test_torch_prepare import N, make_graph

    for kind in PREP_GRAPHS:
        rows, cols, _vals = make_graph(kind)
        deg = np.bincount(rows, minlength=N) + np.bincount(cols, minlength=N)
        rank = np.empty(N, np.int64)
        rank[np.argsort(-deg, kind="stable")] = np.arange(N)
        rr, rc = rank[rows], rank[cols]
        bands = tstair.plan_staircase(rr, rc, N, budget)
        assert bands == jstair.plan_staircase(rr, rc, N, budget)
        got = tstair.staircase_coverage(bands, rr, rc)
        assert got == jstair.staircase_coverage(bands, rr, rc)
        assert 0 < got <= rows.size
    assert tstair.staircase_coverage([], rr, rc) == 0
    assert tstair.staircase_coverage([(0, 8, 8)], np.array([8, 3]),
                                     np.array([0, 3])) == 1


def test_cache_file_is_json_with_the_provenance(tmp_path):
    _, tg = graph_pair("rmat", merged=False)
    ttune.autotune(tg, 16, model=reference_model(), device="cpu")
    (path,) = (tmp_path / "tune").glob("tune-*.json")
    d = json.loads(path.read_text())
    assert d["constants"] == reference_model().provenance
    assert d["plan"] == dataclasses.asdict(tdist.DistPlan())
