"""The port's harness against the JAX package's: ``Experiment``'s fields
and frozen names, the named configurations, the ledger (skip, retry,
failure records, dry run, cluster parts) on the CPU, ``results_to_csv``'s
rows on the same records, the refusal of the TPU's records, the settings
not ported yet, and ``sweep_cuda.py`` (run, parse, migrate)."""

import csv
import dataclasses
import shutil
from pathlib import Path

import pytest

import sweep_cuda
from pygim_tpu.bench import configs as jconfigs
from pygim_tpu.bench import experiment as jexperiment
from pygim_tpu.bench import parse_results as jparse
from pygim_tpu.bench import results_to_csv as jresults_to_csv
from pygim_tpu_torch.bench import Experiment, results_to_csv, run_experiments
from pygim_tpu_torch.bench import configs as tconfigs
from pygim_tpu_torch.bench import parse_results as tparse
from pygim_tpu_torch.utils.metrics import parse_data_lines

ROOT = Path(__file__).resolve().parent.parent
JExperiment = jexperiment.Experiment


def twin(jexp):
    """The port's Experiment with the fields of a reference one."""
    return Experiment(**dataclasses.asdict(jexp))


HAND_MADE = [
    dict(dataset="tiny"),
    dict(dataset="tiny", kind="inference", dtype="int32", hidden=16,
         repeat=1),
    dict(dataset="reddit-uniq", backend="hybrid", hybrid_shape="stair",
         hybrid_dtype="int8", hybrid_core_bytes=12 << 30, phases=True),
    dict(dataset="ogbn-products", kind="training", model="sage", lr=0.003,
         epochs=7, parity=False, oracle_chunk=1 << 20, part_size=400_000,
         part_method="rcm", data_tag="realfmt"),
    dict(dataset="brmat-4096-40000-256", backend="ell", ell_degree=16,
         ell_tables=1, block_nnz_budget=1 << 15, balance="row",
         bcsr_bytes=1 << 20, bcsr_order="lp", bcsr_layout="panel"),
    dict(dataset="x.mtx", sp_parts=2, ds_parts=4, cluster="metis",
         device_counts="1,8", scale_model=True, tune=True),
]


def test_fields_match_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(Experiment)]
    want = [(f.name, f.default) for f in dataclasses.fields(JExperiment)]
    assert got == want


@pytest.mark.parametrize("i", range(len(jconfigs.BASELINE_EXPERIMENTS)))
def test_baseline_entries_match_jax(i):
    jexp = jconfigs.BASELINE_EXPERIMENTS[i]
    texp = tconfigs.BASELINE_EXPERIMENTS[i]
    assert dataclasses.asdict(texp) == dataclasses.asdict(jexp)
    assert texp.frozen_name() == jexp.frozen_name()
    assert tparse._params_from_name(texp.frozen_name()) == \
        jparse._params_from_name(jexp.frozen_name())
    # the prepare configuration: every field the reference sets
    tcfg = dataclasses.asdict(texp.spmm_config())
    for k, v in dataclasses.asdict(jexp.spmm_config()).items():
        assert tcfg[k] == v, k


def test_named_sets_match_jax():
    assert len(tconfigs.BASELINE_EXPERIMENTS) == \
        len(jconfigs.BASELINE_EXPERIMENTS) == 16
    assert tconfigs.DATASETS == jconfigs.DATASETS
    assert tconfigs.NR_BLOCK_BUDGETS == jconfigs.NR_BLOCK_BUDGETS


@pytest.mark.parametrize("name", sorted(jconfigs.DATASETS))
def test_sweep_space_matches_jax(name):
    got, want = tconfigs.sweep_space(name), jconfigs.sweep_space(name)
    assert list(got) == list(want) and got.fields == want.fields
    for pt in want:
        assert Experiment(repeat=1, **pt).frozen_name() == \
            JExperiment(repeat=1, **pt).frozen_name()


@pytest.mark.parametrize("i", range(len(HAND_MADE)))
def test_hand_made_frozen_names_match_jax(i):
    jexp = JExperiment(**HAND_MADE[i])
    assert Experiment(**HAND_MADE[i]).frozen_name() == jexp.frozen_name()
    assert twin(jexp) == Experiment(**HAND_MADE[i])
    stem = jexp.frozen_name()
    assert tparse._params_from_name(stem) == jparse._params_from_name(stem)


LEGACY = (
    "backend-ell_balance-nnz_block_nnz_budget-131072_dataset-pubmed_"
    "ds_parts-1_dtype-int32_hidden-256_kind-inference_model-gcn_"
    "num_layers-2_repeat-2_sp_format-csr_sp_parts-1_tune-False"
)


def test_status_at_probes_legacy_stems(tmp_path):
    """``tests/test_bench.py``'s legacy-stem probe on the port: a stem
    written with every then-existing field is found as done, a near miss
    and a point with a newer non-default field stay todo, and a legacy
    ``.failed`` shows as failed."""
    results = tmp_path / "results"
    results.mkdir()
    (results / f"{LEGACY}.out").write_text(
        "[DATA]device: cpu\n[DATA]infer_time(ms): 1.0\n")
    e = Experiment(dataset="pubmed", kind="inference", backend="ell",
                   dtype="int32", block_nnz_budget=131072, repeat=2)
    assert e.frozen_name() != LEGACY
    assert e.status_at(results) == "done"
    assert dataclasses.replace(e, dtype="int8").status_at(results) == "todo"
    assert dataclasses.replace(e, bcsr_bytes=1 << 20).status_at(results) \
        == "todo"
    (results / f"{LEGACY}.out").rename(results / f"{LEGACY}.failed")
    assert e.status_at(results) == "failed"


@pytest.mark.parametrize("stem", [
    LEGACY, LEGACY.replace("int32", "int8"), LEGACY + "_extra-1",
    LEGACY.replace("_tune-False", ""),
    "backend-blocked_dataset-tiny_kind-spmm",
    "dataset-tiny",
])
@pytest.mark.parametrize("fields", [
    dict(dataset="pubmed", kind="inference", backend="ell", dtype="int32",
         block_nnz_budget=131072, repeat=2),
    dict(dataset="tiny"), dict(dataset="pubmed", kind="inference",
                               backend="ell", dtype="int32", repeat=2),
])
def test_matches_legacy_stem_matches_jax(stem, fields):
    assert Experiment(**fields).matches_legacy_stem(stem) == \
        JExperiment(**fields).matches_legacy_stem(stem)


def test_ledger_and_sweep(tmp_path):
    results = tmp_path / "results"
    exps = [
        Experiment(dataset="tiny", hidden=16, repeat=1),
        Experiment(dataset="tiny", kind="inference", hidden=16, repeat=1,
                   dtype="int32"),
    ]
    out = run_experiments(exps, results, data_root=str(tmp_path / "data"),
                          device="cpu")
    assert len(out) == 2
    for e in exps:
        assert e.status_at(results) == "done"
        text = (results / f"{e.frozen_name()}.out").read_text()
        assert text.count("[DATA]device: cpu") == 1
    # a rerun skips, and still returns the recorded means
    out2 = run_experiments(exps, results, data_root=str(tmp_path / "data"),
                           device="cpu")
    assert out2 == out
    text = results_to_csv(results).read_text()
    assert "pim_time_spmm(ms)" in text and "infer_time(ms)" in text
    assert "dataset" in text


def test_failure_ledger(tmp_path):
    results = tmp_path / "results"
    bad = Experiment(dataset="definitely-not-a-dataset", repeat=1)
    assert run_experiments([bad], results, device="cpu") == {}
    assert bad.status_at(results) == "failed"
    failed = (results / f"{bad.frozen_name()}.failed").read_text()
    assert "KeyError" in failed and "[DATA]device: cpu" in failed
    # a failed point is skipped unless a retry is asked for
    assert run_experiments([bad], results, device="cpu") == {}
    assert run_experiments([bad], results, retry_failed=True,
                           device="cpu") == {}


@pytest.mark.parametrize("method", ["none", "rcm", "lp"])
def test_cluster_part(method, tmp_path):
    exp = Experiment(dataset="tiny", kind="inference", hidden=16, repeat=1,
                     part_size=400, part_idx=1, part_method=method)
    means = run_experiments([exp], tmp_path / "results",
                            data_root=str(tmp_path / "data"),
                            device="cpu")[exp.frozen_name()]
    assert 0 < means["part_nodes"] <= 400
    assert means["part_edges"] > 0 and "infer_time(ms)" in means
    assert "part_size-400" in exp.frozen_name()


def test_dry_run(tmp_path):
    exps = [Experiment(dataset="tiny", repeat=1)]
    assert run_experiments(exps, tmp_path / "r", dry_run=True,
                           device="cuda") == {}
    assert exps[0].status_at(tmp_path / "r") == "todo"
    assert not (tmp_path / "r").exists()


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.parametrize("recorded, sweep", [("cpu", "cuda"), (CARD, "cpu"),
                                             ("NVIDIA H100 80GB HBM3, "
                                              "500.00 W", "cuda")])
def test_other_device_records_refused(recorded, sweep, tmp_path,
                                      monkeypatch):
    """A sweep refuses a directory holding a record of another device (the
    CPU's in a card sweep, the card's in a CPU sweep, the same card at
    another power limit) rather than skip its point as done; a record of
    its own device is skipped."""
    import torch

    from pygim_tpu_torch.bench import experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(experiment, "device_line",
                        lambda dev: CARD if dev.type == "cuda" else dev.type)
    exp = Experiment(dataset="tiny", repeat=1)
    results = tmp_path / "r"
    results.mkdir()
    rec = results / f"{exp.frozen_name()}.out"
    rec.write_text(f"# x\n[DATA]device: {recorded}\n"
                   "[DATA]pim_time_spmm(ms): 5.0\n")
    for dry_run in (True, False):
        with pytest.raises(ValueError, match="not of this sweep's device"):
            run_experiments([exp], results, dry_run=dry_run, device=sweep)
    assert exp.status_at(results) == "done"
    assert not list(results.glob("*.json"))
    own = CARD if sweep == "cuda" else "cpu"
    rec.write_text(f"# x\n[DATA]device: {own}\n")
    assert run_experiments([exp], results, device=sweep) == {}


def test_records_carry_load_and_memory(tmp_path):
    """A record holds the dataset's load time and edges, the merged edges
    of a hybrid operand, and the process's peak host memory in bytes."""
    import resource

    exp = Experiment(dataset="tiny", hidden=16, backend="hybrid",
                     hybrid_dtype="int8", hybrid_shape="stair",
                     hybrid_core_bytes=1 << 18, repeat=1)
    means = exp.run(tmp_path / "r", data_root=str(tmp_path / "data"),
                    device="cpu")
    assert means["load_dataset_time(ms)"] > 0
    assert 0 < means["merged_edges"] <= means["stored_edges"]
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    assert 0 < means["peak_host_rss_bytes"] <= peak
    assert "peak_card_bytes" not in means and means["device"] == "cpu"


def test_no_card_refused(tmp_path, monkeypatch):
    """The card by default, and no fall-back to the CPU without one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_experiments([Experiment(dataset="tiny")], tmp_path / "r")
    assert not (tmp_path / "r").exists()


def test_records_carry_the_operand(tmp_path):
    """A hybrid record holds the core's bands and coverage and the tail's
    edges; an inference record with ``validate`` its verdict."""
    results = tmp_path / "r"
    spmm = Experiment(dataset="tiny", hidden=32, backend="hybrid",
                      hybrid_dtype="int8", hybrid_shape="stair",
                      hybrid_core_bytes=1 << 18, phases=True, repeat=1)
    gcn = Experiment(dataset="tiny", kind="inference", dtype="int32",
                     hidden=16, backend="hybrid", hybrid_dtype="int8",
                     hybrid_shape="stair", hybrid_core_bytes=1 << 18,
                     validate=True, repeat=1)
    out = run_experiments([spmm, gcn], results, device="cpu",
                          data_root=str(tmp_path / "data"))
    for exp, check in ((spmm, "[DATA]verify: OK"),
                       (gcn, "[DATA]validate: OK")):
        rec = parse_data_lines(
            (results / f"{exp.frozen_name()}.out").read_text().splitlines())
        assert check in (results / f"{exp.frozen_name()}.out").read_text()
        assert rec["device"] == ["cpu"] and rec["core_dtype"] == ["int8"]
        assert 0 < rec["core_coverage"][0] <= 1 and rec["tail_edges"][0] >= 0
        assert rec["core_bands"][0].startswith("[[0, ")
    assert "core_time(ms)" in out[spmm.frozen_name()]
    assert any(k.startswith("agg") for k in out[gcn.frozen_name()])


def test_training_kind(tmp_path):
    exp = Experiment(dataset="tiny", kind="training", backend="ell",
                     hidden=16, epochs=2)
    means = exp.run(tmp_path, data_root=str(tmp_path / "data"), device="cpu")
    assert means["train_time(ms)"] > 0 and "acc_delta" in means
    assert exp.status_at(tmp_path) == "done"


@pytest.mark.parametrize("fields,item", [
    (dict(tune=True), None),
    (dict(kind="scaling", backend="ell"), "Queue 1 item 6"),
    (dict(sp_parts=2, kind="training"), "Queue 1 item 6"),
    (dict(ds_parts=2, kind="training"), "Queue 1 item 6"),
    (dict(backend="coo"), None),
    (dict(part_size=400, part_method="metis"), "Queue 1 item 6"),
])
def test_not_ported_settings_raise(fields, item, tmp_path, monkeypatch):
    """Each setting once refused until its slice now runs to a record:
    the ``coo`` backend and ``tune=True`` (item None), whose record holds
    the tuner's pick (``tuned_backend``, ``tuned_balance``,
    ``tuned_block_nnz_budget``), and those of ROADMAP.md Queue 1 items
    6b and 6c (``item``): ``kind="scaling"`` (on the CPU one device, so
    ``edges_per_s_n1``), training over a 2D mesh (its parity with the
    oracle and ``validate: OK``) and ``part_method="metis"`` (the SpMM of
    one part of the k-way partition, verified). A sweep takes their
    records like any other point's."""
    monkeypatch.setenv("PYGIM_TPU_TORCH_TUNE_CACHE", str(tmp_path / "tune"))
    exp = Experiment(dataset="tiny", repeat=1, **fields)
    if exp.kind == "training":
        exp = dataclasses.replace(exp, hidden=16, epochs=3)
    means = exp.run(tmp_path / "a", data_root=str(tmp_path / "data"),
                    device="cpu")
    assert exp.status_at(tmp_path / "a") == "done"
    rec = (tmp_path / "a" / f"{exp.frozen_name()}.out").read_text()
    if exp.kind == "scaling":
        assert means["edges_per_s_n1"] > 0 and "[DATA]virtual_mesh: " in rec
    elif exp.kind == "training":
        assert "[DATA]validate: OK" in rec and "acc_delta" in means
        n = exp.sp_parts * exp.ds_parts
        assert f"[DATA]layout: mesh sp={exp.sp_parts} ds={exp.ds_parts}" \
            in rec and n == 2
    else:
        assert means["pim_time_spmm(ms)"] > 0
        assert "[DATA]verify: OK" in rec
    if exp.part_method == "metis":
        assert 0 < means["part_nodes"] <= 400 * 1.1
    if exp.tune:
        for k in ("tuned_backend", "tuned_balance",
                  "tuned_block_nnz_budget"):
            assert rec.count(f"[DATA]{k}: ") == 1, k
    # the sweep skips it as done, with its recorded means
    ok = Experiment(dataset="tiny", hidden=8, repeat=1)
    out = run_experiments([exp, ok], tmp_path / "a", device="cpu",
                          data_root=str(tmp_path / "data"))
    assert list(out) == [exp.frozen_name(), ok.frozen_name()]
    assert out[exp.frozen_name()] == means


def test_results_to_csv_matches_jax(tmp_path):
    """The same records give the reference's rows: the port's own, and
    hand-written ones with the derived dense time and a stem that is no
    frozen name."""
    results = tmp_path / "r"
    exps = [Experiment(dataset="tiny", hidden=8, repeat=2),
            Experiment(dataset="tiny", backend="ell", balance="row",
                       hidden=8, repeat=1)]
    run_experiments(exps, results, device="cpu",
                    data_root=str(tmp_path / "data"))
    (results / "dataset-x_custom-3.out").write_text(
        "# x\n[DATA]device: cpu\n[DATA]pim_time_spmm(ms): 5.0\n"
        "[DATA]pim_time_spmm(ms): 7.0\n[DATA]load_sparse_time(ms): 1.5\n"
        "[DATA]verify: OK\n")
    (results / "plain_token-7_other.out").write_text(
        "[DATA]device: NVIDIA H100 80GB HBM3, 700.00 W\n[DATA]a: 1\n")
    got = results_to_csv(results, tmp_path / "port.csv")
    want = jresults_to_csv(results, tmp_path / "jax.csv")
    assert got.read_text() == want.read_text()
    rows = list(csv.DictReader(got.open()))
    assert len(rows) == 4
    custom = [r for r in rows if r["dataset"] == "x_custom-3"][0]
    assert float(custom["pim_time_dense(ms)"]) == 4.5
    # an empty directory gives an empty file
    (tmp_path / "empty").mkdir()
    assert results_to_csv(tmp_path / "empty").read_text() == ""


def tpu_record(dst: Path) -> Path:
    """A copy of one of the TPU's records from ``results/``."""
    src = sorted((ROOT / "results").glob("*.out"))[0]
    dst.mkdir(parents=True, exist_ok=True)
    return Path(shutil.copy(src, dst))


def test_tpu_records_refused(tmp_path):
    rec = tpu_record(tmp_path / "r")
    exps = [Experiment(dataset="tiny", repeat=1)]
    for call in (lambda: run_experiments(exps, tmp_path / "r", device="cpu"),
                 lambda: run_experiments(exps, tmp_path / "r", dry_run=True),
                 lambda: results_to_csv(tmp_path / "r")):
        with pytest.raises(ValueError, match=rec.name[:40]):
            call()
    assert not list((tmp_path / "r").glob("*.json"))
    with pytest.raises(ValueError):
        sweep_cuda.main(["parse", "--results", str(tmp_path / "r")])
    with pytest.raises(ValueError):
        sweep_cuda.main(["run", "--dry_run", "--results",
                         str(tmp_path / "r")], device="cpu")


def test_sweep_cuda_run_parse_migrate(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    sweep_cuda.main(["run", "--set", "small", "--dry_run"])
    sweep_cuda.main(["run", "--baseline", "--dry_run"])
    assert not (tmp_path / "results_cuda").exists()  # dry runs write nothing
    (tmp_path / "results_cuda").mkdir()
    sweep_cuda.main(["parse"])
    assert capsys.readouterr().out.strip().endswith(
        str(Path("results_cuda") / "average_all.csv"))
    with pytest.raises(SystemExit):
        sweep_cuda.main(["parse", "--results", str(tmp_path / "missing")])
    # a real run of the small set on the CPU, then its CSV
    sweep_cuda.main(["run", "--set", "small", "--repeat", "1", "--results",
                     "r"], device="cpu")
    outs = sorted(p.name for p in (tmp_path / "r").glob("*.out"))
    assert len(outs) == 8
    sweep_cuda.main(["parse", "--results", "r", "--out", "all.csv"])
    assert len(list(csv.DictReader((tmp_path / "all.csv").open()))) == 8
    sweep_cuda.main(["migrate", "--results", "r", "--rename",
                     "repeat-1=repeat-one"])
    assert len(list((tmp_path / "r").glob("*repeat-one*.out"))) == 8
    assert not list((tmp_path / "r").glob("*repeat-1*"))
