"""The scaling benchmark of the port against the reference's
(``pygim_tpu/bench/scaling.py``): ``run_scaling_benchmark`` in its raw
SpMM form and its ``model=`` form, on ``["cpu"] * 8`` beside the
reference's 8-device virtual CPU mesh, gives the reference's keys and
the same halo request and buffer rows; ``Experiment(kind="scaling")``
writes its record on the CPU; tracked config 5's four entries run (on
the ``tiny`` stand-in, over two virtual devices)."""

import dataclasses

import numpy as np
import pytest

from pygim_tpu.bench.scaling import run_scaling_benchmark as jrun_scaling
from pygim_tpu.data import GraphDataset as JDataset
from pygim_tpu.utils.metrics import DataReporter as JReporter
from pygim_tpu_torch.bench import Experiment
from pygim_tpu_torch.bench.configs import BASELINE_EXPERIMENTS
from pygim_tpu_torch.bench.scaling import run_scaling_benchmark
from pygim_tpu_torch.data import GraphDataset
from pygim_tpu_torch.ops.spmm import SpmmConfig
from pygim_tpu_torch.utils.metrics import DataReporter

from test_torch_mesh import graphs, random_edges

CPUS = ["cpu"] * 8
ROWS = ("halo_request_rows", "halo_buffer_rows")


def datasets(n=96, nnz=700, seed=40):
    """The same small dataset in both packages."""
    jg, tg = graphs(random_edges(n, n, nnz, seed=seed))
    rng = np.random.default_rng(seed + 1)
    common = dict(x=rng.standard_normal((n, 4)).astype(np.float32),
                  y=np.zeros(n, np.int64), train_mask=np.zeros(n, bool),
                  test_mask=np.zeros(n, bool), num_classes=2, synthetic=True)
    return (JDataset(name="t", graph=jg, **common),
            GraphDataset(name="t", graph=tg, **common))


def same_keys_and_rows(got, want, counts):
    assert set(got) == set(want)
    assert got["virtual_mesh"] == want["virtual_mesh"]
    for n in counts:
        assert got[f"edges_per_s_n{n}"] > 0
        if n > 1:
            for r in ROWS:
                assert got[f"{r}_n{n}"] == want[f"{r}_n{n}"], (r, n)


@pytest.mark.parametrize("exchange,order,kw", [
    ("all_to_all", None, {}),
    ("ring", "metis", {}),
    ("all_gather", None, dict(backend="hybrid", hybrid_k=16)),
])
def test_raw_form_matches_reference(exchange, order, kw, monkeypatch):
    from pygim_tpu_torch.core import native as tnative
    from test_torch_prepare import reference_planner

    if not reference_planner():  # both take the fallback partition
        monkeypatch.setenv(tnative.NO_NATIVE_ENV, "1")
    jds, tds = datasets()
    counts = [1, 4]
    want = jrun_scaling(jds, counts, hidden=8, exchange=exchange, repeat=1,
                        reporter=JReporter(echo=False), order=order,
                        config=None if not kw else _jconfig(kw))
    got = run_scaling_benchmark(tds, counts, hidden=8, exchange=exchange,
                                repeat=1, reporter=DataReporter(echo=False),
                                order=order, devices=CPUS,
                                config=SpmmConfig(**kw) if kw else None)
    same_keys_and_rows(got, want, counts)
    assert got["virtual_mesh"]


def _jconfig(kw):
    from pygim_tpu.ops.spmm import SpmmConfig as JConfig

    return JConfig(**kw)


def test_model_form_matches_reference():
    """``model="gcn"`` with int32 aggregation times the whole forward."""
    jds, tds = datasets()
    counts = [1, 4]
    want = jrun_scaling(jds, counts, hidden=8, exchange="ring", repeat=1,
                        reporter=JReporter(echo=False), model="gcn",
                        agg_dtype="int32")
    got = run_scaling_benchmark(tds, counts, hidden=8, exchange="ring",
                                repeat=1, reporter=DataReporter(echo=False),
                                model="gcn", agg_dtype="int32", devices=CPUS)
    same_keys_and_rows(got, want, counts)
    assert got["scaling_efficiency_n4"] > 0


def test_default_counts_and_devices():
    """Counts default to the powers of two the devices hold; no device
    raises."""
    _jds, tds = datasets()
    got = run_scaling_benchmark(tds, hidden=4, repeat=1,
                                reporter=DataReporter(echo=False),
                                devices=CPUS)
    assert {k for k in got if k.startswith("edges_per_s")} == {
        f"edges_per_s_n{n}" for n in (1, 2, 4, 8)}
    with pytest.raises(ValueError, match="no device"):
        run_scaling_benchmark(tds, devices=[])


def test_experiment_scaling_record(tmp_path):
    exp = Experiment(dataset="tiny", kind="scaling", backend="ell",
                     hidden=16, device_counts="1,4", repeat=1)
    means = exp.run(tmp_path / "r", data_root=str(tmp_path / "data"),
                    device="cpu")
    assert exp.status_at(tmp_path / "r") == "done"
    rec = (tmp_path / "r" / f"{exp.frozen_name()}.out").read_text()
    for key in ("virtual_mesh", "edges_per_s_n1", "edges_per_s_n4",
                "scaling_efficiency_n4", "halo_request_rows_n4",
                "halo_buffer_rows_n4"):
        assert f"[DATA]{key}: " in rec, key
    assert "[DATA]device: cpu" in rec and means["edges_per_s_n4"] > 0


CONFIG5 = [e for e in BASELINE_EXPERIMENTS if e.kind == "scaling"]


@pytest.mark.parametrize("i", range(4))
def test_tracked_config5_runs(i, tmp_path):
    """Each of tracked config 5's four entries (``bench/configs.py``) runs
    through ``Experiment`` on the ``tiny`` stand-in over two virtual
    devices, its hub core cut to the stand-in."""
    assert len(CONFIG5) == 4
    exp = dataclasses.replace(CONFIG5[i], dataset="tiny", hidden=16,
                              device_counts="1,2", repeat=1)
    if exp.backend == "hybrid":
        exp = dataclasses.replace(exp, hybrid_core_bytes=64 << 10)
    means = exp.run(tmp_path / "r", data_root=str(tmp_path / "data"),
                    device="cpu")
    assert means["edges_per_s_n2"] > 0
    assert means["halo_buffer_rows_n2"] > 0
