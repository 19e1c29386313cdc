"""The port's entry scripts on the CPU: ``spmm_test_cuda`` and
``inference_cuda`` against the reference CLIs (flags, defaults, choices
and ``[DATA]`` keys), the single-card ``--version`` routing, and
``bench_cuda``'s candidate loop and JSON line (``device="cpu"``, which
only tests pass)."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_cuda  # noqa: E402
import inference  # noqa: E402
import inference_cuda  # noqa: E402
import spmm_test  # noqa: E402
import spmm_test_cuda  # noqa: E402
from pygim_tpu_torch import compat  # noqa: E402
from pygim_tpu_torch.utils import device as tdevice  # noqa: E402
from pygim_tpu_torch.utils.metrics import parse_data_lines  # noqa: E402


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PYGIM_TPU_TORCH_DATA", str(tmp_path / "port"))


def run(capsys, main, argv, **kw):
    capsys.readouterr()
    main(argv, **kw)
    out = capsys.readouterr().out
    return out, parse_data_lines(out.splitlines())


SPMM_ARGV = [["--repeat", "1"],
             ["--repeat", "1", "--data_type", "float32", "--sp_format", "csr"],
             ["--repeat", "1", "--version", "cpu"],
             ["--repeat", "1", "--version", "grande", "--data_type", "INT8"]]


@pytest.mark.parametrize("argv", SPMM_ARGV, ids=["defaults", "float32",
                                                  "cpu", "grande-int8"])
def test_spmm_test_cuda_matches_reference_keys(capsys, tmp_path, argv):
    argv = ["--dataset", "tiny", *argv]
    out, got = run(capsys, spmm_test_cuda.main, argv, device="cpu")
    _ref_out, want = run(capsys, spmm_test.main,
                         [*argv, "--data_root", str(tmp_path / "ref")])
    assert got["verify"] == ["OK"]
    assert got.pop("device") == ["cpu"] and "device" not in want
    assert set(got) == set(want)
    assert got["layout"] == want["layout"] == ["single-chip"]
    assert "ref_time(ms)" in got  # nnz · H <= 2^27: the oracle is timed


@pytest.mark.parametrize("argv", [[], ["--data_type", "float32"],
                                  ["--version", "cpu"],
                                  ["--data_type", "int8", "--version", "spmm"]],
                         ids=["defaults", "float32", "cpu", "spmm-int8"])
def test_inference_cuda_matches_reference_keys(capsys, tmp_path, argv):
    argv = ["--dataset", "tiny", *argv]
    out, got = run(capsys, inference_cuda.main, argv, device="cpu")
    _ref_out, want = run(capsys, inference.main,
                         [*argv, "--data_root", str(tmp_path / "ref")])
    assert got.pop("device") == ["cpu"]
    assert set(got) == set(want)
    assert 0.0 <= got["test_acc"][0] <= 1.0
    assert got["infer_time(ms)"][0] > 0


def test_mesh_request_warns_single_chip(capsys):
    out, got = run(capsys, spmm_test_cuda.main,
                   ["--dataset", "tiny", "--repeat", "1", "--sp_parts", "2",
                    "--ds_parts", "2"], device="cpu")
    assert "[WARN] sp×ds=4 exceeds 1 devices; running single-chip" in out
    assert got["verify"] == ["OK"]
    out, _ = run(capsys, inference_cuda.main, ["--dataset", "tiny"],
                 device="cpu")  # defaults: sp 2 × ds 16
    assert "[WARN] sp×ds=32 exceeds 1 devices; running single-chip" in out


def test_float64_runs_as_float32(capsys):
    out, got = run(capsys, spmm_test_cuda.main,
                   ["--dataset", "tiny", "--repeat", "1", "--data_type",
                    "DBL64"], device="cpu")
    assert "data_type='float64'" in out and got["verify"] == ["OK"]


@pytest.mark.parametrize("main,argv,what", [
    (spmm_test_cuda.main, ["--tune"], "--tune"),
    (inference_cuda.main, ["--tune"], "--tune"),
    (inference_cuda.main, ["--model", "gin"], "--model gin"),
    (inference_cuda.main, ["--model", "sage"], "--model sage"),
    (spmm_test_cuda.main, ["--data_type", "bfloat16"], "bfloat16"),
    (inference_cuda.main, ["--data_type", "int64"], "int64"),
], ids=["spmm-tune", "infer-tune", "gin", "sage", "bf16", "int64"])
def test_unported_flags_raise(main, argv, what):
    with pytest.raises(NotImplementedError, match="not ported") as e:
        main(["--dataset", "tiny", *argv], device="cpu")
    assert what in str(e.value)


def parser_of(get_args):
    """The argument parser a ``get_args`` builds (its ``parse_args``
    returns the parser itself)."""
    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = lambda self, argv=None: self
    try:
        return get_args([])
    finally:
        argparse.ArgumentParser.parse_args = orig


def flags(get_args):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     getattr(a.type, "__name__", a.type), a.nargs)
            for a in parser_of(get_args)._actions if a.dest != "help"}


@pytest.mark.parametrize("port,ref", [
    (spmm_test_cuda.get_args, spmm_test.get_args),
    (inference_cuda.get_args, inference.get_args),
], ids=["spmm_test", "inference"])
def test_get_args_match_reference(port, ref):
    assert flags(port) == flags(ref)
    assert vars(port([])) == vars(ref([]))
    for tok, want in (("INT8", "int8"), ("FLT32", "float32"),
                      ("DBL64", "float64"), ("int16", "int16")):
        assert port(["--data_type", tok]).data_type == want \
            == ref(["--data_type", tok]).data_type


@pytest.mark.parametrize("version,sp,ds,n_dev,size", [
    ("spmm", 2, 2, 1, 4), ("spmm", 2, 2, 4, 4), ("grande", 2, 16, 8, 32),
    ("spmv", 1, 1, 1, 1), ("spmv", 2, 1, 8, 8), ("spmv", 1, 1, 4, 4),
])
def test_mesh_size_is_the_reference_layout(version, sp, ds, n_dev, size):
    assert compat.mesh_size(version, sp, ds, 256, n_dev) == size


def test_fitting_mesh_raises(monkeypatch):
    """Where the reference would lay a mesh over visible devices, the
    port raises: the mesh layouts are not ported."""
    monkeypatch.setattr(compat, "visible_devices", lambda device: 4)
    with pytest.raises(NotImplementedError, match="mesh layouts"):
        spmm_test_cuda.main(["--dataset", "tiny", "--sp_parts", "2",
                             "--ds_parts", "2"], device="cpu")
    with pytest.raises(NotImplementedError, match="mesh layouts"):
        spmm_test_cuda.main(["--dataset", "tiny", "--version", "spmv"],
                            device="cpu")


@pytest.mark.parametrize("argv", [["--lib_path", "/nowhere", "--nr_dpus",
                                   "64"], ["--dataset", "amazonproducts"]],
                         ids=["ignored-flags", "amazon-part"])
def test_accepted_flags(capsys, argv, monkeypatch):
    """``--lib_path`` and ``--nr_dpus`` are accepted and ignored;
    amazonproducts goes through ``cluster_partition`` (contiguous part
    1 of ~500k-node parts), here on a small stand-in of its name."""
    from pygim_tpu_torch import data

    real = data.load_dataset
    monkeypatch.setattr(data, "load_dataset",
                        lambda name, **kw: real("tiny" if name ==
                                                "amazonproducts" else name,
                                                **kw))
    monkeypatch.setattr(data, "cluster_partition",
                        lambda ds, part_size, part_idx: real("tiny"))
    out, got = run(capsys, inference_cuda.main,
                   ["--dataset", "tiny", "--repeat", "1", *argv],
                   device="cpu")
    assert got["infer_time(ms)"][0] > 0


def test_unknown_dataset_exits(capsys):
    with pytest.raises(SystemExit, match="unknown dataset"):
        spmm_test_cuda.main(["--dataset", "no-such-graph"], device="cpu")


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline",
              "spmm_effective_GBps_unique"}


@pytest.fixture
def bench_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("PYGIM_BENCH_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PYGIM_BENCH_DATASET", "rmat-2000-40000")
    monkeypatch.setenv("PYGIM_BENCH_HIDDEN", "32")
    monkeypatch.setenv("PYGIM_BENCH_ITERS", "1")
    monkeypatch.setenv("PYGIM_BENCH_HBM_GBPS", "3350")
    return monkeypatch


def bench_cuda_model_bytes(graph, hidden):
    from pygim_tpu_torch.bench.runners import spmm_model_bytes

    return spmm_model_bytes(graph.nnz, graph.nrows, hidden, 4)


def test_bench_cuda_line(capsys, bench_env):
    capsys.readouterr()
    res = bench_cuda.main(device="cpu")
    cap = capsys.readouterr()
    out = cap.out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == BENCH_KEYS | {"device"} and line["device"] == "cpu"
    assert line["metric"] == \
        "spmm_effective_bandwidth_rmat-2000-40000_csr_f32_h32"
    assert line["unit"] == "GB/s" and line == res["line"]
    gbps = bench_cuda_model_bytes(res["graph"], 32) / res["ms"] / 1e6
    assert line["value"] == round(gbps, 2)
    assert line["vs_baseline"] == round(gbps / (0.7 * 3350), 4)
    assert res["prep"].nnz < res["graph"].nnz  # duplicates merged
    assert line["spmm_effective_GBps_unique"] <= line["value"]
    cfg = res["config"]  # the first candidate: stair int8 at 8 GiB
    assert (cfg.hybrid_dtype, cfg.hybrid_core_bytes, cfg.hybrid_shape) == \
        ("int8", 8 << 30, "stair")
    assert res["prep"].stair and "core_fill" in res["phases"]
    assert {"mul_time(ms)", "gather_time(ms)", "tail_time(ms)",
            "core_time(ms)"} == set(res["phase_times"])
    d = res["describe"]
    assert d["bands"] == res["prep"].stair
    assert 0 <= d["tail_edges"] <= res["prep"].nnz
    assert d["core_coverage"] == \
        (res["prep"].nnz - d["tail_edges"]) / res["prep"].nnz
    assert res["peak_host_rss_kib"] > 0
    assert "verify: OK" in cap.err and "phase_times (ms)" in cap.err


def test_bench_cuda_line_has_bench_keys():
    """bench.py's line, read from its source, has the same keys."""
    src = (ROOT / "bench.py").read_text()
    for k in BENCH_KEYS:
        assert f'"{k}"' in src


def test_bench_cuda_skips_unported_candidates(capsys, bench_env):
    """A pinned bf16 square core is the only candidate: it is skipped with
    a line, and nothing is measured; unpinned, the stair candidates run."""
    bench_env.setenv("PYGIM_BENCH_CORE_SHAPE", "square")
    bench_env.setenv("PYGIM_BENCH_CORE_DTYPE", "bfloat16")
    with pytest.raises(RuntimeError, match="no candidate"):
        bench_cuda.main(device="cpu")
    assert "skipped, not ported" in capsys.readouterr().err
    bench_env.delenv("PYGIM_BENCH_CORE_SHAPE")
    bench_env.delenv("PYGIM_BENCH_CORE_DTYPE")
    bench_env.setenv("PYGIM_BENCH_MEASURE_TOP", "2")
    res = bench_cuda.main(device="cpu")  # stair 8 GiB, then stair 12 GiB
    assert res["config"].hybrid_shape == "stair"
    assert capsys.readouterr().err.count("ms per SpMM") == 2


def test_bench_cuda_float_graph_has_no_candidate(bench_env, capsys):
    """A fractional-valued graph keeps only the bf16 cores (bench.py's
    filter), which the port lacks: all skipped, no line."""
    from pygim_tpu_torch import data

    real = data.load_dataset

    def fractional(name, **kw):
        ds = real(name, **kw)
        ds.graph.vals[:] = 0.5
        return ds

    bench_env.setattr(data, "load_dataset", fractional)
    with pytest.raises(RuntimeError, match="no candidate"):
        bench_cuda.main(device="cpu")
    cap = capsys.readouterr()
    assert cap.err.count("skipped, not ported") == 3 and cap.out == ""


def test_bench_cuda_out_of_memory_moves_on(bench_env, capsys):
    """Out of card memory on stair 8 GiB: the next candidate runs."""
    from pygim_tpu_torch.ops import spmm

    real = spmm.prepare_spmm

    def oom_at_8(graph, cfg, **kw):
        if cfg.hybrid_core_bytes == 8 << 30:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real(graph, cfg, **kw)

    bench_env.setattr(spmm, "prepare_spmm", oom_at_8)
    res = bench_cuda.main(device="cpu")
    assert res["config"].hybrid_core_bytes == 12 << 30
    assert "out of card memory" in capsys.readouterr().err


@pytest.mark.parametrize("fail", ["prepare", "verify"])
def test_bench_cuda_other_errors_fail_the_run(bench_env, capsys, fail):
    """Any error but running out of memory fails the run with no line: a
    kernel fault is never hidden behind a second candidate."""
    from pygim_tpu_torch.bench import runners
    from pygim_tpu_torch.ops import spmm

    if fail == "prepare":
        def broken(graph, cfg, **kw):
            raise ValueError("a fault")
        bench_env.setattr(spmm, "prepare_spmm", broken)
        with pytest.raises(ValueError, match="a fault"):
            bench_cuda.main(device="cpu")
    else:
        bench_env.setattr(runners, "_verify_against_oracle",
                          lambda *a, **kw: False)
        with pytest.raises(AssertionError, match="sampled rows"):
            bench_cuda.main(device="cpu")
    assert capsys.readouterr().out == ""


def test_peak_table_and_unknown_card(monkeypatch):
    monkeypatch.delenv("PYGIM_BENCH_HBM_GBPS", raising=False)
    assert bench_cuda.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert bench_cuda.hbm_peak_gbps("NVIDIA H100 PCIe") == 2000.0
    with pytest.raises(RuntimeError, match="no peak table"):
        bench_cuda.hbm_peak_gbps("NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="no peak table"):
        tdevice.peaks("cpu")
    monkeypatch.setenv("PYGIM_BENCH_HBM_GBPS", "1000")
    assert bench_cuda.hbm_peak_gbps("cpu") == 1000.0


def test_schedule_balance():
    """K-core's tile schedule on a stair of reddit-sim's shape class
    (bands far longer than the 2 GiB scale band) over 132 blocks."""
    from pygim_tpu_torch.ops.core_dot import schedule_balance

    stair = [(0, 13128, 157440), (13128, 32336, 107520),
             (32336, 64264, 64768), (64264, 107576, 32512)]
    b = schedule_balance(stair, 256, 132)
    assert 1.0 <= b < 1.1
    assert schedule_balance([(0, 128, 256)], 256, 132) == 1.0


def test_scripts_import_no_jax():
    """Importing the three scripts and the new modules loads neither JAX
    nor the JAX package."""
    code = (
        "import sys\n"
        "import bench_cuda, inference_cuda, spmm_test_cuda\n"
        "import pygim_tpu_torch.compat, pygim_tpu_torch.utils.cache\n"
        "import pygim_tpu_torch.utils.device\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pygim_tpu' or m.startswith('pygim_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("script", ["spmm_test_cuda.py", "inference_cuda.py",
                                    "bench_cuda.py"])
def test_scripts_need_the_card_by_default(script):
    """Run as scripts they take the card, and without one they fail
    before any result."""
    res = subprocess.run(
        [sys.executable, script, "--dataset", "tiny"][
            :None if script != "bench_cuda.py" else 2],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYGIM_BENCH_DATASET="tiny"))
    assert res.returncode != 0
    assert "[DATA]verify" not in res.stdout
    assert "infer_time" not in res.stdout and '"metric"' not in res.stdout
