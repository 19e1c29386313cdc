"""The PyTorch port stands alone: importing it loads neither JAX, nor
``ml_dtypes`` (which comes with JAX and not with the packages of the
machine with the card), nor the JAX package, and no file of it (or
chip_smoke.py, or the entry scripts bench_cuda.py, spmm_test_cuda.py,
inference_cuda.py, train_cuda.py, sweep_cuda.py) imports any of them;
train_cuda.py's main on the CPU loads none. The package namespaces re-export the names
the reference's do, where the port has them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pygim_tpu_torch"
MODULES = [
    "pygim_tpu_torch",
    "pygim_tpu_torch.core",
    "pygim_tpu_torch.core.graph",
    "pygim_tpu_torch.core.partition",
    "pygim_tpu_torch.core.stair",
    "pygim_tpu_torch.core.banded",
    "pygim_tpu_torch.data",
    "pygim_tpu_torch.ops",
    "pygim_tpu_torch.ops._build",
    "pygim_tpu_torch.ops.core_dot",
    "pygim_tpu_torch.ops.core_int",
    "pygim_tpu_torch.ops.core_f32",
    "pygim_tpu_torch.ops.ell_tail",
    "pygim_tpu_torch.ops.reference",
    "pygim_tpu_torch.ops.spmm",
    "pygim_tpu_torch.quant",
    "pygim_tpu_torch.nn",
    "pygim_tpu_torch.nn.layers",
    "pygim_tpu_torch.nn.models",
    "pygim_tpu_torch.nn.train",
    "pygim_tpu_torch.nn.checkpoint",
    "pygim_tpu_torch.bench.validate",
    "pygim_tpu_torch.bench.report",
    "pygim_tpu_torch.bench.train_report",
    "pygim_tpu_torch.data.datasets",
    "pygim_tpu_torch.utils.timers",
    "pygim_tpu_torch.utils.metrics",
    "pygim_tpu_torch.bench",
    "pygim_tpu_torch.bench.runners",
    "pygim_tpu_torch.entry",
    "pygim_tpu_torch.compat",
    "pygim_tpu_torch.utils.cache",
    "pygim_tpu_torch.utils.device",
    "pygim_tpu_torch.utils.logging",
    "pygim_tpu_torch.utils.profiling",
    "pygim_tpu_torch.core.transforms",
    "pygim_tpu_torch.core.cluster",
    "pygim_tpu_torch.data.real",
    "pygim_tpu_torch.data.real_layout",
    "pygim_tpu_torch.tune",
    "pygim_tpu_torch.tune.space",
    "pygim_tpu_torch.bench.experiment",
    "pygim_tpu_torch.bench.configs",
    "pygim_tpu_torch.bench.parse_results",
    "pygim_tpu_torch.core.bcsr",
    "pygim_tpu_torch.ops.bcsr",
    "pygim_tpu_torch.ops.sddmm",
    "pygim_tpu_torch.tune.bcsr_probe",
    "pygim_tpu_torch.tune.dist",
    "pygim_tpu_torch.tune.cost_model",
    "pygim_tpu_torch.tune.autotuner",
    "pygim_tpu_torch.utils",
    "pygim_tpu_torch.parallel",
    "pygim_tpu_torch.parallel.mesh",
    "pygim_tpu_torch.parallel.collectives",
    "pygim_tpu_torch.parallel.spmm_2d",
    "pygim_tpu_torch.parallel.halo",
    "pygim_tpu_torch.bench.scaling",
    "pygim_tpu_torch.core.native",
    "sweep_cuda",
]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "ml_dtypes" or name.startswith("ml_dtypes.")
            or name == "pygim_tpu" or name.startswith("pygim_tpu."))


# the reference's package-level names (pygim_tpu/__init__.py,
# core/__init__.py, ops/__init__.py, tune/, utils/, nn/, compat.py) the
# port defines, by namespace
REEXPORTS = {
    "pygim_tpu_torch": ["CooGraph", "CsrGraph"],
    "pygim_tpu_torch.core": ["CooGraph", "CsrGraph", "coo_to_csr",
                             "RowBlockPlan", "plan_row_blocks"],
    "pygim_tpu_torch.ops": ["spmm_coo_oracle", "spmm_csr_oracle",
                            "PreparedSpmm", "prepare_spmm"],
    "pygim_tpu_torch.bench": ["Experiment", "run_experiments",
                              "results_to_csv", "run_inference_benchmark",
                              "run_spmm_benchmark"],
    "pygim_tpu_torch.data": ["DATASET_SPECS", "GraphDataset",
                             "cluster_partition", "load_dataset", "load_mtx",
                             "rmat_edges"],
    "pygim_tpu_torch.tune": ["Concat", "For", "Product", "Space", "Table",
                             "Unit", "DEFAULT_SPACE", "HYBRID_SPACE",
                             "TuneResult", "autotune", "plan_statistics",
                             "prepare_tuned", "calibrate_from_phases",
                             "measure_constants", "predict_spmm_time",
                             "DistPlan", "enumerate_dist", "CardCostModel"],
    "pygim_tpu_torch.utils": ["DataReporter", "data_print",
                              "parse_data_lines", "PhaseTimer",
                              "device_time"],
    "pygim_tpu_torch.nn": ["GNN", "make_gnn", "linear_apply",
                           "batchnorm_apply", "quantized_aggregate"],
    "pygim_tpu_torch.parallel": ["make_mesh", "PreparedSpmm2D",
                                 "prepare_spmm_2d", "make_node_mesh",
                                 "prepare_spmm_halo", "PreparedSpmmHalo"],
    "pygim_tpu_torch.compat": ["prepare_pim_spmm", "prepare_pim_spmm_grande",
                               "prepare_pim_spmv", "prepare_for_version",
                               "describe_layout", "dpu_init_ranks",
                               "dpu_init_dpus", "dpu_release"],
}


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        f"for ns, names in {REEXPORTS!r}.items():\n"
        "    m = importlib.import_module(ns)\n"
        "    missing = [n for n in names if not hasattr(m, n)]\n"
        "    assert not missing, (ns, missing)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'ml_dtypes',"
        " 'pygim_tpu') or m.startswith(('jax.', 'ml_dtypes.',"
        " 'pygim_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("module", ["pygim_tpu_torch",
                                    "pygim_tpu_torch.parallel"])
def test_package_alone_loads_no_jax(module):
    """``import pygim_tpu_torch`` and ``import pygim_tpu_torch.parallel``,
    each alone in a fresh process, leave ``jax``, ``ml_dtypes`` and every
    ``pygim_tpu`` module out of ``sys.modules``."""
    code = (
        f"import sys, {module}\n"
        "bad = [m for m in sys.modules if m in ('jax', 'ml_dtypes',"
        " 'pygim_tpu') or m.startswith(('jax.', 'ml_dtypes.',"
        " 'pygim_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_reexports_are_the_ports_own():
    """Queue 3 item 1: each re-exported name is the port's object, the
    same one its defining module holds."""
    import pygim_tpu_torch
    from pygim_tpu_torch import core, ops
    from pygim_tpu_torch.core import graph, partition
    from pygim_tpu_torch.ops import reference
    from pygim_tpu_torch import bench, data
    from pygim_tpu_torch.bench import experiment, parse_results
    from pygim_tpu_torch.data import datasets

    assert pygim_tpu_torch.CooGraph is graph.CooGraph
    assert pygim_tpu_torch.CsrGraph is graph.CsrGraph
    assert core.RowBlockPlan is partition.RowBlockPlan
    assert core.plan_row_blocks is partition.plan_row_blocks
    assert ops.spmm_coo_oracle is reference.spmm_coo_oracle
    assert ops.spmm_csr_oracle is reference.spmm_csr_oracle
    assert bench.Experiment is experiment.Experiment
    assert bench.run_experiments is experiment.run_experiments
    assert bench.results_to_csv is parse_results.results_to_csv
    assert data.load_mtx is datasets.load_mtx
    from pygim_tpu_torch import nn, tune, utils
    from pygim_tpu_torch.nn import layers
    from pygim_tpu_torch.tune import autotuner, cost_model, dist
    from pygim_tpu_torch.utils import metrics, timers

    for name in ("DEFAULT_SPACE", "HYBRID_SPACE", "TuneResult", "autotune",
                 "plan_statistics", "prepare_tuned"):
        assert getattr(tune, name) is getattr(autotuner, name)
    for name in ("CardCostModel", "calibrate_from_phases",
                 "measure_constants", "predict_spmm_time"):
        assert getattr(tune, name) is getattr(cost_model, name)
    assert tune.DistPlan is dist.DistPlan
    assert tune.enumerate_dist is dist.enumerate_dist
    for name in ("DataReporter", "data_print", "parse_data_lines"):
        assert getattr(utils, name) is getattr(metrics, name)
    assert utils.PhaseTimer is timers.PhaseTimer
    assert utils.device_time is timers.device_time
    for name in ("linear_apply", "batchnorm_apply", "quantized_aggregate"):
        assert getattr(nn, name) is getattr(layers, name)
    for ns in REEXPORTS:
        mod = __import__(ns, fromlist=["_"])
        assert set(REEXPORTS[ns]) <= set(dir(mod)), ns


def test_train_cuda_loads_no_jax():
    """train_cuda.py imported and run for one epoch on the CPU."""
    code = (
        "import sys, train_cuda\n"
        "train_cuda.main(['--dataset', 'tiny', '--hidden_size', '16', "
        "'--epochs', '1'], device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pygim_tpu' or m.startswith('pygim_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[DATA]train_time(ms)" in res.stdout


def _sources():
    return sorted(PKG.rglob("*.py")) + [
        ROOT / f for f in ("chip_smoke.py", "bench_cuda.py",
                           "spmm_test_cuda.py", "inference_cuda.py",
                           "train_cuda.py", "sweep_cuda.py")]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert not _forbidden(n), f"{path}: imports {n}"


def test_import_builds_nothing(tmp_path):
    """Kernels build at first launch, never at import."""
    from pygim_tpu_torch.ops import _build

    assert not _build._libs
    name = _build.library_path("core_dot").name
    assert name.startswith("libcore_dot-") and name.endswith(".so")
