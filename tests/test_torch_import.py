"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, and no file of it (or chip_smoke.py, or the entry scripts
bench_cuda.py, spmm_test_cuda.py, inference_cuda.py, train_cuda.py)
imports either; train_cuda.py's main on the CPU loads neither."""

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
    "pygim_tpu_torch.data",
    "pygim_tpu_torch.ops",
    "pygim_tpu_torch.ops._build",
    "pygim_tpu_torch.ops.core_dot",
    "pygim_tpu_torch.ops.core_int",
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
]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "pygim_tpu" or name.startswith("pygim_tpu."))


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
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
                           "train_cuda.py")]


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
