"""The multilevel k-way partitioner's host library: ``csrc/partition_ml.cpp``
(the port's copy of the reference's ``native/partition_ml.cpp``) compiled
with ``g++`` at first use into ``_build/libpartition_ml-<hash>.so``, next
to the CUDA kernels' libraries, and bound with ctypes.

It is host code: ``g++`` is on every machine that has ``nvcc``. A failed
build raises with the compiler's log; nothing falls back to weaker cuts
without being asked. The one switch is :data:`NO_NATIVE_ENV` (the port's
counterpart of the reference's ``PYGIM_TPU_NO_NATIVE``): set to a
non-empty value, :func:`partition_kway_native` returns None and
``core/cluster.py:partition_kway`` takes the reference's
label-propagation packing.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "partition_ml.cpp"
BUILD_DIR = _PKG / "_build"
NO_NATIVE_ENV = "PYGIM_TPU_TORCH_NO_NATIVE"
# the reference's native/Makefile flags without OpenMP, which not every
# g++ ships (its parallel loops are over independent rows: the result is
# the same)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wno-unknown-pragmas", "-shared")

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx(), *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libpartition_ml-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library where it is missing; returns its path. Raises
    ``RuntimeError`` with the compiler's log where the build fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{cmd[0]} could not run for {SOURCE.name}: {e}")
    try:
        if p.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed:\n{p.stdout}{p.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load() -> ctypes.CDLL:
    """The bound library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.partition_kway.argtypes = [
                ctypes.c_int32, _i32p, _i32p, ctypes.c_int32, ctypes.c_float,
                ctypes.c_int32, _i32p]
            lib.partition_kway.restype = ctypes.c_int64
            _lib = lib
        return _lib


def native_enabled() -> bool:
    return not os.environ.get(NO_NATIVE_ENV)


def partition_kway_native(rowptr, colind, nparts: int, tol: float = 0.03,
                          seed: int = 0):
    """``(part, edge_cut)`` of the multilevel partition of the symmetrized
    simple graph of a CSR adjacency (``part`` int32, one part id a node;
    ``edge_cut`` its undirected cut), or None under :data:`NO_NATIVE_ENV`
    or where the library refuses the arguments."""
    if not native_enabled():
        return None
    lib = load()
    rowptr = np.ascontiguousarray(rowptr, np.int32)
    colind = np.ascontiguousarray(colind, np.int32)
    n = rowptr.shape[0] - 1
    part = np.empty(n, dtype=np.int32)
    cut = lib.partition_kway(n, rowptr, colind, int(nparts), float(tol),
                             int(seed), part)
    if cut < 0:
        return None
    return part, int(cut)
