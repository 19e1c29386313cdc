"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function that launches its
kernel on a given stream and returns the launch's ``cudaError_t``. It is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``
inside this package, at first use, from the sources alone; the hash
covers the source, every ``csrc/*.cuh`` header and the flags, so an
edited source or header rebuilds. All
missing libraries are compiled at once, one ``nvcc`` per source.

Nothing here runs at import: this module only names paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: K-tail's quantized payload rounds to the correctly
# rounded x / scale (csrc/ell_tail.cu), and the f32 sums keep IEEE rounding.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the log
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# C entry points per source: name -> argtypes (all return int)
SIGNATURES = {
    "core_dot": {
        # map (host, 128 B), band, r, row bytes, cell mode
        "core_encode_band_map": [_P, _P, _LL, _LL, _I],
        # split, cell mode, int out (host)
        "core_max_clusters": [_I, _I, _P],
        # band maps, band (lo, r, w) (both host), n_bands, xc, xc rows,
        # tiles, starts, clusters, split, nodes, out, h, cell mode,
        # stream-K partials, flags, stream
        "core_bands_scatter_add": [_P, _P, _I, _P, _LL, _P, _P, _I, _I, _P,
                                   _P, _I, _I, _P, _P, _P],
    },
    "core_int": {
        # limbs, packed, split, int out (host)
        "core_int_max_clusters": [_I, _I, _I, _P],
        # band maps, band (lo, r, w) (both host), n_bands, xcT, k_pad,
        # h_pad, limbs, tiles, starts, n_clusters, split, nodes, out, h,
        # vec, packed, stream
        "core_int_scatter_add": [_P, _P, _I, _P, _LL, _I, _I, _P, _P, _I, _I,
                                 _P, _P, _I, _I, _I, _P],
    },
    "core_f32": {
        # map (host, 128 B), band, r, w, cell
        "core_f32_encode_band_map": [_P, _P, _LL, _LL, _I],
        # band maps, band (lo, r, w) (both host), n_bands, cell, xcT,
        # parts, k_pad, h_pad, tiles, n_tiles, nodes, out, h, stream
        "core_f32_tc_scatter_add": [_P, _P, _I, _I, _P, _I, _LL, _I, _P, _I,
                                    _P, _P, _I, _P],
    },
    "bcsr": {
        # tiles, tile f32, tiles (n · slots), tr, plan entries, plan
        # items, n_items, panel_nodes, row_nodes, x, payload, safe, parts,
        # out, h, vec, stream
        "bcsr_add": [_P, _I, _LL, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P,
                     _I, _I, _P],
    },
    "ell_tail": {
        # tables, units, n_units, x, out, h, vec, payload, safe, stream
        "ell_tables_add": [_P, _P, _I, _P, _P, _I, _I, _I, _P, _P],
    },
    "seg_rows": {
        # units, n_units, hub rows, n_hub, cols, vals, val code, keys, inv,
        # nnz_pad, rows_pad, x, x code, int accumulation, out, h, vec,
        # stream
        "seg_rows": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _LL, _I, _P, _I, _I,
                     _P, _I, _I, _P],
    },
    "epilogue": {
        # a, y, n, h, vec, scale, bias, mean, inv, gamma, beta, stream
        "epilogue": [_P, _P, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    },
    "bn_train": {
        # z, n, h, vec, chunks, partials, mean, var, stream
        "bn_stats": [_P, _LL, _I, _I, _I, _P, _P, _P, _P],
        # z, out, n, h, vec, mean, inv, gamma, beta, key, t, scale, stream
        "bn_fwd": [_P, _P, _LL, _I, _I, _P, _P, _P, _P, _P, _I, _F, _P],
        # g, z, n, h, vec, mean, inv, gamma, beta, key, t, scale, chunks,
        # partials, sum_gb, sum_gbx, stream
        "bn_bwd_stats": [_P, _P, _LL, _I, _I, _P, _P, _P, _P, _P, _I, _F, _I,
                         _P, _P, _P, _P],
        # g, z, dz, n, h, vec, mean, inv, gamma, beta, key, t, scale, a,
        # m_b, m_x, stream
        "bn_bwd": [_P, _P, _P, _LL, _I, _I, _P, _P, _P, _P, _P, _I, _F, _P,
                   _P, _P, _P],
    },
    "quant": {
        # x, numel, vec, partials, 2^-k, out (3,), stream
        "quant_abs_max": [_P, _LL, _I, _P, ctypes.c_float, _P, _P],
        # x, numel, vec, safe, out, out type, stream
        "quant_table": [_P, _LL, _I, _P, _P, _I, _P],
        # x, x type, rows, n_rows, safe, limbs, h, h_pad, k_pad, out,
        # stream
        "quant_core_payload": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P],
    },
}

_libs: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are compiled from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile every named source whose library is missing, all at once.
    Returns ``{name: seconds}`` for the sources compiled; the compiler's
    report (``-Xptxas -v``) goes to ``_build/<name>.log``."""
    names = list(SIGNATURES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(exist_ok=True)
    exe = nvcc()
    procs = {}
    try:
        for n in todo:
            so = library_path(n)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            p = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            procs[n] = (p, tmp, so, time.perf_counter())
        took = {}
        for n, (p, tmp, so, t0) in procs.items():
            log, _ = p.communicate()
            took[n] = time.perf_counter() - t0
            (BUILD_DIR / f"{n}.log").write_text(log)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{n}.cu:\n{log}")
            os.replace(tmp, so)
        return took
    finally:
        for p, tmp, _so, _t0 in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero code returned by a host function of ``csrc/``:
    a ``cudaError_t``, or the codes the sources add (900: the CUDA driver has no
    ``cuTensorMapEncodeTiled``, 901: arguments refused, 1000 + r: the
    encode returned ``CUresult`` r)."""
    if err == 0:
        return
    if err == 900:
        why = "cuTensorMapEncodeTiled not found in the CUDA driver"
    elif err == 901:
        why = "arguments refused by the host function"
    elif err >= 1000:
        why = f"cuTensorMapEncodeTiled failed with CUresult {err - 1000}"
    else:
        why = f"CUDA launch failed with cudaError {err}"
    raise RuntimeError(f"{what}: {why}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device
    (PyTorch's own raw-stream query where the build has it: no stream
    object is made a call)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(t.device).cuda_stream
    index = t.device.index
    return raw(torch.cuda.current_device() if index is None else index)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where grad mode is on and one of ``tensors`` requires grad.

    A kernel writes its result through a raw pointer, so autograd sees no
    node: a gradient would stop at the kernel without a word. A caller
    that needs one goes through ``ops/spmm.py:SpmmFunction``, whose
    forward runs with grad mode off. The plain versions on CPU tensors
    take the same rule, so a CPU run cannot pass where the card would cut
    the graph."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an operand requires grad under grad mode; the kernel "
            "has no autograd node (use PreparedAggregate, whose backward "
            "runs the prepared transpose)")
