"""The port's disk cache: prepared hybrid tables and synthesized datasets.

Both live under ``$PYGIM_TPU_TORCH_DATA``, default
``~/.cache/pygim_tpu_torch``, never under the reference's directory
(``$PYGIM_TPU_DATA``, ``~/.cache/pygim_tpu``), so neither package reads a
file the other wrote. A dataset file has the reference's name and
layout; a prepared table file has the reference's contents under the
port's own prefix (``ops/spmm.py:CACHE_PREFIX``). Clearing the cache is
deleting the directory.
"""

from __future__ import annotations

import logging
import os
import tempfile
import zipfile
from pathlib import Path

import numpy as np

CACHE_ENV = "PYGIM_TPU_TORCH_DATA"

# what a damaged or half-written .npz raises on load
LOAD_ERRORS = (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile)

_log = logging.getLogger("pygim_tpu_torch")


def cache_dir() -> Path:
    """The cache directory, read from the environment at each call."""
    root = os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "pygim_tpu_torch")
    return Path(root)


def save_npz(path: Path, arrays: dict) -> bool:
    """``np.savez`` of ``arrays`` to a file of its own beside ``path``, then
    renamed onto it, so a reader never sees a half-written file and two
    writers never share one. A failed write (a full disk, no permission)
    is logged and leaves nothing behind; returns whether ``path`` was
    written."""
    tmp = None
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.stem + ".",
                                   suffix=".tmp.npz")
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.chmod(tmp, 0o644)  # mkstemp's 0600 would hide it from others
        os.replace(tmp, path)
        return True
    except OSError as e:
        _log.warning("cache write of %s failed: %s", path, e)
        if tmp is not None:
            Path(tmp).unlink(missing_ok=True)
        return False
