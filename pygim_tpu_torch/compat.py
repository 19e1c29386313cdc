"""Reference-compatible entry surface: ``--data_type`` tokens and the
``--version`` routing of the CLIs, on one card.

Counterpart of ``pygim_tpu/compat.py:30-144``. ``cpu`` prepares the
oracle. ``spmm``, ``grande`` and ``spmv`` prepare the single-card operand
of the version's default config (the ``ell`` backend), as the reference
does whenever its device mesh would not fit the visible devices: an
``sp_parts × ds_parts`` above the visible cards prints the reference's
``[WARN] ... running single-chip`` line. A mesh that would fit on more
than one visible card raises, since the mesh layouts are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

_DTYPE_ALIASES = {"flt32": "float32", "dbl64": "float64"}
_KNOWN_DTYPES = (
    "int8", "int16", "int32", "int64", "float32", "float64", "bfloat16"
)

# (format, backend) of each version's default config
_VERSION_DEFAULTS = {"grande": ("csr", "ell"), "spmv": ("coo", "ell")}


def normalize_data_type(s: str) -> str:
    """Accept the reference's uppercase dtype tokens (INT32 / FLT32 /
    DBL64) alongside the numpy-style names."""
    t = _DTYPE_ALIASES.get(s.lower(), s.lower())
    if t not in _KNOWN_DTYPES:
        raise ValueError(
            f"unknown data type {s!r}; accepted: {_KNOWN_DTYPES} "
            "(case-insensitive; FLT32/DBL64 aliases supported)"
        )
    return t


def visible_devices(device) -> int:
    """The devices a mesh could span: the visible cards for a CUDA
    device, one otherwise."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def mesh_size(version: str, sp_parts: int, ds_parts: int, hidden_size: int,
              n_devices: int) -> int:
    """The devices the reference's ``version`` would lay its mesh over
    with ``n_devices`` visible (``pygim_tpu/compat.py:42-49, 59-97``);
    a size of one, or above ``n_devices``, runs single-chip."""
    if version == "spmv":
        return sp_parts * min(hidden_size,
                              max(1, n_devices // max(1, sp_parts)))
    return sp_parts * ds_parts


def prepare_for_version(
    version: str,
    adj,
    *,
    hidden_size: int = 256,
    sp_parts: int = 1,
    ds_parts: int = 1,
    sp_format: str = "csr",
    backend: str = "ell",
    config: Optional[SpmmConfig] = None,
    warn=print,
    device="cuda",
):
    """The prepared operand of an entry script's ``--version`` on
    ``device``: ``config`` where given, else the version's default
    (``spmm``: ``backend`` in ``sp_format``; ``grande``: ell in csr;
    ``spmv``: ell in coo; each with ``hidden_hint=hidden_size``);
    ``cpu``: the oracle in ``sp_format``."""
    if version == "cpu":
        return prepare_spmm(adj, SpmmConfig(backend="oracle",
                                            format=sp_format), device=device)
    n_dev = visible_devices(device)
    n = sp_parts * ds_parts
    if n > 1 and n > n_dev:
        warn(f"[WARN] sp×ds={n} exceeds {n_dev} devices; running single-chip")
    m = mesh_size(version, sp_parts, ds_parts, hidden_size, n_dev)
    if 1 < m <= n_dev:
        raise NotImplementedError(
            f"--version {version} over {m} devices: the mesh layouts are not "
            "ported (one card runs single-chip)"
        )
    if config is None:
        fmt, be = _VERSION_DEFAULTS.get(version, (sp_format, backend))
        config = SpmmConfig(format=fmt, backend=be, hidden_hint=hidden_size)
    return prepare_spmm(adj, config, device=device)


__all__ = ["normalize_data_type", "prepare_for_version", "mesh_size"]
