"""Reference-compatible entry surface on one card: the reference's
adapters (``prepare_pim_spmm``, ``prepare_pim_spmm_grande``,
``prepare_pim_spmv``, the ``dpu_*`` shims, ``describe_layout``), the
``--data_type`` tokens and the ``--version`` routing of the CLIs.

Counterpart of ``pygim_tpu/compat.py``. Each adapter prepares its
reference default config (``spmm``: ``backend`` in ``sp_format``;
``grande``: ell in csr; ``spmv``: ell in coo) on one card, as the
reference does whenever its device mesh would not fit the visible
devices; a mesh that would fit on more than one visible card raises,
since the mesh layouts are not ported (ROADMAP.md, Queue 1 item 6).
``--version cpu`` prepares the oracle; an ``sp_parts × ds_parts`` above
the visible cards prints the reference's ``[WARN] ... running
single-chip`` line.
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


def _prepare(graph, n: int, config: SpmmConfig, device):
    """``config`` prepared on ``device`` where no mesh of ``n`` devices
    fits the visible ones; raises where one would."""
    if 1 < n <= visible_devices(device):
        raise NotImplementedError(
            f"a mesh over {n} devices: the mesh layouts are not ported "
            "(ROADMAP.md, Queue 1 item 6; one card runs single-chip)")
    return prepare_spmm(graph, config, device=device)


def prepare_pim_spmm(
    adj, hidden_size: int = 256, sp_parts: int = 1, ds_parts: int = 1,
    sp_format: str = "csr", backend: str = "ell",
    config: Optional[SpmmConfig] = None, *, device="cuda",
):
    """The reference's ``prepare_pim_spmm``: ``config``, or ``backend`` in
    ``sp_format`` at ``hidden_size``, on an ``sp_parts × ds_parts`` grid,
    which on one card is ``prepare_spmm``."""
    cfg = config or SpmmConfig(
        format=sp_format, backend=backend, hidden_hint=hidden_size
    )
    return _prepare(adj, sp_parts * ds_parts, cfg, device)


def prepare_pim_spmm_grande(
    adj, hidden_size: int = 256, sp_parts: int = 2,
    config: Optional[SpmmConfig] = None, *, device="cuda",
):
    """The reference's ``prepare_pim_spmm_grande``: the sparse operand
    replicated and the features sharded over ``sp_parts`` devices (a (1,
    sp_parts) mesh), which on one card is ``prepare_spmm`` of the ell
    backend in csr."""
    cfg = config or SpmmConfig(
        format="csr", backend="ell", hidden_hint=hidden_size
    )
    return _prepare(adj, sp_parts, cfg, device)


def prepare_pim_spmv(
    adj, hidden_size: int, sp_parts: int = 1,
    config: Optional[SpmmConfig] = None, *, device="cuda",
):
    """The reference's ``prepare_pim_spmv``: a column a device, ``ds`` as
    close to ``hidden_size`` as the visible devices allow, which on one
    card is ``prepare_spmm`` of the ell backend in coo."""
    cfg = config or SpmmConfig(
        format="coo", backend="ell", hidden_hint=hidden_size
    )
    ds = min(hidden_size,
             max(1, visible_devices(device) // max(1, sp_parts)))
    return _prepare(adj, sp_parts * ds, cfg, device)


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
    if config is None:
        fmt, be = _VERSION_DEFAULTS.get(version, (sp_format, backend))
        config = SpmmConfig(format=fmt, backend=be, hidden_hint=hidden_size)
    return _prepare(adj, mesh_size(version, sp_parts, ds_parts, hidden_size,
                                   n_dev), config, device)


def dpu_init_ranks(nr_ranks: int = 1, groups_per_rank: int = 1, *,
                   device="cuda") -> list:
    """The reference's shim for ``dpu_init_ranks``: the runtime owns the
    devices, so nothing is allocated; every "rank" sees all the visible
    devices."""
    return [visible_devices(device)] * max(1, int(nr_ranks))


def dpu_init_dpus(nr_dpus: "int | None" = None, *, device="cuda") -> list:
    """The reference's shim for ``dpu_init_dpus``: :func:`dpu_init_ranks`."""
    return dpu_init_ranks(1, device=device)


def dpu_release() -> None:
    """The reference's shim for ``dpu_release``: nothing to free (the
    card's tensors are freed with their operands)."""
    return None


def describe_layout(prep) -> str:
    """The distribution of a prepared operand, in the reference's words:
    every operand of the port is on one card."""
    return "single-chip"


__all__ = [
    "prepare_pim_spmm",
    "prepare_pim_spmm_grande",
    "prepare_pim_spmv",
    "prepare_for_version",
    "describe_layout",
    "dpu_init_ranks",
    "dpu_init_dpus",
    "dpu_release",
    "normalize_data_type",
    "mesh_size",
]
