"""Reference-compatible entry surface: the reference's adapters
(``prepare_pim_spmm``, ``prepare_pim_spmm_grande``, ``prepare_pim_spmv``,
the ``dpu_*`` shims, ``describe_layout``), the ``--data_type`` tokens and
the ``--version`` routing of the CLIs.

Counterpart of ``pygim_tpu/compat.py``. Each adapter prepares its
reference default config (``spmm``: ``backend`` in ``sp_format``;
``grande``: ell in csr; ``spmv``: ell in coo) over the reference's mesh
(``spmm``: ``sp_parts × ds_parts``; ``grande``: ``(1, sp_parts)``;
``spmv``: ``ds`` as close to ``hidden_size`` as the devices allow) where
``1 < sp · ds <=`` the visible devices — the 2D mesh of
``parallel/spmm_2d.py``, over the visible cards (on the CPU, over as many
copies of the CPU device as :func:`visible_devices` counts) — and on
one device otherwise, as the reference. ``--version cpu`` prepares the
oracle; an ``sp_parts × ds_parts`` above the visible devices prints the
reference's ``[WARN] ... running single-chip`` line.
"""

from __future__ import annotations

from typing import Optional

import torch

from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

_DTYPE_ALIASES = {"flt32": "float32", "dbl64": "float64"}
_KNOWN_DTYPES = (
    "int8", "int16", "int32", "int64", "float32", "float64", "bfloat16"
)


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


def _prepare(graph, sp_parts: int, ds_parts: int, config: SpmmConfig,
             device):
    """``config`` prepared over an ``(sp_parts, ds_parts)`` mesh where
    ``1 < sp_parts · ds_parts <=`` the visible devices of ``device``
    (``pygim_tpu/compat.py:42-57``), else on ``device``."""
    n_vis = visible_devices(device)
    if 1 < sp_parts * ds_parts <= n_vis:
        from pygim_tpu_torch.parallel import make_mesh, prepare_spmm_2d

        dev = torch.device(device)
        mesh = make_mesh(sp_parts, ds_parts,
                         None if dev.type == "cuda" else [dev] * n_vis)
        return prepare_spmm_2d(graph, mesh, config)
    return prepare_spmm(graph, config, device=device)


def prepare_pim_spmm(
    adj, hidden_size: int = 256, sp_parts: int = 1, ds_parts: int = 1,
    sp_format: str = "csr", backend: str = "ell",
    config: Optional[SpmmConfig] = None, *, device="cuda",
):
    """The reference's ``prepare_pim_spmm``: ``config``, or ``backend`` in
    ``sp_format`` at ``hidden_size``, on an ``sp_parts × ds_parts`` grid
    (:func:`_prepare`)."""
    cfg = config or SpmmConfig(
        format=sp_format, backend=backend, hidden_hint=hidden_size
    )
    return _prepare(adj, sp_parts, ds_parts, cfg, device)


def prepare_pim_spmm_grande(
    adj, hidden_size: int = 256, sp_parts: int = 2,
    config: Optional[SpmmConfig] = None, *, device="cuda",
):
    """The reference's ``prepare_pim_spmm_grande``: the ell backend in
    csr, the sparse operand replicated and the features sharded over
    ``sp_parts`` devices, a ``(1, sp_parts)`` mesh (:func:`_prepare`)."""
    cfg = config or SpmmConfig(
        format="csr", backend="ell", hidden_hint=hidden_size
    )
    return _prepare(adj, 1, sp_parts, cfg, device)


def prepare_pim_spmv(
    adj, hidden_size: int, sp_parts: int = 1,
    config: Optional[SpmmConfig] = None, *, device="cuda",
):
    """The reference's ``prepare_pim_spmv``: the ell backend in coo, a
    feature column a device, ``ds`` as close to ``hidden_size`` as the
    visible devices allow (:func:`_prepare`)."""
    cfg = config or SpmmConfig(
        format="coo", backend="ell", hidden_hint=hidden_size
    )
    ds = min(hidden_size,
             max(1, visible_devices(device) // max(1, sp_parts)))
    return _prepare(adj, sp_parts, ds, cfg, device)


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
    if version == "grande":
        return prepare_pim_spmm_grande(adj, hidden_size, sp_parts=n,
                                       config=config, device=device)
    if version == "spmv":
        return prepare_pim_spmv(adj, hidden_size, sp_parts=sp_parts,
                                config=config, device=device)
    return prepare_pim_spmm(adj, hidden_size, sp_parts=sp_parts,
                            ds_parts=ds_parts, sp_format=sp_format,
                            backend=backend, config=config, device=device)


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
    ``halo nd=…`` for a halo operand, ``mesh sp=… ds=…`` for a 2D mesh
    operand, else ``single-chip``."""
    mesh = getattr(prep, "mesh", None)
    if mesh is None:
        return "single-chip"
    shape = dict(mesh.shape)
    if "nodes" in shape:
        return f"halo nd={shape['nodes']}"
    return f"mesh sp={shape.get('sp', 1)} ds={shape.get('ds', 1)}"


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
