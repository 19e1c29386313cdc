"""The ``(sp, ds)`` device grid of the 2D mesh, the port's copy of
``pygim_tpu/parallel/mesh.py``, and the 1-D ``nodes`` line of the halo
layout (:class:`NodeMesh`, made by ``parallel/halo.py:make_node_mesh``).

Rank ``r`` of the reference's grid is tile ``(r // ds, r % ds)``; here
the grid is a :class:`Mesh` of ``torch.device`` s, the ``sp`` axis (the
one the partial products are summed over) first. A device may appear in
several cells: ``["cpu"] * 8`` or ``cuda:0`` repeated is a virtual mesh,
every shard's work at its shard shapes on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[s][d]``: the device of shard ``(s, d)``."""

    devices: tuple
    axis_names: tuple = ("sp", "ds")

    @property
    def shape(self) -> dict:
        return {"sp": len(self.devices), "ds": len(self.devices[0])}


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """``devices[d]``: the device of node shard ``d``."""

    devices: tuple
    axis_names: tuple = ("nodes",)

    @property
    def shape(self) -> dict:
        return {"nodes": len(self.devices)}


def is_virtual(devices) -> bool:
    """Whether ``devices`` is a virtual mesh: one device repeated, or
    devices that are not cards (a CPU mesh shares one host's cores). Such
    a mesh checks every shard's work but measures no scaling."""
    devices = [torch.device(d) for d in devices]
    return (len(set(devices)) < len(devices)
            or any(d.type != "cuda" for d in devices))


def visible_cards() -> list:
    """The visible CUDA cards, ``cuda:0`` first (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def make_mesh(sp_parts: int, ds_parts: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """The first ``sp_parts · ds_parts`` of ``devices`` (default: the
    visible cards) as an ``(sp_parts, ds_parts)`` grid; raises
    ``ValueError`` with the reference's message where there are fewer."""
    if devices is None:
        devices = visible_cards()
    devices = [torch.device(d) for d in devices]
    need = sp_parts * ds_parts
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for sp={sp_parts} ds={ds_parts}, "
            f"have {len(devices)}"
        )
    grid = tuple(tuple(devices[s * ds_parts:(s + 1) * ds_parts])
                 for s in range(sp_parts))
    return Mesh(grid)
