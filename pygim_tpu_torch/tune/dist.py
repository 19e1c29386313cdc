"""Distribution plans of the tuner, the port's copy of
``pygim_tpu/tune/dist.py``.

A :class:`DistPlan` is one point on the distribution axes: ``single``
(one card: every single-card backend applies), ``2d`` (an sp × ds rank
grid) or ``halo`` (a 1-D row partition with a halo exchange). The port
tunes for one card: :func:`enumerate_dist` gives the single-card plan,
and a budget above one card, or a search without the single layout,
raises, as the tuner's ``2d`` and ``halo`` plans and their statistics
(``halo_statistics``, the ``metis`` order) are not ported (ROADMAP.md,
Queue 1 item 6d; the 2D mesh itself runs, ``parallel/spmm_2d.py``).
"""

from __future__ import annotations

import dataclasses

MESH_ITEM = "ROADMAP.md, Queue 1 item 6d"


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """One point on the distribution axes, the reference's fields.

    ``layout``: "single" | "2d" | "halo".
    ``sp``/``ds``: rank-grid shape (2d); halo uses sp=n_devices, ds=1.
    ``exchange``: halo feature-exchange strategy.
    ``scatter_output``: 2d reduce-scatter variant.
    ``order``: halo node layout, "none" or "metis".
    """

    layout: str = "single"
    sp: int = 1
    ds: int = 1
    exchange: str = "all_to_all"
    scatter_output: bool = False
    order: str = "none"

    @property
    def n_devices(self) -> int:
        return self.sp * self.ds

    def describe(self) -> str:
        if self.layout == "single":
            return "single-chip"
        if self.layout == "2d":
            tag = "+scatter" if self.scatter_output else ""
            return f"2d sp={self.sp} ds={self.ds}{tag}"
        otag = "" if self.order == "none" else f" order={self.order}"
        return f"halo nd={self.sp} exchange={self.exchange}{otag}"


def enumerate_dist(
    n_devices: int, layouts: tuple = ("single", "2d", "halo"),
) -> list[DistPlan]:
    """The distribution candidates for an ``n_devices`` budget: on one
    card, the single-card plan (the reference's answer there too). Raises
    ``NotImplementedError`` for a budget above one card or ``layouts``
    without ``"single"``."""
    if n_devices > 1:
        raise NotImplementedError(
            f"a tuning budget of {n_devices} devices: the tuner's mesh "
            f"plans are not ported ({MESH_ITEM})")
    if "single" not in layouts:
        raise NotImplementedError(
            f"layouts {tuple(layouts)} without 'single': the tuner's mesh "
            f"plans are not ported ({MESH_ITEM})")
    return [DistPlan()]
