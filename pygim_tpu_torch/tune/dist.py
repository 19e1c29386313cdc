"""Distribution plans of the tuner, the port's copy of
``pygim_tpu/tune/dist.py``.

A :class:`DistPlan` is one point on the distribution axes:

* ``single`` — one card: every single-card backend applies.
* ``2d`` — an sp × ds rank grid (``parallel/spmm_2d.py``), with the
  ``scatter_output`` variant (each sp shard keeps its row block of the
  sum: half the merge's traffic).
* ``halo`` — a 1-D row partition with a halo feature exchange
  (``parallel/halo.py``): ``all_gather``, ``all_to_all`` or ``ring``, in
  the contiguous node order or the ``metis`` order. Which exchange wins
  is a property of the graph's cut, so :func:`halo_statistics` measures
  the actual cut and the cost model prices each exchange from it.

Every statistic here is host planning arithmetic in NumPy: no device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pygim_tpu_torch.core.graph import CsrGraph
from pygim_tpu_torch.core.partition import round_up


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """One point on the distribution axes, the reference's fields.

    ``layout``: "single" | "2d" | "halo".
    ``sp``/``ds``: rank-grid shape (2d); halo uses sp=n_devices, ds=1.
    ``exchange``: halo feature-exchange strategy.
    ``scatter_output``: 2d reduce-scatter variant.
    ``order``: halo node layout, "none" (contiguous ids) or "metis" (the
    multilevel k-way partition's order, ``core/cluster.py``).
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
    orders: tuple = ("none", "metis"),
) -> list[DistPlan]:
    """The distribution candidates for an ``n_devices`` budget, in the
    reference's order: the single-card plan, every factorization of the
    budget (with the ``scatter_output`` variant where ``sp > 1``), then
    every halo exchange × node order (``all_gather`` at order "none"
    only: its volume does not depend on the order)."""
    plans: list[DistPlan] = []
    if n_devices <= 1:
        return [DistPlan()] if "single" in layouts else []
    if "single" in layouts:
        plans.append(DistPlan())
    if "2d" in layouts:
        for sp in range(1, n_devices + 1):
            if n_devices % sp:
                continue
            ds = n_devices // sp
            plans.append(DistPlan("2d", sp, ds))
            if sp > 1:
                plans.append(DistPlan("2d", sp, ds, scatter_output=True))
    if "halo" in layouts:
        for order in orders:
            for ex in ("all_gather", "all_to_all", "ring"):
                if ex == "all_gather" and order != "none":
                    continue
                plans.append(DistPlan("halo", n_devices, 1, exchange=ex,
                                      order=order))
    return plans


def halo_statistics(
    csr: CsrGraph, nd: int, keep: "np.ndarray | None" = None,
    dev_of: "np.ndarray | None" = None,
) -> dict:
    """The measured cut of the ``nd``-way row partition, the reference's
    dict: ``halo_k`` (the most rows any shard requests of one peer,
    padded to 8: the all_to_all slot), the rows each shard receives by
    exchange (``a2a_recv_rows``, ``ring_recv_rows``: the sum over shifts
    of each shift's most, ``ag_recv_rows``), ``cut_rows_total`` (the
    distinct remote rows requested) and ``local_edge_fraction``.

    ``keep``: an edge mask in storage order — the cut of the masked
    subgraph (the hub core's edges stripped) without a stripped copy.
    ``dev_of``: a node → shard map (a k-way partition), the cut measured
    under that layout instead of contiguous ids."""
    n_pad = round_up(csr.nrows, nd)
    rpd = n_pad // nd
    rows_of = np.repeat(
        np.arange(csr.nrows, dtype=np.int64), np.diff(csr.rowptr)
    )
    colind = csr.colind
    if keep is not None:
        rows_of = rows_of[keep]
        colind = colind[keep]
    if dev_of is None:
        d_of = rows_of // rpd
        owner = colind.astype(np.int64) // rpd
    else:
        dev_of = np.asarray(dev_of, dtype=np.int64)
        d_of = dev_of[rows_of]
        owner = dev_of[colind]
    remote = d_of != owner
    if remote.any():
        # distinct (shard, peer, column) triples -> per-pair request sizes
        key = (d_of[remote] * nd + owner[remote]) * csr.ncols + colind[
            remote
        ].astype(np.int64)
        pair = np.unique(key) // csr.ncols
        counts = np.bincount(pair, minlength=nd * nd).reshape(nd, nd)
        k = int(counts.max())
        total_unique = int(counts.sum())
        # the ring: shift s's buffer is the most any receiver requests at
        # that shift (parallel/halo.py's ring plan), at least 8 rows
        ring_rows = 0
        for s in range(1, nd):
            k_s = int(max(counts[(d + s) % nd, d] for d in range(nd)))
            ring_rows += max(8, round_up(k_s, 8)) if k_s else 8
    else:
        k, total_unique = 0, 0
        ring_rows = 8 * (nd - 1)
    k_pad = max(1, round_up(k, 8))
    return {
        "halo_k": k_pad,
        "a2a_recv_rows": nd * k_pad,
        "ring_recv_rows": ring_rows,
        "ag_recv_rows": n_pad - rpd,
        "cut_rows_total": total_unique,
        "local_edge_fraction": float(
            (~remote).sum() / max(1, rows_of.shape[0])
        ),
    }
