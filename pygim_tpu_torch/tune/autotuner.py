"""The per-graph autotuner, the port of ``pygim_tpu/tune/autotuner.py``.

* :func:`plan_statistics` — per-candidate counters from the host plans
  (no device), per device of a :class:`~pygim_tpu_torch.tune.dist.DistPlan`
  (one card, an sp × ds grid or a halo partition): the reference's keys
  value for value, except ``device_bytes``, which reckons the port's
  residency on the largest shard (its tables, K-tail's plan, K-core's and
  K-f32's working set and stream-K workspace, K-bcsr's plan, its x block or
  exchange buffers and its output), and three keys of the port's own:
  ``launches`` (the PyTorch ops and kernel launches the one process issues
  for the whole product: every shard's, and the merge's or the
  exchange's), ``core_cell`` and ``bcsr_tile_dtype`` (which rate prices
  the core's and the tier's work).
* :func:`autotune` — ``mode='model'`` ranks the candidates of every
  distribution plan within ``n_devices`` by
  :func:`~pygim_tpu_torch.tune.cost_model.predict_spmm_time`, priced per
  device as if the devices ran at once; ``mode='measure'`` also times the
  three best that fit the given devices (CUDA events after a warm call)
  and picks the fastest. The search space, its gating, the stair
  candidates, the mesh candidates' rules and the BCSR second stage are
  the reference's.
* :func:`prepare_tuned` — the tuned plan prepared: one card, the 2D mesh
  or the halo layout over the given devices.

A virtual mesh (one card repeated) runs its shards one after another, so
a mesh candidate measures about ``nd`` times its prediction there and
measure mode picks ``single``; such a pick says nothing of real cards.
Results are cached per (graph fingerprint, width, devices, mode, space,
memory cap, the model's provenance) under the tuner's cache
(``tune/cost_model.py:cache_dir``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from typing import Optional

import numpy as np

from pygim_tpu_torch.core.graph import CsrGraph
from pygim_tpu_torch.core.partition import make_row_block_plan
from pygim_tpu_torch.ops.seg_rows import UNIT_ENTRIES
from pygim_tpu_torch.ops.spmm import SpmmConfig
from pygim_tpu_torch.tune.cost_model import (
    CardCostModel,
    cache_dir,
    predict_spmm_time,
)
from pygim_tpu_torch.tune.dist import DistPlan, enumerate_dist, halo_statistics
from pygim_tpu_torch.tune.space import For, Space

_log = logging.getLogger("pygim_tpu_torch.tune")

# the reference's default search space: balance × block budget × backend
DEFAULT_SPACE = (
    For("balance", ["nnz", "row"])
    * For("block_nnz_budget", [1 << 15, 1 << 17, 1 << 19])
    * For("backend", ["blocked", "ell", "hybrid"])
)

# the reference's hybrid extension: core budget × core dtype (int8 and
# int4 are gated to integer-valued graphs in autotune), pruned by the
# memory cap
HYBRID_SPACE = (
    For("backend", ["hybrid"])
    * For("hybrid_core_bytes",
          [1 << 30, 4 << 30, 6 << 30, 8 << 30, 12 << 30])
    * For("hybrid_dtype", [None, "bfloat16", "int8", "int4"])
    * For("balance", ["nnz"])
)

# The share of the card's memory (torch.cuda.mem_get_info's total) that
# autotune's default cap admits: the rest is left to the CUDA context,
# the caching allocator's rounding and the run path's temporaries beyond
# device_bytes. The reference's 0.875 was fitted to another chip's
# out-of-memory errors; no out-of-memory error of the port is on record
# to fit this one to.
HBM_FRACTION = 0.9

# The PyTorch ops and kernel launches of the port's run path
# (ops/spmm.py), each priced at CardCostModel.launch_us:
# blocked: K-rows' one launch whatever the block count, and one more that
# zeroes the hub rows where a row holds more than a unit's entries
# (ops/seg_rows.py);
# ell and hybrid: the output's zeros and K-tail's one launch;
RUN_OPS = 2
# a core: the rank gather, the payload's cast, and a launch a group of
# MAX_BANDS bands (K-core, K-f32); K-f32's split of an f32 payload into
# TF32 parts (core_f32.payload_parts) adds about ten;
CORE_OPS = 2
MAX_BANDS = 16
F32_SPLIT_OPS = 10
# a BCSR tier: K-bcsr's one launch.
BCSR_OPS = 1
# K-core's stream-K workspace: (grid, 2, 128, 128) f32 partials, a grid
# of 132 blocks on the H100 (core_dot.core_max_clusters)
STREAM_K_BYTES = 132 * 2 * 128 * 128 * 4


def blocked_launches(max_row_nnz: int) -> int:
    """Launches of the blocked body (K-rows) on a graph whose longest row
    holds ``max_row_nnz`` entries."""
    return 1 + int(max_row_nnz > UNIT_ENTRIES)


def _stair_mask(memo: dict, csr: CsrGraph, bands) -> np.ndarray:
    """O(nnz) staircase-membership mask, single-slot cached like
    :func:`_in_core_mask`."""
    key = tuple(map(tuple, bands))
    last = memo.get("stair_mask_last")
    if last is not None and last[0] == key:
        return last[1]
    rank, rows_of = memo["rank"], memo["rows_of"]
    rr, cc = rank[rows_of], rank[csr.colind]
    his = np.array([b[1] for b in bands], dtype=np.int64)
    ws = np.array([b[2] for b in bands], dtype=np.int64)
    idx = np.searchsorted(his, rr, side="right")
    mask = (idx < len(bands)) & (
        cc < ws[np.minimum(idx, len(bands) - 1)]
    )
    memo["stair_mask_last"] = (key, mask)
    return mask


def _in_core_mask(memo: dict, csr: CsrGraph, k: int) -> np.ndarray:
    """O(nnz) core-membership mask for core size ``k``. Only the most
    recent k's mask is kept (``memo["in_core_last"]``): the space has many
    distinct k, and a mask each would hold gigabytes at 100M+ edges."""
    last = memo.get("in_core_last")
    if last is not None and last[0] == k:
        return last[1]
    rank, rows_of = memo["rank"], memo["rows_of"]
    mask = (rank[rows_of] < k) & (rank[csr.colind] < k)
    memo["in_core_last"] = (k, mask)
    return mask


def _core_cell(config: SpmmConfig, csr: CsrGraph) -> str:
    """The core's cells as the port stores them: the config's dtype, else
    the graph's (f32 cells for a float64 graph), bf16 on an integer
    graph."""
    if config.hybrid_dtype is not None:
        return config.hybrid_dtype
    if np.issubdtype(csr.vals.dtype, np.floating):
        return "float32"
    return "bfloat16"


def mesh_launches(plan: DistPlan, shard: int, core: bool) -> int:
    """The ops and launches one process issues for a mesh product: every
    shard's ``shard`` (its zeros, K-tail, core and tier, as on one card)
    and those of the layout around them (``parallel/spmm_2d.py``,
    ``parallel/halo.py``, ``parallel/collectives.py``), a ``.to`` across
    devices counted as one op:

    * 2d: a copy of each shard's x block onto its device; the ``sp``
      merge, an add and a transfer a partial beyond the first of each ds
      column (``scatter_output``: of each of the sp row blocks, then the
      blocks' transfers and a cat); the ds columns' cat.
    * halo: each shard's x rows (and the order's gather); ``all_gather``:
      every shard receives every shard's rows and cats them;
      ``all_to_all``: a send gather a shard, then every shard receives a
      slot of every shard, cats and aligns them; ``ring``: a send gather
      and a transfer a shard a shift, a cat a shard; the halo tables'
      K-tail (not ``all_gather``); off ``all_gather``, a core's hub rows
      all_gathered and padded; the outputs' transfers, their cat and the
      order's inverse gather.
    """
    if plan.layout == "2d":
        sp, ds = plan.sp, plan.ds
        n = sp * ds * (shard + 1)
        if plan.scatter_output:
            n += ds * (2 * sp * (sp - 1) + sp + 1)
        else:
            n += ds * 2 * (sp - 1)
        return n + (1 if ds > 1 else 0)
    nd = plan.sp
    order = 2 if plan.order != "none" else 0
    n = nd * (shard + 1) + order + nd + 1
    if plan.exchange == "all_gather":
        n += nd * (nd + 1)
    elif plan.exchange == "all_to_all":
        n += nd + nd * (nd + 1) + nd + nd  # send gathers, slots, aligns
    else:
        n += 2 * nd * (nd - 1) + nd + nd  # shifts, cats, halo K-tail
    if core and plan.exchange != "all_gather":
        n += nd * (nd + 1) + nd
    return n


def plan_statistics(
    csr: CsrGraph,
    hidden: int,
    config: SpmmConfig,
    sp: int = 1,
    ds: int = 1,
    dtype_bytes: int = 4,
    plan: Optional[DistPlan] = None,
    halo_stats: Optional[dict] = None,
    _memo: Optional[dict] = None,
) -> dict:
    """One candidate's counters per device (module docstring): the
    reference's statistics and the port's keys. Byte counters are per
    device (the plans are balanced, so one device's time is the
    product's); ``psum_bytes`` is a device's volume of the plan's
    collective. ``halo_stats`` gives the halo cut
    (:func:`~pygim_tpu_torch.tune.dist.halo_statistics`) instead of
    measuring it; ``_memo`` caches graph-level intermediates across one
    :func:`autotune` call."""
    if plan is None:
        plan = DistPlan() if sp * ds == 1 else DistPlan("2d", sp, ds)
    sp, ds = plan.sp, plan.ds
    memo = _memo if _memo is not None else {}
    h_local = -(-hidden // ds)
    nb = config.resolve_n_blocks(max(1, csr.nnz // max(1, sp)))
    plan_rb = memo.get(("rbplan", nb, config.balance))
    if plan_rb is None:
        plan_rb = make_row_block_plan(csr, nb, balance=config.balance)
        memo[("rbplan", nb, config.balance)] = plan_rb
    nnz_per_block = (
        csr.rowptr[plan_rb.bounds[1:]] - csr.rowptr[plan_rb.bounds[:-1]]
    )
    core_bytes = 0
    bcsr = None
    stair_bands = None
    k_hybrid = None
    ell_scale = 1.0  # tail shrink from BCSR-tier capture
    launches = 0
    extra_bytes = 0  # the port's residency beyond the reference's terms
    if config.backend in ("ell", "hybrid"):
        from pygim_tpu_torch.core.partition import (
            assign_ell_tables,
            choose_degrees_for_config,
        )
        from pygim_tpu_torch.ops.ell_tail import unit_rows

        if "deg" not in memo:
            memo["deg"] = np.diff(csr.rowptr).astype(np.int64)
        deg = memo["deg"]
        launches = RUN_OPS
        if config.backend == "hybrid":
            # hub-core coverage: the degree-ranked top-k × top-k; a 2d
            # plan shards the core by columns, so a device's budget buys
            # a √sp larger core
            itemsize = {"bfloat16": 2, "int8": 1, "int4": 0.5}.get(
                config.hybrid_dtype, dtype_bytes
            )
            budget_eff = config.hybrid_core_bytes * max(1, sp)
            k = config.hybrid_k or min(
                csr.nrows,
                (int(np.sqrt(budget_eff / itemsize)) // 256) * 256,
            )
            if "rank" not in memo:
                total_deg = deg + np.bincount(
                    csr.colind, minlength=csr.ncols
                )[: csr.nrows]
                rank = np.empty(csr.nrows, dtype=np.int64)
                rank[np.argsort(-total_deg)] = np.arange(csr.nrows)
                memo["rank"] = rank
                memo["rows_of"] = np.repeat(
                    np.arange(csr.nrows, dtype=np.int64), deg
                )
            rank, rows_of = memo["rank"], memo["rows_of"]
            if config.hybrid_shape == "stair" and config.hybrid_k is None:
                # staircase region (core/stair.py), planned from one
                # memoized rank × rank histogram
                from pygim_tpu_torch.core.stair import (
                    plan_staircase,
                    stair_grid,
                )

                gd = memo.get("stair_grid")
                if gd is None:
                    gd = stair_grid(
                        rank[rows_of], rank[csr.colind], csr.nrows
                    )
                    memo["stair_grid"] = gd
                col_q = 512 if config.hybrid_dtype == "int4" else 256
                budget_cells = int(budget_eff / itemsize)
                bkey = ("stair", budget_cells, config.stair_max_bands,
                        col_q)
                stair_bands = memo.get(bkey)
                if stair_bands is None:
                    stair_bands = plan_staircase(
                        rank[rows_of], rank[csr.colind], csr.nrows,
                        budget_cells,
                        max_bands=config.stair_max_bands, col_quant=col_q,
                        _grid_data=gd,
                    )
                    memo[bkey] = stair_bands
                cells = sum((hi - lo) * w for lo, hi, w in stair_bands)
                core_bytes = int(cells * itemsize)
                k = stair_bands[-1][1] if stair_bands else 0
            else:
                core_bytes = int(k * k * itemsize) // max(1, sp)
            k_hybrid = k
            tkey = (
                ("tail_deg_stair", tuple(map(tuple, stair_bands)))
                if stair_bands is not None
                else ("tail_deg", k)
            )
            tail_deg = memo.get(tkey)
            if tail_deg is None:
                in_core = (
                    _stair_mask(memo, csr, stair_bands)
                    if stair_bands is not None
                    else _in_core_mask(memo, csr, k)
                )
                tail_deg = np.bincount(
                    rows_of[~in_core], minlength=csr.nrows
                ).astype(np.int64)
                memo[tkey] = tail_deg
            if config.hybrid_dtype in ("int4", "int8"):
                # integer cores demote out-of-range cells to the tail
                # (core/partition.py:int_demote_slab): an exact count of
                # the in-core values out of range, spread over the hubs
                dkey = (
                    ("demote_stair", tuple(map(tuple, stair_bands)))
                    if stair_bands is not None
                    else ("demote", k)
                )
                dem = memo.get(dkey)
                if dem is None:
                    in_core = (
                        _stair_mask(memo, csr, stair_bands)
                        if stair_bands is not None
                        else _in_core_mask(memo, csr, k)
                    )
                    iv = csr.vals[in_core]
                    s = iv[:: max(1, iv.size // 4096)]
                    dem = {"int4": 0, "int8": 0}
                    if s.size and np.all(s == np.round(s)):
                        dem["int4"] = int(((iv > 7) | (iv < -8)).sum())
                        dem["int8"] = int(
                            ((iv > 127) | (iv < -128)).sum()
                        )
                    memo[dkey] = dem
                demoted = dem[config.hybrid_dtype]
                if demoted:
                    tail_deg = tail_deg.copy()
                    hub = rank < min(k, csr.nrows)
                    tail_deg[hub] += demoted // max(1, int(hub.sum()))
            deg = tail_deg
            if config.bcsr_bytes > 0 and stair_bands is None:
                # the BCSR tier, priced by the sampled structure probe;
                # captured edges leave the tail uniformly in the model. A
                # 2d tier splits about the same tiles over sp shards; the
                # halo tier mines in-band tiles only, which the global
                # probe over-credits on an unordered partition (the
                # reference's estimate, kept)
                from pygim_tpu_torch.tune.bcsr_probe import bcsr_statistics

                # bf16 tiles beside a bf16 or int8 core, f32 otherwise
                bcsr_item = (
                    2
                    if (config.hybrid_dtype or "float32")
                    in ("bfloat16", "int8")
                    else 4
                )
                bcsr = bcsr_statistics(
                    csr, rank, rows_of, k,
                    tile_rows=config.bcsr_tile,
                    order=config.bcsr_order,
                    budget_bytes=config.bcsr_bytes,
                    hidden=hidden,
                    itemsize=bcsr_item,
                    min_edges=config.bcsr_min_edges,
                    _memo=memo,
                )
                ell_scale = max(
                    0.0,
                    1.0 - bcsr["captured_edges"]
                    / max(1, bcsr["tail_edges"]),
                )
        # the multi-degree ELL tables exactly as prepare plans them (the
        # same helpers, which read config.hidden_hint like prepare)
        d_list = choose_degrees_for_config(deg, config)
        pick = assign_ell_tables(
            deg, d_list, hidden=config.hidden_hint
        )
        n_vr_total = 0
        padded = 0
        units = 0
        for gi, d_g in enumerate(d_list):
            sub = deg[pick == gi]
            if sub.size == 0:
                continue
            nv = int((-(-sub // d_g)).sum())
            n_vr_total += nv
            padded += nv * d_g
            units += -(-nv // unit_rows(d_g))
        padded_nnz = int(padded * ell_scale)
        # merge of virtual rows: one write + one scattered read per vrow
        scatter_bytes = int(
            2 * n_vr_total * h_local * dtype_bytes * ell_scale
        )
        ell_vrows = int(n_vr_total * ell_scale)
        # vrow_to_row and K-tail's plan: a slot count a virtual row and a
        # unit's two words, split over the shards
        extra_bytes += (8 * n_vr_total + 8 * units) // max(1, sp)
    else:
        ell_vrows = None
        padded_nnz = nb * plan_rb.nnz_pad
        # the reference's blocked materializes each block's gathered
        # contribution and scatter-reads it (K-rows does neither)
        scatter_bytes = 2 * padded_nnz * h_local * dtype_bytes
        launches = blocked_launches(int(np.diff(csr.rowptr).max(initial=0)))
        # rowloc a slot, row_slot a row, and K-rows' plan: the inverse slot
        # map and a unit's four words about every UNIT_ENTRIES entries
        extra_bytes += (4 * padded_nnz + 4 * csr.nrows
                        + 4 * nb * plan_rb.rows_pad
                        + 16 * (-(-padded_nnz // UNIT_ENTRIES) + csr.nrows
                                // 64))

    core_cell = None
    if core_bytes > 0:
        core_cell = _core_cell(config, csr)
        n_bands = len(stair_bands) if stair_bands is not None else 1
        if stair_bands:
            w_max = max(w for *_, w in stair_bands)
        elif plan.layout == "2d":
            w_max = -(-k_hybrid // sp)  # a shard's slab columns
        else:
            w_max = k_hybrid  # one card's core, a halo shard's hub buffer
        launches += CORE_OPS + -(-n_bands // MAX_BANDS)
        # core_nodes, the rank gather xc (f32) and its cast
        extra_bytes += 4 * csr.nrows + w_max * h_local * 6
        if core_cell == "float32":
            # K-f32's TF32 parts of an f32 payload
            launches += F32_SPLIT_OPS
            extra_bytes += 2 * w_max * h_local * 4
        else:
            extra_bytes += STREAM_K_BYTES

    # per device: the 2d column split and the halo row split both divide
    # the edges about evenly over sp devices
    nnz_dev = padded_nnz // max(1, sp)
    scatter_dev = scatter_bytes // max(1, sp)
    out_rows_dev = (
        -(-csr.nrows // sp)
        if plan.layout == "halo" or plan.scatter_output
        else csr.nrows
    )
    gather_bytes = nnz_dev * h_local * dtype_bytes
    stream_bytes = (
        nnz_dev * (4 + dtype_bytes) + out_rows_dev * h_local * dtype_bytes
    )

    # the collective's volume a device
    n_collectives = 1
    collective = None
    psum_bytes = 0
    recv_rows = 0  # the rows a halo shard's exchange delivers
    if plan.layout == "2d" and sp > 1:
        collective = "psum"
        merge_rows = csr.nrows * h_local * dtype_bytes
        frac = (sp - 1) / sp
        # psum ≈ reduce-scatter + all-gather; scatter_output keeps only
        # the reduce-scatter half
        psum_bytes = int(
            merge_rows * frac * (1 if plan.scatter_output else 2)
        )
    elif plan.layout == "halo":
        # the hub core's edges leave before the exchange is planned
        # (parallel/halo.py:_plan_core_halo), so a hybrid's cut is the
        # stripped tail's; only the small stats dict is memoized, per
        # (sp, order[, k])
        hkey = ("halo", sp, plan.order)
        if k_hybrid and core_bytes > 0:
            hkey = ("halo", sp, plan.order, k_hybrid)
        if halo_stats is None:
            halo_stats = memo.get(hkey)
            if halo_stats is None:
                keep = (
                    ~_in_core_mask(memo, csr, k_hybrid)
                    if k_hybrid and core_bytes > 0
                    else None
                )
                dev_of = None
                if plan.order == "metis":
                    # one partitioner run per device count, shared by
                    # every (config, exchange) candidate at this nd
                    dev_of = memo.get(("metis_part", sp))
                    if dev_of is None:
                        from pygim_tpu_torch.core.cluster import (
                            partition_kway,
                        )

                        dev_of = partition_kway(csr, sp)
                        memo[("metis_part", sp)] = dev_of
                halo_stats = halo_statistics(
                    csr, sp, keep=keep, dev_of=dev_of
                )
                memo[hkey] = halo_stats
        recv_rows = {
            "all_to_all": halo_stats["a2a_recv_rows"],
            "ring": halo_stats["ring_recv_rows"],
            "all_gather": halo_stats["ag_recv_rows"],
        }[plan.exchange]
        psum_bytes = recv_rows * hidden * dtype_bytes
        n_collectives = sp - 1 if plan.exchange == "ring" else 1
        collective = plan.exchange
        if k_hybrid and core_bytes > 0 and plan.exchange != "all_gather":
            # the hub core's features: every shard receives the ~k hub
            # rows by one small all_gather (all_gather's exchange takes
            # them from the x it already holds)
            psum_bytes += int(k_hybrid * hidden * dtype_bytes)

    # BCSR middle tier (probed estimates): the tile store, its panels
    # read and partials added, and the tile products, a device's share
    bcsr_stream = bcsr_flops = bcsr_store = 0
    bcsr_tile_dtype = None
    if bcsr is not None and bcsr["n_tiles"]:
        tr, tc = config.bcsr_tile, 128
        slots, n_vb = bcsr["slots"], bcsr["n_vb"]
        bcsr_store = slots * tr * tc * bcsr_item // max(1, sp)
        bcsr_stream = (
            bcsr_store
            + (slots * tc * h_local * dtype_bytes) // max(1, sp)
            + (2 * n_vb * tr * h_local * dtype_bytes) // max(1, sp)
        )
        bcsr_flops = 2 * slots * tr * tc * h_local // max(1, sp)
        bcsr_tile_dtype = "bfloat16" if bcsr_item == 2 else "float32"
        launches += BCSR_OPS
        # K-bcsr's plan (an entry a tile), the panel and row-block index
        # tables and their node lists
        extra_bytes += (16 * slots + 4 * tc * bcsr["n_panels"]
                        + 4 * tr * bcsr["n_rb"]) // max(1, sp)

    # the port's residency on the largest device: its tables (vals f32),
    # the core, the tile store, the run path's plans and temporaries, and
    # its x and output. On a mesh the first device also holds the
    # caller's x and the gathered (nrows, hidden) f32 product.
    x_all = csr.ncols * hidden * dtype_bytes
    if plan.layout == "single":
        io_bytes = (csr.ncols * h_local * dtype_bytes
                    + out_rows_dev * h_local * dtype_bytes)
    elif plan.layout == "2d":
        # its x block and its (nrows, h_local) f32 partial
        io_bytes = (x_all + (-(-csr.ncols // sp)) * h_local * dtype_bytes
                    + csr.nrows * h_local * 4)
        if ds > 1 or plan.scatter_output:
            io_bytes += csr.nrows * hidden * 4
    else:
        # its x rows, its exchange buffer (all_gather: all of x), its f32
        # output rows, and x in the partition's order
        buf_rows = recv_rows + (out_rows_dev if plan.exchange
                                == "all_gather" else 0)
        io_bytes = (x_all + csr.nrows * hidden * 4
                    + out_rows_dev * hidden * (dtype_bytes + 4)
                    + buf_rows * hidden * dtype_bytes
                    + (x_all if plan.order != "none" else 0))
    device_bytes = (
        nnz_dev * (4 + dtype_bytes)
        + core_bytes
        + bcsr_store
        + io_bytes
        + extra_bytes
    )
    if plan.layout != "single":
        launches = mesh_launches(plan, launches, core_bytes > 0)

    return {
        "scatter_bytes": scatter_dev,
        "core_bytes": core_bytes,
        # 2 flops a cell a local column (int4's unpack priced at 1.25×,
        # the reference's)
        "core_flops": int(
            2 * h_local
            * (core_bytes / {"bfloat16": 2, "int8": 1, "int4": 0.5}.get(
                config.hybrid_dtype, dtype_bytes))
            * (1.25 if config.hybrid_dtype == "int4" else 1.0)
        ),
        "core_cell": core_cell,
        "bcsr_stream_bytes": bcsr_stream,
        "bcsr_flops": bcsr_flops,
        "bcsr_captured": 0 if bcsr is None else bcsr["captured_edges"],
        "bcsr_tile_dtype": bcsr_tile_dtype,
        "gather_bytes": gather_bytes,
        # the ELL tail's padded slots and virtual rows a device (None for
        # blocked) and the width that sets its per-row cost
        "ell_slots": nnz_dev if ell_vrows is not None else None,
        "ell_vrows": (
            ell_vrows // max(1, sp) if ell_vrows is not None else None
        ),
        "ell_hidden": h_local,
        "stream_bytes": stream_bytes,
        "psum_bytes": psum_bytes,
        "collective": collective,
        "device_bytes": device_bytes,
        "max_nnz_per_block": int(nnz_per_block.max(initial=0)),
        "mean_nnz_per_block": float(nnz_per_block.mean()) if nb else 0.0,
        "pad_fraction": float(padded_nnz / max(1, csr.nnz)) - 1.0,
        "n_blocks": nb,
        "n_dispatch": n_collectives,
        "rows_pad": plan_rb.rows_pad,
        "nnz_pad": plan_rb.nnz_pad,
        "launches": launches,
    }


def _integer_valued(csr: CsrGraph) -> bool:
    """True where the edge values can ride an exact int8 or int4 core:
    integer dtypes, and float graphs whose sampled values are integers
    (unweighted adjacencies; the rare out-of-range cell demotes to the
    tail at prepare)."""
    if np.issubdtype(csr.vals.dtype, np.integer):
        return True
    if not np.issubdtype(csr.vals.dtype, np.floating):
        return False
    sample = csr.vals[:: max(1, csr.vals.size // 4096)]
    return bool(np.all(sample == np.round(sample)))


def _fingerprint(csr: CsrGraph, hidden: int) -> str:
    h = hashlib.sha256()
    h.update(np.asarray([csr.nrows, csr.ncols, csr.nnz, hidden]).tobytes())
    h.update(csr.rowptr[:: max(1, csr.nrows // 64)].tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class TuneResult:
    config: SpmmConfig
    plan: DistPlan
    predicted_s: float
    measured_s: Optional[float]
    candidates: list  # (config_dict, plan_dict, predicted_s, measured_s|None)
    # the cost model's provenance (CardCostModel.provenance)
    constants: str = "datasheet"
    # measure-mode candidates that raised, as (config_dict, plan_dict,
    # "ExcType: message"): recorded, never dropped
    skipped: list = dataclasses.field(default_factory=list)


def default_devices(device, n_devices: int) -> list:
    """The devices a tuned plan may span: the visible cards for a CUDA
    ``device``, else ``[device] * n_devices`` (copies of the CPU, as
    ``compat.py`` lays a CPU mesh). A list may repeat a device: a virtual
    mesh."""
    import torch

    from pygim_tpu_torch.parallel.mesh import visible_cards

    dev = torch.device(device)
    if dev.type == "cuda":
        return visible_cards()
    return [dev] * max(1, n_devices)


def prepare_tuned(graph, result: TuneResult, device="cuda", devices=None):
    """The tuned (config, plan) prepared: a single-card plan on
    ``device`` (``prepare_spmm``), a ``2d`` plan on
    ``make_mesh(sp, ds, devices)`` (``prepare_spmm_2d`` with its
    ``scatter_output``), a ``halo`` plan on ``make_node_mesh(nd,
    devices)`` (``prepare_spmm_halo`` with its exchange and order).
    ``devices`` defaults to :func:`default_devices`; fewer than the plan
    spans raise ``ValueError``."""
    plan = result.plan
    if plan.layout == "single":
        from pygim_tpu_torch.ops.spmm import prepare_spmm

        return prepare_spmm(graph, result.config, device=device)
    if devices is None:
        devices = default_devices(device, plan.n_devices)
    if len(devices) < plan.n_devices:
        raise ValueError(f"{plan.describe()} spans {plan.n_devices} "
                         f"devices, {len(devices)} given")
    if plan.layout == "2d":
        from pygim_tpu_torch.parallel.mesh import make_mesh
        from pygim_tpu_torch.parallel.spmm_2d import prepare_spmm_2d

        return prepare_spmm_2d(graph, make_mesh(plan.sp, plan.ds, devices),
                               result.config,
                               scatter_output=plan.scatter_output)
    from pygim_tpu_torch.parallel.halo import make_node_mesh, prepare_spmm_halo

    return prepare_spmm_halo(
        graph, make_node_mesh(plan.sp, devices), result.config,
        exchange=plan.exchange,
        order=None if plan.order == "none" else plan.order,
    )


def default_hbm_budget(device) -> Optional[int]:
    """The default memory cap: :data:`HBM_FRACTION` of the card's memory
    on a CUDA device, none elsewhere."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(dev)[1] * HBM_FRACTION)


def mesh_hbm_budget(devices) -> Optional[int]:
    """The default cap of a shard of a mesh over ``devices``: each card's
    :func:`default_hbm_budget` over the shards it holds (a virtual mesh
    puts them all on one card), the least of them; none off CUDA."""
    import torch

    devices = [torch.device(d) for d in devices]
    caps = []
    for d in dict.fromkeys(devices):
        cap = default_hbm_budget(d)
        if cap is None:
            return None
        caps.append(cap // devices.count(d))
    return min(caps) if caps else None


def autotune(
    graph,
    hidden: int,
    space: Optional[Space] = None,
    *,
    n_devices: int = 1,
    layouts: tuple = ("single", "2d", "halo"),
    mode: str = "model",
    model: Optional[CardCostModel] = None,
    use_cache: bool = True,
    repeats: int = 3,
    dtype_bytes: int = 4,
    hbm_budget_bytes: Optional[int] = None,
    device="cuda",
    devices=None,
) -> TuneResult:
    """Pick the best (SpmmConfig, DistPlan) for ``graph`` × width ``hidden``
    within a budget of ``n_devices`` devices.

    ``mode='model'`` ranks every candidate of every plan of
    :func:`~pygim_tpu_torch.tune.dist.enumerate_dist` by the cost model
    (``model``, default :meth:`CardCostModel.default`), a mesh priced per
    device as if its devices ran at once. ``mode='measure'`` (default
    model :meth:`CardCostModel.measured`, and above one device
    :meth:`CardCostModel.for_topology`, which adds the collectives'
    constants measured over ``devices``) also prepares and times the three
    best-predicted candidates that fit ``devices`` and picks the fastest;
    a candidate that raises is recorded in ``skipped``. The candidates
    follow the reference's rules: halo plans only on a square graph,
    ``2d`` and ``halo`` plans only for ``ell`` and ``hybrid``, stair
    cores on one card only, int8 and int4 cores only on integer-valued
    graphs, and the BCSR variants of the best single-card square hybrid.

    ``devices``: what a plan spans (default :func:`default_devices`: the
    visible cards, or ``[device] * n_devices`` off CUDA); it may repeat a
    device. ``hbm_budget_bytes`` caps a candidate's ``device_bytes``, a
    device's residency; its default is the card's
    (:func:`default_hbm_budget`) and, for a mesh plan, that cap over the
    shards each card of ``devices`` holds (:func:`mesh_hbm_budget`), so a
    virtual mesh admits only what its one card holds. A CUDA ``device``
    without a card raises."""
    import torch

    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.parallel.mesh import is_virtual

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"autotune: device {device!r} but no CUDA card")
    if devices is None:
        devices = default_devices(dev, n_devices)
    devices = [torch.device(d) for d in devices]
    dists = enumerate_dist(n_devices, layouts)
    # price the merged graph, which every prepare path runs on
    graph, _ = merge_duplicate_edges(graph)
    csr = graph if isinstance(graph, CsrGraph) else graph.to_csr()
    if space is None:
        # the backends, the hybrid knobs, and a stair variant of every
        # hybrid point but int4 (the reference's measured exclusion)
        pts, seen = [], set()
        stair_pts = [
            {**q, "hybrid_shape": "stair"}
            for q in HYBRID_SPACE
            if q.get("hybrid_dtype") != "int4"
        ]
        for p in list(DEFAULT_SPACE) + list(HYBRID_SPACE) + stair_pts:
            j = json.dumps(p, sort_keys=True)
            if j not in seen:
                seen.add(j)
                pts.append(p)
        space = pts
    # the memory cap of a device of each plan's size
    caps = {}
    for dist in dists:
        nd = dist.n_devices
        if nd not in caps:
            caps[nd] = (hbm_budget_bytes if hbm_budget_bytes is not None
                        else default_hbm_budget(dev) if nd == 1
                        else mesh_hbm_budget(devices[:nd]))
    if model is None:
        if mode != "measure":
            model = CardCostModel.default()
        elif n_devices > 1:
            model = CardCostModel.for_topology(n_devices, devices)
        else:
            model = CardCostModel.measured(dev)
    # every candidate carries the tuned width: prepare's ELL planner reads
    # hidden_hint
    points = [
        {"hidden_hint": hidden, **p} for p in space
    ]
    key = path = None
    if use_cache:
        space_h = hashlib.sha256(
            json.dumps(points, sort_keys=True).encode()
        ).hexdigest()[:8]
        model_h = hashlib.sha256(model.provenance.encode()).hexdigest()[:8]
        cap_tag = "_".join(str(caps[nd]) for nd in sorted(caps)
                           if caps[nd])
        key = (
            _fingerprint(csr, hidden)
            + f"-{mode}-nd{n_devices}-{'.'.join(sorted(layouts))}"
            + f"-sp{space_h}-db{dtype_bytes}"
            + (f"-hbm{cap_tag}" if cap_tag else "")
            + f"-c{model_h}"
        )
        if n_devices > 1:
            # what the mesh plans span: a virtual mesh's pick is never
            # served for real cards
            span = devices[:n_devices]
            key += (f"-{span[0].type}{len(span)}"
                    + ("v" if is_virtual(span) else ""))
        path = cache_dir() / f"tune-{key}.json"
        if path.exists():
            try:
                d = json.loads(path.read_text())
                return TuneResult(
                    config=SpmmConfig(**d["config"]),
                    plan=DistPlan(**d.get("plan", {})),
                    predicted_s=d["predicted_s"],
                    measured_s=d.get("measured_s"),
                    candidates=d["candidates"],
                    constants=d.get("constants", "datasheet"),
                    skipped=d.get("skipped", []),
                )
            except (OSError, ValueError, KeyError, TypeError) as e:
                _log.warning("tune cache %s unreadable (%s): tuning again",
                             path, e)

    square = csr.nrows == csr.ncols
    integer = _integer_valued(csr)
    memo: dict = {}
    scored = []
    for dist in dists:
        if dist.layout == "halo" and not square:
            continue
        cap = caps[dist.n_devices]
        for point in points:
            cfg = SpmmConfig(**point)
            # the mesh layouts run ell and hybrid shards, with the square
            # core only
            if dist.layout != "single" and cfg.backend not in (
                    "ell", "hybrid"):
                continue
            if cfg.backend == "hybrid" and not square:
                continue
            if cfg.hybrid_shape == "stair" and dist.layout != "single":
                continue
            # int8 and int4 cores hold exact small integers: offered for
            # integer-valued graphs only
            if cfg.hybrid_dtype in ("int8", "int4") and not integer:
                continue
            stats = plan_statistics(
                csr, hidden, cfg, plan=dist, dtype_bytes=dtype_bytes,
                _memo=memo,
            )
            if cap is not None and stats["device_bytes"] > cap:
                continue
            scored.append((point, dist, predict_spmm_time(stats, model)))
    if not scored:
        raise ValueError(
            "no feasible candidate (hbm_budget_bytes too small?)"
        )
    scored.sort(key=lambda s: s[2])

    # second stage: BCSR tier variants (tile budget × order) of the best
    # single-card square hybrid, priced by the sampled probe for that one
    # core
    base = next(
        (
            (p, d)
            for p, d, _ in scored
            if d.layout == "single"
            and p.get("backend") == "hybrid"
            and not p.get("bcsr_bytes")
            and p.get("hybrid_shape", "square") != "stair"
        ),
        None,
    )
    if square and base is not None:
        bp, bd = base
        for order in ("rank", "lp"):
            for bb in (1 << 30, 5 << 29):  # 1 GiB, 2.5 GiB tile store
                point = {**bp, "bcsr_bytes": bb, "bcsr_order": order}
                cfg = SpmmConfig(**point)
                stats = plan_statistics(
                    csr, hidden, cfg, plan=bd, dtype_bytes=dtype_bytes,
                    _memo=memo,
                )
                cap = caps[bd.n_devices]
                if cap is not None and stats["device_bytes"] > cap:
                    continue
                if stats["bcsr_captured"] == 0:
                    continue  # no qualifying tiles: the base itself
                scored.append(
                    (point, bd, predict_spmm_time(stats, model))
                )
        scored.sort(key=lambda s: s[2])

    def _mkey(point, dist):
        return json.dumps(
            {**point, "__dist": dataclasses.asdict(dist)}, sort_keys=True
        )

    measured: dict = {}
    skipped: list = []
    if mode == "measure":
        cands = [(p, d) for p, d, _ in scored
                 if d.n_devices <= len(devices)][:3]
        measured, skipped = _measure(csr, hidden, cands, repeats, dev,
                                     devices, _mkey)

    if measured:
        best_point, best_dist = min(
            ((p, d) for p, d, _ in scored if _mkey(p, d) in measured),
            key=lambda pd: measured[_mkey(*pd)],
        )
        best_measured = measured[_mkey(best_point, best_dist)]
    else:
        (best_point, best_dist), best_measured = scored[0][:2], None

    result = TuneResult(
        config=SpmmConfig(**best_point),
        plan=best_dist,
        predicted_s=next(
            t for p, d, t in scored if p == best_point and d == best_dist
        ),
        measured_s=best_measured,
        candidates=[
            (p, dataclasses.asdict(d), t, measured.get(_mkey(p, d)))
            for p, d, t in scored
        ],
        constants=model.provenance,
        skipped=skipped,
    )
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(
            json.dumps(
                {
                    "config": dataclasses.asdict(result.config),
                    "plan": dataclasses.asdict(result.plan),
                    "predicted_s": result.predicted_s,
                    "measured_s": result.measured_s,
                    "candidates": result.candidates,
                    "constants": result.constants,
                    "skipped": result.skipped,
                }
            )
        )
    return result


def _measure(csr, hidden, cands, repeats, dev, devices, mkey):
    """Seconds a ``mul`` of each candidate (``[(point, dist)]``): prepared
    by :func:`prepare_tuned` on ``dev`` or over ``devices``, ``repeats``
    warm calls (the first builds the kernels' per-width plans; over four
    cards a single warm call left the first candidate timed 5-20× its
    steady time), then ``repeats`` calls timed by
    :func:`~pygim_tpu_torch.utils.timers.device_time` on the product's
    device. A candidate that raises (out of memory included)
    goes into the skipped list with its message, and the cards' cached
    blocks are freed."""
    import torch

    from pygim_tpu_torch.utils.timers import device_time

    measured, skipped = {}, []
    x = torch.as_tensor(
        np.random.default_rng(0).standard_normal((csr.ncols, hidden)),
        dtype=torch.float32,
    ).to(dev)
    for point, dist in cands:
        shim = TuneResult(SpmmConfig(**point), dist, 0.0, None, [])
        prep = None
        try:
            prep = prepare_tuned(csr, shim, device=dev, devices=devices)
            measured[mkey(point, dist)] = device_time(
                prep.mul, x, iters=repeats, warmup=max(1, repeats))
        except Exception as e:  # noqa: BLE001 — recorded, never dropped
            err = f"{type(e).__name__}: {e}"
            _log.warning("measure-mode candidate skipped: %s %s: %s",
                         point, dataclasses.asdict(dist), err)
            skipped.append((point, dataclasses.asdict(dist), err))
        finally:
            del prep
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return measured, skipped
