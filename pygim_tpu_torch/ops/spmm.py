"""Prepare-once / run-many SpMM on one CUDA card.

Counterpart of ``pygim_tpu/ops/spmm.py`` for the backends it carries:

``hybrid``  a hub-core, an optional BCSR tile tier and a multi-degree
            ELL tail (the headline path). The core is the square
            ``[0, k)²`` block of the degree ranks or a staircase of row
            bands of tapering width, of int8
            cells, int4 cells nibble-packed two a byte, bf16 cells or f32
            cells (``hybrid_dtype=None``: the graph's own float dtype, or
            bf16 on an integer graph, as the reference).
            :func:`prepare_spmm` plans on the host in NumPy (duplicate
            merge, degree rank, the core's fill, ELL tail) and moves the
            tables to the device. The host tables of an operand on the
            card are cached on disk (``utils/cache.py``: the reference's
            key and contents under the port's own directory and file
            prefix). With ``bcsr_bytes > 0`` a square build adds the
            tile tier (``core/bcsr.py``): dense ``(bcsr_tile, 128)``
            tiles of the rank-space band outside the core, row- or
            panel-major (``bcsr_layout``), in the ``rank``, ``rcm`` or
            ``lp`` order (``bcsr_order``); bf16 tiles beside an int8 or
            bf16 core, f32 otherwise; its edges leave the tail. A stair
            build ignores the budget, as the reference's.
``ell``     the whole merged graph in the same multi-degree ELL tables,
            no core: K-tail alone.
``blocked`` the reference's default: nnz-balanced row blocks padded to
            one static shape (``colind``, ``vals``, ``rowloc``,
            ``row_slot``), every block's rows summed by K-rows
            (``ops/seg_rows.py``) in one launch into an output of the
            accumulation dtype (f32 for a float payload or weights, int32
            wrapping for integer ones).
``coo``     the merged edges sorted by row in exact-nnz chunks
            (``core/partition.py:build_coo_chunks``, rows may straddle
            chunks), the whole row-sorted stream summed by K-rows in one
            launch, in the same accumulation dtype.
``oracle``  the raw edges (no merge) sorted by row, through the COO
            oracle of ``ops/reference.py`` in plain PyTorch ops.

Edge values may be float32, float64 or integer. Float64 values are
merged and fill the core in float64, as the reference's; every ELL value
table reaches the device as float32 (K-tail's weights), where the
reference's ``jnp.asarray`` (x64 off) casts it.

The hybrid's :meth:`PreparedSpmm.mul` computes ``A @ x`` as

1. ``out = zeros(N, H)``;
2. K-tail over every ELL table into ``out``, one launch
   (``ops/ell_tail.py``);
3. the core over all bands into ``out`` at ``core_nodes[lo:hi]``, one
   launch (a square core is the one band ``(0, k, k)``, its rows
   ``core_nodes[:k]``), on ``xc = x[core_nodes[:max w]]``: on int8 or
   int4 cells, for a float x ``bf16(xc)`` through K-core
   (``ops/core_dot.py``; where H is not a multiple of 8, on ``xc`` and
   ``out`` padded with zero columns to the next multiple, cut back to H),
   for an integer x K-int (``ops/core_int.py``), the exact int32 product
   wrapped as the reference's, added as f32; on bf16 cells K-core's bf16
   mode (a float or int8 x, as bf16) or K-f32 (an int16 or int32 x, both
   operands in f32; ``ops/core_f32.py``); on f32 cells K-f32
   (:meth:`PreparedSpmm._core_add`);
4. the BCSR tier, where there is one: K-bcsr (``ops/bcsr.py``), one
   launch, tiles times panels of x scatter-added at their rows

— the order of the reference's hybrid run; ``ell`` runs step 2 alone.

The kernels write through raw pointers, so autograd cannot follow them:
:class:`SpmmFunction` is the differentiable ``A @ x`` of the ``hybrid``,
``ell``, ``blocked`` and ``coo`` backends, its backward ``Aᵀ @ g``
through the same kernels (K-core, K-f32, K-tail, K-rows) on
:meth:`PreparedSpmm.transpose`, the transposed graph prepared once with
the same configuration by the caller that trains.
:class:`PreparedAggregate` takes it wherever grad mode is on and the
payload requires grad; ``oracle`` runs PyTorch ops, which autograd
follows as they are.
:meth:`PreparedSpmm.mul_quantized`
is the fused quantize → aggregate → dequantize of the reference's
``raw_mul_quantized``. The host tables are the reference's bit for bit.
Payloads are float32, bfloat16 (K-tail's bf16-row mode) and int8,
int16, int32 or int64 (taken as int32, as the reference with x64 off).
The tuner that picks a config per graph is ``tune/autotuner.py``.

With ``PYGIM_HYBRID_INTERLEAVE=1`` at prepare, a square core that the
reference would interleave with its tail (:func:`interleave_plan`, kept
as ``PreparedSpmm.interleave``) runs beside the tail on the card: the
core's product goes on a second CUDA stream into a compact ``(k, H)``
f32 buffer while K-tail writes ``out`` on the caller's stream, and after
the join the buffer is added at ``core_nodes`` — the reference's order,
tail first, then ``out.at[core_nodes].add``
(:meth:`PreparedSpmm._interleaved`). The int32 quantized path (a
``safe`` divisor, no table) stays serial, as the reference's. The 2D
``sp × ds`` mesh is ``parallel/spmm_2d.py``; its shards are operands of
this class built from host tables (:meth:`PreparedSpmm.from_host`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.core.banded import core_build_banded, f32_to_bf16_bits
from pygim_tpu_torch.core.bcsr import (
    build_bcsr_panels,
    build_bcsr_tiles,
    tail_tile_order,
)
from pygim_tpu_torch.core.graph import CooGraph, CsrGraph, merge_duplicate_edges
from pygim_tpu_torch.core.partition import (
    build_coo_chunks,
    build_ell_blocks,
    build_ell_rows_multi,
    choose_degrees_for_config,
    int_demote_slab,
    make_row_block_plan,
    pack_nibbles,
    round_up,
    row_slot_table,
)
from pygim_tpu_torch.core.stair import plan_staircase
from pygim_tpu_torch.ops.bcsr import bcsr_add, bcsr_plain, bcsr_plan
from pygim_tpu_torch.ops.core_dot import (
    core_bands_plain,
    core_bands_scatter_add,
    core_plans,
)
from pygim_tpu_torch.ops.core_f32 import (
    core_f32_plain,
    core_f32_plans,
    core_f32_scatter_add,
)
from pygim_tpu_torch.ops.core_int import (
    QUANT_LIMBS,
    RAW_LIMBS,
    core_int_plain,
    core_int_plans,
    core_int_scatter_add,
)
from pygim_tpu_torch.ops.ell_tail import (
    PAYLOADS,
    ell_tables_add,
    ell_tables_plain,
    tail_plan,
)
from pygim_tpu_torch.ops.quant_prologue import (
    abs_max_scale,
    abs_max_scale_plain,
    core_payload,
    payload_dims,
    quant_table,
    quant_table_plain,
)
from pygim_tpu_torch.ops.reference import (
    spmm_coo_oracle,
    spmm_coo_oracle_chunked,
)
from pygim_tpu_torch.ops.seg_rows import (
    blocked_plan,
    blocked_rows,
    blocked_spmm,
    coo_plain,
    coo_plan,
    coo_rows,
)
from pygim_tpu_torch.quant import _SCALE_EXP, dtype_name
from pygim_tpu_torch.utils.cache import LOAD_ERRORS, cache_dir, save_npz
from pygim_tpu_torch.utils.timers import PhaseTimer, device_time

_log = logging.getLogger("pygim_tpu_torch")

BACKENDS = ("hybrid", "ell", "blocked", "coo", "oracle")
# the hybrid core cells a config may name; None means the graph's own
# dtype (float32 or float64 cells), or bfloat16 on an integer graph
CORE_DTYPES = ("int8", "int4", "bfloat16", "float32")
INT_CORES = ("int8", "int4")
CORE_SHAPES = ("square", "stair")
# bytes of one core cell, which size the core against its budget: two
# int4 cells share a byte; a float64 core (a float64 graph with
# hybrid_dtype None) is sized at 8 bytes and stored as float32 cells, as
# the reference's (pygim_tpu/ops/spmm.py:1120-1127)
CELL_BYTES = {"int4": 0.5, "int8": 1.0, "bfloat16": 2.0, "float32": 4.0,
              "float64": 8.0}
# the kernels' stored-width rule of each core, in cells: every row a
# multiple of 16 bytes (the TMA row stride of K-core and K-int; K-f32's
# 16-byte loads), and whole 16-deep steps for K-core's bf16 wgmmas
WIDTH_RULE = {"int4": 32, "int8": 16, "bfloat16": 16, "float32": 4,
              "float64": 4}


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    """Runtime configuration: the reference's fields and defaults. The
    port runs the backends of :data:`BACKENDS`; on ``hybrid``, a square
    or stair core (:data:`CORE_SHAPES`) of int8, int4, bfloat16 or
    float32 cells (:data:`CORE_DTYPES`), or of the graph's own dtype
    (``hybrid_dtype=None``), at any budget (none at ``hybrid_core_bytes
    <= 0``) or a pinned ``hybrid_k``, and on a square build the BCSR tier
    (``bcsr_*``). :meth:`check_supported` raises on anything else."""

    format: str = "csr"              # csr | coo
    backend: str = "blocked"         # oracle | blocked | ell | coo | hybrid
    balance: str = "nnz"             # nnz | row
    n_blocks: Optional[int] = None
    block_nnz_budget: int = 1 << 17  # ~slots gathered per ELL step
    ell_degree: Optional[int] = None # pinned ELL degree (auto = None)
    ell_tables: int = 3              # max multi-degree ELL tables
    hidden_hint: int = 256           # expected dense width (ELL planner)
    hybrid_k: Optional[int] = None         # square core size
    hybrid_core_bytes: int = 4 << 30       # core memory budget
    hybrid_dtype: Optional[str] = None     # core cell dtype
    bcsr_bytes: int = 0
    bcsr_tile: int = 32
    bcsr_min_edges: int = 0
    bcsr_order: str = "rank"
    bcsr_layout: str = "row"
    hybrid_shape: str = "square"           # square | stair
    stair_max_bands: int = 8
    merge_duplicates: bool = True
    oracle_edge_chunk: Optional[int] = None

    def resolve_n_blocks(self, nnz: int) -> int:
        """The blocked backend's block count: pinned, or one block per
        ``block_nnz_budget`` entries."""
        if self.n_blocks is not None:
            return self.n_blocks
        return max(1, -(-nnz // self.block_nnz_budget))

    @property
    def square_build(self) -> bool:
        """Whether a hybrid prepare builds the square core: the square
        shape, and as in the reference (``pygim_tpu/ops/spmm.py:1127``)
        the stair shape with a pinned ``hybrid_k`` or no core budget."""
        return (self.hybrid_shape == "square" or self.hybrid_k is not None
                or self.hybrid_core_bytes <= 0)

    def check_supported(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend != "hybrid":
            return
        if self.hybrid_shape not in CORE_SHAPES:
            # the reference builds a square core for any other shape; the
            # port does not guess
            raise NotImplementedError(
                f"hybrid_shape {self.hybrid_shape!r}: the port runs "
                f"{CORE_SHAPES}")
        if self.hybrid_dtype is not None and self.hybrid_dtype not in CORE_DTYPES:
            raise NotImplementedError(
                f"hybrid_dtype {self.hybrid_dtype!r}: the port's cores are "
                f"{CORE_DTYPES}, or None for the graph's own dtype")


# read at prepare: "1" plans the core↔tail interleave, as the reference's
# gate (pygim_tpu/ops/spmm.py:994)
INTERLEAVE_ENV = "PYGIM_HYBRID_INTERLEAVE"


def interleave_plan(steps, k: int):
    """The reference's core↔tail interleave plan (``_install_core``,
    ``pygim_tpu/ops/spmm.py:965-1026``) for ELL tables of ``steps`` scan
    steps each and a square core of ``k`` rows: one row slab of ``k //
    Σ steps`` rows a step, the deficit given to the table with the most
    steps; ``(slabs, steps, k)``, or None where a slab would hold fewer
    than 8 rows (or there is no step). On the card the plan records that
    the interleave engages; the core stays 2-D there and runs on its own
    stream (module docstring)."""
    steps = [int(n) for n in steps]
    total = sum(steps)
    slab = k // max(1, total)
    if total == 0 or slab < 8:
        return None
    slabs = [slab] * len(steps)
    deficit = k - slab * total
    if deficit:
        j = int(np.argmax(steps))
        slabs[j] += -(-deficit // steps[j])
    return (slabs, steps, int(k))


def ell_step_tables(cols2d, vals2d, vrow_to_row, chunk):
    """Repack (nvr_pad, D) ELL tables into the step layout the run path
    reads: ``(n_steps, chunk·D)`` slots and ``(n_steps, chunk)`` rows."""
    nvr, d = cols2d.shape
    n_steps = nvr // chunk
    return (
        np.ascontiguousarray(cols2d).reshape(n_steps, chunk * d),
        np.ascontiguousarray(vals2d).reshape(n_steps, chunk * d),
        np.ascontiguousarray(vrow_to_row).reshape(n_steps, chunk),
    )


def core_any_width(bands, xc, core_nodes, stair, out, plans=None):
    """K-core (:func:`core_bands_scatter_add`) at any width H: where H is
    not a multiple of 8 (K-core's rule, ``ops/core_dot.py``), ``xc`` and
    ``out`` go to it padded with zero columns, and the first H columns
    come back into ``out`` (in place; returned). ``plans`` are built for
    the padded width."""
    h = out.shape[1]
    pad = -h % 8
    if not pad:
        return core_bands_scatter_add(bands, xc, core_nodes, stair, out,
                                      plans=plans)
    wide = torch.nn.functional.pad(out, (0, pad))
    core_bands_scatter_add(bands, torch.nn.functional.pad(xc, (0, pad)),
                           core_nodes, stair, wide, plans=plans)
    return out.copy_(wide[:, :h])


def _ell_suffix(i: int) -> str:
    """Key suffix of ELL table ``i``: table 0 keeps the unsuffixed names."""
    return "" if i == 0 else f"_{i}"


def _ell_chunk(config, degree: int) -> int:
    """Virtual rows per step, so each step holds ~block_nnz_budget slots."""
    return max(8, round_up(max(1, config.block_nnz_budget // degree), 8))


def _plan_ell_tables(csr, config) -> "list[tuple[int, object]]":
    """Multi-degree ELL tables for ``csr``: ``[(chunk, EllRows)]``."""
    degrees = choose_degrees_for_config(csr.row_lengths, config)
    tables = build_ell_rows_multi(
        csr, degrees, hidden=config.hidden_hint,
        row_chunk_for=lambda D: _ell_chunk(config, D),
    )
    return [(_ell_chunk(config, t.degree), t) for t in tables]


def plan_shared_ell_tables(parts, config, vfill: int):
    """Multi-degree ELL tables of one shape on every shard of a mesh
    (``pygim_tpu/ops/spmm.py:277-330``): the degrees from the combined
    row-length histogram of ``parts`` (CSR), every part building every
    table (``keep_empty``), each table's virtual rows padded to the most
    over the parts (a multiple of its chunk) with val 0 and vrow
    ``vfill``. Returns ``(stacked, meta)``: ``stacked["cols2d{sfx}"]``,
    ``vals2d{sfx}``, ``vrow_to_row{sfx}`` numpy arrays in step layout with
    a leading part dimension, and ``meta`` ``[(chunk, degree)]``."""
    all_len = np.concatenate([p.row_lengths for p in parts])
    degrees = choose_degrees_for_config(all_len, config)
    per_part = [
        build_ell_rows_multi(
            p, degrees, hidden=config.hidden_hint,
            row_chunk_for=lambda D: _ell_chunk(config, D), keep_empty=True)
        for p in parts
    ]
    stacked, meta = {}, []
    for i, D in enumerate(degrees):
        chunk = _ell_chunk(config, D)
        nvr = round_up(max(tabs[i].cols.shape[0] for tabs in per_part), chunk)

        def pad(a, fill=0):
            out = np.full((nvr,) + a.shape[1:], fill, dtype=a.dtype)
            out[: a.shape[0]] = a
            return out

        steps = [ell_step_tables(pad(tabs[i].cols), pad(tabs[i].vals),
                                 pad(tabs[i].vrow_to_row, vfill), chunk)
                 for tabs in per_part]
        sfx = _ell_suffix(i)
        stacked[f"cols2d{sfx}"] = np.stack([t[0] for t in steps])
        stacked[f"vals2d{sfx}"] = np.stack([t[1] for t in steps])
        stacked[f"vrow_to_row{sfx}"] = np.stack([t[2] for t in steps])
        meta.append((chunk, D))
    return stacked, meta


def shared_ell_keys(meta, prefix: str = "") -> "list[str]":
    """The table keys of ``meta`` in order: ``cols2d``, ``vals2d``,
    ``vrow_to_row`` of each table."""
    keys = []
    for i in range(len(meta)):
        sfx = _ell_suffix(i)
        keys += [f"{prefix}cols2d{sfx}", f"{prefix}vals2d{sfx}",
                 f"{prefix}vrow_to_row{sfx}"]
    return keys


def _ell_host(host: dict, tables) -> None:
    """Planned tables ``[(chunk, EllRows)]`` into the host dict under the
    reference's keys."""
    host["n_ell"] = np.int64(len(tables))
    for i, (chunk, t) in enumerate(tables):
        sfx = _ell_suffix(i)
        host[f"degree{sfx}"] = np.int64(t.degree)
        host[f"chunk{sfx}"] = np.int64(chunk)
        host[f"cols2d{sfx}"] = t.cols
        host[f"vals2d{sfx}"] = t.vals
        host[f"vrow_to_row{sfx}"] = t.vrow_to_row


def _finish_hybrid_tail(host, coo, config, tail_sel, pt):
    """Build the ELL tail tables for the non-core edges, in original node
    ids (only the core touches the rank order)."""
    n = coo.nrows
    pt.start("ell_tail")
    tail = CooGraph(
        rows=coo.rows[tail_sel], cols=coo.cols[tail_sel],
        vals=coo.vals[tail_sel], nrows=n, ncols=n,
    )
    _ell_host(host, _plan_ell_tables(tail.to_csr(), config))
    pt.stop("ell_tail")


def _prepare_stair_build(coo, config, rank, order, pt, core_dtype) -> dict:
    """Staircase core: ≤ ``stair_max_bands`` dense row bands of tapering
    width in degree-rank space (core/stair.py; widths a multiple of 256,
    512 for int4), int8 ``(rows, w)``, nibble-packed int4 ``(rows, w //
    2)`` uint8, bfloat16 bits ``(rows, w)`` uint16 or float32 ``(rows,
    w)`` (also the float64 core's cells). Cells outside a band, and cells
    of an integer core that are not an integer in the dtype's range
    ([-128, 127], [-8, 7]), go to the exact ELL tail. Returns the host
    tables."""
    n = coo.nrows
    budget_cells = int(config.hybrid_core_bytes / CELL_BYTES[core_dtype])
    rr = rank[coo.rows].astype(np.int64)
    cc = rank[coo.cols].astype(np.int64)
    pt.start("stair_plan")
    bands = plan_staircase(
        rr, cc, n, budget_cells, max_bands=config.stair_max_bands,
        col_quant=512 if core_dtype == "int4" else 256,
    )
    pt.stop("stair_plan")
    host: dict = {"core_dtype": np.str_(core_dtype)}
    if config.bcsr_bytes > 0:
        _log.info("hybrid_shape='stair': bcsr_bytes ignored (bands subsume "
                  "the tile tier's coverage)")
    if not bands:
        host["k"] = np.int64(0)
        _finish_hybrid_tail(host, coo, config, np.ones(coo.nnz, bool), pt)
        return host
    his = np.array([b[1] for b in bands], dtype=np.int64)
    ws = np.array([b[2] for b in bands], dtype=np.int64)
    bi = np.searchsorted(his, rr, side="right")
    in_core = (bi < len(bands)) & (cc < ws[np.minimum(bi, len(bands) - 1)])
    rows_total = int(his[-1])
    host["k"] = np.int64(rows_total)
    host["stair_bands"] = np.asarray(bands, dtype=np.int64)
    host["core_nodes"] = order[: max(rows_total, int(ws.max()))]

    pt.start("core_fill")
    idx = np.flatnonzero(in_core)
    sidx = idx[np.argsort(rr[idx], kind="stable")]
    srr = rr[sidx]
    vals64 = coo.vals.astype(np.float64)
    demoted = []
    for b, (lo, hi, w) in enumerate(bands):
        rows_b = hi - lo
        store = np.empty((rows_b, w // 2) if core_dtype == "int4"
                         else (rows_b, w),
                         dtype={"int4": np.uint8, "int8": np.int8,
                                "bfloat16": np.uint16}.get(core_dtype,
                                                           np.float32))
        # ~256 MB of f32 cells per fill chunk
        chunk_rows = max(8, ((1 << 28) // max(1, w * 4)) // 8 * 8)
        for c0 in range(0, rows_b, chunk_rows):
            c1 = min(c0 + chunk_rows, rows_b)
            e0 = np.searchsorted(srr, lo + c0, side="left")
            e1 = np.searchsorted(srr, lo + c1, side="left")
            eidx = sidx[e0:e1]
            flat = (rr[eidx] - (lo + c0)) * w + cc[eidx]
            blk = np.bincount(
                flat, weights=vals64[eidx], minlength=(c1 - c0) * w,
            ).astype(np.float32).reshape(c1 - c0, w)
            if core_dtype not in INT_CORES:
                # bf16 bits rounded to nearest even as ml_dtypes' cast, or
                # the f32 sums themselves (float32, and the float64 core)
                store[c0:c1] = (f32_to_bf16_bits(blk)
                                if core_dtype == "bfloat16" else blk)
                continue
            rb, bad_flat = int_demote_slab(blk, core_dtype)
            if bad_flat.size:
                demoted.append(eidx[np.isin(flat, bad_flat)])
            store[c0:c1] = (pack_nibbles(rb) if core_dtype == "int4"
                            else rb.astype(np.int8))
        host[f"stair{b}"] = store
    if demoted:
        dem = np.concatenate(demoted)
        in_core[dem] = False
        _log.info("%s stair core: %d edges not representable — demoted to "
                  "the ELL tail", core_dtype, dem.size)
    pt.stop("core_fill")
    _finish_hybrid_tail(host, coo, config, ~in_core, pt)
    return host


def square_core_k(config, n: int, core_dtype=None) -> int:
    """The square core's size: a pinned ``hybrid_k`` (at most n), 0
    without a budget, else the most ranks whose ``k²`` cells of
    ``core_dtype`` (default ``config.hybrid_dtype``; :data:`CELL_BYTES`)
    fit the budget, a multiple of 256 (at least 256 or n); even for int4,
    whose bytes pair columns (``pygim_tpu/ops/spmm.py:1128-1140``)."""
    core_dtype = core_dtype or config.hybrid_dtype
    if config.hybrid_k is not None:
        k = max(0, min(config.hybrid_k, n))
    elif config.hybrid_core_bytes <= 0:
        k = 0
    else:
        k = int(np.sqrt(config.hybrid_core_bytes / CELL_BYTES[core_dtype]))
        k = (k // 256) * 256
        k = min(max(k, min(256, n)), n)
    if core_dtype == "int4":
        k -= k % 2
    return k


def _prepare_square_build(coo, config, rank, order, pt, core_dtype) -> dict:
    """Square core: the ``[0, k)²`` block of the degree ranks
    (:func:`square_core_k`), built band by band in its stored dtype
    (``core/banded.py``; a float64 core's cells are float32, as the
    reference's ``core_fill_native``); cells of an integer core that are
    not an integer in the dtype's range are zeroed and their edges
    demoted to the exact ELL tail, as every edge outside the block goes
    there. Returns the host tables."""
    k = square_core_k(config, coo.nrows, core_dtype)
    host: dict = {"k": np.int64(k), "core_dtype": np.str_(core_dtype)}
    pt.start("core_fill")
    if k == 0:
        in_core = np.zeros(coo.nnz, dtype=bool)
    else:
        core, tail_mask, bad_flat = core_build_banded(
            coo.rows, coo.cols, coo.vals.astype(np.float32), rank, k,
            "float32" if core_dtype == "float64" else core_dtype)
        in_core = ~tail_mask
        if bad_flat.size:
            idx = np.flatnonzero(in_core)
            flat = (rank[coo.rows[idx]].astype(np.int64) * k
                    + rank[coo.cols[idx]])
            demote = np.isin(flat, bad_flat)
            in_core[idx[demote]] = False
            _log.info("%s core: %d cells (%d edges) not representable — "
                      "demoted to the ELL tail", core_dtype, bad_flat.size,
                      int(demote.sum()))
        host["core"] = core
        host["core_nodes"] = order[:k]  # rank i ↔ node order[i]
    pt.stop("core_fill")
    tail_sel = ~in_core
    if config.bcsr_bytes > 0:
        pt.start("bcsr")
        tail_sel = _bcsr_host(host, coo, config, rank, order, k, core_dtype,
                              tail_sel)
        pt.stop("bcsr")
    _finish_hybrid_tail(host, coo, config, tail_sel, pt)
    return host


def _bcsr_host(host, coo, config, rank, order, k, core_dtype, tail_sel):
    """The square build's BCSR tier (``pygim_tpu/ops/spmm.py:1256-1377``)
    into ``host`` under the reference's ``bcsr_*`` keys, from the edges
    of ``tail_sel``; returns ``tail_sel`` without the edges the tiles
    captured. Tiles are bf16 beside an int8 or bf16 core and f32
    otherwise (an int4, f32 or float64 core), in the degree rank or, for
    ``bcsr_order`` "rcm" / "lp", a rank whose band outside the core is
    re-ordered by the tail's structure. Both layouts pad their virtual
    blocks or panels to a multiple of ``bcsr_step`` (about 8 MB of
    panels a step of the reference's scan) with zero tiles on panel 0:
    row-kind pads target the last row block, panel-kind pads row block 0.
    """
    t_idx = np.flatnonzero(tail_sel)
    t_order, t_rank = order, rank
    if config.bcsr_order in ("rcm", "lp") and k < coo.nrows:
        t_order, t_rank = tail_tile_order(
            coo.rows[t_idx], coo.cols[t_idx], order, rank, k, coo.nrows,
            config.bcsr_order)
    panel = config.bcsr_layout == "panel"
    build = build_bcsr_panels if panel else build_bcsr_tiles
    bc, in_tile = build(
        t_rank[coo.rows[t_idx]], t_rank[coo.cols[t_idx]], coo.vals[t_idx],
        t_order, n=coo.nrows, tile_rows=config.bcsr_tile,
        budget_bytes=config.bcsr_bytes, hidden=config.hidden_hint,
        dtype="bfloat16" if core_dtype in ("bfloat16", "int8")
        else "float32",
        min_edges=config.bcsr_min_edges)
    if bc is None:
        return tail_sel
    tail_sel = tail_sel.copy()
    tail_sel[t_idx[in_tile]] = False
    slots = bc.tiles.shape[1]
    n = bc.tiles.shape[0]
    # ~8 MB of panels a scan step of the reference
    step = max(1, (8 << 20) // max(
        1, (1 if panel else slots) * 128 * config.hidden_hint * 4))
    step = min(step, max(1, n))
    n_pad = round_up(n, step)
    tiles = np.zeros((n_pad,) + bc.tiles.shape[1:], dtype=bc.tiles.dtype)
    tiles[:n] = bc.tiles
    panel_idx = np.zeros((n_pad,) + bc.panel_idx.shape[1:], dtype=np.int32)
    panel_idx[:n] = bc.panel_idx
    if panel:
        n_rb = bc.n_rb
        tile_rb = np.zeros((n_pad, slots), dtype=np.int32)
        tile_rb[:n] = bc.tile_rb
        rb_key = {"bcsr_tile_rb": tile_rb}
    else:
        n_rb = bc.row_nodes.shape[0] // bc.tile_rows
        vb_to_rb = np.full(n_pad, n_rb - 1, dtype=np.int32)
        vb_to_rb[:n] = bc.vblock_to_rb
        rb_key = {"bcsr_vblock_to_rb": vb_to_rb}
    host.update(
        bcsr_kind=np.str_("panel" if panel else "row"),
        bcsr_tiles=tiles,
        bcsr_dtype=np.str_(bc.dtype),
        bcsr_panel_idx=panel_idx,
        **rb_key,
        bcsr_panel_nodes=bc.panel_nodes,
        bcsr_row_nodes=bc.row_nodes,
        bcsr_step=np.int64(step),
        bcsr_n_rb=np.int64(n_rb),
        bcsr_edges=np.int64(bc.n_edges),
    )
    return tail_sel


_CACHE_TAG = b"prep-v4-"  # the reference's layout version
# the port's own file prefix: a fault of the port can never feed the
# reference (``hybrid-<key>.npz``) a table, nor the reverse
CACHE_PREFIX = "hybrid-torch-"

# The devices whose hybrid operands read and write the prepare cache: the
# card's. An operand on the CPU (the plain versions, small test graphs)
# is built every time, so a test sees the same phases whatever ran first.
CACHED_DEVICES = ("cuda",)


def prepare_cache_key(coo, config) -> str:
    """The reference's prepare-cache key of ``coo`` under ``config``
    (``pygim_tpu/ops/spmm.py:880-907``): sha256 over the sizes, every
    ``nnz // 64``-th row, column and value, the value dtype, the layout
    version and the config fields; its first 16 hex digits."""
    h = hashlib.sha256()
    h.update(np.asarray([coo.nrows, coo.nnz]).tobytes())
    stride = max(1, coo.nnz // 64)
    h.update(coo.rows[::stride].tobytes())
    h.update(coo.cols[::stride].tobytes())
    h.update(np.ascontiguousarray(coo.vals[::stride]).tobytes())
    h.update(str(coo.vals.dtype).encode())
    h.update(_CACHE_TAG)
    h.update(
        f"{config.hybrid_k}-{config.hybrid_core_bytes}-"
        f"{config.hybrid_dtype}-{config.ell_degree}-"
        f"{config.ell_tables}-"
        f"{config.block_nnz_budget}-{config.bcsr_bytes}-"
        f"{config.bcsr_tile}-{config.bcsr_min_edges}-"
        f"{config.bcsr_order}-{config.bcsr_layout}-"
        f"{config.hidden_hint}".encode()
    )
    if config.hybrid_shape != "square":
        h.update(f"{config.hybrid_shape}-{config.stair_max_bands}".encode())
    return h.hexdigest()[:16]


def transpose_graph(graph) -> CooGraph:
    """``graph`` with ``rows`` and ``cols`` swapped: Aᵀ."""
    coo = graph if isinstance(graph, CooGraph) else graph.to_coo()
    return CooGraph(rows=coo.cols, cols=coo.rows, vals=coo.vals,
                    nrows=coo.ncols, ncols=coo.nrows)


def check_transpose_graph(graph, source_shape) -> None:
    """Raise unless ``graph`` has the shape and edge count of the graph an
    operand was prepared from (``source_shape``): ``transpose(graph)``
    prepares Aᵀ from it once."""
    if graph is None:
        raise ValueError(
            "Aᵀ is not prepared: call transpose(graph) with the graph "
            "this operand was prepared from")
    if (graph.nrows, graph.ncols, graph.nnz) != source_shape:
        raise ValueError(
            f"transpose(graph): a graph of shape ({graph.nrows}, "
            f"{graph.ncols}) with {graph.nnz} edges, the operand's "
            f"was {source_shape}")


def gather_only(x, cols2d):
    """The gather-only probe of :meth:`PreparedSpmm.phase_times`: each
    step's rows of x gathered and summed into one f32 (H,) vector, no
    weights and no scatter (the reference's scan body, 1687-1702)."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for c in cols2d:
        acc += x.index_select(0, c).float().sum(0)
    return acc


def as_payload(x):
    """``x`` as the products take it: an int64 x becomes int32 (wrapping),
    as the reference's ``jnp.asarray`` puts it with x64 off."""
    return x.to(torch.int32) if x.dtype == torch.int64 else x


class PreparedSpmm:
    """Device-resident prepared sparse operand: ``mul(x) = A @ x``.

    ``dev_arrays`` holds the tables under the reference's key names: for
    ``hybrid`` and ``ell``, ``cols2d{sfx}``, ``vals2d{sfx}``,
    ``vrow_to_row{sfx}`` (``ell_meta`` is ``[(chunk, degree)]``), and for
    ``hybrid`` also ``core_nodes`` and the core, ``stair{b}`` per band of
    a staircase or ``core`` for a square (``stair`` is ``[(lo, hi, w)]``,
    a square's one band ``(0, k, w)``), and with a BCSR tier (``has_bcsr``)
    ``tiles``, ``panel_idx``, ``panel_nodes``, ``row_nodes`` and
    ``vblock_to_rb`` (``bcsr_kind`` "row") or ``tile_rb`` ("panel"); for
    ``blocked``, ``colind``, ``vals``, ``rowloc``, ``row_slot``; for
    ``coo`` (``(n_chunks, chunk_nnz)``) and ``oracle``, ``rows``,
    ``cols``, ``vals``. Edge values
    reach the device as the reference's ``jnp.asarray`` puts them with
    x64 off: float64 as float32, int64 as int32; the ELL value tables are
    float32 always (K-tail's weights). The hybrid's ``prepare_timer``
    holds its host phases; its host tables go through the prepare cache
    on the devices of :data:`CACHED_DEVICES`."""

    def __init__(self, graph, config: SpmmConfig, device="cuda"):
        config.check_supported()
        self._init_state(config, device)
        backend = config.backend
        # the graph as given, to check the one transpose() is handed
        self._source_shape = (graph.nrows, graph.ncols, graph.nnz)
        pt = PhaseTimer()
        if config.merge_duplicates and backend != "oracle":
            # the oracle stays raw: an independent reference must not
            # share the prepared path's transformations
            pt.start("merge")
            graph, _ = merge_duplicate_edges(graph)
            pt.stop("merge")
        coo = graph if isinstance(graph, CooGraph) else None
        csr = graph if isinstance(graph, CsrGraph) else None
        self.nrows, self.ncols, self.nnz = graph.nrows, graph.ncols, graph.nnz
        if backend == "oracle":
            s = (coo if coo is not None else csr.to_coo()).sort_by_row()
            self._dev = {"rows": self._put(s.rows), "cols": self._put(s.cols),
                         "vals": self._put(s.vals, vals=True)}
        elif backend == "blocked":
            csr = csr if csr is not None else coo.to_csr()
            plan = make_row_block_plan(
                csr, config.resolve_n_blocks(csr.nnz),
                balance=config.balance, row_align=8, nnz_align=8)
            ell = build_ell_blocks(csr, plan)
            self.plan, self.rows_pad = plan, plan.rows_pad
            row_slot = row_slot_table(plan)
            self._dev = {"colind": self._put(ell.colind),
                         "vals": self._put(ell.vals, vals=True),
                         "rowloc": self._put(ell.rowloc),
                         "row_slot": self._put(row_slot)}
            if self.device.type == "cuda":
                self._seg_plan = blocked_plan(ell.rowloc, row_slot,
                                              plan.rows_pad, ell.colind,
                                              ell.vals)
        elif backend == "coo":
            ch = build_coo_chunks(
                coo if coo is not None else csr.to_coo(),
                config.resolve_n_blocks(graph.nnz))
            self._dev = {"rows": self._put(ch.rows), "cols": self._put(ch.cols),
                         "vals": self._put(ch.vals, vals=True)}
            if self.device.type == "cuda":
                self._seg_plan = coo_plan(ch.rows, graph.nrows)
        elif backend == "ell":
            host: dict = {}
            _ell_host(host, _plan_ell_tables(
                csr if csr is not None else coo.to_csr(), config))
            self._install_ell(host)
        else:
            coo = coo if coo is not None else csr.to_coo()
            if coo.nrows != coo.ncols:
                raise ValueError("hybrid backend requires square adjacency")
            if not np.issubdtype(coo.vals.dtype, np.floating):
                # integer weights ride a bf16, int8 or int4 core and an f32
                # tail; no core dtype means bf16, written back into the
                # config (pygim_tpu/ops/spmm.py:826-850)
                if config.hybrid_dtype not in (None, "bfloat16", *INT_CORES):
                    raise ValueError("integer hybrid aggregation requires a "
                                     "bfloat16, int8 or int4 core")
                if config.hybrid_dtype is None:
                    config = dataclasses.replace(config,
                                                 hybrid_dtype="bfloat16")
                    self.config = config
                coo = dataclasses.replace(coo,
                                          vals=coo.vals.astype(np.float32))
            elif (config.hybrid_dtype is None
                  and str(coo.vals.dtype) not in CELL_BYTES):
                raise NotImplementedError(
                    f"hybrid_dtype None on a {coo.vals.dtype} graph: the "
                    "port's float cores are float32 (and a float64 graph's)")
            self.prepare_timer = pt
            host = self._prepare_hybrid(coo, config, pt)
            pt.start("upload")
            self._install_hybrid(host)
            pt.stop("upload")

    def _init_state(self, config, device) -> None:
        self.config = config
        self.device = torch.device(device)
        self._transpose = None
        self._dev = {}
        self.ell_meta = []
        self.stair = None     # the core's stored bands [(lo, hi, w)] (a square: one)
        self._band_keys = []  # their tables in dev_arrays
        self._tail_plan = None
        self._seg_plan = None  # K-rows' plan (blocked, coo; on the card)
        self._core_plans = {}  # H -> K-core plans of the bands
        self._int_plans = {}   # (H, limbs) -> K-int plans of the same
        self._f32_plans = {}   # H -> K-f32 plans of the same
        self._bcsr_plans = {}  # H -> K-bcsr's work plan of the BCSR tier
        self.has_bcsr = False
        self.interleave = None  # interleave_plan's tuple where it engages
        self._side = {}         # device -> the interleave's second stream

    @classmethod
    def from_host(cls, host: dict, config: SpmmConfig, nrows: int,
                  ncols: int, device="cuda", nnz: int = 0) -> "PreparedSpmm":
        """An ``nrows × ncols`` operand of ``config.backend`` ("hybrid" or
        "ell") from host tables in the layout of the hybrid's build (the
        ELL tail under ``n_ell`` and the table keys, ``k``,
        ``core_dtype``, a square ``core`` of any width with
        ``core_nodes``, and the BCSR tier's ``bcsr_*`` keys), on
        ``device``, with nothing planned from a graph: a shard of
        ``parallel/spmm_2d.py``. A ``core_rows`` key gathers the core's
        payload rows ``x[core_rows]`` where the product scatters to
        ``core_nodes`` (:meth:`_xc`). It never interleaves and has no
        transpose."""
        config.check_supported()
        self = cls.__new__(cls)
        self._init_state(config, device)
        self._source_shape = None
        self.nrows, self.ncols, self.nnz = nrows, ncols, nnz
        self._install_hybrid(host, interleave=False)
        return self

    def _put(self, arr, vals: bool = False) -> torch.Tensor:
        """``arr`` (numpy) on the operand's device; edge values (``vals``)
        as the class docstring says."""
        arr = np.ascontiguousarray(arr)
        if vals and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif vals and arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        return torch.from_numpy(arr).to(self.device)

    def _prepare_hybrid(self, coo, config, pt) -> dict:
        """The host tables: from the prepare cache where it holds them
        (phase ``cache_load``), else built and saved there (phase
        ``cache_save``); built alone off :data:`CACHED_DEVICES`."""
        if self.device.type not in CACHED_DEVICES:
            return self._prepare_hybrid_build(coo, config)
        key = prepare_cache_key(coo, config)
        path = cache_dir() / f"{CACHE_PREFIX}{key}.npz"
        if path.exists():
            pt.start("cache_load")
            try:
                with np.load(path) as z:
                    host = {k: z[k] for k in z.files}
            except LOAD_ERRORS as e:
                _log.warning("prepare cache %s unreadable (%s): rebuilding",
                             path, e)
                host = None
            pt.stop("cache_load")
            if host is not None:
                return host
        host = self._prepare_hybrid_build(coo, config)
        pt.start("cache_save")
        save_npz(path, host)
        pt.stop("cache_save")
        return host

    def _install_ell(self, host: dict) -> None:
        """The ELL tables of ``host`` to the device in step layout, their
        ``ell_meta`` and, on the card, K-tail's plan of them."""
        tail_host = []
        for i in range(int(host["n_ell"])):
            sfx = _ell_suffix(i)
            chunk = int(host[f"chunk{sfx}"])
            c, v, r = ell_step_tables(
                host[f"cols2d{sfx}"], host[f"vals2d{sfx}"],
                host[f"vrow_to_row{sfx}"], chunk,
            )
            self._dev["cols2d" + sfx] = self._put(c)
            self._dev["vals2d" + sfx] = self._put(np.asarray(v, np.float32))
            self._dev["vrow_to_row" + sfx] = self._put(r)
            self.ell_meta.append((chunk, int(host[f"degree{sfx}"])))
            tail_host.append((v, r))
        if self.device.type == "cuda":
            self._tail_plan = tail_plan(self.ell_tables(self._dev),
                                        host=tail_host)

    def _install_hybrid(self, host: dict, interleave: bool = True) -> None:
        """The host tables to the device: the ELL tail, and the core's
        bands ``self.stair`` under ``self._band_keys`` — the stair's
        ``stair{b}``, or the square ``core`` as the one band ``(0, k, k)``.
        ``self.stair`` holds the stored widths, which the products run on:
        a band whose width misses the kernels' rule (:data:`WIDTH_RULE`:
        int8 and bf16 cells a multiple of 16, int4 of 32, f32 of 4: a
        pinned ``hybrid_k``, or a stair band as wide as the graph) gets
        zero cells appended to each row here, on the host, and ``xc`` is
        zero-padded to match (:meth:`_xc`). The logical widths stay in the
        host tables (``stair_bands``, ``k``). bf16 cells go up as
        ``torch.bfloat16``, their stored uint16 bits viewed as such.
        ``core_rows`` (a mesh shard's gather rows) is padded with row 0
        to the stored width, as its zero cells. With ``interleave`` a
        square core plans the core↔tail interleave where
        :data:`INTERLEAVE_ENV` is "1" (:func:`interleave_plan`)."""
        self.hybrid_k_eff = int(host["k"])
        self.core_dtype = str(host["core_dtype"])
        self._install_ell(host)
        self._install_bcsr(host)
        packed = self.core_dtype == "int4"
        if "stair_bands" in host:
            bands = [tuple(int(v) for v in b) for b in host["stair_bands"]]
            self._band_keys = [f"stair{b}" for b in range(len(bands))]
        elif "core" in host and self.hybrid_k_eff > 0:
            k = self.hybrid_k_eff
            w = host["core"].shape[1] * (1 + packed)
            bands, self._band_keys = [(0, k, w)], ["core"]
            if interleave and os.environ.get(INTERLEAVE_ENV, "0") == "1":
                self.interleave = interleave_plan(
                    [c.shape[0] for c, *_ in self.ell_tables(self._dev)], k)
        else:
            return
        q = WIDTH_RULE[self.core_dtype]
        self.stair = []
        for key, (lo, hi, w) in zip(self._band_keys, bands):
            band, wq = host[key], round_up(w, q)
            if wq != w:
                band = np.pad(band, ((0, 0), (0, (wq - w) // (1 + packed))))
            self.stair.append((lo, hi, wq))
            if self.core_dtype == "bfloat16":
                self._dev[key] = torch.from_numpy(np.ascontiguousarray(
                    band).view(np.int16)).view(torch.bfloat16).to(self.device)
            else:
                self._dev[key] = self._put(band)
        self._dev["core_nodes"] = self._put(host["core_nodes"])
        if "core_rows" in host:
            rows = np.asarray(host["core_rows"], np.int32)
            self._dev["core_rows"] = self._put(
                np.pad(rows, (0, self.stair[0][2] - rows.shape[0])))

    def _install_bcsr(self, host: dict) -> None:
        """The BCSR tier of ``host``, where it has one, to the device under
        the reference's names (``_install_hybrid_bcsr``,
        ``pygim_tpu/ops/spmm.py:1081-1104``), bf16 tiles as
        ``torch.bfloat16``, with ``bcsr_kind``, ``bcsr_step``,
        ``bcsr_n_rb`` and ``bcsr_edges``."""
        self.has_bcsr = "bcsr_tiles" in host
        if not self.has_bcsr:
            return
        tiles = np.ascontiguousarray(host["bcsr_tiles"])
        if str(host["bcsr_dtype"]) == "bfloat16":
            tiles = torch.from_numpy(tiles.view(np.int16)).view(
                torch.bfloat16).to(self.device)
        else:
            tiles = self._put(tiles)
        self.bcsr_kind = str(host["bcsr_kind"])
        self.bcsr_step = int(host["bcsr_step"])
        self.bcsr_n_rb = int(host["bcsr_n_rb"])
        self.bcsr_edges = int(host["bcsr_edges"])
        rb = "tile_rb" if self.bcsr_kind == "panel" else "vblock_to_rb"
        self._dev.update(
            tiles=tiles, panel_idx=self._put(host["bcsr_panel_idx"]),
            panel_nodes=self._put(host["bcsr_panel_nodes"]),
            row_nodes=self._put(host["bcsr_row_nodes"]),
            **{rb: self._put(host[f"bcsr_{rb}"])})

    def bcsr_tables(self, dev: dict) -> tuple:
        """The BCSR tier's ``(kind, tiles, panel_idx, rb, panel_nodes,
        row_nodes)`` in ``dev``, the arguments of
        :func:`~pygim_tpu_torch.ops.bcsr.bcsr_add` before x."""
        rb = "tile_rb" if self.bcsr_kind == "panel" else "vblock_to_rb"
        return (self.bcsr_kind, dev["tiles"], dev["panel_idx"], dev[rb],
                dev["panel_nodes"], dev["row_nodes"])

    def _prepare_hybrid_build(self, coo, config) -> dict:
        pt = self.prepare_timer
        n = coo.nrows
        pt.start("rank")
        deg = np.bincount(coo.rows, minlength=n).astype(np.int64)
        deg += np.bincount(coo.cols, minlength=n)
        order = np.argsort(-deg).astype(np.int32)
        rank = np.empty(n, dtype=np.int32)
        rank[order] = np.arange(n, dtype=np.int32)
        pt.stop("rank")
        core_dtype = config.hybrid_dtype or str(coo.vals.dtype)
        build = (_prepare_square_build if config.square_build
                 else _prepare_stair_build)
        return build(coo, config, rank, order, pt, core_dtype)

    @property
    def dev_arrays(self) -> dict:
        return self._dev

    @property
    def device_bytes(self) -> int:
        """Bytes of the operand's device tables."""
        return sum(t.numel() * t.element_size() for t in self._dev.values())

    def transpose(self, graph=None) -> "PreparedSpmm":
        """``Aᵀ``: ``graph``, the graph this operand was prepared from, with
        ``rows`` and ``cols`` swapped, prepared with this operand's
        configuration on its device and kept (one more operand of device
        memory; its prepare-cache key differs, as its graph does). The
        operand holds no host copy of its graph, so the first call takes
        it and later calls return the operand prepared then. The backward
        of :class:`SpmmFunction` runs on it: whoever trains prepares it
        (``run_training_benchmark`` and ``train_cuda.py`` before their
        clock), and an inference run never does."""
        if self._transpose is None:
            check_transpose_graph(graph, self._source_shape)
            self._transpose = PreparedSpmm(transpose_graph(graph),
                                           self.config, device=self.device)
        return self._transpose

    def mul(self, x):
        """``A @ x`` through the kernels (plain versions on CPU tensors).
        ``x``: (ncols, H) float32, bfloat16, int8, int16, int32 or int64
        on the operand's device (int64 is taken as int32, wrapping, as the
        reference's ``jnp.asarray`` with x64 off); the result is float32
        (N, H). On an int8 or int4 core an integer x is exact (the
        reference's wrapped int32 product); on a bf16 or f32 core the
        product is the reference's f32 dot (:meth:`_core_add`); the tail
        sums in f32, as the reference's hybrid ``run``; the BCSR tier as
        ``ops/bcsr.py`` says. The oracle, ``blocked`` and ``coo`` return the
        accumulation dtype of ``ops/reference.py`` (the oracle takes any x;
        K-rows on the card the weights and payloads of
        ``ops/seg_rows.py``)."""
        return self.raw_mul(x, self._dev)

    def raw_mul(self, x, dev: dict):
        x = as_payload(x)
        if self.config.backend == "oracle":
            return self._oracle(x, dev)
        if self.config.backend == "blocked":
            return self._blocked(x, dev)
        if self.config.backend == "coo":
            return self._coo(x, dev)
        return self._run(x, dev)

    def _rows_plan(self, dev):
        """K-rows' plan where ``dev`` is this operand's own tables (built
        at prepare on the card), else None (a launch on the card then
        raises: the plan is of the operand's own tables)."""
        return self._seg_plan if dev is self._dev else None

    def _coo(self, x, dev, plain=False):
        """The ``coo`` body (``pygim_tpu/ops/spmm.py:1883-1897``): every
        row's ``Σ x[cols] · vals`` in the accumulation dtype, by K-rows
        (:func:`~pygim_tpu_torch.ops.seg_rows.coo_rows`) or, with
        ``plain``, its plain version."""
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        args = (dev["rows"], dev["cols"], dev["vals"], x.contiguous(),
                self.nrows)
        if plain:
            return coo_plain(*args)
        return coo_rows(*args, plan=self._rows_plan(dev))

    def _blocked(self, x, dev, plain=False):
        """The blocked body (``pygim_tpu/ops/spmm.py:136-161``) by K-rows
        (:func:`~pygim_tpu_torch.ops.seg_rows.blocked_rows`) or, with
        ``plain``, its plain version."""
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        args = (dev["colind"], dev["vals"], dev["rowloc"], dev["row_slot"],
                x.contiguous(), self.rows_pad)
        if plain:
            return blocked_spmm(*args)
        return blocked_rows(*args, plan=self._rows_plan(dev))

    def _oracle(self, x, dev):
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        chunk = self.config.oracle_edge_chunk
        args = (dev["rows"], dev["cols"], dev["vals"], x, self.nrows)
        if chunk:
            return spmm_coo_oracle_chunked(*args, chunk)
        return spmm_coo_oracle(*args)

    def ell_tables(self, dev: dict) -> list:
        """The ELL tables of ``dev`` as ``[(cols2d, vals2d, vrow_to_row,
        degree)]``."""
        tables = []
        for i, (_chunk, degree) in enumerate(self.ell_meta):
            sfx = _ell_suffix(i)
            tables.append((dev[f"cols2d{sfx}"], dev[f"vals2d{sfx}"],
                           dev[f"vrow_to_row{sfx}"], degree))
        return tables

    def _tail(self, x, tables, out, **kw):
        """K-tail over this operand's own tables, with the plan built
        once at prepare (``kw``: ``safe`` for a rounded payload)."""
        plan = self._tail_plan
        if plan is not None and out.device != plan.tabs.device:
            plan = None
        return ell_tables_add(x, tables, out, plan=plan, **kw)

    def _bcsr(self, x, kind, tiles, panel_idx, rb, panel_nodes, row_nodes,
              out, safe=None):
        """K-bcsr over this operand's own tier, with its work plan built
        once per H on the card (``ops/bcsr.py:bcsr_plan``)."""
        plan = None
        if out.is_cuda and out.device == tiles.device:
            h = out.shape[1]
            if h not in self._bcsr_plans:
                self._bcsr_plans[h] = bcsr_plan(
                    kind, panel_idx, rb, tiles.shape[2], h,
                    tile_bytes=tiles.element_size(), device=tiles.device)
            plan = self._bcsr_plans[h]
        return bcsr_add(x, kind, tiles, panel_idx, rb, panel_nodes,
                        row_nodes, out, safe=safe, plan=plan)

    def _core(self, bands, xc, core_nodes, stair, out):
        """K-core over this operand's own bands at any width, with their
        plans built once per padded width on the card."""
        plans = None
        if out.is_cuda and out.device == bands[0].device:
            h = -(-out.shape[1] // 8) * 8
            if h not in self._core_plans:
                self._core_plans[h] = core_plans(bands, stair, h)
            plans = self._core_plans[h]
        return core_any_width(bands, xc, core_nodes, stair, out, plans=plans)

    def _core_f32(self, bands, xc, core_nodes, stair, out):
        """K-f32 over this operand's own bands, with their plans built
        once per H on the card."""
        plans = None
        if out.is_cuda and out.device == bands[0].device:
            h = out.shape[1]
            if h not in self._f32_plans:
                self._f32_plans[h] = core_f32_plans(bands, stair, h)
            plans = self._f32_plans[h]
        return core_f32_scatter_add(bands, xc, core_nodes, stair, out,
                                    plans=plans)

    def _core_int(self, bands, xc, core_nodes, stair, out, limbs,
                  payload=None):
        """K-int over this operand's own bands, with their plans built
        once per (H, limbs) on the card."""
        plans = None
        if out.is_cuda and out.device == bands[0].device:
            key = (out.shape[1], limbs)
            if key not in self._int_plans:
                self._int_plans[key] = core_int_plans(bands, stair, *key)
            plans = self._int_plans[key]
        return core_int_scatter_add(bands, xc, core_nodes, stair, out,
                                    limbs, plans=plans, payload=payload)

    def mul_plain(self, x):
        """The same product through the plain PyTorch versions on any
        device, at H unpadded — the yardstick the kernels are held
        against."""
        backend = self.config.backend
        if backend == "oracle":
            return self.raw_mul(x, self._dev)  # plain PyTorch ops already
        if backend == "blocked":
            return self._blocked(as_payload(x), self._dev, plain=True)
        if backend == "coo":
            return self._coo(as_payload(x), self._dev, plain=True)
        return self._run(as_payload(x), self._dev, plain=True)

    def _kernels(self, dev: dict, plain: bool):
        """The (tail, K-core, K-int, K-f32, K-bcsr) functions of a run: the
        plain versions; the kernels with the plans this operand keeps for
        its own tables; or the kernels planning a foreign ``dev`` each
        call."""
        if plain:
            return (ell_tables_plain, core_bands_plain,
                    lambda *a, limbs: core_int_plain(*a), core_f32_plain,
                    bcsr_plain)
        if dev is self._dev:
            return (self._tail, self._core, self._core_int, self._core_f32,
                    self._bcsr)
        return (ell_tables_add, core_any_width, core_int_scatter_add,
                core_f32_scatter_add, bcsr_add)

    def _check_x(self, x):
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        if x.dtype not in PAYLOADS:
            raise TypeError(
                f"the {self.config.backend} product takes a float32, "
                f"bfloat16, int8, int16, int32 or int64 payload, got "
                f"{x.dtype}")

    def _run(self, x, dev, plain=False, safe=None, limbs=None):
        """``A @ x`` into a fresh float32 (N, H): the tail, the core, the
        BCSR tier. An integer x, or a float32 x with ``safe`` (rounded to
        ``round(x / safe)`` in every tier), takes an int8 or int4 core's
        integer product with ``limbs`` (default :data:`RAW_LIMBS` of x's
        dtype); the tier computes in the reference's dtype for x
        (``ops/bcsr.py:compute_mode``)."""
        self._check_x(x)
        kernels = self._kernels(dev, plain)
        out = torch.zeros((self.nrows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        if self.interleave is not None and safe is None and not plain:
            self._interleaved(x, dev, out, kernels, limbs)
        else:
            if safe is None:
                kernels[0](x, self.ell_tables(dev), out)
            else:
                kernels[0](x, self.ell_tables(dev), out, safe=safe)
            if self.stair:
                self._core_add(x, dev, out, kernels, safe, limbs, plain=plain)
        if self.has_bcsr:
            kernels[4](x, *self.bcsr_tables(dev), out, safe=safe)
        return out

    def _interleaved(self, x, dev, out, kernels, limbs=None):
        """The tail and the core of :meth:`_run` under the interleave: the
        core's product (:meth:`_core_add`) into a zeroed compact ``(k,
        H)`` f32 buffer at rows ``arange(k)``, on the operand's second
        stream on the card, while the tail runs into ``out`` on the
        caller's stream; after the join the buffer is added at
        ``core_nodes[:k]``. The sums are those of the serial order (tail,
        then ``out[r] += core[r]``): the buffer holds ``0 + core[r]``
        exactly. On the CPU the same steps run one after the other."""
        k = self.hybrid_k_eff
        cn = dev["core_nodes"]
        key = out.device
        rows = torch.arange(k, dtype=torch.int32, device=key)
        buf = torch.zeros((k, out.shape[1]), dtype=torch.float32,
                          device=key)
        if not out.is_cuda:
            kernels[0](x, self.ell_tables(dev), out)
            self._core_add(x, dev, buf, kernels, limbs=limbs, rows=rows)
            return out.index_add_(0, cn[:k], buf)
        if key not in self._side:
            self._side[key] = torch.cuda.Stream(device=key)
        main, side = torch.cuda.current_stream(key), self._side[key]
        side.wait_stream(main)  # x, rows, buf's zeros
        with torch.cuda.stream(side):
            self._core_add(x, dev, buf, kernels, limbs=limbs, rows=rows)
        for t in (x, rows, buf):  # made on the caller's stream, read on the side
            t.record_stream(side)
        kernels[0](x, self.ell_tables(dev), out)
        main.wait_stream(side)
        return out.index_add_(0, cn[:k], buf)

    def _gather_rows(self, dev):
        """The rows of the rank gather that the core's products read:
        ``core_nodes[:max w]``, or a mesh shard's ``core_rows[:max w]``
        where ``dev`` holds them."""
        rows = dev["core_rows"] if "core_rows" in dev else dev["core_nodes"]
        return rows[:max(w for *_, w in self.stair)]

    def _xc(self, x, cn, dev=None):
        """The rank gather ``x[core_nodes[:max w]]``, zero rows appended
        where a padded square core is wider than its k nodes; a mesh
        shard's ``x[core_rows]`` where ``dev`` holds them."""
        if dev is not None and "core_rows" in dev:
            return x.index_select(0, dev["core_rows"])
        w_max = max(w for *_, w in self.stair)
        xc = x.index_select(0, cn[:w_max])
        if xc.shape[0] < w_max:
            xc = torch.nn.functional.pad(xc, (0, 0, 0, w_max - xc.shape[0]))
        return xc

    def _core_add(self, x, dev, out, kernels, safe=None, limbs=None,
                  rows=None, xc=None, plain=False):
        """The core tier of :meth:`_run` into ``out`` at ``core_nodes`` (or
        ``rows``): the rank gather ``xc`` (or the caller's ``xc``, as wide
        as the stored band: a halo shard's hub buffer), rounded to
        ``round(xc / safe)`` where ``safe`` is given, then the product of
        the reference's ``_core_matmul`` for this core and payload
        (``pygim_tpu/ops/spmm.py:586-630``) through ``kernels``
        (:meth:`_kernels`):

        ========== ======================== =====================
        core       payload                  kernel, product
        ========== ======================== =====================
        int8, int4 float32, bfloat16        K-core, ``bf16(xc)``
        int8, int4 int8, int16, int32       K-int, exact int32
        bfloat16   float32, bfloat16, int8  K-core bf16, ``bf16(xc)`` (exact for int8)
        bfloat16   int16, int32             K-f32, both in f32
        float32    any                      K-f32, ``f32(xc)``
        ========== ======================== =====================

        A float64 core (a float64 graph with ``hybrid_dtype`` None) holds
        f32 cells, so it is the float32 row.

        Through the kernels (not ``plain``), an integer product on an int8
        or int4 core without the caller's ``xc`` takes its payload from
        K-quant (``ops/quant_prologue.py:core_payload``): the gather, the
        rounding and K-int's limbs in one pass."""
        _tail_fn, core_fn, int_fn, f32_fn, _bcsr_fn = kernels
        cn = dev["core_nodes"] if rows is None else rows
        bands = [dev[k] for k in self._band_keys]
        if (xc is None and not plain and self.core_dtype in INT_CORES
                and (safe is not None or not x.is_floating_point())):
            limbs = limbs or RAW_LIMBS[torch.int32 if safe is not None
                                       else x.dtype]
            w_max = max(w for *_, w in self.stair)
            payload = core_payload(x, self._gather_rows(dev), safe, limbs,
                                   *payload_dims(w_max, out.shape[1]))
            return int_fn(bands, None, cn, self.stair, out, limbs=limbs,
                          payload=payload)
        if xc is None:
            xc = self._xc(x, dev["core_nodes"], dev)
        if safe is not None:
            xc = torch.round(xc / safe).to(torch.int32)
        if self.core_dtype in INT_CORES:
            if xc.is_floating_point():
                return core_fn(bands, xc.to(torch.bfloat16), cn, self.stair,
                               out)
            return int_fn(bands, xc, cn, self.stair, out,
                          limbs=limbs or RAW_LIMBS[xc.dtype])
        if self.core_dtype == "bfloat16" and (
                xc.is_floating_point() or xc.dtype == torch.int8):
            return core_fn(bands, xc.to(torch.bfloat16), cn, self.stair, out)
        return f32_fn(bands, xc, cn, self.stair, out)

    @property
    def supports_fused_quant(self) -> bool:
        """True where :meth:`raw_mul_quantized` folds the quantization
        into the aggregate: the ell and hybrid backends."""
        return self.config.backend in ("ell", "hybrid")

    def raw_mul_quantized(self, x, dev: dict, agg_dtype, plain=False,
                          dequantize=True):
        """Fused quantize → A·x → dequantize, the reference's
        ``raw_mul_quantized``: ``scale = 2·max|x| / 2^k`` on the device,
        ``q = round(x / safe)`` (a true division, half to even), the exact
        integer core product (hybrid) and the f32-summed tail, then ``out *
        scale``. int8 and int16 round x once into an (N, H) table of that
        dtype, which every tier reads; int32 has no table (it would be as
        large as x) and rounds inside K-tail's gather (payload mode (iii))
        and on the core's gathered rows.

        A float ``agg_dtype`` ("float32", "bfloat16", "float16",
        "float64": the reference keeps x's float32 for each) is the float
        passthrough: ``k = 20``, x rounded once to ``round(x / safe)`` in
        float32, and that float payload through the float path (K-tail's
        f32 rows; an int8, int4 or bf16 core rounds it to bf16 in K-core,
        an f32 core takes it in K-f32; the tier in its float compute
        dtype), then ``out * scale``. Rounding before the gathers gives the
        reference's values, which rounds after them. ``x`` float32;
        returns float32. ``plain`` runs the plain versions.

        On the card K-quant computes the prologue
        (``ops/quant_prologue.py``): ``scale`` and ``safe`` in one
        reduction, the int8 / int16 table in one pass, and the core's
        limb payload straight from x or the table (:meth:`_core_add`).
        With ``dequantize=False`` the product comes back undequantized,
        as ``(out, scale)``: the caller folds ``out * scale`` into its
        epilogue (K-epi, ``nn/layers.py:bn_epilogue``)."""
        if not self.supports_fused_quant:
            raise ValueError(f"fused quantization unsupported for backend "
                             f"{self.config.backend!r}")
        name = dtype_name(agg_dtype)
        if name == "int64":
            # x64 off: int64 is int32, and its scale exponent is int32's
            # (_SCALE_EXP.get(name, 20), pygim_tpu/ops/spmm.py:1574)
            name = "int32"
        passthrough = name not in _SCALE_EXP
        kind = getattr(torch, name, None)
        if passthrough and not (isinstance(kind, torch.dtype)
                                and kind.is_floating_point):
            raise ValueError(f"fused quantization to {name!r}: int8, int16, "
                             "int32, int64 or a float dtype")
        if x.dtype != torch.float32:
            raise TypeError(f"quantized aggregation takes a float32 x, got "
                            f"{x.dtype}")
        _abs_max, scale, safe = (abs_max_scale_plain if plain
                                 else abs_max_scale)(x, name)
        if passthrough:
            out = self._run(torch.round(x / safe), dev, plain)
        elif name == "int32":
            out = self._run(x, dev, plain, safe=safe,
                            limbs=QUANT_LIMBS[name])
        else:
            xq = (quant_table_plain if plain else quant_table)(x, safe, name)
            out = self._run(xq, dev, plain, limbs=QUANT_LIMBS[name])
        return out * scale if dequantize else (out, scale)

    def mul_quantized(self, x, agg_dtype):
        """:meth:`raw_mul_quantized` on this operand's own tables."""
        return self.raw_mul_quantized(x, self._dev, agg_dtype)

    def mul_quantized_plain(self, x, agg_dtype):
        """:meth:`mul_quantized` through the plain versions."""
        return self.raw_mul_quantized(x, self._dev, agg_dtype, plain=True)

    def phase_times(self, x, iters: int = 3) -> dict:
        """Device times in ms of the product's phases, each timed alone
        with CUDA events (``utils/timers.device_time``), the reference's
        ``phase_times`` (``pygim_tpu/ops/spmm.py:1666-1773``; the oracle,
        ``blocked`` and ``coo`` have ``mul_time`` alone):

        * ``mul_time`` — :meth:`mul`;
        * ``gather_time`` — :func:`gather_only` over every ELL table's
          column steps (ell, hybrid);
        * ``tail_time`` — K-tail alone into a zero output (ell, hybrid);
          its mode follows x (f32 rows, bf16 rows, integer rows);
        * ``core_time`` — the rank gather and the core's product alone into
          a zero output (hybrid): K-core (int8 or int4 cells, or bf16
          cells with a float or int8 x), K-int (int8 or int4 cells with an
          integer x) or K-f32 (f32 cells, or bf16 cells with an int16 or
          int32 x), as :meth:`_core_add` dispatches;
        * ``bcsr_time`` — K-bcsr alone into a zero output (hybrid with a
          tier), in the compute mode ``mul`` takes for x.

        The phases overlap the product's work; they are no sum of it."""
        d = self._dev
        out = {"mul_time(ms)": device_time(self.mul, x, iters=iters) * 1e3}
        if self.config.backend not in ("ell", "hybrid"):
            return out
        x = as_payload(x)
        self._check_x(x)
        tables = self.ell_tables(d)

        def zeros():
            return torch.zeros((self.nrows, x.shape[1]), dtype=torch.float32,
                               device=x.device)

        out["gather_time(ms)"] = sum(
            device_time(gather_only, x, c, iters=iters) * 1e3
            for c, *_ in tables)
        out["tail_time(ms)"] = device_time(
            lambda: self._tail(x, tables, zeros()), iters=iters) * 1e3
        if self.stair:
            kernels = self._kernels(d, plain=False)
            out["core_time(ms)"] = device_time(
                lambda: self._core_add(x, d, zeros(), kernels),
                iters=iters) * 1e3
        if self.has_bcsr:
            out["bcsr_time(ms)"] = device_time(
                lambda: self._bcsr(x, *self.bcsr_tables(d), zeros()),
                iters=iters) * 1e3
        return out


# the backends that run hand kernels (blocked and coo: K-rows)
KERNEL_BACKENDS = ("hybrid", "ell", "blocked", "coo")


def runs_kernels(prep) -> bool:
    """Whether ``prep``'s products run hand kernels, which autograd cannot
    follow: a mesh operand (``parallel/``: its shards are ell or hybrid
    whatever the backend named) or a single-card operand of
    :data:`KERNEL_BACKENDS`."""
    return (getattr(prep, "mesh", None) is not None
            or prep.config.backend in KERNEL_BACKENDS)


class SpmmFunction(torch.autograd.Function):
    """``A @ x`` through ``prep``'s kernels (:meth:`PreparedSpmm.mul`),
    differentiable in x: the backward is ``Aᵀ @ g`` through the same
    kernels on :meth:`PreparedSpmm.transpose`. The port's counterpart of
    JAX's autodiff through the reference's ``raw_mul``. Any operand with
    ``mul`` and a prepared ``transpose()`` serves: the mesh operands
    (``parallel/spmm_2d.py``, ``parallel/halo.py``) run ``Aᵀ g`` on their
    own layout's kernels, their product landing on x's device.

    Numerics of the core (hybrid): on int8, int4 and bf16 cells the
    reference's autodiff of ``bf16(band) @ bf16(xc)`` computes each
    band's transposed product, rounds it to bf16 and adds the bands'
    shares in bf16; K-core on Aᵀ rounds ``g`` to bf16 once, before its
    product, and sums in f32. Each core term stays within 2^-8 relative
    of the exact ``Aᵀ @ g``. On f32 cells both sides are f32 products
    (K-f32 on Aᵀ), differing in summation order only. The tail
    is f32 on both sides; K-tail adds hub pieces with atomics, so two
    backward passes on the card may differ in the last bits. ``blocked``
    and ``coo`` (K-rows on Aᵀ): f32 on both sides, summation order only,
    K-rows' hub pieces added with atomics."""

    @staticmethod
    def forward(ctx, x, prep):
        ctx.prep = prep
        return prep.mul(x.contiguous())

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return ctx.prep.transpose().mul(g.contiguous()), None


class PreparedAggregate:
    """Callable aggregate ``v -> A·v`` bound to a prepared operand, with
    ``quantized_raw`` and ``quantized``, the fused quantized-aggregate
    hooks the conv layers probe
    (:func:`pygim_tpu_torch.nn.layers.raw_quantized_aggregate`): the
    integer dtypes and the float passthrough, undequantized and
    dequantized. Under grad
    mode a payload that requires grad goes through :class:`SpmmFunction`
    on the kernel backends, whose operand's transpose must be prepared
    first (``prep.transpose(graph)``), as on a mesh operand; ``oracle``
    is PyTorch ops, which autograd follows."""

    def __init__(self, prep, dev=None):
        self.prep = prep
        self.dev = prep.dev_arrays if dev is None else dev

    def __call__(self, v):
        if (torch.is_grad_enabled() and v.requires_grad
                and runs_kernels(self.prep)):
            if self.dev is not self.prep.dev_arrays:
                raise NotImplementedError(
                    "a gradient through tables other than the operand's "
                    "own: its prepared transpose is of its own graph")
            self.prep.transpose()  # raises before the forward if unprepared
            return SpmmFunction.apply(v, self.prep)
        return self.prep.raw_mul(v, self.dev)

    def quantized(self, v, agg_dtype: str):
        """Fused quantize → aggregate → dequantize
        (:meth:`PreparedSpmm.raw_mul_quantized`), or None where the
        backend does not fuse (the caller then quantizes around the plain
        aggregate). Raises under grad mode on a payload that requires
        grad: training aggregates the float payload, as the reference's
        train step, and the port does not imitate the gradient JAX passes
        through ``max|x|`` in the scale."""
        raw = self.quantized_raw(v, agg_dtype)
        return None if raw is None else raw[0] * raw[1]

    def quantized_raw(self, v, agg_dtype: str):
        """:meth:`quantized` before its dequantize: ``(out, scale)`` with
        the aggregate ``out * scale``, or None where the backend does not
        fuse. The evaluation forward takes this hook and folds ``out *
        scale`` into the layer's epilogue (K-epi,
        ``nn/layers.py:bn_epilogue``)."""
        if torch.is_grad_enabled() and v.requires_grad:
            raise NotImplementedError(
                f"a gradient through the {agg_dtype} quantized aggregate: "
                "training aggregates the float payload (agg_dtype=None)")
        if not self.prep.supports_fused_quant:
            return None
        return self.prep.raw_mul_quantized(v, self.dev, agg_dtype,
                                           dequantize=False)


def prepare_spmm(graph, config: Optional[SpmmConfig] = None, *,
                 device="cuda", **kw) -> PreparedSpmm:
    """Entry point: plan, fill and move ``graph`` to ``device``."""
    if config is None:
        config = SpmmConfig(**kw)
    elif kw:
        config = dataclasses.replace(config, **kw)
    return PreparedSpmm(graph, config, device=device)
