"""Host planning of the sparse operands.

Counterpart of ``pygim_tpu/core/partition.py``: the multi-degree ELL
planner of the hybrid's tail (the edges outside the dense core, packed
into up to three tables of different fixed degree D; every row lands in
exactly one table, and rows longer than D are split into several virtual
rows that the run path adds back into the same output row), the
row-block planner of the ``blocked`` backend, and the cell rules of the
integer cores (range check, nibble packing).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from pygim_tpu_torch.core.graph import INDEX_DTYPE, CsrGraph


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class EllRows:
    """Fixed-degree row-ELL with virtual-row splitting.

    ``cols``/``vals``: (n_virtual_pad, D) — padding entries col 0 / val 0.
    ``vrow_to_row``: (n_virtual_pad,) destination row per virtual row;
    padding targets the last row (nrows-1) with zero values, which keeps
    the array non-decreasing.
    """

    cols: np.ndarray
    vals: np.ndarray
    vrow_to_row: np.ndarray
    degree: int
    n_virtual: int
    nrows: int
    ncols: int


_ELL_DEGREE_CANDIDATES = (
    2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512
)

# The reference planner's cost constants, kept value for value so the
# port plans the same tables as the reference: a per-slot gather cost,
# and a per-virtual-row overhead with a part that grows with the dense
# width H. The argmin below reads only their ratios. They are to be
# recalibrated on the card, with the table shapes then allowed to differ
# from the reference's, in the slice that ports the tuner.
_ELL_SLOT_NS = 8.7
_ELL_VROW_FIXED_NS = 52.0
_ELL_VROW_NS_PER_H = 1.0 / 68.0


def _ell_vrow_ns(hidden) -> float:
    h = 256 if hidden is None else int(hidden)
    return _ELL_VROW_FIXED_NS + h * _ELL_VROW_NS_PER_H


def choose_ell_degree(
    row_lengths: np.ndarray, hidden: Optional[int] = None
) -> int:
    """Single degree D: argmin over the candidates of
    ``Σ_r ceil(deg_r / D) · (D·slot + vrow(H))``."""
    deg = row_lengths[row_lengths > 0].astype(np.int64)
    if deg.size == 0:
        return 4
    v_ns = _ell_vrow_ns(hidden)
    best_d, best_cost = 4, float("inf")
    for d in _ELL_DEGREE_CANDIDATES:
        n_vr = int((-(-deg // d)).sum())
        cost = n_vr * (d * _ELL_SLOT_NS + v_ns)
        if cost < best_cost - 1e-9:
            best_d, best_cost = d, cost
    return best_d


def choose_ell_degrees(
    row_lengths: np.ndarray,
    hidden: Optional[int] = None,
    max_tables: int = 3,
) -> "tuple[int, ...]":
    """Multi-degree ELL: up to ``max_tables`` degrees, each row packed in
    the table that costs it least. Exhaustive search over candidate
    combinations on the degree histogram; an extra table must cut the
    modelled cost by ≥2% to be kept. Returns degrees ascending."""
    deg = row_lengths[row_lengths > 0].astype(np.int64)
    if deg.size == 0:
        return (4,)
    if max_tables <= 1:
        return (choose_ell_degree(row_lengths, hidden),)
    cnt = np.bincount(deg)  # cnt[d] rows of degree d
    ds = np.arange(cnt.size, dtype=np.int64)
    v_ns = _ell_vrow_ns(hidden)
    cands = [d for d in _ELL_DEGREE_CANDIDATES if d <= max(2, deg.max())]
    cost = {
        D: (-(-ds // D)) * (D * _ELL_SLOT_NS + v_ns) * cnt
        for D in cands
    }
    best: "tuple[float, tuple[int, ...]]" = (float("inf"), (4,))
    for t in range(1, max_tables + 1):
        t_best = (float("inf"), (4,))
        for combo in itertools.combinations(cands, t):
            c = float(np.minimum.reduce([cost[D] for D in combo]).sum())
            if c < t_best[0]:
                t_best = (c, combo)
        if t_best[0] < best[0] * (1.0 - 0.02 * (t > 1)):
            best = t_best
        else:
            break
    return tuple(sorted(best[1]))


def choose_degrees_for_config(row_lengths: np.ndarray, config) -> "tuple[int, ...]":
    """The degree set for a (graph, config): pinned degree, single table,
    or the multi-table split."""
    if config.ell_degree:
        return (config.ell_degree,)
    if config.ell_tables <= 1:
        return (choose_ell_degree(row_lengths, hidden=config.hidden_hint),)
    return choose_ell_degrees(
        row_lengths, hidden=config.hidden_hint, max_tables=config.ell_tables,
    )


def assign_ell_tables(
    row_lengths: np.ndarray,
    degrees: "tuple[int, ...]",
    hidden: Optional[int] = None,
) -> np.ndarray:
    """Per-row table index (into sorted ``degrees``) minimizing the
    modelled per-row cost; -1 for empty rows."""
    deg = row_lengths.astype(np.int64)
    v_ns = _ell_vrow_ns(hidden)
    costs = np.stack(
        [(-(-deg // D)) * (D * _ELL_SLOT_NS + v_ns) for D in degrees]
    )
    pick = np.argmin(costs, axis=0).astype(np.int32)
    pick[deg == 0] = -1
    return pick


def build_ell_rows(
    csr: CsrGraph, degree: Optional[int] = None, *, row_chunk: int = 1
) -> EllRows:
    """Vectorized construction of one fixed-degree table. ``row_chunk``
    pads n_virtual to a multiple (the run path's step size)."""
    deg = np.diff(csr.rowptr).astype(np.int64)
    D = degree if degree is not None else choose_ell_degree(deg)
    n_vr_per_row = -(-deg // D)  # 0 for empty rows
    vrow_offset = np.zeros(csr.nrows + 1, dtype=np.int64)
    np.cumsum(n_vr_per_row, out=vrow_offset[1:])
    n_virtual = int(vrow_offset[-1])
    n_virtual_pad = round_up(max(n_virtual, 1), row_chunk)

    cols = np.zeros((n_virtual_pad, D), dtype=INDEX_DTYPE)
    vals = np.zeros((n_virtual_pad, D), dtype=csr.vals.dtype)
    vrow_to_row = np.full(
        n_virtual_pad, max(csr.nrows - 1, 0), dtype=INDEX_DTYPE
    )
    rows_of_nnz = np.repeat(np.arange(csr.nrows, dtype=np.int64), deg)
    pos_in_row = np.arange(csr.nnz, dtype=np.int64) - np.repeat(
        csr.rowptr[:-1].astype(np.int64), deg
    )
    gvr = vrow_offset[rows_of_nnz] + pos_in_row // D
    slot = pos_in_row % D
    flat = gvr * D + slot
    cols.reshape(-1)[flat] = csr.colind
    vals.reshape(-1)[flat] = csr.vals
    nz_rows = np.flatnonzero(n_vr_per_row)
    vrow_to_row[:n_virtual] = np.repeat(nz_rows, n_vr_per_row[nz_rows])
    return EllRows(
        cols=cols, vals=vals, vrow_to_row=vrow_to_row, degree=D,
        n_virtual=n_virtual, nrows=csr.nrows, ncols=csr.ncols,
    )


def build_ell_rows_multi(
    csr: CsrGraph,
    degrees: "tuple[int, ...]",
    hidden: Optional[int] = None,
    row_chunk_for=None,
) -> "list[EllRows]":
    """Multi-degree ELL tables: each row's edges land in exactly one
    table (:func:`assign_ell_tables`), so the tables' adds into the
    output touch disjoint rows. A degree nobody picked is dropped.
    ``row_chunk_for(D)`` supplies each table's step size (default 1)."""
    lens = csr.row_lengths
    pick = assign_ell_tables(lens, degrees, hidden)
    deg64 = lens.astype(np.int64)
    edge_pick = np.repeat(pick, deg64)  # per-nnz table index
    out: "list[EllRows]" = []
    for gi, D in enumerate(degrees):
        rmask = pick == gi
        if not rmask.any():
            continue
        sub_lens = np.where(rmask, deg64, 0)
        rowptr = np.zeros(csr.nrows + 1, dtype=np.int64)
        np.cumsum(sub_lens, out=rowptr[1:])
        sel = edge_pick == gi
        sub = CsrGraph(
            rowptr=rowptr, colind=csr.colind[sel], vals=csr.vals[sel],
            ncols=csr.ncols,
        )
        chunk = 1 if row_chunk_for is None else row_chunk_for(D)
        out.append(build_ell_rows(sub, D, row_chunk=chunk))
    if not out:  # empty graph: one empty table keeps callers simple
        chunk = 1 if row_chunk_for is None else row_chunk_for(degrees[0])
        out.append(build_ell_rows(csr, degrees[0], row_chunk=chunk))
    return out


# ---- row-block planning of the blocked backend ----------------------------
# NumPy copies of ``pygim_tpu/core/partition.py:33-193``.


def plan_row_blocks(rowptr: np.ndarray, n_blocks: int,
                    balance: str = "nnz") -> np.ndarray:
    """Row boundaries ``bounds`` (n_blocks + 1,): block b owns rows
    ``[bounds[b], bounds[b + 1])``. ``balance='row'``: equal row counts;
    ``'nnz'``: each boundary where the running nnz first reaches ``b ·
    nnz / n_blocks`` (row-granular)."""
    nrows = rowptr.shape[0] - 1
    if n_blocks <= 0:
        raise ValueError("n_blocks must be positive")
    if balance == "row":
        bounds = np.linspace(0, nrows, n_blocks + 1).round().astype(np.int64)
    elif balance == "nnz":
        nnz = int(rowptr[-1])
        targets = (np.arange(1, n_blocks, dtype=np.int64) * nnz) // n_blocks
        cuts = np.searchsorted(rowptr[1:], targets, side="left") + 1
        bounds = np.concatenate(([0], cuts, [nrows])).astype(np.int64)
        bounds = np.maximum.accumulate(np.minimum(bounds, nrows))
    else:
        raise ValueError(f"unknown balance policy {balance!r}")
    return bounds.astype(INDEX_DTYPE)


@dataclasses.dataclass(frozen=True)
class RowBlockPlan:
    """A static row-block partition of one CSR operand: ``bounds``
    (n_blocks + 1,), and every block padded to ``rows_pad`` rows and
    ``nnz_pad`` entries."""

    bounds: np.ndarray
    rows_pad: int
    nnz_pad: int
    balance: str

    @property
    def n_blocks(self) -> int:
        return int(self.bounds.shape[0]) - 1

    @property
    def rows_per_block(self) -> np.ndarray:
        return np.diff(self.bounds)


def make_row_block_plan(csr: CsrGraph, n_blocks: int, balance: str = "nnz",
                        *, row_align: int = 8,
                        nnz_align: int = 8) -> RowBlockPlan:
    """:func:`plan_row_blocks` with the blocks' static paddings: the most
    rows and the most entries of any block, rounded up to ``row_align``
    and ``nnz_align``."""
    bounds = plan_row_blocks(csr.rowptr, n_blocks, balance)
    rows_per_block = np.diff(bounds)
    nnz_per_block = csr.rowptr[bounds[1:]] - csr.rowptr[bounds[:-1]]
    rows_pad = round_up(max(int(rows_per_block.max(initial=0)), 1), row_align)
    nnz_pad = round_up(max(int(nnz_per_block.max(initial=0)), 1), nnz_align)
    return RowBlockPlan(bounds=bounds, rows_pad=rows_pad, nnz_pad=nnz_pad,
                        balance=balance)


def row_slot_table(plan: RowBlockPlan) -> np.ndarray:
    """Global row r → its slot in the flattened (n_blocks, rows_pad)
    output, so one gather recovers the (nrows, H) result."""
    nrows = int(plan.bounds[-1])
    slot = np.empty(nrows, dtype=INDEX_DTYPE)
    for b in range(plan.n_blocks):
        r0, r1 = int(plan.bounds[b]), int(plan.bounds[b + 1])
        slot[r0:r1] = b * plan.rows_pad + np.arange(r1 - r0)
    return slot


def with_padding(plan: RowBlockPlan, rows_pad: int,
                 nnz_pad: int) -> RowBlockPlan:
    """The plan with larger static capacities (one padded shape for
    several parts)."""
    if rows_pad < plan.rows_pad or nnz_pad < plan.nnz_pad:
        raise ValueError("padding can only grow")
    return dataclasses.replace(plan, rows_pad=rows_pad, nnz_pad=nnz_pad)


@dataclasses.dataclass(frozen=True)
class EllBlocks:
    """Padded per-block tables: ``colind``, ``vals``, ``rowloc``
    (n_blocks, nnz_pad) — padding entries col 0, value 0 and the block's
    last padded row — and ``row_start`` (n_blocks,)."""

    colind: np.ndarray
    vals: np.ndarray
    rowloc: np.ndarray
    row_start: np.ndarray
    rows_pad: int
    nnz_pad: int
    nrows: int
    ncols: int


def build_ell_blocks(csr: CsrGraph, plan: RowBlockPlan) -> EllBlocks:
    """The padded block tables of ``csr`` under ``plan``: block b holds
    the entries of its rows in CSR order, each with its block-local row."""
    nb = plan.n_blocks
    colind = np.zeros((nb, plan.nnz_pad), dtype=INDEX_DTYPE)
    vals = np.zeros((nb, plan.nnz_pad), dtype=csr.vals.dtype)
    rowloc = np.full((nb, plan.nnz_pad), plan.rows_pad - 1, dtype=INDEX_DTYPE)
    rowptr = csr.rowptr
    rows_of_nnz = np.repeat(np.arange(csr.nrows, dtype=np.int64),
                            np.diff(rowptr))
    for b in range(nb):
        r0, r1 = int(plan.bounds[b]), int(plan.bounds[b + 1])
        e0, e1 = int(rowptr[r0]), int(rowptr[r1])
        k = e1 - e0
        colind[b, :k] = csr.colind[e0:e1]
        vals[b, :k] = csr.vals[e0:e1]
        rowloc[b, :k] = rows_of_nnz[e0:e1] - r0
    return EllBlocks(
        colind=colind, vals=vals, rowloc=rowloc,
        row_start=plan.bounds[:-1].astype(INDEX_DTYPE),
        rows_pad=plan.rows_pad, nnz_pad=plan.nnz_pad,
        nrows=csr.nrows, ncols=csr.ncols,
    )


# ---- integer core cells (the hybrid's int8 and packed int4 cores) ---------


def int_demote_slab(slab: np.ndarray, core_dtype: str):
    """Round a float core slab to the exact-integer range of
    ``core_dtype`` ([-128, 127] for int8, [-8, 7] for int4). Cells that
    are not an integer in the range are zeroed; returns ``(rounded,
    bad_flat)``, ``bad_flat`` their row-major flat indices (int64), so the
    caller demotes their edges to the exact tail
    (``pygim_tpu/core/partition.py:531-552``)."""
    hi = 127 if core_dtype == "int8" else 7
    r = np.round(slab)
    bad = (r > hi) | (r < -hi - 1) | (r != slab)
    if not bad.any():
        return r, np.empty(0, dtype=np.int64)
    br, bc = np.nonzero(bad)
    return np.where(bad, 0.0, r), br.astype(np.int64) * slab.shape[1] + bc


def pack_nibbles(slab: np.ndarray) -> np.ndarray:
    """Nibble-pack an integer-valued slab of even width column-pairwise:
    byte j holds cells (2j, 2j + 1), the low nibble the even column
    (``pygim_tpu/core/partition.py:555-560``)."""
    lo = slab[:, 0::2].astype(np.int8).astype(np.uint8) & 0xF
    hi = slab[:, 1::2].astype(np.int8).astype(np.uint8) & 0xF
    return lo | (hi << 4)
