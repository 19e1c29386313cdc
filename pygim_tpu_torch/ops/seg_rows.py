"""K-rows: the gather-weight-sum of the ``blocked`` and ``coo`` backends.

Counterpart of two XLA bodies of the reference: ``blocked_spmm``
(``pygim_tpu/ops/spmm.py:136-161``) and the ``coo`` backend's run
(``pygim_tpu/ops/spmm.py:1883-1897``), each a ``lax.scan`` of
``jnp.take`` and ``segment_sum``. The CUDA kernel is ``csrc/seg_rows.cu``:
one launch over a backend's whole tables, read in place, walking a unit
list built here on the host at prepare (:func:`blocked_plan`,
:func:`coo_plan`). For every output row ``r``::

    out[r] = Σ over the row's stored entries e of vals[e] · x[cols[e]]

in ``accum_dtype`` of the weights' and the payload's promoted dtype
(``ops/reference.py``): float32 where either is float (bfloat16 too),
int32 wrapping for integer weights and an integer payload.

``blocked`` reads ``colind``, ``vals``, ``rowloc`` (``(n_blocks,
nnz_pad)``) and the inverse of ``row_slot`` (slot → row, -1 for a slot
that holds none); entry e of block b lands in row ``inv[b · rows_pad +
rowloc[e]]``. The pads of a block (col 0, val 0, the block's last slot)
land on its last row where the block fills ``rows_pad`` rows and are
dropped otherwise, as in the reference, so ``0 · x[0]`` spreads a
non-finite ``x[0]`` into exactly the reference's rows. ``coo`` reads
``rows``, ``cols``, ``vals`` (``(n_chunks, chunk_nnz)``) as one flat
row-sorted stream, so a row that straddles chunks is one run; its pads
(row ``nrows - 1``, col 0, val 0) are summed as stored. Rows without
entries come out zero.

The plan (:class:`SegPlan`) cuts the rows into units of whole row runs,
about :data:`UNIT_ENTRIES` entries and at most :data:`UNIT_ROWS` rows
each, never across a block; a unit writes each of its rows once. A row
longer than :data:`UNIT_ENTRIES` (a hub) is cut into pieces of that many
entries, each a unit that adds its partial sum with atomics into the row,
which a small kernel zeroes first. Integer atomics are exact in any
order; float pieces add in no fixed order, so two runs on the card may
differ in the last bits of a hub row.

The wrappers (:func:`blocked_rows`, :func:`coo_rows`) take the plain
versions (:func:`blocked_spmm`, :func:`coo_plain`) for CPU tensors and
launch the kernel on CUDA tensors or raise; each mode counts its
launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from pygim_tpu_torch.ops import _build
from pygim_tpu_torch.ops.reference import accum_dtype

# kernel launches since the last reset (plain ints; launches only), by mode
launches = 0
coo_launches = 0

UNIT_ENTRIES = 128  # entries a unit aims at; a longer row is cut in pieces
UNIT_ROWS = 64      # rows a unit owns at most

# the kernel's codes of the weights' and the payload's dtypes
VAL_CODES = {torch.float32: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3}
X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3,
           torch.int32: 4}


def blocked_spmm(colind, vals, rowloc, row_slot, x, rows_pad: int):
    """The blocked product in plain PyTorch (``pygim_tpu/ops/spmm.py:
    136-161``): for each row block b, gather ``x[colind[b]]``, weight it
    by ``vals[b]`` and sum it into the block's ``rows_pad`` rows at
    ``rowloc[b]``; then take each row's slot (``row_slot``). One block at
    a time, so no (nnz, H) buffer exists. Accumulates in ``accum_dtype``
    of the two dtypes: float32 for a float payload or float weights,
    int32 (wrapping) for an integer one."""
    acc = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
    h = x.shape[1]
    if x.shape[0] == 0 or colind.shape[0] == 0:
        # a zero-column or zero-edge operand: the padding indices would
        # gather from an empty x; the product is exact zeros
        return torch.zeros((row_slot.shape[0], h), dtype=acc, device=x.device)
    out = torch.zeros((colind.shape[0] * rows_pad, h), dtype=acc,
                      device=x.device)
    for b in range(colind.shape[0]):
        g = x.index_select(0, colind[b]).to(acc) * vals[b].to(acc)[:, None]
        out[b * rows_pad:(b + 1) * rows_pad].index_add_(0, rowloc[b], g)
    return out.index_select(0, row_slot)


def coo_plain(rows, cols, vals, x, nrows: int):
    """The ``coo`` body in plain PyTorch (``pygim_tpu/ops/spmm.py:
    1883-1897``): per chunk, ``x[cols] · vals`` in the accumulation dtype,
    added by row into the output; one chunk's ``(chunk, H)`` gather at a
    time."""
    acc = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
    out = torch.zeros((nrows, x.shape[1]), dtype=acc, device=x.device)
    for r, c, v in zip(rows, cols, vals):
        out.index_add_(0, r, x.index_select(0, c).to(acc)
                       * v.to(acc)[:, None])
    return out


@dataclasses.dataclass
class SegPlan:
    """One operand's K-rows plan: ``units`` int32 ``(n, 4)`` rows (first
    entry of the flat stream, entries, first row, rows | atomic << 30),
    the units with the most entries first; ``hub_rows`` int32, the rows
    whose pieces add atomically; ``inv`` int32 (blocked: slot → row, -1
    for none; None for coo); ``nrows`` the output's rows. ``to(device)``
    gives the copy a launch reads."""

    units: np.ndarray
    hub_rows: np.ndarray
    inv: "np.ndarray | None"
    nrows: int
    dev: dict = dataclasses.field(default_factory=dict)

    @property
    def n_units(self) -> int:
        return int(self.units.shape[0])

    def reading(self) -> dict:
        """The plan's counts: units, the pieces of hub rows among them,
        hub rows, and the entries the units walk."""
        u = self.units.astype(np.int64)
        return dict(units=self.n_units,
                    pieces=int(((u[:, 3] >> 30) == 1).sum()),
                    hub_rows=int(self.hub_rows.size),
                    entries=int(u[:, 1].sum()))

    def to(self, device) -> dict:
        """The plan's tables on ``device`` (made once, then kept)."""
        device = torch.device(device)
        if device not in self.dev:
            self.dev[device] = {
                k: None if v is None else torch.from_numpy(
                    np.ascontiguousarray(v)).to(device)
                for k, v in (("units", self.units),
                             ("hub_rows", self.hub_rows), ("inv", self.inv))}
        return self.dev[device]


def plan_units(counts, starts, breaks) -> "tuple[np.ndarray, np.ndarray]":
    """The unit list over rows in order: ``counts[r]`` entries of row r
    from flat entry ``starts[r]`` on, ``breaks[r]`` True where a unit must
    begin (a block's first row). Rows of at most :data:`UNIT_ENTRIES`
    entries go into units of consecutive rows, a new unit wherever the
    entries before a row (counted from the stretch's start) cross a
    multiple of :data:`UNIT_ENTRIES` or its rows one of
    :data:`UNIT_ROWS`, and at every break or hub: fewer than twice
    :data:`UNIT_ENTRIES` entries a unit. A hub row is cut into pieces of
    :data:`UNIT_ENTRIES` entries, flagged atomic. Returns ``(units,
    hub_rows)`` (:class:`SegPlan`)."""
    counts = np.asarray(counts, np.int64)
    starts = np.asarray(starts, np.int64)
    n = counts.size
    empty = np.zeros((0, 4), np.int32), np.zeros(0, np.int32)
    if n == 0:
        return empty
    hub = counts > UNIT_ENTRIES
    cut = np.asarray(breaks, bool).copy()
    cut[0] = True
    cut |= hub
    cut[1:] |= hub[:-1]
    first = np.flatnonzero(cut)  # each stretch's first row
    sid = np.cumsum(cut) - 1
    before = np.cumsum(counts) - counts
    c = before - before[first][sid]  # entries before the row in its stretch
    i = np.arange(n) - first[sid]  # rows before it
    new = cut.copy()
    new[1:] |= ((c[1:] // UNIT_ENTRIES != c[:-1] // UNIT_ENTRIES)
                | (i[1:] // UNIT_ROWS != i[:-1] // UNIT_ROWS))
    heads = np.flatnonzero(new & ~hub)
    units = []
    if heads.size:
        # a unit runs from its head to the next unit's head or a hub row
        stop = np.r_[np.flatnonzero(new), n]
        nxt = stop[np.searchsorted(stop, heads, side="right")]
        csum = np.r_[0, np.cumsum(counts)]
        units.append(np.stack([starts[heads], csum[nxt] - csum[heads], heads,
                               nxt - heads, np.zeros_like(heads)], 1))
    hubs = np.flatnonzero(hub)
    if hubs.size:
        k = -(-counts[hubs] // UNIT_ENTRIES)
        row = np.repeat(hubs, k)
        j = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
        ent = np.minimum(UNIT_ENTRIES, counts[row] - j * UNIT_ENTRIES)
        units.append(np.stack([starts[row] + j * UNIT_ENTRIES, ent, row,
                               np.ones_like(row), np.ones_like(row)], 1))
    if not units:
        return empty
    u = np.concatenate(units)
    if u[:, 0].max(initial=0) + UNIT_ENTRIES >= 1 << 31:
        raise ValueError("K-rows: more than 2^31 stored entries")
    u = u[np.argsort(-u[:, 1], kind="stable")]
    packed = np.stack([u[:, 0], u[:, 1], u[:, 2], u[:, 3] | u[:, 4] << 30], 1)
    return packed.astype(np.int32), hubs.astype(np.int32)


def blocked_plan(rowloc, row_slot, rows_pad: int, colind=None,
                 vals=None) -> SegPlan:
    """The plan of a blocked operand from its host tables: ``rowloc``
    ``(n_blocks, nnz_pad)`` (sorted within each block, as
    ``core/partition.py:build_ell_blocks`` stores it) and ``row_slot``
    (increasing: every block's rows consecutive, as ``row_slot_table``).
    A row's run is its slot's entries; the entries of a slot that holds
    no row (a block's pads past its rows) are in no unit. With
    ``colind`` and ``vals``, a block that fills its ``rows_pad`` rows
    keeps one of the equal zero-weight entries that end its last row (its
    pads: col 0, val 0): each adds the same ``0 · x[col]``, and adding it
    again changes nothing, NaN and signed zeros included, so a block of
    a row-balanced plan, padded to the densest block's entries, is not
    walked pad by pad."""
    rowloc = np.asarray(rowloc)
    row_slot = np.asarray(row_slot, np.int64)
    nb, nnz_pad = rowloc.shape
    nrows = row_slot.size
    if nrows and np.any(np.diff(row_slot) <= 0):
        raise ValueError("K-rows: row_slot must be increasing")
    inv = np.full(nb * rows_pad, -1, np.int32)
    inv[row_slot] = np.arange(nrows, dtype=np.int32)
    counts = np.zeros(nrows, np.int64)
    starts = np.zeros(nrows, np.int64)
    block = row_slot // max(1, rows_pad)
    for b in range(nb):
        rl = rowloc[b]
        if np.any(rl[1:] < rl[:-1]):
            raise ValueError(f"K-rows: rowloc of block {b} is not sorted")
        per_slot = np.bincount(rl, minlength=rows_pad)
        mine = inv[b * rows_pad:(b + 1) * rows_pad]
        live = mine >= 0
        counts[mine[live]] = per_slot[live]
        starts[mine[live]] = b * nnz_pad + np.cumsum(per_slot)[live] \
            - per_slot[live]
        if colind is not None and mine[-1] >= 0 and per_slot[-1] > 1:
            counts[mine[-1]] -= _repeats(colind[b], vals[b], per_slot[-1])
    breaks = np.r_[True, block[1:] != block[:-1]] if nrows else np.zeros(
        0, bool)
    units, hubs = plan_units(counts, starts, breaks)
    return SegPlan(units=units, hub_rows=hubs, inv=inv, nrows=nrows)


def _repeats(cols, vals, run: int) -> int:
    """How many of the last ``run`` entries of a full block (its last
    row's) repeat the zero-weight entry before them: the equal (col, val
    bits) entries that end the row, but the first, where that val is
    0."""
    if vals[-1] != 0:
        return 0
    bits = np.ascontiguousarray(vals[-run:]).view(f"u{vals.itemsize}")
    same = (cols[-run:] == cols[-1]) & (bits == bits[-1])
    tail = run if same.all() else int(np.argmin(same[::-1]))
    return max(0, tail - 1)


def coo_plan(rows, nrows: int) -> SegPlan:
    """The plan of a coo operand from its ``rows`` table (``(n_chunks,
    chunk_nnz)``, non-decreasing when flattened, as
    ``core/partition.py:build_coo_chunks`` stores it)."""
    flat = np.asarray(rows).reshape(-1)
    if np.any(flat[1:] < flat[:-1]):
        raise ValueError("K-rows: coo rows must be non-decreasing")
    counts = np.bincount(flat, minlength=nrows).astype(np.int64)
    starts = np.cumsum(counts) - counts
    units, hubs = plan_units(counts, starts, np.zeros(nrows, bool))
    return SegPlan(units=units, hub_rows=hubs, inv=None, nrows=nrows)


@functools.lru_cache(maxsize=None)
def _dtype_codes(vals_dtype, x_dtype):
    acc = accum_dtype(torch.promote_types(vals_dtype, x_dtype))
    if (vals_dtype not in VAL_CODES or x_dtype not in X_CODES
            or acc not in (torch.float32, torch.int32)):
        raise TypeError(
            f"K-rows takes float32, int32, int16 or int8 weights and a "
            f"float32, bfloat16, int8, int16 or int32 payload, got "
            f"{vals_dtype} weights and a {x_dtype} payload")
    return VAL_CODES[vals_dtype], X_CODES[x_dtype], acc == torch.int32


def _codes(vals, x):
    """The kernel's (val code, x code, integer accumulation) for these
    dtypes, or TypeError where it has none (cached by dtype pair)."""
    return _dtype_codes(vals.dtype, x.dtype)


_lib = None  # the bound library, once loaded


def _launch(plan: SegPlan, cols, vals, keys, x, blocked: bool,
            nnz_pad: int = 0, rows_pad: int = 0):
    """One K-rows launch into a fresh (nrows, H) output. The host's part
    of a call is kept to what changes between calls: the dtype codes are
    cached by dtype pair, the library once, the plan's device copy once,
    and the device is switched only where x is not on the current one
    (``chip_smoke.py:rows_host_steps`` times each step)."""
    global _lib
    val_code, x_code, int_acc = _codes(vals, x)
    h = x.shape[1]
    dev = x.device
    out = torch.empty((plan.nrows, h),
                      dtype=torch.int32 if int_acc else torch.float32,
                      device=dev)
    for name, t in (("cols", cols), ("vals", vals), ("keys", keys), ("x", x)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"K-rows: {name} must be contiguous on {dev}")
    if cols.dtype != torch.int32 or keys.dtype != torch.int32:
        raise TypeError("K-rows: the index tables must be int32")
    if plan.nrows == 0 or h == 0:
        return out.zero_()
    d = plan.to(dev)
    xp, op = x.data_ptr(), out.data_ptr()
    vec = h % 4 == 0 and xp % (4 * x.element_size()) == 0 and op % 16 == 0
    if _lib is None:
        _lib = _build.load("seg_rows")
    switch = dev.index is not None and dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        err = _lib.seg_rows(
            d["units"].data_ptr(), plan.n_units, d["hub_rows"].data_ptr(),
            int(plan.hub_rows.size), cols.data_ptr(), vals.data_ptr(),
            val_code, keys.data_ptr(),
            d["inv"].data_ptr() if blocked else None, nnz_pad, rows_pad,
            xp, x_code, int(int_acc), op, h, int(vec), _build.stream_of(x))
    _build.check(err, "seg_rows")
    return out


def blocked_rows(colind, vals, rowloc, row_slot, x, rows_pad: int,
                 plan: "SegPlan | None" = None):
    """``A @ x`` of a blocked operand's tables (the arguments of
    :func:`blocked_spmm`): the plain version on CPU tensors; on CUDA
    tensors one K-rows launch on ``plan`` (:func:`blocked_plan` of these
    tables, which the operand builds at prepare; None raises), or a
    raise. A zero-column or zero-edge operand is exact zeros, as the
    reference's."""
    global launches
    _build.refuse_grad("blocked_rows", x)
    if x.device.type == "cpu":
        return blocked_spmm(colind, vals, rowloc, row_slot, x, rows_pad)
    if x.device.type != "cuda":
        raise ValueError(f"no K-rows kernel for device {x.device}")
    if x.shape[0] == 0 or colind.shape[0] == 0:
        _codes(vals, x)
        acc = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
        return torch.zeros((row_slot.shape[0], x.shape[1]), dtype=acc,
                           device=x.device)
    if plan is None:
        raise ValueError("K-rows needs the operand's plan (blocked_plan, "
                         "built at prepare on the card)")
    if plan.nrows != row_slot.shape[0] or plan.inv.size != (
            colind.shape[0] * rows_pad):
        raise ValueError("K-rows plan was built for other tables")
    out = _launch(plan, colind, vals, rowloc, x, True, colind.shape[1],
                  rows_pad)
    launches += 1
    return out


def coo_rows(rows, cols, vals, x, nrows: int, plan: "SegPlan | None" = None):
    """``A @ x`` of a coo operand's chunks (the arguments of
    :func:`coo_plain`): the plain version on CPU tensors; on CUDA tensors
    one K-rows launch on ``plan`` (:func:`coo_plan` of ``rows``, which the
    operand builds at prepare; None raises), or a raise."""
    global coo_launches
    _build.refuse_grad("coo_rows", x)
    if x.device.type == "cpu":
        return coo_plain(rows, cols, vals, x, nrows)
    if x.device.type != "cuda":
        raise ValueError(f"no K-rows kernel for device {x.device}")
    if x.shape[0] == 0 and rows.numel():
        raise ValueError("K-rows: a coo operand with entries needs x rows")
    if plan is None:
        raise ValueError("K-rows needs the operand's plan (coo_plan, built "
                         "at prepare on the card)")
    if plan.nrows != nrows or plan.inv is not None:
        raise ValueError("K-rows plan was built for other tables")
    out = _launch(plan, cols, vals, rows, x, False)
    coo_launches += 1
    return out
