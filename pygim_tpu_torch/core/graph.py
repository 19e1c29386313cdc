"""Host-side sparse graph containers (NumPy).

Counterpart of ``pygim_tpu/core/graph.py``: immutable NumPy COO / CSR
containers that the prepare step plans from. Values default to ones when
absent.

One deliberate difference in mechanism, none in result: the reference's
``coo_to_csr`` calls a native counting sort for float32 values, which
keeps the input order of entries within each row. This copy gets the
same order from a stable argsort by row, so the ELL tail tables built
from it are the reference's bit for bit. Other value dtypes take the
reference's (row, col) lexsort.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

VAL_DTYPES = {
    "int8": np.int8,
    "int16": np.int16,
    "int32": np.int32,
    "int64": np.int64,
    "float32": np.float32,
    "float64": np.float64,
    "bfloat16": np.float32,  # host container keeps f32; device casts to bf16
}

INDEX_DTYPE = np.int32


def _as_index(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != INDEX_DTYPE:
        a = a.astype(INDEX_DTYPE)
    return np.ascontiguousarray(a)


@dataclasses.dataclass(frozen=True)
class CooGraph:
    """COO sparse matrix A of shape (nrows, ncols) with ``nnz`` entries.

    ``rows``/``cols`` are int32; ``vals`` any dtype of :data:`VAL_DTYPES`
    (defaults to ones). Row = destination, col = source.
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    nrows: int
    ncols: int

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @classmethod
    def from_edges(
        cls,
        rows: Sequence[int],
        cols: Sequence[int],
        vals: Optional[Sequence[float]] = None,
        *,
        nrows: Optional[int] = None,
        ncols: Optional[int] = None,
        dtype: str = "float32",
    ) -> "CooGraph":
        rows = _as_index(rows)
        cols = _as_index(cols)
        if rows.shape != cols.shape or rows.ndim != 1:
            raise ValueError("rows/cols must be equal-length 1-D arrays")
        np_dtype = VAL_DTYPES[dtype]
        if vals is None:
            vals = np.ones(rows.shape[0], dtype=np_dtype)
        else:
            vals = np.ascontiguousarray(np.asarray(vals), dtype=np_dtype)
        if nrows is None:
            nrows = int(rows.max()) + 1 if rows.size else 0
        if ncols is None:
            ncols = int(cols.max()) + 1 if cols.size else 0
        return cls(rows=rows, cols=cols, vals=vals, nrows=int(nrows),
                   ncols=int(ncols))

    @classmethod
    def from_scipy(cls, mat, dtype: str = "float32") -> "CooGraph":
        """A SciPy sparse matrix's entries, in its COO order."""
        coo = mat.tocoo()
        return cls.from_edges(
            coo.row, coo.col, coo.data, nrows=coo.shape[0],
            ncols=coo.shape[1], dtype=dtype,
        )

    def to_dense(self) -> np.ndarray:
        """The dense matrix, duplicates summed (in float64, cast back to
        the value dtype; int8 values widen to int32)."""
        out = np.zeros((self.nrows, self.ncols), dtype=np.float64)
        np.add.at(out, (self.rows, self.cols), self.vals.astype(np.float64))
        return out.astype(self.vals.dtype if self.vals.dtype != np.int8
                          else np.int32)

    def sort_by_row(self) -> "CooGraph":
        """Canonical (row, col) lexicographic order, stable."""
        order = np.lexsort((self.cols, self.rows))
        return CooGraph(
            rows=self.rows[order], cols=self.cols[order],
            vals=self.vals[order], nrows=self.nrows, ncols=self.ncols,
        )

    def to_csr(self) -> "CsrGraph":
        return coo_to_csr(self)

    def col_split(self, nparts: int) -> "list[CooGraph]":
        """``nparts`` contiguous column ranges (:func:`column_split_bounds`,
        the last part takes the remainder), each part's columns rebased to
        its range: the ``sp_parts`` split of the 2D mesh."""
        if nparts <= 0:
            raise ValueError("nparts must be positive")
        parts = []
        for lo, hi in column_split_bounds(self.ncols, nparts):
            mask = (self.cols >= lo) & (self.cols < hi)
            parts.append(CooGraph(
                rows=self.rows[mask], cols=self.cols[mask] - lo,
                vals=self.vals[mask], nrows=self.nrows, ncols=hi - lo))
        return parts


@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """CSR sparse matrix: ``rowptr`` (nrows+1), ``colind``/``vals`` (nnz)."""

    rowptr: np.ndarray
    colind: np.ndarray
    vals: np.ndarray
    ncols: int

    @property
    def nrows(self) -> int:
        return int(self.rowptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.colind.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.rowptr)

    def to_coo(self) -> CooGraph:
        rows = np.repeat(
            np.arange(self.nrows, dtype=INDEX_DTYPE), self.row_lengths
        )
        return CooGraph(
            rows=rows, cols=self.colind.copy(), vals=self.vals.copy(),
            nrows=self.nrows, ncols=self.ncols,
        )

    def col_split(self, nparts: int) -> "list[CsrGraph]":
        """:meth:`CooGraph.col_split` in CSR, each row's entries in their
        order."""
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         self.row_lengths)
        parts = []
        for lo, hi in column_split_bounds(self.ncols, nparts):
            mask = (self.colind >= lo) & (self.colind < hi)
            counts = np.bincount(rows[mask], minlength=self.nrows)
            rowptr = np.zeros(self.nrows + 1, dtype=INDEX_DTYPE)
            np.cumsum(counts, out=rowptr[1:])
            parts.append(CsrGraph(
                rowptr=rowptr,
                colind=(self.colind[mask] - lo).astype(INDEX_DTYPE),
                vals=self.vals[mask], ncols=hi - lo))
        return parts


def column_split_bounds(ncols: int, nparts: int) -> "list[tuple[int, int]]":
    """``nparts`` equal column ranges ``(lo, hi)``, the remainder in the
    last; raises where a part would be empty."""
    w = ncols // nparts
    if w == 0:
        raise ValueError(f"cannot split {ncols} columns into {nparts} parts")
    return [(i * w, (i + 1) * w if i < nparts - 1 else ncols)
            for i in range(nparts)]


def coo_to_csr(coo: CooGraph) -> CsrGraph:
    """COO→CSR. Float32 values keep their input order within each row
    (stable sort by row, the order of the reference's native counting
    sort); other dtypes sort by (row, col) as the reference's fallback."""
    if coo.vals.dtype == np.float32:
        order = np.argsort(coo.rows, kind="stable")
    else:
        order = np.lexsort((coo.cols, coo.rows))
    counts = np.bincount(coo.rows, minlength=coo.nrows)
    rowptr = np.zeros(coo.nrows + 1, dtype=INDEX_DTYPE)
    np.cumsum(counts, out=rowptr[1:])
    return CsrGraph(
        rowptr=rowptr,
        colind=np.ascontiguousarray(coo.cols[order], dtype=INDEX_DTYPE),
        vals=np.ascontiguousarray(coo.vals[order]),
        ncols=coo.ncols,
    )


def merge_duplicate_edges(graph) -> "tuple[CooGraph, bool]":
    """Sum duplicate ``(row, col)`` entries into single edges — a semantic
    no-op for SpMM that shrinks every gather tier. Returns
    ``(graph, merged?)``; the input comes back unchanged when it is
    already a simple graph, or when merged integer values would overflow
    every storage dtype up to int32.

    Integer values accumulate in int64 and cast back to the narrowest
    safe dtype (original, else int32); float values accumulate in float64
    and return to the original dtype."""
    coo = graph if isinstance(graph, CooGraph) else graph.to_coo()
    key = coo.rows.astype(np.int64) * np.int64(coo.ncols) + coo.cols
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(ks.size, dtype=bool)
    if ks.size:
        first[1:] = ks[1:] != ks[:-1]
    if first.all():
        return coo, False
    idx = np.flatnonzero(first)
    if np.issubdtype(coo.vals.dtype, np.integer):
        acc = np.add.reduceat(coo.vals[order].astype(np.int64), idx)
        info = np.iinfo(coo.vals.dtype)
        if acc.max(initial=0) <= info.max and acc.min(initial=0) >= info.min:
            vals = acc.astype(coo.vals.dtype)
        elif (acc.max(initial=0) <= np.iinfo(np.int32).max
              and acc.min(initial=0) >= np.iinfo(np.int32).min):
            vals = acc.astype(np.int32)
        else:
            return coo, False
    else:
        vals = np.add.reduceat(
            coo.vals[order].astype(np.float64), idx
        ).astype(coo.vals.dtype)
    return (
        CooGraph(
            rows=(ks[idx] // coo.ncols).astype(coo.rows.dtype),
            cols=(ks[idx] % coo.ncols).astype(coo.cols.dtype),
            vals=vals,
            nrows=coo.nrows,
            ncols=coo.ncols,
        ),
        True,
    )
