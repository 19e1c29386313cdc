"""Oracle sparse products in plain PyTorch — the port's own reference.

Counterpart of ``pygim_tpu/ops/reference.py``: simple gather +
index-add products that every prepared backend is held against.

Accumulation dtype rules: integer inputs accumulate in int32 (int64
stays int64); bfloat16 accumulates in float32.
"""

from __future__ import annotations

import numpy as np
import torch

_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32)


def accum_dtype(val_dtype: torch.dtype) -> torch.dtype:
    if val_dtype == torch.int64:
        return torch.int64
    if val_dtype in _INT_DTYPES:
        return torch.int32
    if val_dtype == torch.bfloat16:
        return torch.float32
    return val_dtype


def spmm_coo_oracle(rows, cols, vals, x, nrows: int):
    """``out[r] = Σ_k vals[k] · x[cols[k]]`` over ``rows[k] == r``.
    Materializes the (nnz, H) gather: small graphs only."""
    acc = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
    contrib = x.index_select(0, cols).to(acc) * vals.to(acc)[:, None]
    out = torch.zeros((nrows, x.shape[1]), dtype=acc, device=x.device)
    return out.index_add_(0, rows, contrib)


def spmm_coo_oracle_chunked(rows, cols, vals, x, nrows: int, chunk: int):
    """The same per-edge math as :func:`spmm_coo_oracle`, ``chunk`` edges
    at a time, so no (nnz, H) buffer exists."""
    acc = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
    out = torch.zeros((nrows, x.shape[1]), dtype=acc, device=x.device)
    for lo in range(0, int(rows.shape[0]), max(1, chunk)):
        hi = lo + chunk
        g = x.index_select(0, cols[lo:hi]).to(acc)
        out.index_add_(0, rows[lo:hi], g * vals[lo:hi].to(acc)[:, None])
    return out


def spmm_csr_oracle(rowptr, colind, vals, x, nrows: int):
    """CSR oracle — expands row ids, then the COO oracle."""
    rowids = torch.repeat_interleave(
        torch.arange(nrows, dtype=colind.dtype, device=colind.device),
        torch.diff(rowptr).long(),
    )
    return spmm_coo_oracle(rowids, colind, vals, x, nrows)


def spmm_dense_oracle(dense_a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """NumPy float64 ground truth for tiny cases."""
    return dense_a.astype(np.float64) @ x.astype(np.float64)


def sddmm_coo_oracle(rows, cols, a, b):
    """Sampled dense-dense product ``out[k] = <a[rows[k]], b[cols[k]]>``,
    each factor in the accumulation dtype of ``a``'s and ``b``'s (the
    whole (nnz, D) gathers at once: small graphs only)."""
    acc = accum_dtype(torch.promote_types(a.dtype, b.dtype))
    return (a.index_select(0, rows).to(acc)
            * b.index_select(0, cols).to(acc)).sum(-1, dtype=acc)
