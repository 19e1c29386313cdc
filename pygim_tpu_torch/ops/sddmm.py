"""SDDMM: the sampled dense-dense product ``out[k] = <a[rows[k]],
b[cols[k]]>``, the port of ``pygim_tpu/ops/sddmm.py``.

SpMM's sibling (attention-style edge scores): it gathers rows of two
dense operands and reduces along the feature axis. The edges are taken
in row-sorted order and cut into chunks of ``edge_chunk``; each chunk is
two row gathers and a row-wise dot in the accumulation dtype, so one
chunk's two ``(chunk, D)`` gathers bound the memory. Plain PyTorch ops:
the reference's body is an XLA gather and reduce, no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.core.graph import CooGraph
from pygim_tpu_torch.core.partition import round_up
from pygim_tpu_torch.ops.reference import accum_dtype


@dataclasses.dataclass(frozen=True)
class SddmmConfig:
    edge_chunk: int = 1 << 17


class PreparedSddmm:
    """Prepare-once/run-many over the edge list; ``run(a, b)`` returns the
    per-edge scores in the graph's row-sorted edge order
    (``CooGraph.sort_by_row``), on the operand's device."""

    def __init__(self, graph: CooGraph, config: Optional[SddmmConfig] = None,
                 device="cuda"):
        config = config or SddmmConfig()
        s = graph.sort_by_row()
        self.nnz = graph.nnz
        self.chunk = min(config.edge_chunk, max(8, round_up(self.nnz, 8)))
        pad = round_up(max(self.nnz, 1), self.chunk)
        rows = np.zeros(pad, dtype=np.int32)
        cols = np.zeros(pad, dtype=np.int32)
        rows[:self.nnz] = s.rows
        cols[:self.nnz] = s.cols
        self.device = torch.device(device)
        self._rows = torch.from_numpy(rows.reshape(-1, self.chunk)).to(
            self.device)
        self._cols = torch.from_numpy(cols.reshape(-1, self.chunk)).to(
            self.device)

    def run(self, a, b):
        """Scores of every edge, ``(nnz,)`` in the accumulation dtype of
        ``a``'s and ``b``'s (:func:`~pygim_tpu_torch.ops.reference.
        accum_dtype`: f32 for bf16, int32 for narrow integers)."""
        acc = accum_dtype(torch.promote_types(a.dtype, b.dtype))
        out = torch.empty(self._rows.numel(), dtype=acc, device=a.device)
        for i, (r, c) in enumerate(zip(self._rows, self._cols)):
            ga = a.index_select(0, r).to(acc)
            gb = b.index_select(0, c).to(acc)
            out[i * self.chunk:(i + 1) * self.chunk] = (ga * gb).sum(-1, dtype=acc)
        return out[:self.nnz]


def prepare_sddmm(graph: CooGraph, config: Optional[SddmmConfig] = None, *,
                  device="cuda") -> PreparedSddmm:
    return PreparedSddmm(graph, config, device=device)
