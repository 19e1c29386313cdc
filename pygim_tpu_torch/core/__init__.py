"""Host-side graph containers and prepare-time planners (NumPy)."""

from pygim_tpu_torch.core.graph import (
    CooGraph,
    CsrGraph,
    coo_to_csr,
    merge_duplicate_edges,
)
from pygim_tpu_torch.core.partition import RowBlockPlan, plan_row_blocks

__all__ = ["CooGraph", "CsrGraph", "RowBlockPlan", "coo_to_csr",
           "merge_duplicate_edges", "plan_row_blocks"]
