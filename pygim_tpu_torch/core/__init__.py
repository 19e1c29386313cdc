"""Host-side graph containers and prepare-time planners (NumPy)."""

from pygim_tpu_torch.core.graph import (
    CooGraph,
    CsrGraph,
    coo_to_csr,
    merge_duplicate_edges,
)

__all__ = ["CooGraph", "CsrGraph", "coo_to_csr", "merge_duplicate_edges"]
