"""Sparse products: host prepare, the hand-written kernels, the oracle."""

from pygim_tpu_torch.ops.spmm import (
    PreparedAggregate,
    PreparedSpmm,
    SpmmConfig,
    prepare_spmm,
)

__all__ = ["PreparedAggregate", "PreparedSpmm", "SpmmConfig", "prepare_spmm"]
