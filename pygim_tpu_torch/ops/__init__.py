"""Sparse products: host prepare, the hand-written kernels, the oracle."""

from pygim_tpu_torch.ops import core_dot, core_int, ell_tail
from pygim_tpu_torch.ops.spmm import (
    PreparedAggregate,
    PreparedSpmm,
    SpmmConfig,
    prepare_spmm,
)


def launch_counts() -> dict:
    """Each kernel's launches since :func:`reset_launch_counts` (each
    wrapper adds one where it launches its kernel, and nowhere else)."""
    return {"K-core": core_dot.launches, "K-int": core_int.launches,
            "K-tail": ell_tail.launches,
            "K-tail-quant": ell_tail.quant_launches}


def reset_launch_counts() -> None:
    core_dot.launches = core_int.launches = 0
    ell_tail.launches = ell_tail.quant_launches = 0


__all__ = ["PreparedAggregate", "PreparedSpmm", "SpmmConfig", "prepare_spmm",
           "launch_counts", "reset_launch_counts"]
