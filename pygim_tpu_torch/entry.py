"""The flagship model's forward step: twin of ``__graft_entry__.entry()``.

A 2-layer GCN (64 → 128 → 16) with int32-quantized aggregation through
the stair-int8 hybrid SpMM on a toy graph: 256 nodes, 8 edges a row, the
columns drawn with ``numpy.random.default_rng(0)``, the reference's. The
aggregate is ``prep.mul``, a plain callable, so every conv takes the
unfused quantize round trip (``nn/layers.py:quantized_aggregate``) and the
SpMM runs on an int32 payload: K-tail on int32 rows and K-int at four
limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from pygim_tpu_torch.core.graph import CooGraph
from pygim_tpu_torch.nn.models import make_gnn
from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

N, F_IN, HIDDEN, F_OUT = 256, 64, 128, 16
CONFIG = SpmmConfig(backend="hybrid", hybrid_shape="stair",
                    hybrid_core_bytes=1 << 16, hybrid_dtype="int8",
                    stair_max_bands=4)


def toy_graph(n: int = N, deg: int = 8, seed: int = 0) -> CooGraph:
    """``deg`` edges out of every row, to columns drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=n * deg)
    return CooGraph.from_edges(rows, cols, nrows=n, ncols=n)


def entry(device="cuda", state_dict=None):
    """``(fwd, (x,))``: the forward step and a zero (256, 64) input on
    ``device``. The weights are ``make_gnn``'s from seed 0, or
    ``state_dict`` (e.g. ``params_from_jax`` of the reference's model)."""
    prep = prepare_spmm(toy_graph(), CONFIG, device=device)
    model = make_gnn(0, "gcn", F_IN, HIDDEN, F_OUT, agg_dtype="int32",
                     device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)

    @torch.inference_mode()
    def fwd(x):
        return model(x, prep.mul)

    x = torch.zeros((N, F_IN), dtype=torch.float32, device=device)
    return fwd, (x,)
