"""GNN layers as ``nn.Module``s over plain tensor functions.

Counterpart of ``pygim_tpu/nn/layers.py`` for the GCN of this slice.
Semantics follow the reference's forked PyG layers:

* GCNConv forward = ``lin(x)`` → quantized aggregate → ``+bias``; like
  the reference, and deliberately, no self-loops and no degree
  normalisation are applied despite the layer's name.
* Linear weights keep the JAX ``(din, dout)`` layout: ``y = x @ w + b``.
* BatchNorm runs in inference mode on its running statistics.

GIN and SAGE come with a later slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from pygim_tpu_torch.quant import (
    _SCALE_EXP,
    dtype_name,
    symmetric_dequantize,
    symmetric_quantize,
)

Aggregate = Callable[[torch.Tensor], torch.Tensor]  # x -> A @ x


def glorot(generator: torch.Generator, din: int, dout: int) -> torch.Tensor:
    """Uniform in ±sqrt(6 / (din + dout)), shape (din, dout), on the CPU."""
    limit = math.sqrt(6.0 / (din + dout))
    u = torch.rand((din, dout), generator=generator, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def linear_apply(w, b, x):
    y = x @ w
    return y if b is None else y + b


def batchnorm_apply(scale, bias, mean, var, x, eps: float = 1e-5):
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * scale + bias


def quantized_aggregate(aggregate: Aggregate, x, agg_dtype=None):
    """quantize → A·x → dequantize. ``agg_dtype=None`` aggregates in x's
    own dtype (scale 1). An integer ``agg_dtype`` (int8, int16, int32)
    goes to the aggregate's fused hook where it has one
    (:meth:`PreparedAggregate.quantized
    <pygim_tpu_torch.ops.spmm.PreparedAggregate.quantized>`: K-tail and
    K-int, bit-identical to the round trip); a plain callable takes the
    unfused quantize round trip, as does a hook that returns None (a
    backend that does not fuse, the oracle)."""
    if agg_dtype is not None:
        name = dtype_name(agg_dtype)
        fused = getattr(aggregate, "quantized", None)
        if fused is not None and name in _SCALE_EXP:
            out = fused(x, name)
            if out is not None:
                return out.to(x.dtype)
    scale, x_q = symmetric_quantize(x, agg_dtype)
    out = symmetric_dequantize(aggregate(x_q), 1.0, scale)
    return out.to(x.dtype)


class Linear(nn.Module):
    """``x @ w (+ b)`` with ``w`` of shape (din, dout)."""

    def __init__(self, din: int, dout: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.w = nn.Parameter(glorot(g, din, dout))
        self.b = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x):
        return linear_apply(self.w, self.b, x)


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm1d on running statistics."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("mean", torch.zeros(d))
        self.register_buffer("var", torch.ones(d))

    def forward(self, x):
        return batchnorm_apply(self.scale, self.bias, self.mean, self.var,
                               x, self.eps)


class GCNConv(nn.Module):
    """``lin(x)`` (no bias) → aggregate → ``+ bias``."""

    def __init__(self, din: int, dout: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lin = Linear(din, dout, bias=False, generator=generator)
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x, aggregate: Aggregate, agg_dtype=None):
        out = quantized_aggregate(aggregate, self.lin(x), agg_dtype)
        return out + self.bias
