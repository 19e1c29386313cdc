"""GNN layers as ``nn.Module``s over plain tensor functions.

Counterpart of ``pygim_tpu/nn/layers.py``. Semantics follow the
reference's forked PyG layers:

* GCNConv forward = ``lin(x)`` → quantized aggregate → ``+bias``; like
  the reference, and deliberately, no self-loops and no degree
  normalisation are applied despite the layer's name.
* GINConv forward = aggregate → ``+ (1 + eps)·x`` → MLP (Linear →
  BatchNorm → ReLU → Linear). The MLP's BatchNorm runs in inference mode
  even in training, and ``eps`` and that BatchNorm's ``mean`` and ``var``
  are trainable parameters: the reference keeps all three as leaves of
  its parameter pytree, so its optimizer updates them every step
  (``pygim_tpu/nn/layers.py:141-160``).
* SAGEConv forward = aggregate → ``lin_l`` → ``+ lin_r(x)`` → optional
  L2 normalisation (``aggr='add'``).
* Linear weights keep the JAX ``(din, dout)`` layout: ``y = x @ w + b``.
* :class:`BatchNorm` applies its running statistics;
  :func:`batchnorm_train_apply` is the training-mode BatchNorm of the
  model's own ``bn0``/``bns``, which returns the updated running
  statistics for the caller to merge.
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


def batchnorm_train_apply(scale, bias, mean, var, x, eps: float = 1e-5,
                          momentum: float = 0.1):
    """Training-mode BatchNorm: the batch statistics normalise ``x`` (the
    biased variance, as ``jnp.var``; the normalisation differentiates
    through them), and ``(y, {"mean", "var"})`` comes back with the
    updated running statistics, detached: the running variance takes the
    unbiased batch variance ``var · n / max(1, n - 1)``, momentum 0.1."""
    b_mean = x.mean(0)
    b_var = x.var(0, unbiased=False)
    y = (x - b_mean) * torch.rsqrt(b_var + eps) * scale + bias
    n = x.shape[0]
    with torch.no_grad():
        unbiased = b_var * (n / max(1, n - 1))
        stats = {"mean": (1 - momentum) * mean + momentum * b_mean,
                 "var": (1 - momentum) * var + momentum * unbiased}
    return y, stats


def dropout(x, rate: float, generator: torch.Generator | None,
            training: bool):
    """Inverted dropout: keep each element with probability ``1 - rate``
    (``uniform < 1 - rate``, drawn from ``generator`` on x's device) and
    scale the kept ones by ``1 / (1 - rate)``. Identity in evaluation or
    at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
    """BatchNorm1d applying its running statistics. They are buffers, or
    trainable parameters with ``trainable_stats`` (GIN's MLP, as in the
    reference)."""

    def __init__(self, d: int, eps: float = 1e-5,
                 trainable_stats: bool = False):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        if trainable_stats:
            self.mean = nn.Parameter(torch.zeros(d))
            self.var = nn.Parameter(torch.ones(d))
        else:
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


class GINConv(nn.Module):
    """aggregate → ``+ (1 + eps)·x`` → Linear → BatchNorm (running
    statistics, always) → ReLU → Linear; ``eps`` and the BatchNorm's
    ``mean`` and ``var`` are trainable (module docstring)."""

    def __init__(self, d: int, eps: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor(eps, dtype=torch.float32))
        self.mlp = nn.Module()
        self.mlp.lin1 = Linear(d, d, generator=generator)
        self.mlp.bn = BatchNorm(d, trainable_stats=True)
        self.mlp.lin2 = Linear(d, d, generator=generator)

    def forward(self, x, aggregate: Aggregate, agg_dtype=None):
        out = quantized_aggregate(aggregate, x, agg_dtype)
        out = out + (1.0 + self.eps) * x
        m = self.mlp
        return m.lin2(torch.relu(m.bn(m.lin1(out))))


class SAGEConv(nn.Module):
    """aggregate → ``lin_l`` (with bias) → ``+ lin_r(x)`` (no bias) →
    L2-normalised rows where ``normalize``."""

    def __init__(self, din: int, dout: int, normalize: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.normalize = normalize
        self.lin_l = Linear(din, dout, generator=generator)
        self.lin_r = Linear(din, dout, bias=False, generator=generator)

    def forward(self, x, aggregate: Aggregate, agg_dtype=None):
        out = self.lin_l(quantized_aggregate(aggregate, x, agg_dtype))
        out = out + self.lin_r(x)
        if self.normalize:
            norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
            out = out / torch.clamp(norm, min=1e-12)
        return out
