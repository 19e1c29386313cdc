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
* Where no gradient is needed (:func:`fusable`), an evaluation forward
  ends each block in :func:`bn_epilogue`, one K-epi pass
  (``ops/epilogue.py``) for what comes before the BatchNorm's output
  (a dequantize scale, a bias), the BatchNorm and the ReLU; each conv's
  ``epilogue_parts`` gives that pass its input, and the GCN takes its
  aggregate undequantized (:func:`raw_quantized_aggregate`). The values
  are those of the separate ops, bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from pygim_tpu_torch.ops.epilogue import epilogue
from pygim_tpu_torch.quant import (
    _SCALE_EXP,
    dtype_name,
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


def fusable(*tensors) -> bool:
    """Whether a forward through ``tensors`` may take the fused kernels:
    grad mode is off, or none of them requires grad (the kernels write
    through raw pointers, which autograd does not follow)."""
    return not torch.is_grad_enabled() or not any(
        t is not None and t.requires_grad for t in tensors)


def bn_epilogue(bn, a, scale=None, bias=None):
    """``relu(bn(a * scale + bias))`` in one K-epi pass (``scale`` a 0-dim
    tensor and ``bias`` an (H,) one, each optional): the same values as
    the ops ``a * scale``, ``+ bias``, :func:`batchnorm_apply` with
    ``bn``'s running statistics, ``torch.relu``. CPU tensors take those
    ops (``ops/epilogue.py:epilogue_plain``)."""
    return epilogue(a, bn.mean, bn.var, bn.scale, bn.bias, bn.eps,
                    scale=scale, bias=bias)


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
    (:meth:`PreparedAggregate.quantized_raw
    <pygim_tpu_torch.ops.spmm.PreparedAggregate.quantized_raw>`: K-tail and
    K-int, bit-identical to the round trip); a plain callable takes the
    unfused quantize round trip, as does a hook that returns None (a
    backend that does not fuse, the oracle). The dequantize is ``a *
    scale`` of :func:`raw_quantized_aggregate`, which is
    ``symmetric_dequantize(a, 1.0, scale)``."""
    a, s = raw_quantized_aggregate(aggregate, x, agg_dtype)
    return (a if s is None else a * s).to(x.dtype)


def raw_quantized_aggregate(aggregate: Aggregate, x, agg_dtype=None):
    """:func:`quantized_aggregate` before its dequantize and its cast:
    ``(a, s)`` with ``(a * s).to(x.dtype)`` (``a.to(x.dtype)`` where ``s``
    is None) its value, bit for bit. A fused aggregate gives it through
    its ``quantized_raw`` hook (:meth:`PreparedAggregate.quantized_raw
    <pygim_tpu_torch.ops.spmm.PreparedAggregate.quantized_raw>`), or
    through ``quantized`` where it has only that; the round trip gives
    the plain aggregate of the quantized x and the scale (None for
    ``agg_dtype=None``: ``x``'s own dtype, scale 1)."""
    if agg_dtype is not None:
        name = dtype_name(agg_dtype)
        if name in _SCALE_EXP:
            raw = getattr(aggregate, "quantized_raw", None)
            got = None if raw is None else raw(x, name)
            if got is not None:
                return got
            fused = getattr(aggregate, "quantized", None)
            out = None if fused is None else fused(x, name)
            if out is not None:
                return out, None
    scale, x_q = symmetric_quantize(x, agg_dtype)
    return aggregate(x_q), None if agg_dtype is None else scale


def epilogue_input(a, s, dtype):
    """``(a, s)`` of :func:`raw_quantized_aggregate` as K-epi takes them
    for an activation of ``dtype``: float32 ``a``; an integer ``a``
    becomes float32 first, as the promoting ``a * s`` converts it; any
    other ``a`` is dequantized and cast here (``s`` None)."""
    if dtype == torch.float32 and a.dtype == torch.float32:
        return a, s
    if dtype == torch.float32 and not a.is_floating_point() and s is not None:
        return a.float(), s
    return (a if s is None else a * s).to(dtype), None


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

    def epilogue_parts(self, x):
        """``(x @ w, None, b)``: the linear's product and its bias, for
        :func:`bn_epilogue`."""
        return linear_apply(self.w, None, x), None, self.b


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

    def epilogue_parts(self, x, aggregate: Aggregate, agg_dtype=None):
        """``(a, s, bias)`` with ``forward(x) == a * s + bias`` (``s``
        None: ``a + bias``): the aggregate undequantized, its scale and the
        conv's bias, for :func:`bn_epilogue`."""
        h = self.lin(x)
        a, s = epilogue_input(*raw_quantized_aggregate(aggregate, h,
                                                       agg_dtype), h.dtype)
        return a, s, self.bias


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

    def epilogue_parts(self, x, aggregate: Aggregate, agg_dtype=None):
        """``(h @ w2, None, b2)`` with ``forward(x) == h @ w2 + b2``: the
        MLP's inner Linear → BatchNorm → ReLU in one :func:`bn_epilogue`,
        its last product and bias for the block's."""
        out = quantized_aggregate(aggregate, x, agg_dtype)
        out = out + (1.0 + self.eps) * x
        m = self.mlp
        h = bn_epilogue(m.bn, *m.lin1.epilogue_parts(out))
        return m.lin2.epilogue_parts(h)


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

    def epilogue_parts(self, x, aggregate: Aggregate, agg_dtype=None):
        """``(forward(x), None, None)``: the bias sits inside the sum."""
        return self(x, aggregate, agg_dtype), None, None
