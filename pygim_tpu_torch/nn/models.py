"""The GCN / GIN / SAGE models of ``pygim_tpu/nn/models.py`` as one
``nn.Module``.

``Linear(in, hidden)`` → BatchNorm → ReLU → dropout, then ``num_layers``
× (conv → BatchNorm → ReLU → dropout), then ``Linear(hidden, out)``. In
evaluation BatchNorm applies its running statistics and dropout is the
identity, and where no gradient is needed each block ends in one K-epi
pass (:func:`forward_stem`, :func:`forward_block`); in training (:func:`gnn_apply` with ``training=True``) the
model's ``bn0``/``bns`` normalise by batch statistics and return their
updated running statistics (:func:`merge_bn_stats` writes them back), and
dropout draws from a ``torch.Generator``, one key per dropout site in
layer order: each BatchNorm → ReLU → dropout block is one
:func:`~pygim_tpu_torch.nn.layers.bn_relu_dropout_train` (K-bn on the
card), with its own backward.

The aggregate is any ``x -> A @ x`` callable, e.g. a
:class:`~pygim_tpu_torch.ops.spmm.PreparedAggregate`, which is
differentiable on every backend (on ``hybrid`` and ``ell`` through
:class:`~pygim_tpu_torch.ops.spmm.SpmmFunction`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pygim_tpu_torch.nn.layers import (
    BatchNorm,
    GCNConv,
    GINConv,
    Linear,
    SAGEConv,
    bn_epilogue,
    bn_relu_dropout_train,
    fusable,
)

CONVS = ("gcn", "sage", "gin")


class GNN(nn.Module):
    """Static config + parameters. State-dict keys: ``ln1.w``, ``ln1.b``,
    ``bn0.{scale,bias,mean,var}``, ``bns.<i>.*``, ``ln2.w``, ``ln2.b``,
    and per conv ``convs.<i>.lin.w``, ``convs.<i>.bias`` (GCN),
    ``convs.<i>.eps``, ``convs.<i>.mlp.{lin1,bn,lin2}.*`` (GIN),
    ``convs.<i>.lin_l.{w,b}``, ``convs.<i>.lin_r.w`` (SAGE) — the JAX
    pytree's paths."""

    def __init__(self, conv: str, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int = 2,
                 dropout: float = 0.5, agg_dtype: Optional[str] = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if conv not in CONVS:
            raise ValueError(f"unknown conv {conv!r}")
        g = generator if generator is not None else torch.Generator()
        self.conv, self.num_layers = conv, num_layers
        self.dropout, self.agg_dtype = dropout, agg_dtype
        # init order of the reference's key split: ln1, ln2, convs
        self.ln1 = Linear(in_channels, hidden_channels, generator=g)
        self.bn0 = BatchNorm(hidden_channels)
        self.ln2 = Linear(hidden_channels, out_channels, generator=g)
        self.convs = nn.ModuleList(
            _make_conv(conv, hidden_channels, g) for _ in range(num_layers)
        )
        self.bns = nn.ModuleList(
            BatchNorm(hidden_channels) for _ in range(num_layers)
        )

    def forward(self, x, aggregate, generator=None):
        return gnn_apply(self, x, aggregate, generator=generator)


def _make_conv(conv: str, d: int, g: torch.Generator) -> nn.Module:
    if conv == "gcn":
        return GCNConv(d, d, generator=g)
    if conv == "sage":
        return SAGEConv(d, d, generator=g)
    return GINConv(d, generator=g)


def make_gnn(seed: int, conv: str, in_channels: int, hidden_channels: int,
             out_channels: int, num_layers: int = 2, dropout: float = 0.5,
             agg_dtype: Optional[str] = None, device="cuda") -> GNN:
    """A GNN with glorot weights from ``torch.Generator().manual_seed(seed)``
    (drawn on the CPU, so every device gets the same weights), in
    evaluation mode on ``device``; ``.train()`` puts it in training
    mode."""
    g = torch.Generator().manual_seed(seed)
    model = GNN(conv, in_channels, hidden_channels, out_channels,
                num_layers=num_layers, dropout=dropout, agg_dtype=agg_dtype,
                generator=g)
    return model.to(device).eval()


def forward_stem(model: GNN, x, fused: bool):
    """The evaluation forward's first block, ``relu(bn0(ln1(x)))``: one
    K-epi pass after the product where ``fused``, the ops otherwise (the
    same values)."""
    if fused:
        return bn_epilogue(model.bn0, *model.ln1.epilogue_parts(x))
    return torch.relu(model.bn0(model.ln1(x)))


def forward_block(model: GNN, i: int, h, aggregate, fused: bool):
    """The evaluation forward's conv block ``i``, ``relu(bns[i](conv(h)))``
    at ``model.agg_dtype``: the conv's ``epilogue_parts`` and one K-epi
    pass where ``fused`` (a GCN's dequantize and bias, a GIN's last bias
    go into it), the ops otherwise (the same values)."""
    conv, bn = model.convs[i], model.bns[i]
    if fused:
        return bn_epilogue(bn, *conv.epilogue_parts(h, aggregate,
                                                    model.agg_dtype))
    return torch.relu(bn(conv(h, aggregate, model.agg_dtype)))


def gnn_apply(model: GNN, x, aggregate, *, training: Optional[bool] = None,
              generator: Optional[torch.Generator] = None,
              return_bn_stats: bool = False):
    """The forward, in the model's mode unless ``training`` says.

    Evaluation: running BatchNorm statistics, no dropout, aggregation in
    ``model.agg_dtype``. Training: batch statistics, dropout at
    ``model.dropout`` from ``generator`` (a ``torch.Generator`` on x's
    device; required where the rate is above 0), and the float aggregate
    (``agg_dtype=None``), as the reference's train step. With
    ``return_bn_stats`` the updated running statistics come back too, as
    ``(logits, {"bn0": {...}, "bns": [...]})`` (None in evaluation), for
    :func:`merge_bn_stats`."""
    training = model.training if training is None else training
    if not training:
        fused = fusable(x, *model.parameters())
        h = forward_stem(model, x, fused)
        for i in range(len(model.convs)):
            h = forward_block(model, i, h, aggregate, fused)
        out = model.ln2(h)
        if return_bn_stats:
            return out, {"bns": [None] * len(model.convs), "bn0": None}
        return out
    rate = model.dropout
    stats = {"bns": []}
    h, stats["bn0"] = bn_relu_dropout_train(model.bn0, model.ln1(x), rate,
                                            generator)
    for conv, layer in zip(model.convs, model.bns):
        h, s = bn_relu_dropout_train(layer, conv(h, aggregate, None), rate,
                                     generator)
        stats["bns"].append(s)
    out = model.ln2(h)
    return (out, stats) if return_bn_stats else out


@torch.no_grad()
def merge_bn_stats(model: GNN, bn_stats: dict) -> None:
    """Write the running statistics of :func:`gnn_apply`'s training
    forward into ``model.bn0`` and ``model.bns``, in place (the
    reference's ``merge_bn_stats``, which leaves GIN's inner BatchNorm
    alone as this does)."""
    layers = [(model.bn0, bn_stats.get("bn0"))]
    layers += list(zip(model.bns, bn_stats["bns"]))
    for layer, s in layers:
        if s is not None:
            layer.mean.copy_(s["mean"])
            layer.var.copy_(s["var"])


def params_from_jax(params) -> "dict[str, torch.Tensor]":
    """The state dict of :class:`GNN` from the JAX ``make_gnn(...).params``
    pytree (leaves as numpy arrays or anything ``np.asarray`` takes), so
    both packages compute the same function:
    ``model.load_state_dict(params_from_jax(jax_gnn.params))``."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}

    def bn(prefix, p):
        for k in ("scale", "bias", "mean", "var"):
            sd[f"{prefix}.{k}"] = t(p[k])

    def lin(prefix, p):
        sd[f"{prefix}.w"] = t(p["w"])
        if "b" in p:
            sd[f"{prefix}.b"] = t(p["b"])

    lin("ln1", params["ln1"])
    bn("bn0", params["bn0"])
    lin("ln2", params["ln2"])
    for i, c in enumerate(params["convs"]):
        pre = f"convs.{i}"
        if "mlp" in c:  # GIN
            sd[f"{pre}.eps"] = t(c["eps"])
            lin(f"{pre}.mlp.lin1", c["mlp"]["lin1"])
            bn(f"{pre}.mlp.bn", c["mlp"]["bn"])
            lin(f"{pre}.mlp.lin2", c["mlp"]["lin2"])
        elif "lin_l" in c:  # SAGE
            lin(f"{pre}.lin_l", c["lin_l"])
            lin(f"{pre}.lin_r", c["lin_r"])
        else:  # GCN
            lin(f"{pre}.lin", c["lin"])
            sd[f"{pre}.bias"] = t(c["bias"])
    for i, p in enumerate(params["bns"]):
        bn(f"bns.{i}", p)
    return sd
