"""The GCN model of ``pygim_tpu/nn/models.py`` as an ``nn.Module``.

``Linear(in, hidden)`` → BatchNorm → ReLU, then ``num_layers`` × (conv →
BatchNorm → ReLU), then ``Linear(hidden, out)``. Dropout is identity in
evaluation, the only mode of this slice; training comes later.

The aggregate is any ``x -> A @ x`` callable, e.g. a
:class:`~pygim_tpu_torch.ops.spmm.PreparedAggregate`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pygim_tpu_torch.nn.layers import BatchNorm, GCNConv, Linear


class GNN(nn.Module):
    """Static config + parameters. State-dict keys: ``ln1.w``, ``ln1.b``,
    ``bn0.{scale,bias,mean,var}``, ``convs.<i>.lin.w``, ``convs.<i>.bias``,
    ``bns.<i>.*``, ``ln2.w``, ``ln2.b`` — the JAX pytree's paths."""

    def __init__(self, conv: str, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int = 2,
                 dropout: float = 0.5, agg_dtype: Optional[str] = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if conv != "gcn":
            raise NotImplementedError(
                f"conv {conv!r}: only 'gcn' is ported so far (GIN and SAGE "
                "come with a later slice)"
            )
        g = generator if generator is not None else torch.Generator()
        self.conv, self.num_layers = conv, num_layers
        self.dropout, self.agg_dtype = dropout, agg_dtype
        # init order of the reference's key split: ln1, ln2, convs
        self.ln1 = Linear(in_channels, hidden_channels, generator=g)
        self.bn0 = BatchNorm(hidden_channels)
        self.ln2 = Linear(hidden_channels, out_channels, generator=g)
        self.convs = nn.ModuleList(
            GCNConv(hidden_channels, hidden_channels, generator=g)
            for _ in range(num_layers)
        )
        self.bns = nn.ModuleList(
            BatchNorm(hidden_channels) for _ in range(num_layers)
        )

    def forward(self, x, aggregate):
        return gnn_apply(self, x, aggregate)


def make_gnn(seed: int, conv: str, in_channels: int, hidden_channels: int,
             out_channels: int, num_layers: int = 2, dropout: float = 0.5,
             agg_dtype: Optional[str] = None, device="cuda") -> GNN:
    """A GNN with glorot weights from ``torch.Generator().manual_seed(seed)``
    (drawn on the CPU, so every device gets the same weights), in
    evaluation mode on ``device``."""
    g = torch.Generator().manual_seed(seed)
    model = GNN(conv, in_channels, hidden_channels, out_channels,
                num_layers=num_layers, dropout=dropout, agg_dtype=agg_dtype,
                generator=g)
    return model.to(device).eval()


def gnn_apply(model: GNN, x, aggregate):
    """Evaluation-mode forward (running BatchNorm stats, no dropout)."""
    if model.training:
        raise NotImplementedError(
            "training mode comes with the training slice; call .eval()"
        )
    h = torch.relu(model.bn0(model.ln1(x)))
    for conv, bn in zip(model.convs, model.bns):
        h = torch.relu(bn(conv(h, aggregate, model.agg_dtype)))
    return model.ln2(h)


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

    sd["ln1.w"], sd["ln1.b"] = t(params["ln1"]["w"]), t(params["ln1"]["b"])
    bn("bn0", params["bn0"])
    sd["ln2.w"], sd["ln2.b"] = t(params["ln2"]["w"]), t(params["ln2"]["b"])
    for i, c in enumerate(params["convs"]):
        sd[f"convs.{i}.lin.w"] = t(c["lin"]["w"])
        sd[f"convs.{i}.bias"] = t(c["bias"])
    for i, p in enumerate(params["bns"]):
        bn(f"bns.{i}", p)
    return sd
