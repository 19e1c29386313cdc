from pygim_tpu_torch.nn.models import (
    GNN,
    gnn_apply,
    make_gnn,
    merge_bn_stats,
    params_from_jax,
)

__all__ = ["GNN", "gnn_apply", "make_gnn", "merge_bn_stats", "params_from_jax"]
