from pygim_tpu_torch.nn.layers import (
    batchnorm_apply,
    linear_apply,
    quantized_aggregate,
)
from pygim_tpu_torch.nn.models import (
    GNN,
    gnn_apply,
    make_gnn,
    merge_bn_stats,
    params_from_jax,
)

__all__ = ["GNN", "batchnorm_apply", "gnn_apply", "linear_apply", "make_gnn",
           "merge_bn_stats", "params_from_jax", "quantized_aggregate"]
