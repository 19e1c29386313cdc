from pygim_tpu_torch.data.datasets import (
    DATASET_SPECS,
    GraphDataset,
    cluster_partition,
    load_dataset,
    load_mtx,
    rmat_edges,
)

__all__ = ["DATASET_SPECS", "GraphDataset", "cluster_partition", "load_dataset",
           "load_mtx", "rmat_edges"]
