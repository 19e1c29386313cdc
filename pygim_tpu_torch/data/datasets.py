"""Synthetic dataset stand-ins.

Counterpart of ``pygim_tpu/data/datasets.py`` for the stand-ins only:
each known dataset name resolves to an R-MAT graph with the published
node count, stored edge count, feature width and class count, with
random features, labels and a 10% train mask. The same name and seed
give the reference's graph, features, labels and masks, array for
array. Real-dataset loaders and the on-disk cache come in a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pygim_tpu_torch.core.graph import CooGraph

# name -> (num_nodes, num_edges(directed), feat_dim, num_classes)
DATASET_SPECS = {
    "pubmed": (19_717, 88_651, 500, 3),
    "cora": (2_708, 10_556, 1_433, 7),
    "citeseer": (3_327, 9_104, 3_703, 6),
    "reddit": (232_965, 114_615_892, 602, 41),
    "ogbn-arxiv": (169_343, 1_166_243, 128, 40),
    "ogbn-proteins": (132_534, 79_122_504, 8, 112),
    "ogbn-products": (2_449_029, 123_718_280, 100, 47),
    "amazonproducts": (1_569_960, 264_339_468, 200, 107),
    # small synthetic configs for tests
    "tiny": (1_000, 10_000, 32, 4),
    "small": (20_000, 400_000, 64, 8),
}


@dataclasses.dataclass
class GraphDataset:
    name: str
    graph: CooGraph          # adjacency (row = destination, col = source)
    x: np.ndarray            # node features (N, F)
    y: np.ndarray            # labels (N,)
    train_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    synthetic: bool
    metric: str = "acc"

    @property
    def num_nodes(self) -> int:
        return self.graph.nrows

    @property
    def num_edges(self) -> int:
        return self.graph.nnz


def rmat_edges(
    n: int, e: int, *, a=0.57, b=0.19, c=0.19, seed=0
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized R-MAT edge generation (power-law degree skew), as a
    multigraph: duplicates are kept, so ``e`` is the stored edge count."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n, 2)))))
    rows = np.zeros(e, dtype=np.int64)
    cols = np.zeros(e, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(e)
        rows = rows * 2 + (r >= a + b).astype(np.int64)
        cols = cols * 2 + (
            ((r >= a) & (r < a + b)) | (r >= a + b + c)
        ).astype(np.int64)
    return (rows % n).astype(np.int32), (cols % n).astype(np.int32)


def _synthesize(name: str, spec, seed=0) -> GraphDataset:
    n, e, f, ccount = spec
    rows, cols = rmat_edges(n, e, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, ccount, n).astype(np.int32)
    train = np.zeros(n, dtype=bool)
    train[rng.choice(n, max(1, n // 10), replace=False)] = True
    graph = CooGraph.from_edges(rows, cols, nrows=n, ncols=n, dtype="float32")
    metric = "rocauc" if name == "ogbn-proteins" else "acc"
    return GraphDataset(
        name=name, graph=graph, x=x, y=y, train_mask=train,
        test_mask=~train, num_classes=ccount, synthetic=True, metric=metric,
    )


def load_dataset(name: str, *, seed: int = 0) -> GraphDataset:
    """The synthetic stand-in for a spec name, or ``rmat-<n>-<e>``
    (64 features, 16 classes) for ad-hoc sizes."""
    name = name.lower()
    if name.startswith("rmat-"):
        _, ns, es = name.split("-")
        return _synthesize(name, (int(ns), int(es), 64, 16), seed)
    if name not in DATASET_SPECS:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DATASET_SPECS)} "
            f"or rmat-<n>-<e>"
        )
    return _synthesize(name, DATASET_SPECS[name], seed)
