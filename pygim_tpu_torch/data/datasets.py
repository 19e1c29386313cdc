"""Synthetic dataset stand-ins.

Counterpart of ``pygim_tpu/data/datasets.py`` for the stand-ins only:
each known dataset name resolves to an R-MAT graph with the published
node count, stored edge count, feature width and class count, with
random features, labels and a 10% train mask; ``planted-<n>-<e>-<c>``
is a learnable planted partition (the training parity graphs). The same
name and seed give the reference's graph, features, labels and masks,
array for array. A spec name's stand-in is cached on disk as ``<name>-sim.npz``
under the port's cache directory (``utils/cache.py``), the reference's
file layout; ``rmat-<n>-<e>`` names are made anew each time, as in the
reference. Real-dataset loaders come in a later slice.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np

from pygim_tpu_torch.core.graph import CooGraph
from pygim_tpu_torch.utils.cache import LOAD_ERRORS, cache_dir, save_npz

_log = logging.getLogger("pygim_tpu_torch")

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


def _synthesize_planted(name: str, n: int, e: int, c: int, seed=0):
    """The reference's planted partition (``_synthesize_planted``): labels
    are ``c`` communities, 90% of the edges join two members of one class
    (homophily), features (32) are a noisy class signature, so a 2-layer
    GNN learns it — the graph behind the trained-accuracy parity runs."""
    rng = np.random.default_rng(seed)
    c = max(2, c)
    y = rng.integers(0, c, n).astype(np.int32)
    e_in = int(e * 0.9)
    members = [np.where(y == k)[0] for k in range(c)]
    sizes = np.array([len(m) for m in members])
    ok = sizes > 0
    probs = np.where(ok, sizes, 0) / sizes[ok].sum()
    cls = rng.choice(c, e_in, p=probs)
    r_in = np.empty(e_in, dtype=np.int64)
    c_in = np.empty(e_in, dtype=np.int64)
    for k in range(c):
        m = cls == k
        if m.any() and len(members[k]):
            r_in[m] = rng.choice(members[k], m.sum())
            c_in[m] = rng.choice(members[k], m.sum())
    rows = np.concatenate([r_in, rng.integers(0, n, e - e_in)])
    cols = np.concatenate([c_in, rng.integers(0, n, e - e_in)])
    f = 32
    sig = rng.standard_normal((c, f)).astype(np.float32)
    x = sig[y] + 1.5 * rng.standard_normal((n, f)).astype(np.float32)
    train = np.zeros(n, dtype=bool)
    train[rng.choice(n, max(1, n // 10), replace=False)] = True
    graph = CooGraph.from_edges(rows, cols, nrows=n, ncols=n, dtype="float32")
    return GraphDataset(
        name=name, graph=graph, x=x, y=y, train_mask=train,
        test_mask=~train, num_classes=c, synthetic=True,
    )


def _save_cache(ds: GraphDataset, path: Path) -> None:
    save_npz(path, dict(
        rows=ds.graph.rows, cols=ds.graph.cols, x=ds.x, y=ds.y,
        train_mask=ds.train_mask, test_mask=ds.test_mask,
        num_classes=ds.num_classes, synthetic=ds.synthetic,
        nrows=ds.graph.nrows,
    ))


def _load_cache(name: str, path: Path) -> GraphDataset:
    """The cached stand-in. As in the reference (``_load_cache``), the
    metric is not stored, so a cached ``ogbn-proteins`` loads with
    ``"acc"``."""
    with np.load(path) as z:
        n = int(z["nrows"])
        graph = CooGraph.from_edges(
            z["rows"], z["cols"], nrows=n, ncols=n, dtype="float32"
        )
        return GraphDataset(
            name=name, graph=graph, x=z["x"], y=z["y"],
            train_mask=z["train_mask"], test_mask=z["test_mask"],
            num_classes=int(z["num_classes"]),
            synthetic=bool(z["synthetic"]),
        )


def load_dataset(name: str, root: Optional[str] = None, *, seed: int = 0,
                 use_cache: bool = True) -> GraphDataset:
    """The synthetic stand-in for a spec name, ``rmat-<n>-<e>`` (64
    features, 16 classes) for ad-hoc sizes, or ``planted-<n>-<e>-<c>``
    (32 features, ``c`` classes); the last two are made anew each time. A spec name's stand-in is
    read from ``root`` (default: the cache directory) where it was saved,
    else synthesized and saved there; ``use_cache=False`` does neither.
    As in the reference, the file's name holds no seed."""
    name = name.lower()
    if name.startswith("rmat-"):
        _, ns, es = name.split("-")
        return _synthesize(name, (int(ns), int(es), 64, 16), seed)
    if name.startswith("planted-"):
        _, ns, es, cs = name.split("-")
        return _synthesize_planted(name, int(ns), int(es), int(cs), seed)
    if name not in DATASET_SPECS:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DATASET_SPECS)} "
            f"or rmat-<n>-<e> or planted-<n>-<e>-<c>"
        )
    path = Path(cache_dir() if root is None else root) / f"{name}-sim.npz"
    if use_cache and path.exists():
        try:
            return _load_cache(name, path)
        except LOAD_ERRORS as e:
            _log.warning("dataset cache %s unreadable (%s): synthesizing "
                         "anew", path, e)
    ds = _synthesize(name, DATASET_SPECS[name], seed)
    if use_cache:
        _save_cache(ds, path)
    return ds


def cluster_partition(ds: GraphDataset, part_size: int, part_idx: int = 1,
                      method: str = "none") -> GraphDataset:
    """Partition ``part_idx`` of ``ds`` in parts of ``part_size`` nodes,
    the reference's ``cluster_partition`` (``inference.py`` takes part 1
    of ~500k-node parts of amazonproducts). ``method="none"``: contiguous
    node ranges, and the edges inside one. The clustered methods (``rcm``,
    ``lp``, ``metis``) come with ``core/cluster.py``; they raise."""
    if method != "none":
        raise NotImplementedError(
            f"cluster_partition(method={method!r}): only 'none' is ported "
            "(the clustered orders need core/cluster.py)"
        )
    n = ds.num_nodes
    nparts = max(1, -(-n // part_size))
    part_idx = min(part_idx, nparts - 1)
    lo = part_idx * part_size
    hi = min(n, lo + part_size)
    g = ds.graph
    mask = (g.rows >= lo) & (g.rows < hi) & (g.cols >= lo) & (g.cols < hi)
    sub = CooGraph.from_edges(
        g.rows[mask] - lo, g.cols[mask] - lo, g.vals[mask],
        nrows=hi - lo, ncols=hi - lo,
    )
    sl = slice(lo, hi)
    return GraphDataset(
        name=f"{ds.name}-part{part_idx}", graph=sub, x=ds.x[sl], y=ds.y[sl],
        train_mask=ds.train_mask[sl], test_mask=ds.test_mask[sl],
        num_classes=ds.num_classes, synthetic=ds.synthetic,
    )
