"""Datasets: real files where they are on disk, synthetic stand-ins
otherwise.

Counterpart of ``pygim_tpu/data/datasets.py``. A known dataset name
resolves, in this order, to its raw files under ``root`` read by the
PyG-free parsers (``data/real.py``), to ``torch_geometric``'s loaders
where that package is importable (it is optional and absent on the
machines this port targets), and else to a synthetic stand-in: an R-MAT
graph with the published node count, stored edge count, feature width
and class count, random features and labels and a 10% train mask,
cached on disk as ``<name>-sim.npz`` (the reference's file layout) under
the port's cache directory (``utils/cache.py``).

Other names: ``<name>-uniq`` (a stand-in whose edges are all distinct,
as real datasets count them; cached as ``<name>-uniq-sim.npz``),
``rmat-<n>-<e>`` and ``rmat-<n>-<e>-uniq`` (64 features, 16 classes),
``brmat-<n>-<e>-<b>`` (hidden communities of ``b`` nodes),
``planted-<n>-<e>-<c>`` (a learnable planted partition, the training
parity graphs) and ``<file>.mtx`` (a MatrixMarket file under ``root``);
the parametric names are made anew each time. The same name and seed
give the reference's graph, features, labels and masks, array for array.
"""

from __future__ import annotations

import dataclasses
import logging
import os
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
    val_mask: Optional[np.ndarray] = None  # the real loaders' validation
                                           # split; stand-ins have none

    @property
    def num_nodes(self) -> int:
        return self.graph.nrows

    @property
    def num_edges(self) -> int:
        return self.graph.nnz


def rmat_edges(
    n: int, e: int, *, a=0.57, b=0.19, c=0.19, seed=0, unique=False
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized R-MAT edge generation (power-law degree skew). By
    default a multigraph: duplicates are kept, so ``e`` is the stored
    edge count. ``unique=True`` rejection-samples until ``e`` distinct
    edges exist, in the order of their first draw (real datasets count
    distinct pairs: real Reddit's 114.6M edges have no duplicates); it
    raises ``ValueError`` where ``e > n²`` and ``RuntimeError`` after 8
    batches in a row that add no new edge."""
    rng = np.random.default_rng(seed)
    scale = max(1, int(np.ceil(np.log2(max(n, 2)))))

    def _draw(m: int) -> tuple[np.ndarray, np.ndarray]:
        rows = np.zeros(m, dtype=np.int64)
        cols = np.zeros(m, dtype=np.int64)
        for _ in range(scale):
            r = rng.random(m)
            rows = rows * 2 + (r >= a + b).astype(np.int64)
            cols = cols * 2 + (
                ((r >= a) & (r < a + b)) | (r >= a + b + c)
            ).astype(np.int64)
        return (rows % n).astype(np.int32), (cols % n).astype(np.int32)

    if not unique:
        return _draw(e)
    if e > n * n:
        raise ValueError(f"cannot place {e} unique edges in an {n}x{n} graph")
    seen = np.empty(0, dtype=np.int64)  # the accepted keys, sorted
    out_r: list = []
    out_c: list = []
    have = 0
    stalled = 0
    # about 40 bytes of temporaries a drawn edge: 64M edges a batch keep
    # one batch near 2.5 GB of host memory
    batch_cap = 64 * 2**20
    while have < e:
        m = min(int((e - have) * 1.7) + 1024, batch_cap)
        br, bc = _draw(m)
        k = br.astype(np.int64) * n + bc
        # first occurrence within the batch, in draw order
        _, first = np.unique(k, return_index=True)
        first.sort()
        kf = k[first]
        if seen.size:  # drop keys accepted in earlier batches
            pos = np.searchsorted(seen, kf)
            dup = (pos < seen.size) & (
                seen[np.minimum(pos, seen.size - 1)] == kf)
            first = first[~dup]
        take = first[: e - have]
        out_r.append(br[take])
        out_c.append(bc[take])
        # a linear merge of two sorted key arrays, not a sort of `seen`
        new_sorted = np.sort(k[take])
        seen = np.insert(seen, np.searchsorted(seen, new_sorted), new_sorted)
        have += take.size
        # a request near the skew's reachable cells can accept nothing
        # batch after batch: only batches that add no edge count as stalled
        stalled = stalled + 1 if take.size == 0 else 0
        if stalled >= 8:
            raise RuntimeError(
                f"rmat_edges(unique=True) stalled at {have}/{e} unique "
                f"edges after {stalled} zero-progress batches — the "
                f"request saturates this R-MAT skew's reachable cells "
                f"(a={a}, b={b}, c={c}); lower e or the skew"
            )
    return np.concatenate(out_r), np.concatenate(out_c)


def _synthesize(name: str, spec, seed=0, unique=False) -> GraphDataset:
    n, e, f, ccount = spec
    rows, cols = rmat_edges(n, e, seed=seed, unique=unique)
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


def _synthesize_block(name: str, n: int, e: int, b: int, seed=0):
    """The reference's block-community graph (``_synthesize_block``):
    ``n`` nodes in ``n / b`` communities of ``b`` consecutive ids, 90% of
    the edges inside one, the rest anywhere, then the ids scrambled by a
    fixed permutation, so the structure is latent (a locality order must
    recover it); 64 features, 16 classes."""
    rng = np.random.default_rng(seed)
    b = max(1, min(b, n))
    e_in = int(e * 0.9)
    comm = rng.integers(0, max(1, n // b), e_in) * b
    rows = np.concatenate([
        comm + rng.integers(0, b, e_in),
        rng.integers(0, n, e - e_in),
    ])
    cols = np.concatenate([
        comm + rng.integers(0, b, e_in),
        rng.integers(0, n, e - e_in),
    ])
    perm = rng.permutation(n).astype(np.int64)
    rows, cols = perm[rows], perm[cols]
    graph = CooGraph.from_edges(rows, cols, nrows=n, ncols=n, dtype="float32")
    f, ccount = 64, 16
    rng2 = np.random.default_rng(seed + 1)
    x = rng2.standard_normal((n, f)).astype(np.float32)
    y = rng2.integers(0, ccount, n).astype(np.int32)
    train = np.zeros(n, dtype=bool)
    train[rng2.choice(n, max(1, n // 10), replace=False)] = True
    return GraphDataset(
        name=name, graph=graph, x=x, y=y, train_mask=train,
        test_mask=~train, num_classes=ccount, synthetic=True,
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


def _try_real_dataset(name: str, root: str) -> Optional[GraphDataset]:
    """``torch_geometric``'s (and OGB's) loaders where that package is
    importable, as the reference's ``_try_real_dataset``; None where it is
    absent or fails (the caller then takes the stand-in)."""
    try:
        import torch_geometric  # noqa: F401
    except ImportError:
        return None
    try:
        from torch_geometric.datasets import Planetoid, Reddit

        if name in ("cora", "citeseer", "pubmed"):
            ds = Planetoid(root=root, name=name.capitalize())
        elif name == "reddit":
            ds = Reddit(root=os.path.join(root, "Reddit"))
        elif name.startswith("ogbn-"):
            from ogb.nodeproppred import PygNodePropPredDataset

            ds = PygNodePropPredDataset(name=name, root=root)
        else:
            return None
        data = ds[0]
        ei = data.edge_index.numpy()
        n = data.num_nodes
        graph = CooGraph.from_edges(
            ei[1], ei[0], nrows=n, ncols=n, dtype="float32"
        )  # row = destination
        y = data.y.numpy().reshape(-1).astype(np.int32)
        train = (
            data.train_mask.numpy()
            if hasattr(data, "train_mask")
            else np.ones(n, dtype=bool)
        )
        test = (
            data.test_mask.numpy()
            if hasattr(data, "test_mask")
            else np.ones(n, dtype=bool)
        )
        return GraphDataset(
            name=name, graph=graph, x=data.x.numpy().astype(np.float32),
            y=y, train_mask=train, test_mask=test,
            num_classes=int(y.max()) + 1, synthetic=False,
        )
    except Exception as e:  # noqa: BLE001 — an optional loader's failure
        _log.warning("torch_geometric could not load %s (%s): taking the "
                     "stand-in", name, e)
        return None


def _cached_stand_in(name: str, spec, root: str, seed: int, use_cache: bool,
                     unique: bool = False) -> GraphDataset:
    """The stand-in of a spec, read from ``<root>/<name>-sim.npz`` where
    it was saved, else synthesized and saved there (``use_cache=False``
    does neither). As in the reference, the file's name holds no seed."""
    path = Path(root) / f"{name}-sim.npz"
    if use_cache and path.exists():
        try:
            return _load_cache(name, path)
        except LOAD_ERRORS as e:
            _log.warning("dataset cache %s unreadable (%s): synthesizing "
                         "anew", path, e)
    ds = _synthesize(name, spec, seed, unique=unique)
    if use_cache:
        _save_cache(ds, path)
    return ds


def load_dataset(name: str, root: Optional[str] = None, *, seed: int = 0,
                 use_cache: bool = True) -> GraphDataset:
    """The dataset ``name`` (module docstring): real files under ``root``
    (default: the cache directory) where they exist, else the stand-in.
    Raises ``KeyError`` on an unknown name."""
    from pygim_tpu_torch.data.real import try_load_real

    name = name.lower()
    root = str(cache_dir() if root is None else root)
    if name.endswith("-uniq"):
        base = name[: -len("-uniq")]
        if base.startswith("rmat-"):
            _, ns, es = base.split("-")
            return _synthesize(name, (int(ns), int(es), 64, 16), seed,
                               unique=True)
        if base not in DATASET_SPECS:
            raise KeyError(f"unknown dataset {name!r} "
                           f"(base {base!r} has no synthetic spec)")
        return _cached_stand_in(name, DATASET_SPECS[base], root, seed,
                                use_cache, unique=True)
    if name.startswith("rmat-"):
        _, ns, es = name.split("-")
        return _synthesize(name, (int(ns), int(es), 64, 16), seed)
    if name.startswith("brmat-"):
        _, ns, es, bs = name.split("-")
        return _synthesize_block(name, int(ns), int(es), int(bs), seed)
    if name.startswith("planted-"):
        _, ns, es, cs = name.split("-")
        return _synthesize_planted(name, int(ns), int(es), int(cs), seed)
    if name.endswith(".mtx"):
        # the graph from the file, padded square; features and labels
        # synthetic, sized to it
        g = load_mtx(os.path.join(root, name))
        if g.nrows != g.ncols:
            n = max(g.nrows, g.ncols)
            g = CooGraph(
                rows=g.rows, cols=g.cols, vals=g.vals, nrows=n, ncols=n
            )
        rng = np.random.default_rng(seed)
        n = g.nrows
        return GraphDataset(
            name=name, graph=g,
            x=rng.standard_normal((n, 64)).astype(np.float32),
            y=rng.integers(0, 4, n).astype(np.int32),
            train_mask=np.zeros(n, dtype=bool),
            test_mask=np.ones(n, dtype=bool),
            num_classes=4, synthetic=True,
        )
    if name not in DATASET_SPECS:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DATASET_SPECS)}, "
            "<name>-uniq, rmat-<n>-<e>[-uniq], brmat-<n>-<e>-<b>, "
            "planted-<n>-<e>-<c> or <file>.mtx"
        )
    real = try_load_real(name, root) or _try_real_dataset(name, root)
    if real is not None:
        return real
    return _cached_stand_in(name, DATASET_SPECS[name], root, seed, use_cache)


def load_mtx(path: str, dtype: str = "float32") -> CooGraph:
    """A MatrixMarket file (the SuiteSparse sets) through SciPy."""
    import scipy.io

    return CooGraph.from_scipy(scipy.io.mmread(path), dtype=dtype)


def _subgraph(ds: GraphDataset, part_idx: int, sub: CooGraph, sl):
    return GraphDataset(
        name=f"{ds.name}-part{part_idx}", graph=sub, x=ds.x[sl], y=ds.y[sl],
        train_mask=ds.train_mask[sl], test_mask=ds.test_mask[sl],
        num_classes=ds.num_classes, synthetic=ds.synthetic,
    )


def cluster_partition(ds: GraphDataset, part_size: int, part_idx: int = 1,
                      method: str = "none") -> GraphDataset:
    """Partition ``part_idx`` of ``ds`` in parts of ``part_size`` nodes,
    the reference's ``cluster_partition`` (``inference.py`` takes part 1
    of ~500k-node parts of amazonproducts), with the edges inside it.
    ``method``: ``"none"``, contiguous node ranges; ``"rcm"`` or
    ``"lp"``, ranges of a locality order (``core/cluster.py``), so each
    part is a low-cut cluster on a graph whose ids carry no locality; its
    nodes keep their original relative order. ``"metis"``: part
    ``part_idx`` of the multilevel k-way partition into ``ceil(n /
    part_size)`` parts (``core/cluster.py:partition_kway``)."""
    n = ds.num_nodes
    nparts = max(1, -(-n // part_size))
    part_idx = min(part_idx, nparts - 1)
    lo = part_idx * part_size
    hi = min(n, lo + part_size)
    g = ds.graph
    if method == "metis" and nparts > 1:
        from pygim_tpu_torch.core.cluster import partition_kway

        part = partition_kway(g, nparts)
        nodes = np.flatnonzero(part == part_idx)
        pos = np.full(n, -1, dtype=np.int64)
        pos[nodes] = np.arange(nodes.size)
        mask = (pos[g.rows] >= 0) & (pos[g.cols] >= 0)
        sub = CooGraph.from_edges(
            pos[g.rows[mask]], pos[g.cols[mask]], g.vals[mask],
            nrows=nodes.size, ncols=nodes.size,
        )
        return _subgraph(ds, part_idx, sub, nodes)
    if method != "none":
        from pygim_tpu_torch.core.cluster import locality_order

        order = locality_order(g, method=method)
        nodes = np.sort(order[lo:hi])  # this part's original node ids
        pos = np.full(n, -1, dtype=np.int64)
        pos[nodes] = np.arange(hi - lo)
        mask = (pos[g.rows] >= 0) & (pos[g.cols] >= 0)
        sub = CooGraph.from_edges(
            pos[g.rows[mask]], pos[g.cols[mask]], g.vals[mask],
            nrows=hi - lo, ncols=hi - lo,
        )
        return _subgraph(ds, part_idx, sub, nodes)
    mask = (g.rows >= lo) & (g.rows < hi) & (g.cols >= lo) & (g.cols < hi)
    sub = CooGraph.from_edges(
        g.rows[mask] - lo, g.cols[mask] - lo, g.vals[mask],
        nrows=hi - lo, ncols=hi - lo,
    )
    return _subgraph(ds, part_idx, sub, slice(lo, hi))
