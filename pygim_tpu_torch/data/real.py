"""Parsers of the real datasets' raw files, with no ``torch_geometric``
or ``ogb``: the twin of ``pygim_tpu/data/real.py``, on NumPy, pickle,
gzip and SciPy. ``load_dataset`` reads these files where they lie under
its root, and otherwise takes the synthetic stand-ins (every record then
says ``data_source: synthetic``).

The raw layouts, as the upstream downloads unpack them:

* Planetoid (cora, citeseer, pubmed): ``<root>/<Name>/raw/ind.<name>.{x,
  tx,allx,y,ty,ally,graph,test.index}``: pickled SciPy CSR feature
  blocks, one-hot label blocks, a neighbour-dict adjacency and the
  permuted test index (citeseer's gap of isolated test nodes included).
* Reddit (PyG): ``<root>/Reddit/raw/reddit_data.npz`` (feature, label,
  node_types) and ``reddit_graph.npz`` (a SciPy sparse adjacency).
* OGB node property (ogbn-arxiv, ogbn-products, ...): ``<root>/<name with
  underscores>/raw/{edge.csv.gz,node-feat.csv.gz,node-label.csv.gz,
  num-node-list.csv.gz}`` and ``split/<scheme>/{train,valid,test}.csv.gz``.

Downloading is not part of the port: the files are put in place by hand
(``data/real_layout.py`` writes a stand-in in these layouts).
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path

import numpy as np

from pygim_tpu_torch.core.graph import CooGraph

PLANETOID_NAMES = ("cora", "citeseer", "pubmed")


def _pickle_load(path: Path):
    with open(path, "rb") as f:
        # the upstream files were pickled under Python 2
        return pickle.load(f, encoding="latin1")


def planetoid_dir(root: str, name: str) -> Path:
    return Path(root) / name.capitalize() / "raw"


def load_planetoid(root: str, name: str):
    """Parse the Planetoid ``ind.<name>.*`` files (what
    ``torch_geometric.datasets.Planetoid`` reads). Returns ``(graph, x, y,
    train_mask, val_mask, test_mask)``: train = the first ``len(y)``
    nodes, val = the next 500, test = the ``test.index`` entries, whose
    rows the raw blocks store in permuted order. Citeseer's test block
    skips isolated nodes; those ids come back as zero-feature, label-0
    nodes, as the upstream loader does. The adjacency is symmetrized and
    deduplicated, without self-loops, row = destination."""
    import scipy.sparse as sp

    name = name.lower()
    d = planetoid_dir(root, name)
    xs, ys, tx, ty, allx, ally = (
        _pickle_load(d / f"ind.{name}.{ext}")
        for ext in ("x", "y", "tx", "ty", "allx", "ally")
    )
    graph_dict = _pickle_load(d / f"ind.{name}.graph")
    test_idx = np.loadtxt(d / f"ind.{name}.test.index", dtype=np.int64)
    test_sorted = np.sort(test_idx)

    lo, hi = int(test_sorted[0]), int(test_sorted[-1])
    if hi - lo + 1 > len(test_idx):
        # citeseer: re-insert the missing ids as zero rows, so node ids
        # stay dense
        full = hi - lo + 1
        tx_full = sp.lil_matrix((full, xs.shape[1]), dtype=np.float32)
        tx_full[test_sorted - lo, :] = tx
        tx = tx_full.tocsr()
        ty_full = np.zeros((full, ty.shape[1]), dtype=ty.dtype)
        ty_full[test_sorted - lo, :] = ty
        ty = ty_full

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_sorted, :]
    x = np.asarray(features.todense(), dtype=np.float32)
    labels = np.vstack((ally, ty))
    labels[test_idx, :] = labels[test_sorted, :]
    y = labels.argmax(axis=1).astype(np.int32)

    n = x.shape[0]
    src, dst = [], []
    for u, nbrs in graph_dict.items():
        for v in nbrs:
            src.append(u)
            dst.append(v)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = (src < n) & (dst < n) & (src != dst)
    src, dst = src[keep], dst[keep]
    und = np.unique(
        np.stack([np.concatenate([dst, src]), np.concatenate([src, dst])]),
        axis=1,
    )
    graph = CooGraph.from_edges(und[0], und[1], nrows=n, ncols=n)

    train = np.zeros(n, dtype=bool)
    train[: len(ys)] = True
    val = np.zeros(n, dtype=bool)
    val[len(ys): len(ys) + 500] = True
    test = np.zeros(n, dtype=bool)
    test[test_sorted] = True
    return graph, x, y, train, val, test


def reddit_dir(root: str) -> Path:
    return Path(root) / "Reddit" / "raw"


def load_reddit(root: str):
    """Parse PyG's Reddit files: ``reddit_data.npz`` (feature, label,
    node_types: 1 train, 2 val, 3 test) and ``reddit_graph.npz`` (the
    adjacency, transposed here so that row = destination)."""
    import scipy.sparse as sp

    d = reddit_dir(root)
    with np.load(d / "reddit_data.npz") as data:
        x = data["feature"].astype(np.float32)
        y = data["label"].astype(np.int32)
        types = data["node_types"]
    adj = sp.load_npz(d / "reddit_graph.npz")
    graph = CooGraph.from_scipy(adj.T)
    return graph, x, y, types == 1, types == 2, types == 3


def ogb_dir(root: str, name: str) -> Path:
    return Path(root) / name.replace("-", "_") / "raw"


def _read_csv_gz(path: Path, dtype, chunk_bytes: int = 1 << 26) -> np.ndarray:
    """A numeric ``.csv.gz`` as a 2-D array of ``dtype``, read in blocks
    of ``chunk_bytes`` decompressed bytes, each parsed by one C-level
    ``np.fromstring`` pass (newlines folded into the separator), so it
    stays practical at OGB scale (ogbn-products' edge file has ~124M
    lines). Values pass through float64, exact for every integer id
    below 2^53. An empty file gives shape ``(0, 1)``."""
    parts: list[np.ndarray] = []
    ncols, rem = None, b""
    with gzip.open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            block = rem + block
            cut = block.rfind(b"\n")
            if cut < 0:
                rem = block
                continue
            rem, text = block[cut + 1:], block[:cut]
            if ncols is None:
                ncols = text.split(b"\n", 1)[0].count(b",") + 1
            parts.append(np.fromstring(
                text.replace(b"\n", b","), dtype=np.float64, sep=","))
    if rem.strip():
        if ncols is None:
            ncols = rem.count(b",") + 1
        parts.append(np.fromstring(
            rem.replace(b"\n", b","), dtype=np.float64, sep=","))
    flat = np.concatenate(parts) if parts else np.empty((0,), np.float64)
    return flat.reshape(-1, ncols or 1).astype(dtype)


def load_ogb_nodeprop(root: str, name: str):
    """Parse an OGB node-property dataset from its raw ``.csv.gz`` files
    (what ``ogb.nodeproppred`` extracts). The split comes from
    ``split/<scheme>/{train,valid,test}.csv.gz``, the first scheme
    directory in name order that holds each part; with no split files
    every node is a test node. ``edge.csv`` is (source, destination);
    the graph's rows are destinations."""
    raw = ogb_dir(root, name)
    n = int(_read_csv_gz(raw / "num-node-list.csv.gz", np.int64)[0, 0])
    edges = _read_csv_gz(raw / "edge.csv.gz", np.int64)
    x = _read_csv_gz(raw / "node-feat.csv.gz", np.float32)
    y = _read_csv_gz(raw / "node-label.csv.gz", np.float32)
    y = y.reshape(n, -1)[:, 0].astype(np.int32)
    if x.shape[0] != n:
        raise ValueError(f"{raw / 'node-feat.csv.gz'}: {x.shape[0]} rows "
                         f"for {n} nodes")
    graph = CooGraph.from_edges(edges[:, 1], edges[:, 0], nrows=n, ncols=n)

    split_root = raw.parent / "split"
    schemes = sorted(split_root.glob("*")) if split_root.exists() else []
    masks = {}
    for part in ("train", "valid", "test"):
        masks[part] = np.zeros(n, dtype=bool)
        for scheme in schemes:
            p = scheme / f"{part}.csv.gz"
            if p.exists():
                masks[part][_read_csv_gz(p, np.int64).reshape(-1)] = True
                break
    if not masks["test"].any():
        masks["test"][:] = True
    return graph, x, y, masks["train"], masks["valid"], masks["test"]


def try_load_real(name: str, root: str):
    """``name`` from its raw files under ``root``, as a ``GraphDataset``
    with ``synthetic=False`` and its ``val_mask``; None where the files
    are absent. Files that exist but do not parse raise: a damaged real
    dataset fails loudly instead of turning into a stand-in."""
    name = name.lower()
    if name in PLANETOID_NAMES:
        if not (planetoid_dir(root, name) / f"ind.{name}.graph").exists():
            return None
        graph, x, y, train, val, test = load_planetoid(root, name)
    elif name == "reddit":
        if not (reddit_dir(root) / "reddit_data.npz").exists():
            return None
        graph, x, y, train, val, test = load_reddit(root)
    elif name.startswith("ogbn-"):
        if not (ogb_dir(root, name) / "edge.csv.gz").exists():
            return None
        graph, x, y, train, val, test = load_ogb_nodeprop(root, name)
    else:
        return None

    from pygim_tpu_torch.data.datasets import GraphDataset

    metric = "rocauc" if name == "ogbn-proteins" else "acc"
    return GraphDataset(
        name=name, graph=graph, x=x, y=y, train_mask=train, test_mask=test,
        num_classes=int(y.max()) + 1, synthetic=False, metric=metric,
        val_mask=val,
    )
