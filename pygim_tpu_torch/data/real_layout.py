"""Write a synthetic stand-in in the exact raw layout of its real
dataset, so the real-format parsers (``data/real.py``) run end to end at
any scale on stand-in bytes: the twin of ``tools/write_real_layout.py``.

* ``reddit``: ``<out>/Reddit/raw/reddit_data.npz`` and
  ``reddit_graph.npz`` (features, labels, node types and the SciPy
  adjacency; :func:`~pygim_tpu_torch.data.real.load_reddit`).
* ``ogbn-*``: ``<out>/<name with _>/raw/{edge,node-feat,node-label,
  num-node-list}.csv.gz`` and ``split/time/{train,valid,test}.csv.gz``
  (:func:`~pygim_tpu_torch.data.real.load_ogb_nodeprop`).

:func:`verify_roundtrip` parses the files back through
``try_load_real`` and holds graph, features, labels and masks to the
source. From the command line::

    python3 -m pygim_tpu_torch.data.real_layout ogbn-arxiv realdata
    python3 -m pygim_tpu_torch.data.real_layout reddit realdata reddit-uniq

The optional third argument names the stand-in that supplies the bytes:
a layout stores one cell per (row, col), so a multigraph stand-in is
written (and verified) merged; the ``-uniq`` sibling has no duplicates.
"""

from __future__ import annotations

import dataclasses
import gzip
import sys
import time
from pathlib import Path

import numpy as np


def _log(*a):
    print(f"[{time.strftime('%H:%M:%S')}]", *a, flush=True)


def _val_mask(ds):
    val = getattr(ds, "val_mask", None)
    return ~(ds.train_mask | ds.test_mask) if val is None else val


def write_reddit(ds, out_root: Path) -> None:
    """PyG's Reddit files: the adjacency stored as ``adj[s, d] = G[d, s]``
    (``load_reddit`` transposes it back), node types 1 / 2 / 3 for train
    / validation / test."""
    import scipy.sparse as sp

    raw = Path(out_root) / "Reddit" / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    g = ds.graph
    adj = sp.csr_matrix(
        (g.vals, (g.cols, g.rows)), shape=(g.ncols, g.nrows)
    )
    sp.save_npz(raw / "reddit_graph.npz", adj)
    types = np.full(ds.x.shape[0], 2, dtype=np.int64)
    types[ds.train_mask] = 1
    types[ds.test_mask] = 3
    np.savez(
        raw / "reddit_data.npz",
        feature=ds.x, label=ds.y.astype(np.int64), node_types=types,
    )
    _log(f"wrote {raw} (adj nnz={adj.nnz})")


def _write_csv_gz(path: Path, arr: np.ndarray, fmt: str) -> None:
    with gzip.open(path, "wt", compresslevel=1) as f:
        np.savetxt(f, arr, fmt=fmt, delimiter=",")


def write_ogb(ds, name: str, out_root: Path) -> None:
    """OGB's node-property files: edges as (source, destination), features
    as ``%.6g`` (so they parse back within 2e-5), the split under
    ``split/time``."""
    raw = Path(out_root) / name.replace("-", "_") / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    g = ds.graph
    n = ds.x.shape[0]
    _write_csv_gz(raw / "edge.csv.gz", np.stack([g.cols, g.rows], axis=1),
                  "%d")
    _write_csv_gz(raw / "node-feat.csv.gz", ds.x, "%.6g")
    _write_csv_gz(raw / "node-label.csv.gz", ds.y.reshape(-1, 1), "%d")
    _write_csv_gz(raw / "num-node-list.csv.gz",
                  np.array([[n]], dtype=np.int64), "%d")
    split = raw.parent / "split" / "time"
    split.mkdir(parents=True, exist_ok=True)
    for part, mask in (("train", ds.train_mask), ("valid", _val_mask(ds)),
                       ("test", ds.test_mask)):
        _write_csv_gz(split / f"{part}.csv.gz",
                      np.flatnonzero(mask).reshape(-1, 1), "%d")
    _log(f"wrote {raw} (E={g.nnz})")


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"real-layout round trip: {what}")


def verify_roundtrip(ds, name: str, out_root: Path, real=None):
    """Hold the dataset parsed from ``out_root`` (``real``, else parsed
    here through ``try_load_real``) to ``ds``: marked real, the same
    edges in (row, col) order, values within 1e-6, features within 2e-5
    (OGB's CSV holds ``%.6g``; Reddit's npz is exact), labels and train /
    test masks equal, a validation mask present. Raises
    ``AssertionError`` on a difference; returns the parsed dataset."""
    from pygim_tpu_torch.data.real import try_load_real

    if real is None:
        t0 = time.time()
        real = try_load_real(name, str(out_root))
        _require(real is not None, "the parser did not find the layout")
        _log(f"parsed back through try_load_real in {time.time() - t0:.1f}s")
    _require(not real.synthetic, "the parsed dataset is marked synthetic")
    a, b = real.graph.sort_by_row(), ds.graph.sort_by_row()
    _require(a.nnz == b.nnz, f"{a.nnz} edges parsed, {b.nnz} written")
    _require(np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols),
             "the edges differ")
    _require(np.allclose(a.vals, b.vals, rtol=1e-6, atol=0),
             "the edge values differ")
    _require(real.x.shape == ds.x.shape
             and np.allclose(real.x, ds.x, rtol=2e-5, atol=2e-5),
             "the features differ by more than 2e-5")
    _require(np.array_equal(real.y, ds.y), "the labels differ")
    _require(np.array_equal(real.train_mask, ds.train_mask),
             "the train masks differ")
    _require(np.array_equal(real.test_mask, ds.test_mask),
             "the test masks differ")
    _require(real.val_mask is not None, "no validation mask")
    _log(f"round trip verified: {name} N={real.graph.nrows} "
         f"E={real.graph.nnz} data_source=real")
    return real


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0]
    out_root = Path(argv[1] if len(argv) > 1 else "realdata")
    source = argv[2] if len(argv) > 2 else name
    from pygim_tpu_torch.core.graph import merge_duplicate_edges
    from pygim_tpu_torch.data import load_dataset

    t0 = time.time()
    ds = load_dataset(source)
    _log(f"loaded {source} stand-in in {time.time() - t0:.0f}s "
         f"(N={ds.graph.nrows}, E={ds.graph.nnz})")
    merged, _ = merge_duplicate_edges(ds.graph)
    if merged.nnz != ds.graph.nnz:
        _log(f"{source} is a multigraph ({ds.graph.nnz} stored / "
             f"{merged.nnz} unique): writing its merged cells; the -uniq "
             "sibling has none to merge")
        ds = dataclasses.replace(ds, graph=merged)
    if name == "reddit":
        write_reddit(ds, out_root)
    elif name.startswith("ogbn-"):
        write_ogb(ds, name, out_root)
    else:
        raise SystemExit(f"no real layout known for {name}")
    verify_roundtrip(ds, name, out_root)


if __name__ == "__main__":
    main()
