"""Named experiment sets, the twin of ``pygim_tpu/bench/configs.py``: the
reference's budget and dataset sets, the BASELINE.md tracked
configurations (``BASELINE_EXPERIMENTS``, entry for entry and field for
field, so each has the reference's frozen name) and the default sweep.
The port runs every point, tracked config 5's four halo scaling entries
included (``bench/scaling.py``)."""

from __future__ import annotations

from pygim_tpu_torch.bench.experiment import Experiment
from pygim_tpu_torch.tune.space import For

NR_BLOCK_BUDGETS = {"set_1": [1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 19]}
DATASETS = {
    "set_1": ["pubmed", "ogbn-arxiv", "reddit", "ogbn-products"],
    "small": ["tiny", "small"],
}

BASELINE_EXPERIMENTS = [
    # (1) one SpMM on Reddit, CSR, float32, hidden 256, with the per-phase
    # times: the int8 core at 12 GiB (stair, square) and the bf16 core
    Experiment(dataset="reddit", kind="spmm", sp_format="csr",
               dtype="float32", hidden=256, backend="hybrid", phases=True,
               hybrid_core_bytes=12 << 30, hybrid_dtype="int8",
               hybrid_shape="stair"),
    Experiment(dataset="reddit", kind="spmm", sp_format="csr",
               dtype="float32", hidden=256, backend="hybrid", phases=True,
               hybrid_core_bytes=12 << 30, hybrid_dtype="int8"),
    Experiment(dataset="reddit", kind="spmm", sp_format="csr",
               dtype="float32", hidden=256, backend="hybrid", phases=True,
               hybrid_core_bytes=12 << 30, hybrid_dtype="bfloat16"),
    # (1b) the same on reddit-uniq, the simple-graph stand-in (114.6M
    # edges, all distinct, as real Reddit's): prepare's merge cannot
    # shrink its stored workload
    Experiment(dataset="reddit-uniq", kind="spmm", sp_format="csr",
               dtype="float32", hidden=256, backend="hybrid", phases=True,
               hybrid_core_bytes=12 << 30, hybrid_dtype="int8",
               hybrid_shape="stair"),
    Experiment(dataset="reddit-uniq", kind="spmm", sp_format="csr",
               dtype="float32", hidden=256, backend="hybrid", phases=True,
               hybrid_core_bytes=12 << 30, hybrid_dtype="int8"),
    Experiment(dataset="reddit-uniq", kind="spmm", sp_format="csr",
               dtype="float32", hidden=256, backend="hybrid", phases=True,
               hybrid_core_bytes=10 << 30, hybrid_dtype="int8"),
    # (2) 2-layer GCN on Reddit, float32, with the per-layer check
    Experiment(dataset="reddit", kind="inference", model="gcn",
               num_layers=2, dtype="float32", hidden=256, backend="hybrid",
               hybrid_core_bytes=12 << 30, hybrid_dtype="int8",
               hybrid_shape="stair", validate=True),
    Experiment(dataset="reddit", kind="inference", model="gcn",
               num_layers=2, dtype="float32", hidden=256, backend="hybrid",
               hybrid_core_bytes=12 << 30, hybrid_dtype="int8",
               validate=True),
    Experiment(dataset="reddit", kind="inference", model="gcn",
               num_layers=2, dtype="float32", hidden=256, backend="hybrid",
               hybrid_core_bytes=12 << 30, hybrid_dtype="bfloat16",
               validate=True),
    # (3) GIN and SAGE on ogbn-arxiv, COO against CSR, autotuned
    Experiment(dataset="ogbn-arxiv", kind="inference", model="gin",
               sp_format="coo", tune=True),
    Experiment(dataset="ogbn-arxiv", kind="inference", model="sage",
               sp_format="csr", tune=True),
    # (4) the int8-quantized GCN on ogbn-products on a nibble-packed int4
    # square core at 6 GiB, no middle tier
    Experiment(dataset="ogbn-products", kind="inference", model="gcn",
               dtype="int8", backend="hybrid", hybrid_dtype="int4",
               hybrid_core_bytes=6 << 30, validate=True),
    # (5) ogbn-papers100M's GCN, edge-partitioned with a halo exchange,
    # rehearsed on an R-MAT of papers100M's density (~14.5 edges a node)
    Experiment(dataset="rmat-1048576-15728640", kind="scaling",
               backend="ell", hidden=128, exchange="all_to_all", repeat=2),
    Experiment(dataset="rmat-1048576-15728640", kind="scaling",
               backend="ell", hidden=128, exchange="ring", repeat=2),
    # the row-sharded hub-core on the halo layout
    Experiment(dataset="rmat-1048576-15728640", kind="scaling",
               backend="hybrid", hybrid_core_bytes=8 << 20, hidden=128,
               exchange="ring", repeat=2),
    # the full GCN forward over the edge-partitioned mesh, int32
    # aggregation
    Experiment(dataset="rmat-1048576-15728640", kind="scaling",
               backend="ell", hidden=128, exchange="ring", repeat=2,
               scale_model=True, model="gcn", dtype="int32"),
]


# The reference's round-2 three-tier configuration for products-shaped
# graphs (docs/PERF.md:107, 168-172): a bf16 square core at 2 GiB, 2.5
# GiB of BCSR tiles of 16 rows in the RCM order of the tail, H 256, on
# the ogbn-products stand-in. The float32 SpMM with its phases in both
# layouts, and tracked config 4's model (the int8 GCN, validated) on the
# panel layout. Not among the reference's named sets.
_THREE_TIER = dict(dataset="ogbn-products", hidden=256, backend="hybrid",
                   hybrid_dtype="bfloat16", hybrid_core_bytes=2 << 30,
                   bcsr_bytes=5 << 29, bcsr_tile=16, bcsr_order="rcm")
THREE_TIER_EXPERIMENTS = [
    Experiment(kind="spmm", phases=True, bcsr_layout="panel", **_THREE_TIER),
    Experiment(kind="spmm", phases=True, bcsr_layout="row", **_THREE_TIER),
    Experiment(kind="inference", model="gcn", dtype="int8", validate=True,
               bcsr_layout="panel", **_THREE_TIER),
]


def sweep_space(datasets: str = "small"):
    """The default sweep: datasets × backends × balance."""
    return (
        For("dataset", DATASETS[datasets])
        * For("backend", ["blocked", "ell"])
        * For("balance", ["nnz", "row"])
    )
