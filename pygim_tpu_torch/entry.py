"""The flagship model's forward step, twin of ``__graft_entry__.entry()``,
and the multi-device dry run, twin of
``__graft_entry__.dryrun_multichip()``.

A 2-layer GCN (64 → 128 → 16) with int32-quantized aggregation through
the stair-int8 hybrid SpMM on a toy graph: 256 nodes, 8 edges a row, the
columns drawn with ``numpy.random.default_rng(0)``, the reference's. The
aggregate is ``prep.mul``, a plain callable, so every conv takes the
unfused quantize round trip (``nn/layers.py:quantized_aggregate``) and the
SpMM runs on an int32 payload: K-tail on int32 rows and K-int at four
limbs.

:func:`dryrun_multichip` runs, once each on tiny shapes, a GCN training
step over an ``(sp, ds)`` 2D mesh, the halo layout's ``all_to_all`` on
a skewed graph (three ELL tables or more), its ring with a hub core and
a BCSR tier, the 2D hybrid with a BCSR tier, and the scaling benchmark.
"""

from __future__ import annotations

import numpy as np
import torch

from pygim_tpu_torch.core.graph import CooGraph
from pygim_tpu_torch.nn.models import make_gnn
from pygim_tpu_torch.ops.spmm import SpmmConfig, prepare_spmm

N, F_IN, HIDDEN, F_OUT = 256, 64, 128, 16
CONFIG = SpmmConfig(backend="hybrid", hybrid_shape="stair",
                    hybrid_core_bytes=1 << 16, hybrid_dtype="int8",
                    stair_max_bands=4)


def toy_graph(n: int = N, deg: int = 8, seed: int = 0) -> CooGraph:
    """``deg`` edges out of every row, to columns drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=n * deg)
    return CooGraph.from_edges(rows, cols, nrows=n, ncols=n)


def skewed_graph(n: int, seed: int = 1) -> CooGraph:
    """Hub rows (32 edges, the first ``n // 16``, at least 2) and rows of
    two: the multi-degree ELL split on every shard."""
    rng = np.random.default_rng(seed)
    deg = np.full(n, 2, dtype=np.int64)
    deg[: max(2, n // 16)] = 32
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=rows.size)
    return CooGraph.from_edges(rows, cols, nrows=n, ncols=n)


def entry(device="cuda", state_dict=None):
    """``(fwd, (x,))``: the forward step and a zero (256, 64) input on
    ``device``. The weights are ``make_gnn``'s from seed 0, or
    ``state_dict`` (e.g. ``params_from_jax`` of the reference's model)."""
    prep = prepare_spmm(toy_graph(), CONFIG, device=device)
    model = make_gnn(0, "gcn", F_IN, HIDDEN, F_OUT, agg_dtype="int32",
                     device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict)

    @torch.inference_mode()
    def fwd(x):
        return model(x, prep.mul)

    x = torch.zeros((N, F_IN), dtype=torch.float32, device=device)
    return fwd, (x,)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Every mesh path once over ``n_devices`` shards: on the visible cards
    where ``device`` is a card and there are enough of them, else on a
    virtual mesh of ``device`` repeated. Raises where a step fails or
    gives a non-finite loss or a wrong shape."""
    from pygim_tpu_torch.bench.scaling import run_scaling_benchmark
    from pygim_tpu_torch.data import GraphDataset
    from pygim_tpu_torch.nn.train import make_train_step
    from pygim_tpu_torch.ops.spmm import PreparedAggregate
    from pygim_tpu_torch.parallel import (
        make_mesh,
        make_node_mesh,
        prepare_spmm_2d,
        prepare_spmm_halo,
    )
    from pygim_tpu_torch.parallel.mesh import visible_cards
    from pygim_tpu_torch.utils.metrics import DataReporter

    dev = torch.device(device)
    cards = visible_cards() if dev.type == "cuda" else []
    devices = (cards[:n_devices] if len(cards) >= n_devices
               else [dev] * n_devices)
    first = devices[0]
    ds_ = 2 if n_devices % 2 == 0 else 1
    sp = n_devices // ds_
    mesh = make_mesh(sp, ds_, devices)

    n, f_in, h, f_out = 16 * sp, 8, 16, 4
    coo = toy_graph(n, deg=4)
    prep = prepare_spmm_2d(coo, mesh, SpmmConfig(n_blocks=2))
    prep.transpose(coo)  # the backward's operand
    model = make_gnn(0, "gcn", f_in, h, f_out, device=first)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, PreparedAggregate(prep), optimizer)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((n, f_in)),
                        dtype=torch.float32).to(first)
    labels = torch.as_tensor(rng.integers(0, f_out, n)).to(first)
    mask = torch.ones(n, dtype=torch.float32, device=first)
    gen = torch.Generator(device=first)
    gen.manual_seed(1)
    loss = step(x, labels, mask, gen)
    if not torch.isfinite(loss):
        raise AssertionError("non-finite training loss")

    halo = prepare_spmm_halo(skewed_graph(n), make_node_mesh(n_devices,
                                                             devices),
                             SpmmConfig(n_blocks=2), exchange="all_to_all")
    if len(halo._local_meta) + len(halo._halo_meta) < 3:
        raise AssertionError("the skewed dry-run graph should split into "
                             "three ELL tables or more")
    tiers = SpmmConfig(backend="hybrid", hybrid_k=8, bcsr_bytes=1 << 20,
                       bcsr_tile=8, bcsr_min_edges=2)
    ring = prepare_spmm_halo(coo, make_node_mesh(n_devices, devices), tiers,
                             exchange="ring")
    hyb = prepare_spmm_2d(coo, mesh, SpmmConfig(
        backend="hybrid", hybrid_k=16, bcsr_bytes=1 << 20, bcsr_tile=8,
        bcsr_min_edges=2))
    with torch.inference_mode():
        for op in (halo, ring, hyb):
            out = op.mul(x)
            if out.shape != (n, f_in) or not torch.isfinite(out).all():
                raise AssertionError(f"{type(op).__name__}: a product of "
                                     f"shape {tuple(out.shape)}")

    tiny = GraphDataset(
        name="dryrun", graph=coo, x=np.zeros((n, f_in), dtype=np.float32),
        y=np.zeros(n, dtype=np.int64), train_mask=np.zeros(n, bool),
        test_mask=np.zeros(n, bool), num_classes=f_out, synthetic=True)
    means = run_scaling_benchmark(tiny, device_counts=[1, n_devices],
                                  hidden=8, repeat=1,
                                  reporter=DataReporter(echo=False),
                                  devices=devices)
    for key in (f"edges_per_s_n{n_devices}",
                f"scaling_efficiency_n{n_devices}"):
        if key not in means:
            raise AssertionError(f"the scaling benchmark reported no {key}")
