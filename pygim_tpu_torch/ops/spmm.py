"""Prepare-once / run-many SpMM on one CUDA card.

Counterpart of ``pygim_tpu/ops/spmm.py`` for the slice it carries: the
``hybrid`` backend with a staircase int8 core and a float payload.
:func:`prepare_spmm` plans on the host (duplicate merge, degree rank,
staircase bands, multi-degree ELL tail), fills the int8 bands and the
ELL tables, and moves them to the device; :meth:`PreparedSpmm.mul` then
computes ``A @ x`` as

1. ``out = zeros(N, H)``;
2. K-tail over every ELL table into ``out``, one launch
   (``ops/ell_tail.py``);
3. ``xc = bf16(x[core_nodes])`` and K-core over all bands into ``out``
   at ``core_nodes[lo:hi]``, one launch (``ops/core_dot.py``); where H is
   not a multiple of 8, K-core runs on ``xc`` and ``out`` padded with
   zero columns to the next multiple, and the product is cut back to H

— the order of the reference's hybrid run. The host tables are the
reference's bit for bit. Other backends, core shapes and dtypes, and
the prepare cache come in later slices; the config raises on them.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.core.graph import CooGraph, merge_duplicate_edges
from pygim_tpu_torch.core.partition import (
    build_ell_rows_multi,
    choose_degrees_for_config,
    round_up,
)
from pygim_tpu_torch.core.stair import plan_staircase
from pygim_tpu_torch.ops.core_dot import (
    core_bands_plain,
    core_bands_scatter_add,
    core_plans,
)
from pygim_tpu_torch.ops.ell_tail import (
    ell_tables_add,
    ell_tables_plain,
    tail_plan,
)
from pygim_tpu_torch.utils.timers import PhaseTimer

_log = logging.getLogger("pygim_tpu_torch")


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    """Runtime configuration: the reference's fields and defaults. This
    slice runs ``backend="hybrid"``, ``hybrid_shape="stair"``,
    ``hybrid_dtype="int8"``, ``hybrid_k=None`` with a positive core
    budget; :meth:`check_supported` raises on anything else."""

    format: str = "csr"              # csr | coo
    backend: str = "blocked"         # oracle | blocked | ell | coo | hybrid
    balance: str = "nnz"             # nnz | row
    n_blocks: Optional[int] = None
    block_nnz_budget: int = 1 << 17  # ~slots gathered per ELL step
    ell_degree: Optional[int] = None # pinned ELL degree (auto = None)
    ell_tables: int = 3              # max multi-degree ELL tables
    hidden_hint: int = 256           # expected dense width (ELL planner)
    hybrid_k: Optional[int] = None         # square core size
    hybrid_core_bytes: int = 4 << 30       # core memory budget
    hybrid_dtype: Optional[str] = None     # core cell dtype
    bcsr_bytes: int = 0
    bcsr_tile: int = 32
    bcsr_min_edges: int = 0
    bcsr_order: str = "rank"
    bcsr_layout: str = "row"
    hybrid_shape: str = "square"           # square | stair
    stair_max_bands: int = 8
    merge_duplicates: bool = True
    oracle_edge_chunk: Optional[int] = None

    def check_supported(self) -> None:
        want = {
            "backend": "hybrid", "hybrid_shape": "stair",
            "hybrid_dtype": "int8", "hybrid_k": None,
        }
        bad = {k: getattr(self, k) for k, v in want.items()
               if getattr(self, k) != v}
        if self.hybrid_core_bytes <= 0:
            bad["hybrid_core_bytes"] = self.hybrid_core_bytes
        if bad:
            raise NotImplementedError(
                f"pygim_tpu_torch runs only the stair-int8 hybrid so far "
                f"({want}, hybrid_core_bytes > 0); got {bad}"
            )


def ell_step_tables(cols2d, vals2d, vrow_to_row, chunk):
    """Repack (nvr_pad, D) ELL tables into the step layout the run path
    reads: ``(n_steps, chunk·D)`` slots and ``(n_steps, chunk)`` rows."""
    nvr, d = cols2d.shape
    n_steps = nvr // chunk
    return (
        np.ascontiguousarray(cols2d).reshape(n_steps, chunk * d),
        np.ascontiguousarray(vals2d).reshape(n_steps, chunk * d),
        np.ascontiguousarray(vrow_to_row).reshape(n_steps, chunk),
    )


def core_any_width(bands, xc, core_nodes, stair, out, plans=None):
    """K-core (:func:`core_bands_scatter_add`) at any width H: where H is
    not a multiple of 8 (K-core's rule, ``ops/core_dot.py``), ``xc`` and
    ``out`` go to it padded with zero columns, and the first H columns
    come back into ``out`` (in place; returned). ``plans`` are built for
    the padded width."""
    h = out.shape[1]
    pad = -h % 8
    if not pad:
        return core_bands_scatter_add(bands, xc, core_nodes, stair, out,
                                      plans=plans)
    wide = torch.nn.functional.pad(out, (0, pad))
    core_bands_scatter_add(bands, torch.nn.functional.pad(xc, (0, pad)),
                           core_nodes, stair, wide, plans=plans)
    return out.copy_(wide[:, :h])


def _ell_suffix(i: int) -> str:
    """Key suffix of ELL table ``i``: table 0 keeps the unsuffixed names."""
    return "" if i == 0 else f"_{i}"


def _ell_chunk(config, degree: int) -> int:
    """Virtual rows per step, so each step holds ~block_nnz_budget slots."""
    return max(8, round_up(max(1, config.block_nnz_budget // degree), 8))


def _plan_ell_tables(csr, config) -> "list[tuple[int, object]]":
    """Multi-degree ELL tables for ``csr``: ``[(chunk, EllRows)]``."""
    degrees = choose_degrees_for_config(csr.row_lengths, config)
    tables = build_ell_rows_multi(
        csr, degrees, hidden=config.hidden_hint,
        row_chunk_for=lambda D: _ell_chunk(config, D),
    )
    return [(_ell_chunk(config, t.degree), t) for t in tables]


def _finish_hybrid_tail(host, coo, config, tail_sel, pt):
    """Build the ELL tail tables for the non-core edges, in original node
    ids (only the core touches the rank order)."""
    n = coo.nrows
    pt.start("ell_tail")
    tail = CooGraph(
        rows=coo.rows[tail_sel], cols=coo.cols[tail_sel],
        vals=coo.vals[tail_sel], nrows=n, ncols=n,
    )
    tables = _plan_ell_tables(tail.to_csr(), config)
    host["n_ell"] = np.int64(len(tables))
    for i, (chunk, t) in enumerate(tables):
        sfx = _ell_suffix(i)
        host[f"degree{sfx}"] = np.int64(t.degree)
        host[f"chunk{sfx}"] = np.int64(chunk)
        host[f"cols2d{sfx}"] = t.cols
        host[f"vals2d{sfx}"] = t.vals
        host[f"vrow_to_row{sfx}"] = t.vrow_to_row
    pt.stop("ell_tail")


def _prepare_stair_build(coo, config, rank, order, pt) -> dict:
    """Staircase int8 core: ≤ ``stair_max_bands`` dense row bands of
    tapering width in degree-rank space (core/stair.py). Cells outside a
    band, and cells that are not an integer in [-128, 127], go to the
    exact ELL tail. Returns the host tables."""
    n = coo.nrows
    budget_cells = int(config.hybrid_core_bytes)  # int8: one byte a cell
    rr = rank[coo.rows].astype(np.int64)
    cc = rank[coo.cols].astype(np.int64)
    pt.start("stair_plan")
    bands = plan_staircase(
        rr, cc, n, budget_cells, max_bands=config.stair_max_bands,
        col_quant=256,
    )
    pt.stop("stair_plan")
    host: dict = {"core_dtype": np.str_("int8")}
    if config.bcsr_bytes > 0:
        _log.info("hybrid_shape='stair': bcsr_bytes ignored (bands subsume "
                  "the tile tier's coverage)")
    if not bands:
        host["k"] = np.int64(0)
        _finish_hybrid_tail(host, coo, config, np.ones(coo.nnz, bool), pt)
        return host
    his = np.array([b[1] for b in bands], dtype=np.int64)
    ws = np.array([b[2] for b in bands], dtype=np.int64)
    bi = np.searchsorted(his, rr, side="right")
    in_core = (bi < len(bands)) & (cc < ws[np.minimum(bi, len(bands) - 1)])
    rows_total = int(his[-1])
    host["k"] = np.int64(rows_total)
    host["stair_bands"] = np.asarray(bands, dtype=np.int64)
    host["core_nodes"] = order[: max(rows_total, int(ws.max()))]

    pt.start("core_fill")
    idx = np.flatnonzero(in_core)
    sidx = idx[np.argsort(rr[idx], kind="stable")]
    srr = rr[sidx]
    vals64 = coo.vals.astype(np.float64)
    demoted = []
    for b, (lo, hi, w) in enumerate(bands):
        rows_b = hi - lo
        store = np.empty((rows_b, w), dtype=np.int8)
        # ~256 MB of f32 cells per fill chunk
        chunk_rows = max(8, ((1 << 28) // max(1, w * 4)) // 8 * 8)
        for c0 in range(0, rows_b, chunk_rows):
            c1 = min(c0 + chunk_rows, rows_b)
            e0 = np.searchsorted(srr, lo + c0, side="left")
            e1 = np.searchsorted(srr, lo + c1, side="left")
            eidx = sidx[e0:e1]
            flat = (rr[eidx] - (lo + c0)) * w + cc[eidx]
            blk = np.bincount(
                flat, weights=vals64[eidx], minlength=(c1 - c0) * w,
            ).astype(np.float32).reshape(c1 - c0, w)
            rb = np.round(blk)
            bad = (rb > 127) | (rb < -128) | (rb != blk)
            if bad.any():
                dem = np.isin(flat, np.flatnonzero(bad.ravel()))
                demoted.append(eidx[dem])
                rb = np.where(bad, 0.0, rb)
            store[c0:c1] = rb.astype(np.int8)
        host[f"stair{b}"] = store
    if demoted:
        dem = np.concatenate(demoted)
        in_core[dem] = False
        _log.info("int8 stair core: %d edges not representable — demoted "
                  "to the ELL tail", dem.size)
    pt.stop("core_fill")
    _finish_hybrid_tail(host, coo, config, ~in_core, pt)
    return host


class PreparedSpmm:
    """Device-resident prepared sparse operand: ``mul(x) = A @ x``.

    ``dev_arrays`` holds the tables under the reference's key names
    (``cols2d{sfx}``, ``vals2d{sfx}``, ``vrow_to_row{sfx}``,
    ``stair{b}``, ``core_nodes``); ``ell_meta`` is ``[(chunk, degree)]``
    and ``stair`` is ``[(lo, hi, w)]``."""

    def __init__(self, graph, config: SpmmConfig, device="cuda"):
        config.check_supported()
        self.config = config
        self.device = torch.device(device)
        if config.merge_duplicates:
            graph, _ = merge_duplicate_edges(graph)
        coo = graph if isinstance(graph, CooGraph) else graph.to_coo()
        if coo.nrows != coo.ncols:
            raise ValueError("hybrid backend requires square adjacency")
        if not np.issubdtype(coo.vals.dtype, np.floating):
            coo = dataclasses.replace(coo, vals=coo.vals.astype(np.float32))
        elif coo.vals.dtype != np.float32:
            raise TypeError(
                f"edge values must be float32 or integer, got {coo.vals.dtype}"
            )
        self.nrows, self.ncols, self.nnz = coo.nrows, coo.ncols, coo.nnz
        host = self._prepare_hybrid_build(coo, config)
        self.hybrid_k_eff = int(host["k"])
        self._dev = {}
        self.ell_meta = []
        tail_host = []
        for i in range(int(host["n_ell"])):
            sfx = _ell_suffix(i)
            chunk = int(host[f"chunk{sfx}"])
            tabs = ell_step_tables(
                host[f"cols2d{sfx}"], host[f"vals2d{sfx}"],
                host[f"vrow_to_row{sfx}"], chunk,
            )
            for key, arr in zip(("cols2d", "vals2d", "vrow_to_row"), tabs):
                self._dev[key + sfx] = self._put(arr)
            self.ell_meta.append((chunk, int(host[f"degree{sfx}"])))
            tail_host.append(tabs[1:])
        # K-tail's plan of the device tables (the card only)
        self._tail_plan = None
        if self.device.type == "cuda":
            self._tail_plan = tail_plan(self.ell_tables(self._dev),
                                        host=tail_host)
        self.stair = None
        self._core_plans = {}  # H -> K-core plans of the device bands
        if "stair_bands" in host:
            self.stair = [tuple(int(v) for v in b) for b in host["stair_bands"]]
            for b in range(len(self.stair)):
                self._dev[f"stair{b}"] = self._put(host[f"stair{b}"])
            self._dev["core_nodes"] = self._put(host["core_nodes"])

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _prepare_hybrid_build(self, coo, config) -> dict:
        pt = self.prepare_timer = PhaseTimer()
        n = coo.nrows
        pt.start("rank")
        deg = np.bincount(coo.rows, minlength=n).astype(np.int64)
        deg += np.bincount(coo.cols, minlength=n)
        order = np.argsort(-deg).astype(np.int32)
        rank = np.empty(n, dtype=np.int32)
        rank[order] = np.arange(n, dtype=np.int32)
        pt.stop("rank")
        return _prepare_stair_build(coo, config, rank, order, pt)

    @property
    def dev_arrays(self) -> dict:
        return self._dev

    def mul(self, x):
        """``A @ x`` through the kernels (plain versions on CPU tensors).
        ``x``: (ncols, H) float32 on the operand's device."""
        return self.raw_mul(x, self._dev)

    def raw_mul(self, x, dev: dict):
        if dev is self._dev:
            return self._run(x, dev, self._core, self._tail)
        return self._run(x, dev, core_any_width, ell_tables_add)

    def ell_tables(self, dev: dict) -> list:
        """The ELL tables of ``dev`` as ``[(cols2d, vals2d, vrow_to_row,
        degree)]``."""
        tables = []
        for i, (_chunk, degree) in enumerate(self.ell_meta):
            sfx = _ell_suffix(i)
            tables.append((dev[f"cols2d{sfx}"], dev[f"vals2d{sfx}"],
                           dev[f"vrow_to_row{sfx}"], degree))
        return tables

    def _tail(self, x, tables, out):
        """K-tail over this operand's own tables, with the plan built
        once at prepare."""
        plan = self._tail_plan
        if plan is not None and out.device != plan.tabs.device:
            plan = None
        return ell_tables_add(x, tables, out, plan=plan)

    def _core(self, bands, xc, core_nodes, stair, out):
        """K-core over this operand's own bands at any width, with their
        plans built once per padded width on the card."""
        plans = None
        if out.is_cuda and out.device == bands[0].device:
            h = -(-out.shape[1] // 8) * 8
            if h not in self._core_plans:
                self._core_plans[h] = core_plans(bands, stair, h)
            plans = self._core_plans[h]
        return core_any_width(bands, xc, core_nodes, stair, out, plans=plans)

    def mul_plain(self, x):
        """The same product through the plain PyTorch versions on any
        device, at H unpadded — the yardstick the kernels are held
        against."""
        return self._run(x, self._dev, core_bands_plain, ell_tables_plain)

    def _run(self, x, dev, core_fn, tail_fn):
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        if x.dtype != torch.float32:
            raise TypeError(
                f"the hybrid product takes a float32 payload, got {x.dtype}; "
                "bf16 and integer-quantized payloads come with the K-int slice"
            )
        h = x.shape[1]
        out = torch.zeros((self.nrows, h), dtype=torch.float32,
                          device=x.device)
        tail_fn(x, self.ell_tables(dev), out)
        if self.stair:
            cn = dev["core_nodes"]
            xc = x.index_select(0, cn).to(torch.bfloat16)
            bands = [dev[f"stair{b}"] for b in range(len(self.stair))]
            core_fn(bands, xc, cn, self.stair, out)
        return out


class PreparedAggregate:
    """Callable aggregate ``v -> A·v`` bound to a prepared operand.
    ``quantized`` is the fused integer-aggregate hook the conv layers
    probe; it comes with the K-int slice and raises until then."""

    def __init__(self, prep, dev=None):
        self.prep = prep
        self.dev = prep.dev_arrays if dev is None else dev

    def __call__(self, v):
        return self.prep.raw_mul(v, self.dev)

    def quantized(self, v, agg_dtype: str):
        raise NotImplementedError(
            f"integer-quantized aggregation ({agg_dtype}) on the hybrid "
            "path comes with the K-int slice (int8 / wide-int band GEMMs)"
        )


def prepare_spmm(graph, config: Optional[SpmmConfig] = None, *,
                 device="cuda", **kw) -> PreparedSpmm:
    """Entry point: plan, fill and move ``graph`` to ``device``."""
    if config is None:
        config = SpmmConfig(**kw)
    elif kw:
        config = dataclasses.replace(config, **kw)
    return PreparedSpmm(graph, config, device=device)
