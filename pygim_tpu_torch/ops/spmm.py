"""Prepare-once / run-many SpMM on one CUDA card.

Counterpart of ``pygim_tpu/ops/spmm.py`` for the slice it carries: the
``hybrid`` backend with a staircase int8 core. :func:`prepare_spmm` plans
on the host (duplicate merge, degree rank, staircase bands, multi-degree
ELL tail), fills the int8 bands and the ELL tables, and moves them to the
device; :meth:`PreparedSpmm.mul` then computes ``A @ x`` as

1. ``out = zeros(N, H)``;
2. K-tail over every ELL table into ``out``, one launch
   (``ops/ell_tail.py``);
3. the core over all bands into ``out`` at ``core_nodes[lo:hi]``, one
   launch: for a float32 x, ``xc = bf16(x[core_nodes])`` through K-core
   (``ops/core_dot.py``; where H is not a multiple of 8, on ``xc`` and
   ``out`` padded with zero columns to the next multiple, cut back to H);
   for an int8, int16 or int32 x, ``xc = x[core_nodes[:max w]]`` through
   K-int (``ops/core_int.py``), the exact int32 product wrapped as the
   reference's, added as f32

— the order of the reference's hybrid run. :meth:`PreparedSpmm.mul_quantized`
is the fused quantize → aggregate → dequantize of the reference's
``raw_mul_quantized``. The host tables are the reference's bit for bit.
Other backends, core shapes and dtypes (the square, bf16 and int4
cores), bfloat16 and int64 payloads, and the prepare cache come in later
slices; they raise.
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
from pygim_tpu_torch.ops.core_int import (
    QUANT_LIMBS,
    RAW_LIMBS,
    core_int_plain,
    core_int_plans,
    core_int_scatter_add,
)
from pygim_tpu_torch.ops.ell_tail import (
    PAYLOADS,
    ell_tables_add,
    ell_tables_plain,
    tail_plan,
)
from pygim_tpu_torch.quant import _SCALE_EXP, dtype_name, quant_scale
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
        self._int_plans = {}   # (H, limbs) -> K-int plans of the same
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
        ``x``: (ncols, H) float32, int8, int16 or int32 on the operand's
        device; the result is float32 (N, H). An integer x is exact in
        the core (the reference's wrapped int32 product) and summed in
        f32 in the tail, as the reference's ``run``."""
        return self.raw_mul(x, self._dev)

    def raw_mul(self, x, dev: dict):
        return self._run(x, dev)

    def ell_tables(self, dev: dict) -> list:
        """The ELL tables of ``dev`` as ``[(cols2d, vals2d, vrow_to_row,
        degree)]``."""
        tables = []
        for i, (_chunk, degree) in enumerate(self.ell_meta):
            sfx = _ell_suffix(i)
            tables.append((dev[f"cols2d{sfx}"], dev[f"vals2d{sfx}"],
                           dev[f"vrow_to_row{sfx}"], degree))
        return tables

    def _tail(self, x, tables, out, **kw):
        """K-tail over this operand's own tables, with the plan built
        once at prepare (``kw``: ``safe`` for a rounded payload)."""
        plan = self._tail_plan
        if plan is not None and out.device != plan.tabs.device:
            plan = None
        return ell_tables_add(x, tables, out, plan=plan, **kw)

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

    def _core_int(self, bands, xc, core_nodes, stair, out, limbs):
        """K-int over this operand's own bands, with their plans built
        once per (H, limbs) on the card."""
        plans = None
        if out.is_cuda and out.device == bands[0].device:
            key = (out.shape[1], limbs)
            if key not in self._int_plans:
                self._int_plans[key] = core_int_plans(bands, stair, *key)
            plans = self._int_plans[key]
        return core_int_scatter_add(bands, xc, core_nodes, stair, out,
                                    limbs, plans=plans)

    def mul_plain(self, x):
        """The same product through the plain PyTorch versions on any
        device, at H unpadded — the yardstick the kernels are held
        against."""
        return self._run(x, self._dev, plain=True)

    def _kernels(self, dev: dict, plain: bool):
        """The (tail, float core, integer core) functions of a run: the
        plain versions; the kernels with the plans this operand keeps for
        its own tables; or the kernels planning a foreign ``dev`` each
        call."""
        if plain:
            return (ell_tables_plain, core_bands_plain,
                    lambda *a, limbs: core_int_plain(*a))
        if dev is self._dev:
            return self._tail, self._core, self._core_int
        return ell_tables_add, core_any_width, core_int_scatter_add

    def _run(self, x, dev, plain=False, safe=None, limbs=None):
        """``A @ x`` into a fresh float32 (N, H). An integer x, or a
        float32 x with ``safe`` (rounded to ``round(x / safe)`` in the tail
        and the core), takes the integer core with ``limbs`` (default
        :data:`RAW_LIMBS` of x's dtype)."""
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        if x.dtype not in PAYLOADS:
            raise TypeError(
                f"the hybrid product takes a float32, int8, int16 or int32 "
                f"payload, got {x.dtype} (bfloat16 and int64 payloads are "
                "not ported)"
            )
        tail_fn, core_fn, int_fn = self._kernels(dev, plain)
        h = x.shape[1]
        out = torch.zeros((self.nrows, h), dtype=torch.float32,
                          device=x.device)
        if safe is None:
            tail_fn(x, self.ell_tables(dev), out)
        else:
            tail_fn(x, self.ell_tables(dev), out, safe=safe)
        if self.stair:
            cn = dev["core_nodes"]
            bands = [dev[f"stair{b}"] for b in range(len(self.stair))]
            if x.dtype == torch.float32 and safe is None:
                xc = x.index_select(0, cn).to(torch.bfloat16)
                core_fn(bands, xc, cn, self.stair, out)
            else:
                xc = x.index_select(0, cn[:max(w for *_, w in self.stair)])
                if safe is not None:
                    xc = torch.round(xc / safe).to(torch.int32)
                int_fn(bands, xc, cn, self.stair, out,
                       limbs=limbs or RAW_LIMBS[xc.dtype])
        return out

    @property
    def supports_fused_quant(self) -> bool:
        """True: the hybrid backend folds the quantization into the
        aggregate (:meth:`raw_mul_quantized`)."""
        return True

    def raw_mul_quantized(self, x, dev: dict, agg_dtype, plain=False):
        """Fused quantize → A·x → dequantize, the reference's
        ``raw_mul_quantized``: ``scale = 2·max|x| / 2^k`` on the device,
        ``q = round(x / safe)`` (a true division, half to even), the exact
        integer core product and the f32-summed tail, then ``out * scale``.
        int8 and int16 round x once into an (N, H) table of that dtype,
        which both tiers read; int32 has no table (it would be as large as
        x) and rounds inside K-tail's gather (payload mode (iii)) and on
        the core's gathered rows. ``x`` float32; returns float32.
        ``plain`` runs the plain versions."""
        name = dtype_name(agg_dtype)
        if name not in _SCALE_EXP:
            raise NotImplementedError(
                f"fused quantization to {name!r}: int8, int16 and int32 are "
                "ported (int64 and the float passthrough are not)"
            )
        if x.dtype != torch.float32:
            raise TypeError(f"quantized aggregation takes a float32 x, got "
                            f"{x.dtype}")
        scale, safe = quant_scale(x, name)
        limbs = QUANT_LIMBS[name]
        if name == "int32":
            out = self._run(x, dev, plain, safe=safe, limbs=limbs)
        else:
            xq = torch.round(x / safe).to(getattr(torch, name))
            out = self._run(xq, dev, plain, limbs=limbs)
        return out * scale

    def mul_quantized(self, x, agg_dtype):
        """:meth:`raw_mul_quantized` on this operand's own tables."""
        return self.raw_mul_quantized(x, self._dev, agg_dtype)

    def mul_quantized_plain(self, x, agg_dtype):
        """:meth:`mul_quantized` through the plain versions."""
        return self.raw_mul_quantized(x, self._dev, agg_dtype, plain=True)


class PreparedAggregate:
    """Callable aggregate ``v -> A·v`` bound to a prepared operand, with
    ``quantized``, the fused integer-aggregate hook the conv layers probe
    (:func:`pygim_tpu_torch.nn.layers.quantized_aggregate`)."""

    def __init__(self, prep, dev=None):
        self.prep = prep
        self.dev = prep.dev_arrays if dev is None else dev

    def __call__(self, v):
        return self.prep.raw_mul(v, self.dev)

    def quantized(self, v, agg_dtype: str):
        """Fused quantize → aggregate → dequantize
        (:meth:`PreparedSpmm.raw_mul_quantized`)."""
        return self.prep.raw_mul_quantized(v, self.dev, agg_dtype)


def prepare_spmm(graph, config: Optional[SpmmConfig] = None, *,
                 device="cuda", **kw) -> PreparedSpmm:
    """Entry point: plan, fill and move ``graph`` to ``device``."""
    if config is None:
        config = SpmmConfig(**kw)
    elif kw:
        config = dataclasses.replace(config, **kw)
    return PreparedSpmm(graph, config, device=device)
