"""Prepare-once / run-many SpMM on one CUDA card.

Counterpart of ``pygim_tpu/ops/spmm.py`` for the backends it carries:

``hybrid``  an integer hub-core plus a multi-degree ELL tail (the
            headline path). The core is the square ``[0, k)²`` block of
            the degree ranks or a staircase of row bands of tapering
            width, of int8 cells or int4 cells nibble-packed two a byte.
            :func:`prepare_spmm` plans on the host in NumPy (duplicate
            merge, degree rank, the core's fill, ELL tail) and moves the
            tables to the device. The host tables of an operand on the
            card are cached on disk (``utils/cache.py``: the reference's
            key and contents under the port's own directory and file
            prefix).
``ell``     the whole merged graph in the same multi-degree ELL tables,
            no core: K-tail alone.
``blocked`` the reference's default: nnz-balanced row blocks padded to
            one static shape, each a gather, weight and sorted segment-sum
            in plain PyTorch ops, one block at a time.
``oracle``  the raw edges (no merge) sorted by row, through the COO
            oracle of ``ops/reference.py`` in plain PyTorch ops.

Edge values may be float32, float64 or integer. Float64 values are
merged and fill the core in float64, as the reference's; every ELL value
table reaches the device as float32 (K-tail's weights), where the
reference's ``jnp.asarray`` (x64 off) casts it.

The hybrid's :meth:`PreparedSpmm.mul` computes ``A @ x`` as

1. ``out = zeros(N, H)``;
2. K-tail over every ELL table into ``out``, one launch
   (``ops/ell_tail.py``);
3. the core over all bands into ``out`` at ``core_nodes[lo:hi]``, one
   launch (a square core is the one band ``(0, k, k)``, its rows
   ``core_nodes[:k]``): for a float32 x, ``xc = bf16(x[core_nodes])``
   through K-core
   (``ops/core_dot.py``; where H is not a multiple of 8, on ``xc`` and
   ``out`` padded with zero columns to the next multiple, cut back to H);
   for an int8, int16 or int32 x, ``xc = x[core_nodes[:max w]]`` through
   K-int (``ops/core_int.py``), the exact int32 product wrapped as the
   reference's, added as f32

— the order of the reference's hybrid run; ``ell`` runs step 2 alone.
:meth:`PreparedSpmm.mul_quantized`
is the fused quantize → aggregate → dequantize of the reference's
``raw_mul_quantized``. The host tables are the reference's bit for bit.
The ``coo`` backend, the bf16 and f32 cores, the BCSR tile tier and
bfloat16 and int64 payloads come in later slices; they raise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.core.banded import core_build_banded
from pygim_tpu_torch.core.graph import CooGraph, CsrGraph, merge_duplicate_edges
from pygim_tpu_torch.core.partition import (
    build_ell_blocks,
    build_ell_rows_multi,
    choose_degrees_for_config,
    int_demote_slab,
    make_row_block_plan,
    pack_nibbles,
    round_up,
    row_slot_table,
)
from pygim_tpu_torch.core.stair import plan_staircase
from pygim_tpu_torch.ops.core_dot import (
    core_bands_plain,
    core_bands_scatter_add,
    core_plans,
    width_rule,
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
from pygim_tpu_torch.ops.reference import (
    accum_dtype,
    spmm_coo_oracle,
    spmm_coo_oracle_chunked,
)
from pygim_tpu_torch.quant import _SCALE_EXP, dtype_name, quant_scale
from pygim_tpu_torch.utils.cache import LOAD_ERRORS, cache_dir, save_npz
from pygim_tpu_torch.utils.timers import PhaseTimer, device_time

_log = logging.getLogger("pygim_tpu_torch")

BACKENDS = ("hybrid", "ell", "blocked", "oracle")
CORE_DTYPES = ("int8", "int4")  # the hybrid core cells the port stores
CORE_SHAPES = ("square", "stair")


@dataclasses.dataclass(frozen=True)
class SpmmConfig:
    """Runtime configuration: the reference's fields and defaults. The
    port runs the backends of :data:`BACKENDS`; on ``hybrid``, a square
    or stair core (:data:`CORE_SHAPES`) of int8 or int4 cells
    (:data:`CORE_DTYPES`) at any budget (none at ``hybrid_core_bytes <=
    0``) or a pinned ``hybrid_k``. :meth:`check_supported` raises on
    anything else."""

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

    def resolve_n_blocks(self, nnz: int) -> int:
        """The blocked backend's block count: pinned, or one block per
        ``block_nnz_budget`` entries."""
        if self.n_blocks is not None:
            return self.n_blocks
        return max(1, -(-nnz // self.block_nnz_budget))

    @property
    def square_build(self) -> bool:
        """Whether a hybrid prepare builds the square core: the square
        shape, and as in the reference (``pygim_tpu/ops/spmm.py:1127``)
        the stair shape with a pinned ``hybrid_k`` or no core budget."""
        return (self.hybrid_shape == "square" or self.hybrid_k is not None
                or self.hybrid_core_bytes <= 0)

    def check_supported(self) -> None:
        if self.backend in ("ell", "oracle", "blocked"):
            return
        if self.backend not in ("hybrid", "coo"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend != "hybrid":
            raise NotImplementedError(
                f"backend {self.backend!r}: the port runs {BACKENDS} so far "
                "('coo' is not ported)"
            )
        if self.hybrid_shape not in CORE_SHAPES:
            # the reference builds a square core for any other shape; the
            # port does not guess
            raise NotImplementedError(
                f"hybrid_shape {self.hybrid_shape!r}: the port runs "
                f"{CORE_SHAPES}")
        if self.hybrid_dtype not in CORE_DTYPES:
            raise NotImplementedError(
                f"hybrid_dtype {self.hybrid_dtype!r}: the port's cores are "
                f"{CORE_DTYPES} (None means the graph's dtype, a float32, "
                "float64 or bfloat16 core; the bf16 and f32 cores are not "
                "ported)")
        if self.bcsr_bytes > 0 and self.square_build:
            raise NotImplementedError(
                "bcsr_bytes > 0 on a square core: the BCSR tile tier is not "
                "ported")


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


def _ell_host(host: dict, tables) -> None:
    """Planned tables ``[(chunk, EllRows)]`` into the host dict under the
    reference's keys."""
    host["n_ell"] = np.int64(len(tables))
    for i, (chunk, t) in enumerate(tables):
        sfx = _ell_suffix(i)
        host[f"degree{sfx}"] = np.int64(t.degree)
        host[f"chunk{sfx}"] = np.int64(chunk)
        host[f"cols2d{sfx}"] = t.cols
        host[f"vals2d{sfx}"] = t.vals
        host[f"vrow_to_row{sfx}"] = t.vrow_to_row


def _finish_hybrid_tail(host, coo, config, tail_sel, pt):
    """Build the ELL tail tables for the non-core edges, in original node
    ids (only the core touches the rank order)."""
    n = coo.nrows
    pt.start("ell_tail")
    tail = CooGraph(
        rows=coo.rows[tail_sel], cols=coo.cols[tail_sel],
        vals=coo.vals[tail_sel], nrows=n, ncols=n,
    )
    _ell_host(host, _plan_ell_tables(tail.to_csr(), config))
    pt.stop("ell_tail")


def _core_itemsize(core_dtype: str) -> float:
    """Stored bytes of one core cell: two int4 cells share a byte."""
    return 0.5 if core_dtype == "int4" else 1.0


def _prepare_stair_build(coo, config, rank, order, pt) -> dict:
    """Staircase core: ≤ ``stair_max_bands`` dense row bands of tapering
    width in degree-rank space (core/stair.py; widths a multiple of 256,
    512 for int4), int8 ``(rows, w)`` or nibble-packed int4 ``(rows, w //
    2)`` uint8. Cells outside a band, and cells that are not an integer in
    the dtype's range ([-128, 127], [-8, 7]), go to the exact ELL tail.
    Returns the host tables."""
    core_dtype = config.hybrid_dtype
    n = coo.nrows
    budget_cells = int(config.hybrid_core_bytes / _core_itemsize(core_dtype))
    rr = rank[coo.rows].astype(np.int64)
    cc = rank[coo.cols].astype(np.int64)
    pt.start("stair_plan")
    bands = plan_staircase(
        rr, cc, n, budget_cells, max_bands=config.stair_max_bands,
        col_quant=512 if core_dtype == "int4" else 256,
    )
    pt.stop("stair_plan")
    host: dict = {"core_dtype": np.str_(core_dtype)}
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
        store = np.empty((rows_b, w // 2) if core_dtype == "int4"
                         else (rows_b, w),
                         dtype=np.uint8 if core_dtype == "int4" else np.int8)
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
            rb, bad_flat = int_demote_slab(blk, core_dtype)
            if bad_flat.size:
                demoted.append(eidx[np.isin(flat, bad_flat)])
            store[c0:c1] = (pack_nibbles(rb) if core_dtype == "int4"
                            else rb.astype(np.int8))
        host[f"stair{b}"] = store
    if demoted:
        dem = np.concatenate(demoted)
        in_core[dem] = False
        _log.info("%s stair core: %d edges not representable — demoted to "
                  "the ELL tail", core_dtype, dem.size)
    pt.stop("core_fill")
    _finish_hybrid_tail(host, coo, config, ~in_core, pt)
    return host


def square_core_k(config, n: int) -> int:
    """The square core's size: a pinned ``hybrid_k`` (at most n), 0
    without a budget, else the most ranks whose ``k²`` cells fit the
    budget, a multiple of 256 (at least 256 or n); even for int4, whose
    bytes pair columns (``pygim_tpu/ops/spmm.py:1128-1140``)."""
    if config.hybrid_k is not None:
        k = max(0, min(config.hybrid_k, n))
    elif config.hybrid_core_bytes <= 0:
        k = 0
    else:
        k = int(np.sqrt(config.hybrid_core_bytes
                        / _core_itemsize(config.hybrid_dtype)))
        k = (k // 256) * 256
        k = min(max(k, min(256, n)), n)
    if config.hybrid_dtype == "int4":
        k -= k % 2
    return k


def _prepare_square_build(coo, config, rank, order, pt) -> dict:
    """Square core: the ``[0, k)²`` block of the degree ranks
    (:func:`square_core_k`), built band by band in its stored dtype
    (``core/banded.py``); cells that are not an integer in the dtype's
    range are zeroed and their edges demoted to the exact ELL tail, as
    every edge outside the block goes there. Returns the host tables."""
    core_dtype = config.hybrid_dtype
    k = square_core_k(config, coo.nrows)
    host: dict = {"k": np.int64(k), "core_dtype": np.str_(core_dtype)}
    pt.start("core_fill")
    if k == 0:
        in_core = np.zeros(coo.nnz, dtype=bool)
    else:
        core, tail_mask, bad_flat = core_build_banded(
            coo.rows, coo.cols, coo.vals.astype(np.float32), rank, k,
            core_dtype)
        in_core = ~tail_mask
        if bad_flat.size:
            idx = np.flatnonzero(in_core)
            flat = (rank[coo.rows[idx]].astype(np.int64) * k
                    + rank[coo.cols[idx]])
            demote = np.isin(flat, bad_flat)
            in_core[idx[demote]] = False
            _log.info("%s core: %d cells (%d edges) not representable — "
                      "demoted to the ELL tail", core_dtype, bad_flat.size,
                      int(demote.sum()))
        host["core"] = core
        host["core_nodes"] = order[:k]  # rank i ↔ node order[i]
    pt.stop("core_fill")
    _finish_hybrid_tail(host, coo, config, ~in_core, pt)
    return host


def blocked_spmm(colind, vals, rowloc, row_slot, x, rows_pad: int):
    """The blocked product (``pygim_tpu/ops/spmm.py:136-161``): for each
    row block b, gather ``x[colind[b]]``, weight it by ``vals[b]`` and sum
    it into the block's ``rows_pad`` rows at ``rowloc[b]``; then take each
    row's slot (``row_slot``). One block at a time, so no (nnz, H) buffer
    exists. Accumulates in ``accum_dtype`` of the two dtypes: float32 for
    a float payload or float weights, int32 (wrapping) for an integer
    one."""
    acc = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
    h = x.shape[1]
    if x.shape[0] == 0 or colind.shape[0] == 0:
        # a zero-column or zero-edge operand: the padding indices would
        # gather from an empty x; the product is exact zeros
        return torch.zeros((row_slot.shape[0], h), dtype=acc, device=x.device)
    out = torch.zeros((colind.shape[0] * rows_pad, h), dtype=acc,
                      device=x.device)
    for b in range(colind.shape[0]):
        g = x.index_select(0, colind[b]).to(acc) * vals[b].to(acc)[:, None]
        out[b * rows_pad:(b + 1) * rows_pad].index_add_(0, rowloc[b], g)
    return out.index_select(0, row_slot)


_CACHE_TAG = b"prep-v4-"  # the reference's layout version
# the port's own file prefix: a fault of the port can never feed the
# reference (``hybrid-<key>.npz``) a table, nor the reverse
CACHE_PREFIX = "hybrid-torch-"

# The devices whose hybrid operands read and write the prepare cache: the
# card's. An operand on the CPU (the plain versions, small test graphs)
# is built every time, so a test sees the same phases whatever ran first.
CACHED_DEVICES = ("cuda",)


def prepare_cache_key(coo, config) -> str:
    """The reference's prepare-cache key of ``coo`` under ``config``
    (``pygim_tpu/ops/spmm.py:880-907``): sha256 over the sizes, every
    ``nnz // 64``-th row, column and value, the value dtype, the layout
    version and the config fields; its first 16 hex digits."""
    h = hashlib.sha256()
    h.update(np.asarray([coo.nrows, coo.nnz]).tobytes())
    stride = max(1, coo.nnz // 64)
    h.update(coo.rows[::stride].tobytes())
    h.update(coo.cols[::stride].tobytes())
    h.update(np.ascontiguousarray(coo.vals[::stride]).tobytes())
    h.update(str(coo.vals.dtype).encode())
    h.update(_CACHE_TAG)
    h.update(
        f"{config.hybrid_k}-{config.hybrid_core_bytes}-"
        f"{config.hybrid_dtype}-{config.ell_degree}-"
        f"{config.ell_tables}-"
        f"{config.block_nnz_budget}-{config.bcsr_bytes}-"
        f"{config.bcsr_tile}-{config.bcsr_min_edges}-"
        f"{config.bcsr_order}-{config.bcsr_layout}-"
        f"{config.hidden_hint}".encode()
    )
    if config.hybrid_shape != "square":
        h.update(f"{config.hybrid_shape}-{config.stair_max_bands}".encode())
    return h.hexdigest()[:16]


def gather_only(x, cols2d):
    """The gather-only probe of :meth:`PreparedSpmm.phase_times`: each
    step's rows of x gathered and summed into one f32 (H,) vector, no
    weights and no scatter (the reference's scan body, 1687-1702)."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for c in cols2d:
        acc += x.index_select(0, c).float().sum(0)
    return acc


class PreparedSpmm:
    """Device-resident prepared sparse operand: ``mul(x) = A @ x``.

    ``dev_arrays`` holds the tables under the reference's key names: for
    ``hybrid`` and ``ell``, ``cols2d{sfx}``, ``vals2d{sfx}``,
    ``vrow_to_row{sfx}`` (``ell_meta`` is ``[(chunk, degree)]``), and for
    ``hybrid`` also ``core_nodes`` and the core, ``stair{b}`` per band of
    a staircase or ``core`` for a square (``stair`` is ``[(lo, hi, w)]``,
    a square's one band ``(0, k, w)``); for ``blocked``, ``colind``,
    ``vals``, ``rowloc``, ``row_slot``; for ``oracle``, ``rows``,
    ``cols``, ``vals``. Edge values
    reach the device as the reference's ``jnp.asarray`` puts them with
    x64 off: float64 as float32, int64 as int32; the ELL value tables are
    float32 always (K-tail's weights). The hybrid's ``prepare_timer``
    holds its host phases; its host tables go through the prepare cache
    on the devices of :data:`CACHED_DEVICES`."""

    def __init__(self, graph, config: SpmmConfig, device="cuda"):
        config.check_supported()
        self.config = config
        self.device = torch.device(device)
        backend = config.backend
        pt = PhaseTimer()
        if config.merge_duplicates and backend != "oracle":
            # the oracle stays raw: an independent reference must not
            # share the prepared path's transformations
            pt.start("merge")
            graph, _ = merge_duplicate_edges(graph)
            pt.stop("merge")
        coo = graph if isinstance(graph, CooGraph) else None
        csr = graph if isinstance(graph, CsrGraph) else None
        self.nrows, self.ncols, self.nnz = graph.nrows, graph.ncols, graph.nnz
        self._dev = {}
        self.ell_meta = []
        self.stair = None     # the core's stored bands [(lo, hi, w)] (a square: one)
        self._band_keys = []  # their tables in dev_arrays
        self._tail_plan = None
        self._core_plans = {}  # H -> K-core plans of the bands
        self._int_plans = {}   # (H, limbs) -> K-int plans of the same
        if backend == "oracle":
            s = (coo if coo is not None else csr.to_coo()).sort_by_row()
            self._dev = {"rows": self._put(s.rows), "cols": self._put(s.cols),
                         "vals": self._put(s.vals, vals=True)}
        elif backend == "blocked":
            csr = csr if csr is not None else coo.to_csr()
            plan = make_row_block_plan(
                csr, config.resolve_n_blocks(csr.nnz),
                balance=config.balance, row_align=8, nnz_align=8)
            ell = build_ell_blocks(csr, plan)
            self.plan, self.rows_pad = plan, plan.rows_pad
            self._dev = {"colind": self._put(ell.colind),
                         "vals": self._put(ell.vals, vals=True),
                         "rowloc": self._put(ell.rowloc),
                         "row_slot": self._put(row_slot_table(plan))}
        elif backend == "ell":
            host: dict = {}
            _ell_host(host, _plan_ell_tables(
                csr if csr is not None else coo.to_csr(), config))
            self._install_ell(host)
        else:
            coo = coo if coo is not None else csr.to_coo()
            if coo.nrows != coo.ncols:
                raise ValueError("hybrid backend requires square adjacency")
            if not np.issubdtype(coo.vals.dtype, np.floating):
                # integer weights ride the int8 core and an f32 tail, as
                # the reference casts them (pygim_tpu/ops/spmm.py:848)
                coo = dataclasses.replace(coo,
                                          vals=coo.vals.astype(np.float32))
            self.prepare_timer = pt
            host = self._prepare_hybrid(coo, config, pt)
            pt.start("upload")
            self._install_hybrid(host)
            pt.stop("upload")

    def _put(self, arr, vals: bool = False) -> torch.Tensor:
        """``arr`` (numpy) on the operand's device; edge values (``vals``)
        as the class docstring says."""
        arr = np.ascontiguousarray(arr)
        if vals and arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif vals and arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        return torch.from_numpy(arr).to(self.device)

    def _prepare_hybrid(self, coo, config, pt) -> dict:
        """The host tables: from the prepare cache where it holds them
        (phase ``cache_load``), else built and saved there (phase
        ``cache_save``); built alone off :data:`CACHED_DEVICES`."""
        if self.device.type not in CACHED_DEVICES:
            return self._prepare_hybrid_build(coo, config)
        key = prepare_cache_key(coo, config)
        path = cache_dir() / f"{CACHE_PREFIX}{key}.npz"
        if path.exists():
            pt.start("cache_load")
            try:
                with np.load(path) as z:
                    host = {k: z[k] for k in z.files}
            except LOAD_ERRORS as e:
                _log.warning("prepare cache %s unreadable (%s): rebuilding",
                             path, e)
                host = None
            pt.stop("cache_load")
            if host is not None:
                return host
        host = self._prepare_hybrid_build(coo, config)
        pt.start("cache_save")
        save_npz(path, host)
        pt.stop("cache_save")
        return host

    def _install_ell(self, host: dict) -> None:
        """The ELL tables of ``host`` to the device in step layout, their
        ``ell_meta`` and, on the card, K-tail's plan of them."""
        tail_host = []
        for i in range(int(host["n_ell"])):
            sfx = _ell_suffix(i)
            chunk = int(host[f"chunk{sfx}"])
            c, v, r = ell_step_tables(
                host[f"cols2d{sfx}"], host[f"vals2d{sfx}"],
                host[f"vrow_to_row{sfx}"], chunk,
            )
            self._dev["cols2d" + sfx] = self._put(c)
            self._dev["vals2d" + sfx] = self._put(np.asarray(v, np.float32))
            self._dev["vrow_to_row" + sfx] = self._put(r)
            self.ell_meta.append((chunk, int(host[f"degree{sfx}"])))
            tail_host.append((v, r))
        if self.device.type == "cuda":
            self._tail_plan = tail_plan(self.ell_tables(self._dev),
                                        host=tail_host)

    def _install_hybrid(self, host: dict) -> None:
        """The host tables to the device: the ELL tail, and the core's
        bands ``self.stair`` under ``self._band_keys`` — the stair's
        ``stair{b}``, or the square ``core`` as the one band ``(0, k, k)``.
        ``self.stair`` holds the stored widths, which the products run on:
        a band whose width misses the kernels' rule (int8 cells a multiple
        of 16, int4 of 32: a pinned ``hybrid_k``, or a stair band as wide
        as the graph) gets zero cells appended to each row here, on the
        host, and ``xc`` is zero-padded to match (:meth:`_xc`). The logical
        widths stay in the host tables (``stair_bands``, ``k``)."""
        self.hybrid_k_eff = int(host["k"])
        self.core_dtype = str(host["core_dtype"])
        self._install_ell(host)
        if "stair_bands" in host:
            bands = [tuple(int(v) for v in b) for b in host["stair_bands"]]
            self._band_keys = [f"stair{b}" for b in range(len(bands))]
        elif "core" in host:
            k = self.hybrid_k_eff
            bands, self._band_keys = [(0, k, k)], ["core"]
        else:
            return
        packed = self.core_dtype == "int4"
        q = width_rule(packed)
        self.stair = []
        for key, (lo, hi, w) in zip(self._band_keys, bands):
            band, wq = host[key], round_up(w, q)
            if wq != w:
                band = np.pad(band, ((0, 0), (0, (wq - w) // (1 + packed))))
            self.stair.append((lo, hi, wq))
            self._dev[key] = self._put(band)
        self._dev["core_nodes"] = self._put(host["core_nodes"])

    def _prepare_hybrid_build(self, coo, config) -> dict:
        pt = self.prepare_timer
        n = coo.nrows
        pt.start("rank")
        deg = np.bincount(coo.rows, minlength=n).astype(np.int64)
        deg += np.bincount(coo.cols, minlength=n)
        order = np.argsort(-deg).astype(np.int32)
        rank = np.empty(n, dtype=np.int32)
        rank[order] = np.arange(n, dtype=np.int32)
        pt.stop("rank")
        if config.square_build:
            return _prepare_square_build(coo, config, rank, order, pt)
        return _prepare_stair_build(coo, config, rank, order, pt)

    @property
    def dev_arrays(self) -> dict:
        return self._dev

    def mul(self, x):
        """``A @ x`` through the kernels (plain versions on CPU tensors).
        ``x``: (ncols, H) float32, int8, int16 or int32 on the operand's
        device; the result is float32 (N, H). An integer x is exact in
        the core (the reference's wrapped int32 product) and summed in
        f32 in the tail, as the reference's hybrid ``run``. The oracle
        takes any x and returns the accumulation dtype of ``ops/reference.py``."""
        return self.raw_mul(x, self._dev)

    def raw_mul(self, x, dev: dict):
        if self.config.backend == "oracle":
            return self._oracle(x, dev)
        if self.config.backend == "blocked":
            return self._blocked(x, dev)
        return self._run(x, dev)

    def _blocked(self, x, dev):
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        return blocked_spmm(dev["colind"], dev["vals"], dev["rowloc"],
                            dev["row_slot"], x, self.rows_pad)

    def _oracle(self, x, dev):
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        chunk = self.config.oracle_edge_chunk
        args = (dev["rows"], dev["cols"], dev["vals"], x, self.nrows)
        if chunk:
            return spmm_coo_oracle_chunked(*args, chunk)
        return spmm_coo_oracle(*args)

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
        if self.config.backend in ("oracle", "blocked"):
            return self.raw_mul(x, self._dev)  # plain PyTorch ops already
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

    def _check_x(self, x):
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        if x.dtype not in PAYLOADS:
            raise TypeError(
                f"the {self.config.backend} product takes a float32, int8, "
                f"int16 or int32 payload, got {x.dtype} (bfloat16 and int64 "
                "payloads are not ported)"
            )

    def _run(self, x, dev, plain=False, safe=None, limbs=None):
        """``A @ x`` into a fresh float32 (N, H). An integer x, or a
        float32 x with ``safe`` (rounded to ``round(x / safe)`` in the tail
        and the core), takes the integer core with ``limbs`` (default
        :data:`RAW_LIMBS` of x's dtype)."""
        self._check_x(x)
        tail_fn, core_fn, int_fn = self._kernels(dev, plain)
        out = torch.zeros((self.nrows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        if safe is None:
            tail_fn(x, self.ell_tables(dev), out)
        else:
            tail_fn(x, self.ell_tables(dev), out, safe=safe)
        if self.stair:
            self._core_add(x, dev, out, core_fn, int_fn, safe, limbs)
        return out

    def _xc(self, x, cn):
        """The rank gather ``x[core_nodes[:max w]]``, zero rows appended
        where a padded square core is wider than its k nodes."""
        w_max = max(w for *_, w in self.stair)
        xc = x.index_select(0, cn[:w_max])
        if xc.shape[0] < w_max:
            xc = torch.nn.functional.pad(xc, (0, 0, 0, w_max - xc.shape[0]))
        return xc

    def _core_add(self, x, dev, out, core_fn, int_fn, safe=None, limbs=None):
        """The core tier of :meth:`_run` into ``out``: the rank gather,
        then K-core (float32 x) or K-int (integer x, or ``safe``)."""
        cn = dev["core_nodes"]
        bands = [dev[k] for k in self._band_keys]
        if x.dtype == torch.float32 and safe is None:
            return core_fn(bands, self._xc(x, cn).to(torch.bfloat16), cn,
                           self.stair, out)
        xc = self._xc(x, cn)
        if safe is not None:
            xc = torch.round(xc / safe).to(torch.int32)
        return int_fn(bands, xc, cn, self.stair, out,
                      limbs=limbs or RAW_LIMBS[xc.dtype])

    @property
    def supports_fused_quant(self) -> bool:
        """True where :meth:`raw_mul_quantized` folds the quantization
        into the aggregate: the ell and hybrid backends."""
        return self.config.backend in ("ell", "hybrid")

    def raw_mul_quantized(self, x, dev: dict, agg_dtype, plain=False):
        """Fused quantize → A·x → dequantize, the reference's
        ``raw_mul_quantized``: ``scale = 2·max|x| / 2^k`` on the device,
        ``q = round(x / safe)`` (a true division, half to even), the exact
        integer core product (hybrid) and the f32-summed tail, then ``out *
        scale``. int8 and int16 round x once into an (N, H) table of that
        dtype, which every tier reads; int32 has no table (it would be as
        large as x) and rounds inside K-tail's gather (payload mode (iii))
        and on the core's gathered rows. ``x`` float32; returns float32.
        ``plain`` runs the plain versions."""
        if not self.supports_fused_quant:
            raise ValueError(f"fused quantization unsupported for backend "
                             f"{self.config.backend!r}")
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

    def phase_times(self, x, iters: int = 3) -> dict:
        """Device times in ms of the product's phases, each timed alone
        with CUDA events (``utils/timers.device_time``), the reference's
        ``phase_times`` (``pygim_tpu/ops/spmm.py:1666-1773``):

        * ``mul_time`` — :meth:`mul`;
        * ``gather_time`` — :func:`gather_only` over every ELL table's
          column steps (ell, hybrid);
        * ``tail_time`` — K-tail alone into a zero output (ell, hybrid);
        * ``core_time`` — the rank gather and K-core (K-int for an integer
          x) alone into a zero output (hybrid).

        The phases overlap the product's work; they are no sum of it."""
        d = self._dev
        out = {"mul_time(ms)": device_time(self.mul, x, iters=iters) * 1e3}
        if self.config.backend in ("oracle", "blocked"):
            return out
        self._check_x(x)
        tables = self.ell_tables(d)

        def zeros():
            return torch.zeros((self.nrows, x.shape[1]), dtype=torch.float32,
                               device=x.device)

        out["gather_time(ms)"] = sum(
            device_time(gather_only, x, c, iters=iters) * 1e3
            for c, *_ in tables)
        out["tail_time(ms)"] = device_time(
            lambda: self._tail(x, tables, zeros()), iters=iters) * 1e3
        if self.stair:
            out["core_time(ms)"] = device_time(
                lambda: self._core_add(x, d, zeros(), self._core,
                                       self._core_int),
                iters=iters) * 1e3
        return out


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
        (:meth:`PreparedSpmm.raw_mul_quantized`), or None where the
        backend does not fuse (the caller then quantizes around the plain
        aggregate)."""
        if not self.prep.supports_fused_quant:
            return None
        return self.prep.raw_mul_quantized(v, self.dev, agg_dtype)


def prepare_spmm(graph, config: Optional[SpmmConfig] = None, *,
                 device="cuda", **kw) -> PreparedSpmm:
    """Entry point: plan, fill and move ``graph`` to ``device``."""
    if config is None:
        config = SpmmConfig(**kw)
    elif kw:
        config = dataclasses.replace(config, **kw)
    return PreparedSpmm(graph, config, device=device)
