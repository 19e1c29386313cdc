"""The 2D ``sp × ds`` mesh SpMM, the port's copy of
``pygim_tpu/parallel/spmm_2d.py``.

The reference's 2D partition: A is split by columns over ``sp`` (the
rows of x follow), and x and the output by feature columns over ``ds``.
Shard ``(s, d)`` multiplies A's column part ``s`` by its ``(ncols_pad /
sp, h_pad / ds)`` block of x: the multi-degree ELL tail (K-tail or
K-tail-quant), on ``hybrid`` the column-sharded hub core (K-core, K-int
or K-f32, as the single-card operand's core dispatches) and, with
``bcsr_bytes > 0``, the BCSR tier (K-bcsr). The ``sp`` partials are then
summed (``parallel/collectives.py``): the whole ``(nrows, h_pad / ds)``
sum for each ``ds`` column, or with ``scatter_output`` each ``sp``
shard's row block of it.

A shard is a :class:`~pygim_tpu_torch.ops.spmm.PreparedSpmm` built from
its host tables (``PreparedSpmm.from_host``), uploaded once per distinct
device: a virtual mesh on one card (``cuda:0`` repeated) holds one copy
of each ``sp`` shard's tables, not ``sp · ds``. The product comes back
as one float32 ``(nrows, h)`` tensor on the grid's first device. The
host tables are the reference's byte for byte (``host_arrays``, under
its key names).

Training over the mesh: :meth:`PreparedSpmm2D.transpose` prepares Aᵀ
on the same mesh with the same configuration, and
``ops/spmm.py:SpmmFunction`` runs the backward ``Aᵀ g`` on it, every
shard through its kernels. The core is the reference's square
column-sharded slab (the 2D path builds no staircase).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.core.banded import f32_to_bf16_bits
from pygim_tpu_torch.core.bcsr import TILE_COLS, build_bcsr_tiles, tail_tile_order
from pygim_tpu_torch.core.graph import CsrGraph, merge_duplicate_edges
from pygim_tpu_torch.core.partition import (
    int_demote_slab,
    pack_nibbles,
    round_up,
    strip_csr,
)
from pygim_tpu_torch.ops.spmm import (
    PreparedSpmm,
    SpmmConfig,
    _ell_suffix,
    as_payload,
    check_transpose_graph,
    plan_shared_ell_tables,
    transpose_graph,
)
from pygim_tpu_torch.parallel.collectives import psum, psum_scatter
from pygim_tpu_torch.parallel.mesh import Mesh
from pygim_tpu_torch.utils.timers import device_time

# bytes of a core cell under the mesh budget rules (the reference's,
# spmm_2d.py:121-123 and halo.py:229-231); other cells are 4
MESH_CELL_BYTES = {"bfloat16": 2, "int8": 1, "int4": 0.5}


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (K-tail's bulk path)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def shard_ell_host(h: dict, meta, s: int, prefix: str = "") -> dict:
    """Shard ``s``'s ELL tables of the stacked ``h`` (keys
    ``{prefix}cols2d{sfx}``, ...) in the layout ``PreparedSpmm.from_host``
    takes, without a core."""
    host = {"n_ell": np.int64(len(meta)), "k": np.int64(0),
            "core_dtype": np.str_("float32")}
    for i, (chunk, degree) in enumerate(meta):
        sfx = _ell_suffix(i)
        host[f"degree{sfx}"] = np.int64(degree)
        host[f"chunk{sfx}"] = np.int64(chunk)
        for k in ("cols2d", "vals2d"):
            host[f"{k}{sfx}"] = h[f"{prefix}{k}{sfx}"][s].reshape(-1, degree)
        host[f"vrow_to_row{sfx}"] = h[f"{prefix}vrow_to_row{sfx}"][s].reshape(-1)
    return host


def stack_bcsr(bcs: list, config: SpmmConfig, row_fill: int,
               panel_base=None) -> tuple:
    """The shards' BCSR tiles (``bcs[s]``: a ``BcsrTiles`` or None) padded
    to one shape and stacked, the reference's layout
    (``pygim_tpu/parallel/spmm_2d.py:290-336``, ``halo.py:410-449``): pad
    vblocks hold zero tiles and point at the last row block, pad row nodes
    are ``row_fill``, shard ``s``'s panel nodes less ``panel_base[s]``.
    Returns ``({tiles, panel_idx, vblock_to_rb, panel_nodes, row_nodes},
    step)``."""
    tr, tc = config.bcsr_tile, TILE_COLS
    built = [bc for bc in bcs if bc is not None]
    s_max = max(bc.tiles_per_vblock for bc in built)
    step = max(1, (8 << 20) // max(1, s_max * tc * config.hidden_hint * 4))
    n_vb_max = max((bc.tiles.shape[0] for bc in built), default=1)
    step = min(step, n_vb_max)
    n_vb_pad = round_up(n_vb_max, step)
    np_max = max((bc.panel_nodes.shape[0] for bc in built), default=tc)
    nr_max = max((bc.row_nodes.shape[0] for bc in built), default=tr)
    n = len(bcs)
    tiles = np.zeros((n, n_vb_pad, s_max, tr, tc), dtype=built[0].tiles.dtype)
    pidx = np.zeros((n, n_vb_pad, s_max), dtype=np.int32)
    vb2rb = np.zeros((n, n_vb_pad), dtype=np.int32)
    pnodes = np.zeros((n, np_max), dtype=np.int32)
    rnodes = np.full((n, nr_max), row_fill, dtype=np.int32)
    for s, bc in enumerate(bcs):
        if bc is None:
            continue
        nv, sv = bc.tiles.shape[0], bc.tiles_per_vblock
        tiles[s, :nv, :sv] = bc.tiles
        pidx[s, :nv, :sv] = bc.panel_idx
        vb2rb[s] = bc.row_nodes.shape[0] // tr - 1  # pads: the last rb
        vb2rb[s, :nv] = bc.vblock_to_rb
        base = 0 if panel_base is None else panel_base[s]
        pnodes[s, : bc.panel_nodes.shape[0]] = bc.panel_nodes - base
        rnodes[s, : bc.row_nodes.shape[0]] = bc.row_nodes
    return dict(tiles=tiles, panel_idx=pidx, vblock_to_rb=vb2rb,
                panel_nodes=pnodes, row_nodes=rnodes), step


def shard_bcsr_host(op, s: int, prefix: str = "") -> dict:
    """Shard ``s``'s row-kind BCSR tables of ``op.host_arrays`` (keys
    ``{prefix}tiles``, ...; :func:`stack_bcsr`'s) in ``from_host``'s
    layout."""
    h = op.host_arrays
    return dict(
        bcsr_kind=np.str_("row"), bcsr_dtype=np.str_(op.bcsr_dtype),
        bcsr_step=np.int64(op.bcsr_step),
        bcsr_n_rb=np.int64(h[f"{prefix}row_nodes"].shape[1]
                           // op.config.bcsr_tile),
        bcsr_edges=np.int64(op.bcsr_edges),
        **{f"bcsr_{k}": h[f"{prefix}{k}"][s] for k in (
            "tiles", "panel_idx", "vblock_to_rb", "panel_nodes",
            "row_nodes")})


class PreparedSpmm2D:
    """Prepare-once / run-many over an ``(sp, ds)`` :class:`Mesh`:
    ``mul(x) = A @ x``. ``dev_arrays`` maps ``(s, device)`` to that
    shard's device tables (the dict :meth:`raw_mul` takes);
    ``host_arrays`` holds the stacked host tables under the reference's
    names (``cols2d{sfx}``, ``vals2d{sfx}``, ``vrow_to_row{sfx}``,
    ``core``, ``core_rows``, ``core_nodes``, ``tiles``, ``panel_idx``,
    ``vblock_to_rb``, ``panel_nodes``, ``row_nodes``)."""

    supports_fused_quant = False

    def __init__(self, graph, mesh: Mesh, config: Optional[SpmmConfig] = None,
                 *, scatter_output: bool = False):
        config = config or SpmmConfig()
        config.check_supported()
        # the graph as given, to check the one transpose() is handed
        self._source_shape = (graph.nrows, graph.ncols, graph.nnz)
        self._transpose = None
        if config.merge_duplicates:
            graph, _ = merge_duplicate_edges(graph)
        self.mesh = mesh
        self.config = config
        self.scatter_output = scatter_output
        self.sp, self.ds = mesh.shape["sp"], mesh.shape["ds"]
        sp = self.sp
        csr = graph if isinstance(graph, CsrGraph) else graph.to_csr()
        self.nrows, self.ncols, self.nnz = csr.nrows, csr.ncols, csr.nnz
        # x's rows shard equally over sp
        self.ncols_pad = round_up(csr.ncols, sp)
        parts = CsrGraph(rowptr=csr.rowptr, colind=csr.colind, vals=csr.vals,
                         ncols=self.ncols_pad).col_split(sp)
        self.host_arrays = {}
        self.hybrid_k_eff = 0
        self.has_bcsr = False
        self.bcsr_edges = 0
        self.core_dtype = None
        if config.backend == "hybrid":
            if csr.nrows != csr.ncols:
                raise ValueError("hybrid backend requires square adjacency")
            self._plan_core_2d(csr, parts, config)
            if config.bcsr_bytes > 0:
                self._plan_bcsr_2d(csr, parts, config)
        stacked, self.ell_meta = plan_shared_ell_tables(
            parts, config, vfill=max(self.nrows - 1, 0))
        self.host_arrays.update(stacked)
        # scatter mode pads the rows so each sp shard owns an equal block
        self.nrows_pad = round_up(self.nrows, sp) if scatter_output else self.nrows
        self._install()

    def _plan_core_2d(self, csr, parts, config: SpmmConfig) -> None:
        """The hub core sharded by columns over sp
        (``pygim_tpu/parallel/spmm_2d.py:110-206``): shard s holds the
        ``(k, k_col_pad)`` slab of the core columns whose nodes lie in its
        rows of x; the core's edges leave ``parts`` (in place)."""
        n, sp = csr.nrows, self.sp
        deg = np.diff(csr.rowptr).astype(np.int64)
        deg = deg + np.bincount(csr.colind, minlength=n)[:n]
        order = np.argsort(-deg).astype(np.int32)
        rank = np.empty(n, dtype=np.int32)
        rank[order] = np.arange(n, dtype=np.int32)
        core_dtype = config.hybrid_dtype or "float32"
        itemsize = MESH_CELL_BYTES.get(core_dtype, 4)
        if config.hybrid_k is not None:
            k = max(1, min(config.hybrid_k, n))
        else:
            # a shard holds ~k²/sp cells: the budget buys a √sp larger core
            k = int(np.sqrt(config.hybrid_core_bytes * sp / itemsize))
            k = min(max((k // 256) * 256, min(256, n)), n)
        self.hybrid_k_eff, self.core_dtype = k, core_dtype
        w = self.ncols_pad // sp
        owner = order[:k] // w  # the shard holding each ranked node's x row
        k_col_pad = max(8, int(np.bincount(owner, minlength=sp).max()))
        if core_dtype == "int4":
            k_col_pad += k_col_pad % 2  # a byte holds a column pair
        pos_in_shard = np.zeros(k, dtype=np.int64)
        sels = []
        for s in range(sp):
            sel = np.flatnonzero(owner == s)
            pos_in_shard[sel] = np.arange(sel.size)
            sels.append(sel)
        np_core = {"bfloat16": np.uint16, "int8": np.int8,
                   "int4": np.uint8}.get(core_dtype, np.float32)
        core_cols = k_col_pad // 2 if core_dtype == "int4" else k_col_pad
        cores = np.zeros((sp, k, core_cols), dtype=np_core)
        core_rows = np.zeros((sp, k_col_pad), dtype=np.int32)
        for s, p in enumerate(parts):
            lo = s * w
            rows_of = np.repeat(np.arange(p.nrows, dtype=np.int64),
                                np.diff(p.rowptr))
            rr = rank[rows_of]
            cc_global = p.colind.astype(np.int64) + lo
            cc = rank[np.minimum(cc_global, n - 1)]
            in_core = (rr < k) & (cc < k) & (cc_global < n)
            slab = np.zeros((k, k_col_pad), dtype=np.float32)
            np.add.at(slab, (rr[in_core], pos_in_shard[cc[in_core]]),
                      p.vals[in_core].astype(np.float32))
            if core_dtype in ("int8", "int4"):
                # cells outside the integer range go to the exact tail
                slab, bad_flat = int_demote_slab(slab, core_dtype)
                if bad_flat.size:
                    idx = np.flatnonzero(in_core)
                    e_flat = (rr[idx].astype(np.int64) * k_col_pad
                              + pos_in_shard[cc[idx]])
                    in_core[idx[np.isin(e_flat, bad_flat)]] = False
            if core_dtype == "int4":
                cores[s] = pack_nibbles(slab)
            elif core_dtype == "bfloat16":
                cores[s] = f32_to_bf16_bits(slab)  # ml_dtypes' cast
            else:
                cores[s] = slab.astype(np_core)
            del slab
            core_rows[s, : sels[s].size] = order[:k][sels[s]] - lo
            parts[s] = strip_csr(p, ~in_core, rows_of)
        self.host_arrays.update(core=cores, core_rows=core_rows,
                                core_nodes=order[:k])
        self._rank, self._order = rank, order

    def _plan_bcsr_2d(self, csr, parts, config: SpmmConfig) -> None:
        """The BCSR tier over the mesh
        (``pygim_tpu/parallel/spmm_2d.py:208-336``): row-major tiles whose
        rows keep the global tile rank and whose panels are ranked within
        each shard's own nodes, so a panel reads only that shard's rows of
        x; ``bcsr_bytes`` a shard. The captured edges leave ``parts``."""
        n, sp = csr.nrows, self.sp
        w = self.ncols_pad // sp
        k = self.hybrid_k_eff
        rank, order = self._rank, self._order
        core_dtype = config.hybrid_dtype or "float32"
        bdt = "bfloat16" if core_dtype in ("bfloat16", "int8") else "float32"
        part_edges = []
        for s, p in enumerate(parts):
            rows_of = np.repeat(np.arange(p.nrows, dtype=np.int64),
                                np.diff(p.rowptr))
            part_edges.append((rows_of, p.colind.astype(np.int64) + s * w,
                               p.vals))
        t_order, t_rank = order.astype(np.int64), rank
        if config.bcsr_order in ("rcm", "lp") and k < n:
            t_order, t_rank = tail_tile_order(
                np.concatenate([e[0] for e in part_edges]),
                np.concatenate([e[1] for e in part_edges]),
                t_order, rank, k, n, config.bcsr_order)
        tr = config.bcsr_tile
        bcs, captured = [], 0
        for s, p in enumerate(parts):
            rows_of, cols_g, vals = part_edges[s]
            lo, hi = s * w, min(n, s * w + w)
            n_s = max(1, hi - lo)
            loc_nodes = np.arange(lo, max(lo, hi), dtype=np.int64)
            loc_sorted = loc_nodes[np.argsort(t_rank[loc_nodes], kind="stable")]
            col_rank_of = np.zeros(n_s, dtype=np.int64)
            col_rank_of[loc_sorted - lo] = np.arange(loc_sorted.size)
            bc, in_tile = build_bcsr_tiles(
                t_rank[rows_of], col_rank_of[np.minimum(cols_g - lo, n_s - 1)],
                vals, t_order, n=n, tile_rows=tr,
                budget_bytes=config.bcsr_bytes, hidden=config.hidden_hint,
                dtype=bdt, min_edges=config.bcsr_min_edges,
                col_order=loc_sorted, n_cols=n_s)
            if bc is not None:
                parts[s] = strip_csr(p, ~in_tile, rows_of)
                captured += bc.n_edges
            bcs.append(bc)
        if captured == 0:
            return
        tables, step = stack_bcsr(bcs, config, n - 1,
                                  [s * w for s in range(sp)])
        self.host_arrays.update(tables)
        self.has_bcsr = True
        self.bcsr_step = step
        self.bcsr_edges = captured
        self.bcsr_dtype = bdt

    def _shard_host(self, s: int) -> dict:
        """Shard s's host tables in the layout ``PreparedSpmm.from_host``
        takes."""
        h = self.host_arrays
        host = shard_ell_host(h, self.ell_meta, s)
        host["core_dtype"] = np.str_(self.core_dtype or "float32")
        if self.hybrid_k_eff > 0:
            host.update(k=np.int64(self.hybrid_k_eff), core=h["core"][s],
                        core_rows=h["core_rows"][s],
                        core_nodes=h["core_nodes"])
        if self.has_bcsr:
            host.update(shard_bcsr_host(self, s))
        return host

    def _install(self) -> None:
        """Each sp shard's tables onto each distinct device of its row of
        the grid, once."""
        cfg = dataclasses.replace(
            self.config,
            backend="hybrid" if self.config.backend == "hybrid" else "ell")
        w = self.ncols_pad // self.sp
        self._shards = {}
        for s in range(self.sp):
            host = self._shard_host(s)
            for dev in dict.fromkeys(self.mesh.devices[s]):
                self._shards[s, dev] = PreparedSpmm.from_host(
                    host, cfg, self.nrows_pad, w, device=dev)
        self._dev = {key: op.dev_arrays for key, op in self._shards.items()}

    @property
    def dev_arrays(self) -> dict:
        return self._dev

    @property
    def device_bytes(self) -> int:
        """Bytes of the tables on all devices."""
        return sum(op.device_bytes for op in self._shards.values())

    @property
    def out_device(self) -> torch.device:
        return self.mesh.devices[0][0]

    def transpose(self, graph=None) -> "PreparedSpmm2D":
        """``Aᵀ`` on the same mesh, configuration and output mode:
        ``graph``, the graph this operand was prepared from, transposed
        and prepared at the first call and kept (later calls return it).
        The backward of ``ops/spmm.py:SpmmFunction`` runs on it."""
        if self._transpose is None:
            check_transpose_graph(graph, self._source_shape)
            self._transpose = PreparedSpmm2D(
                transpose_graph(graph), self.mesh, self.config,
                scatter_output=self.scatter_output)
        return self._transpose

    def _local(self, x, dev: dict, plain: bool = False) -> dict:
        """Every shard's partial product, ``{(s, d): (nrows_pad, h_pad /
        ds) f32}`` on its device."""
        if x.dim() != 2 or x.shape[0] != self.ncols:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.ncols}, H)")
        x = as_payload(x)
        h = x.shape[1]
        h_pad = round_up(h, self.ds)
        if self.ncols_pad != x.shape[0] or h_pad != h:
            x = torch.nn.functional.pad(
                x, (0, h_pad - h, 0, self.ncols_pad - x.shape[0]))
        w, hd = self.ncols_pad // self.sp, h_pad // self.ds
        parts = {}
        for s in range(self.sp):
            for d in range(self.ds):
                device = self.mesh.devices[s][d]
                op = self._shards[s, device]
                xl = aligned(x[s * w:(s + 1) * w, d * hd:(d + 1) * hd]
                              .to(device))
                parts[s, d] = op._run(xl, dev[s, device], plain=plain)
        return parts

    def _merge(self, parts: dict, h: int) -> torch.Tensor:
        """The sp merge of ``parts`` and the ds columns side by side, rows
        and columns cut back to ``(nrows, h)``, on :attr:`out_device`."""
        cols = []
        for d in range(self.ds):
            col = [parts[s, d] for s in range(self.sp)]
            if self.scatter_output:
                blocks = psum_scatter(
                    col, [self.mesh.devices[s][d] for s in range(self.sp)])
                out = torch.cat([b.to(self.out_device) for b in blocks])
            else:
                out = psum(col, self.out_device)
            cols.append(out)
        out = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
        return out[: self.nrows, :h]

    def raw_mul(self, x, dev: dict):
        """``A @ x`` on the shard tables ``dev`` (:attr:`dev_arrays`)."""
        return self._merge(self._local(x, dev), x.shape[1])

    def mul(self, x):
        """``A @ x``: x (ncols, H) float32, bfloat16, int8, int16, int32 or
        int64 (taken as int32); float32 (nrows, H) on the grid's first
        device. Each shard's tiers are the single-card operand's
        (``ops/spmm.py:PreparedSpmm.mul``)."""
        return self.raw_mul(x, self._dev)

    def mul_plain(self, x):
        """The same product with every shard through the plain versions."""
        return self._merge(self._local(x, self._dev, plain=True), x.shape[1])

    def phase_times(self, x, iters: int = 3) -> dict:
        """``mul_time`` (the whole product), ``local_time`` (every shard's
        partial, no merge) and ``psum_time``, their difference: the merge
        (``pygim_tpu/parallel/spmm_2d.py:476-490``), in ms."""
        total = device_time(self.mul, x, iters=iters) * 1e3
        local = device_time(lambda: list(self._local(x, self._dev).values()),
                            iters=iters) * 1e3
        return {"mul_time(ms)": total, "local_time(ms)": local,
                "psum_time(ms)": max(0.0, total - local)}


def prepare_spmm_2d(graph, mesh: Mesh, config: Optional[SpmmConfig] = None,
                    *, scatter_output: bool = False, **kw) -> PreparedSpmm2D:
    """Entry point: the 2D counterpart of ``prepare_spmm``."""
    if config is None:
        config = SpmmConfig(**kw)
    elif kw:
        config = dataclasses.replace(config, **kw)
    return PreparedSpmm2D(graph, mesh, config, scatter_output=scatter_output)
