"""The halo layout: a row-partitioned SpMM over a 1-D ``nodes`` mesh with a
feature exchange, the port's copy of ``pygim_tpu/parallel/halo.py``.

The graph is split by rows over ``nd`` node shards: shard ``d`` owns the
contiguous node range ``[d · rpd, (d + 1) · rpd)`` (``rpd = ceil(n / nd)``;
trailing shards may own no rows), its rows of A, its rows ``x_loc`` of x
and its rows of the output. The neighbours' features it needs come over
one of three exchanges (``parallel/collectives.py``):

* ``all_gather``: every shard receives all of x (``n_pad`` rows).
* ``all_to_all``: shard ``d`` receives in slot ``p`` the rows of peer
  ``p`` its edges reference, each slot padded to the most any pair needs
  (``halo_k``).
* ``ring``: ``nd − 1`` shifts, shift ``s`` sending each shard's requested
  rows to shard ``(d + s) % nd``, each shift padded to its own most.

Per shard, in the reference's order of adds into one float32 ``(rpd,
H)`` output (an integer payload stays exact):

1. the local edges' ELL tables on ``x_loc`` (``all_gather``: every edge's
   tables on the gathered x), K-tail or K-tail-quant;
2. the halo edges' ELL tables on the received buffer, the same kernels;
3. with ``backend="hybrid"``, the row-sharded hub core: the shard's
   ``(kp, nd · kp)`` slab of its own hub rows × every hub column in
   gathered-buffer order, times the gathered hub features, added at its
   hubs' rows: K-core, K-int or K-f32 as the single-card operand's core
   dispatches (``ops/spmm.py:PreparedSpmm._core_add``);
4. with ``bcsr_bytes > 0``, the in-band BCSR tiles on ``x_loc``, K-bcsr's
   row kind.

A shard is a :class:`~pygim_tpu_torch.ops.spmm.PreparedSpmm` made from
its host tables (``PreparedSpmm.from_host``; ``all_to_all`` and ``ring``
hold a second one for the halo tables), on ``mesh.devices[d]``. Its core
keeps only the slab rows of the hubs it owns (the reference's pad rows
are zero and would scatter to row 0 twice; a shard without hubs has no
core), and a shard without tiles runs no tier: empty shards launch
nothing. The host tables are the reference's byte for byte, stacked over
the shards under its key names in ``host_arrays``. ``mul`` takes x in the
original node order and returns float32 ``(nrows, H)`` on the first
device, in the original order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pygim_tpu_torch.core.banded import f32_to_bf16_bits
from pygim_tpu_torch.core.bcsr import build_bcsr_tiles, tail_tile_order
from pygim_tpu_torch.core.graph import CsrGraph, merge_duplicate_edges
from pygim_tpu_torch.core.partition import (
    int_demote_slab,
    pack_nibbles,
    round_up,
    strip_csr,
)
from pygim_tpu_torch.ops.spmm import (
    PAYLOADS,
    PreparedSpmm,
    SpmmConfig,
    as_payload,
    check_transpose_graph,
    plan_shared_ell_tables,
    transpose_graph,
)
from pygim_tpu_torch.parallel.collectives import all_gather, all_to_all, ppermute
from pygim_tpu_torch.parallel.mesh import NodeMesh, visible_cards
from pygim_tpu_torch.parallel.spmm_2d import (
    MESH_CELL_BYTES,
    aligned,
    shard_bcsr_host,
    shard_ell_host,
    stack_bcsr,
)
from pygim_tpu_torch.utils.timers import device_time

EXCHANGES = ("all_gather", "all_to_all", "ring")


def make_node_mesh(n_devices: int, devices=None) -> NodeMesh:
    """The first ``n_devices`` of ``devices`` (default: the visible cards;
    repeats allowed, a virtual mesh) as a node line; fewer where there are
    fewer, as the reference's slice of ``jax.devices()``."""
    if devices is None:
        devices = visible_cards()
    devices = [torch.device(d) for d in devices][:n_devices]
    if not devices:
        raise ValueError("a node mesh needs at least one device")
    return NodeMesh(tuple(devices))


class PreparedSpmmHalo:
    """Prepare-once / run-many over a :class:`NodeMesh`: ``mul(x) = A @
    x`` with ``exchange`` one of :data:`EXCHANGES` and ``order`` None
    (contiguous ids), a permutation array (new position → original id),
    or ``"rcm"``, ``"lp"``, ``"metis"`` or ``"auto"`` (metis where its cut
    is below 0.95 of the contiguous one, else none: ``order_choice``).
    ``dev_arrays`` maps each shard ``d`` to its device tables (the dict
    :meth:`raw_mul` takes)."""

    supports_fused_quant = False

    def __init__(self, graph, mesh: NodeMesh,
                 config: Optional[SpmmConfig] = None,
                 exchange: str = "all_to_all", order=None):
        config = config or SpmmConfig()
        config.check_supported()
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        self._source_shape = (graph.nrows, graph.ncols, graph.nnz)
        self._transpose = None
        if config.merge_duplicates:
            graph, _ = merge_duplicate_edges(graph)
        self.mesh, self.config, self.exchange = mesh, config, exchange
        self.nd = nd = mesh.shape["nodes"]
        order = self._resolve_order(graph, order)
        self.order = order
        if order is not None:
            from pygim_tpu_torch.core.cluster import relabel

            graph = relabel(graph, order)
        csr = graph if isinstance(graph, CsrGraph) else graph.to_csr()
        if csr.nrows != csr.ncols:
            raise ValueError("halo mode requires a square adjacency")
        self.nrows, self.ncols = csr.nrows, csr.ncols
        self.n_pad = round_up(csr.nrows, nd)
        self.rows_per_dev = self.n_pad // nd
        self.host_arrays = {}
        self.nnz = csr.nnz
        self.hybrid_k_eff = 0
        self.core_dtype = None
        self.has_bcsr = False
        self.bcsr_edges = 0
        self._hub_rows = None
        self._tile_shards = set()
        if config.backend == "hybrid":
            csr = self._plan_core_halo(csr, config)
        parts, bounds = self._row_parts(csr)
        if config.backend == "hybrid" and config.bcsr_bytes > 0:
            self._plan_bcsr_halo(parts, bounds, config)
        if exchange == "all_gather":
            self._plan_all_gather(parts)
        else:
            self._plan_all_to_all(parts)
        if order is not None:
            inv = np.empty(self.nrows, dtype=np.int32)
            inv[np.asarray(order)] = np.arange(self.nrows, dtype=np.int32)
            self.host_arrays["order"] = np.asarray(order, dtype=np.int32)
            self.host_arrays["inv_order"] = inv
        self._install()

    # ------------------------------------------------------------ planning

    def _resolve_order(self, graph, order):
        """``order`` as a permutation array or None, the reference's
        choice (``pygim_tpu/parallel/halo.py:86-134``)."""
        self.order_choice = order if isinstance(order, str) else None
        if not isinstance(order, str):
            return order
        from pygim_tpu_torch.core import cluster

        if order == "auto":
            part = cluster.partition_kway(graph, self.nd)
            contig = (np.arange(graph.nrows, dtype=np.int64) * self.nd
                      // graph.nrows).astype(np.int32)
            if cluster.edge_cut_fraction(graph, part) < 0.95 * (
                    cluster.edge_cut_fraction(graph, contig)):
                self.order_choice = "metis"
                return np.argsort(part, kind="stable").astype(np.int64)
            self.order_choice = "none"
            return None
        if order == "metis":
            return cluster.partition_order(graph, self.nd)
        return cluster.locality_order(graph, method=order)

    def _row_parts(self, csr):
        """Each shard's rows as a CSR of ``rpd`` rows (global columns) and
        its ``(lo, hi)`` range (``:154-179``)."""
        rpd = self.rows_per_dev
        bounds = [(min(d * rpd, csr.nrows), min((d + 1) * rpd, csr.nrows))
                  for d in range(self.nd)]
        parts = []
        for lo, hi in bounds:
            e0, e1 = ((int(csr.rowptr[lo]), int(csr.rowptr[hi])) if hi > lo
                      else (0, 0))
            rowptr = csr.rowptr[lo:hi + 1] - csr.rowptr[lo]
            if rowptr.size == 0:
                rowptr = np.zeros(1, dtype=csr.rowptr.dtype)
            rowptr = np.concatenate([rowptr, np.full(
                rpd - (hi - lo), rowptr[-1], dtype=rowptr.dtype)])
            parts.append(CsrGraph(rowptr=rowptr.astype(np.int32),
                                  colind=csr.colind[e0:e1].copy(),
                                  vals=csr.vals[e0:e1].copy(),
                                  ncols=csr.ncols))
        return parts, bounds

    def _plan_core_halo(self, csr, config: SpmmConfig):
        """The row-sharded hub core (``:205-324``): shard d's slab holds its
        own hub rows (padded to ``kp``) × every hub column at
        ``owner · kp + slot``, the order of one all_gather of each shard's
        ``(kp, H)`` hub features. The budget-derived k shrinks by 256
        until the largest slab fits ``hybrid_core_bytes``; int8 and int4
        cells out of range go back to the tail. Returns the tail's CSR."""
        n, nd, rpd = csr.nrows, self.nd, self.rows_per_dev
        deg = np.diff(csr.rowptr).astype(np.int64)
        deg = deg + np.bincount(csr.colind, minlength=n)[:n]
        order = np.argsort(-deg).astype(np.int32)
        rank = np.empty(n, dtype=np.int32)
        rank[order] = np.arange(n, dtype=np.int32)
        core_dtype = config.hybrid_dtype or "float32"
        itemsize = MESH_CELL_BYTES.get(core_dtype, 4)
        if config.hybrid_k is not None:
            k = max(0, min(config.hybrid_k, n))
        else:
            k = int(np.sqrt(config.hybrid_core_bytes * nd / itemsize))
            k = min((k // 256) * 256, n)
            while k >= 256:
                owned = np.bincount(order[:k].astype(np.int64) // rpd,
                                    minlength=nd).max()
                kp_try = max(8, round_up(int(owned), 8))
                if kp_try * (nd * kp_try) * itemsize \
                        <= config.hybrid_core_bytes:
                    break
                k -= 256
            k = max(0, k)
        if k == 0:
            return csr
        hubs = order[:k].astype(np.int64)  # rank j -> node id
        owner = hubs // rpd
        counts = np.bincount(owner, minlength=nd)
        kp = max(8, round_up(int(counts.max()), 8))
        slot = np.empty(k, dtype=np.int64)
        own_hub = np.zeros((nd, kp), dtype=np.int32)
        for d in range(nd):
            sel = np.flatnonzero(owner == d)
            slot[sel] = np.arange(sel.size)
            own_hub[d, :sel.size] = hubs[sel] - d * rpd
        buffer_pos = owner * kp + slot  # hub rank -> gathered-buffer column
        rows_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.rowptr))
        rr = rank[rows_of]
        cc = rank[csr.colind]
        in_core = (rr < k) & (cc < k)
        row_owner = rows_of // rpd
        w = nd * kp
        np_core = {"bfloat16": np.uint16, "int8": np.int8,
                   "int4": np.uint8}.get(core_dtype, np.float32)
        slabs = np.zeros((nd, kp, w // 2 if core_dtype == "int4" else w),
                         dtype=np_core)
        for d in range(nd):
            sel = np.flatnonzero(in_core & (row_owner == d))
            slab = np.zeros((kp, w), dtype=np.float32)
            np.add.at(slab, (slot[rr[sel]], buffer_pos[cc[sel]]),
                      csr.vals[sel].astype(np.float32))
            if core_dtype in ("int8", "int4"):
                slab, bad_flat = int_demote_slab(slab, core_dtype)
                if bad_flat.size:
                    e_flat = slot[rr[sel]] * w + buffer_pos[cc[sel]]
                    in_core[sel[np.isin(e_flat, bad_flat)]] = False
            if core_dtype == "int4":
                slabs[d] = pack_nibbles(slab)
            elif core_dtype == "bfloat16":
                slabs[d] = f32_to_bf16_bits(slab)  # ml_dtypes' cast
            else:
                slabs[d] = slab.astype(np_core)
            del slab
        # gathered-buffer position -> global node (pad slots: node 0, whose
        # slab columns are zero)
        buf_nodes = np.zeros(nd * kp, dtype=np.int32)
        buf_nodes[buffer_pos] = hubs
        self.host_arrays.update(core_slab=slabs, core_own=own_hub,
                                core_buf_nodes=buf_nodes)
        self.hybrid_k_eff, self.core_dtype = k, core_dtype
        self._hub_rows = counts
        return strip_csr(csr, ~in_core, rows_of)

    def _plan_bcsr_halo(self, parts, bounds, config: SpmmConfig) -> None:
        """The in-band BCSR tiles (``:326-449``): each shard mines its edges
        with both ends in its own rows, ranked in the band (in-band
        degree, or RCM / label propagation), so a panel gathers only
        ``x_loc``. Captured edges leave the parts in place; the tables are
        padded to one shape (pad vblocks: zero tiles, the last row
        block)."""
        rpd = self.rows_per_dev
        core_dtype = config.hybrid_dtype or "float32"
        bdt = "bfloat16" if core_dtype in ("bfloat16", "int8") else "float32"
        tr = config.bcsr_tile
        bcs, captured = [], 0
        for d, p in enumerate(parts):
            lo, _hi = bounds[d]
            rows_of = np.repeat(np.arange(p.nrows, dtype=np.int64),
                                np.diff(p.rowptr))
            local = (p.colind >= lo) & (p.colind < lo + rpd)
            rr_n = rows_of[local]
            cc_n = p.colind[local].astype(np.int64) - lo
            if rr_n.size == 0:
                bcs.append(None)
                continue
            deg = (np.bincount(rr_n, minlength=rpd)
                   + np.bincount(cc_n, minlength=rpd))
            order = np.argsort(-deg).astype(np.int64)
            rank = np.empty(rpd, dtype=np.int64)
            rank[order] = np.arange(rpd)
            if config.bcsr_order in ("rcm", "lp"):
                order, rank = tail_tile_order(rr_n, cc_n, order, rank, 0, rpd,
                                              config.bcsr_order)
            bc, in_tile = build_bcsr_tiles(
                rank[rr_n], rank[cc_n], p.vals[local], order, n=rpd,
                tile_rows=tr, budget_bytes=config.bcsr_bytes,
                hidden=config.hidden_hint, dtype=bdt,
                min_edges=config.bcsr_min_edges)
            if bc is not None:
                strip = np.zeros(p.colind.shape[0], dtype=bool)
                strip[np.flatnonzero(local)[in_tile]] = True
                parts[d] = strip_csr(p, ~strip, rows_of)
                captured += bc.n_edges
            bcs.append(bc)
        if captured == 0:
            return
        tables, step = stack_bcsr(bcs, config, rpd - 1)
        self.host_arrays.update({f"bcsr_{k}": v for k, v in tables.items()})
        self._tile_shards = {d for d, bc in enumerate(bcs)
                             if bc is not None and bc.n_edges}
        self.has_bcsr = True
        self.bcsr_step = step
        self.bcsr_edges = captured
        self.bcsr_dtype = bdt

    def _ell_tables(self, parts, prefix: str = ""):
        """Shared-shape multi-degree ELL tables of ``parts``, prefixed into
        ``host_arrays``; returns their ``[(chunk, degree)]``. Pad virtual
        rows target the last local row with value 0."""
        stacked, meta = plan_shared_ell_tables(
            parts, self.config, vfill=max(self.rows_per_dev - 1, 0))
        self.ell_degree, self.row_chunk = meta[0][1], meta[0][0]
        self.host_arrays.update({f"{prefix}{k}": v for k, v in stacked.items()})
        return meta

    def _plan_all_gather(self, parts) -> None:
        self.halo_k = self.n_pad  # every shard receives all rows
        self.request_rows = (self.nd - 1) * self.rows_per_dev * self.nd
        self.ell_meta = self._ell_tables(parts)

    def _plan_all_to_all(self, parts) -> None:
        """The local / halo split and the send tables of ``all_to_all`` and
        ``ring`` (``:476-594``)."""
        nd, rpd = self.nd, self.rows_per_dev
        requests = []  # requests[d][peer]: unique global columns of peer's
        for d, p in enumerate(parts):
            owner = p.colind // rpd
            req = []
            for peer in range(nd):
                cols = np.unique(p.colind[owner == peer])
                req.append(cols if peer != d else cols[:0])
            requests.append(req)
        self.request_rows = sum(len(r) for req in requests for r in req)
        ring = self.exchange == "ring"
        if ring:
            ks = []
            for s in range(1, nd):
                k_s = max(len(requests[(d + s) % nd][d]) for d in range(nd))
                ks.append(max(8, round_up(k_s, 8)) if k_s else 8)
            self.ring_ks = ks
            offsets = np.concatenate(([0], np.cumsum(ks))).astype(np.int64)
            halo_rows = int(offsets[-1])
            self.halo_k = halo_rows
            for i, s in enumerate(range(1, nd)):
                tab = np.zeros((nd, ks[i]), dtype=np.int32)
                for d in range(nd):
                    want = requests[(d + s) % nd][d]
                    tab[d, :len(want)] = want - d * rpd
                self.host_arrays[f"send_idx_{i}"] = tab
        else:
            K = max((len(r) for req in requests for r in req), default=1)
            K = max(1, round_up(K, 8))
            self.halo_k = K
            halo_rows = nd * K
            send_idx = np.zeros((nd, nd, K), dtype=np.int32)
            for d in range(nd):
                for peer in range(nd):
                    want = requests[peer][d]
                    send_idx[d, peer, :len(want)] = want - d * rpd
        local_parts, halo_parts = [], []
        for d, p in enumerate(parts):
            owner = p.colind // rpd
            rows_of = np.repeat(np.arange(p.nrows, dtype=np.int64),
                                np.diff(p.rowptr))
            is_local = owner == d
            new_col = np.empty_like(p.colind)
            new_col[is_local] = p.colind[is_local] - d * rpd
            for peer in range(nd):
                if peer == d:
                    continue
                sel = owner == peer
                if not sel.any():
                    continue
                pos = np.searchsorted(requests[d][peer], p.colind[sel])
                base = offsets[(d - peer) % nd - 1] if ring else peer * K
                new_col[sel] = base + pos

            def rebuild(mask, ncols):
                counts = np.bincount(rows_of[mask], minlength=p.nrows)
                rowptr = np.zeros(p.nrows + 1, dtype=np.int32)
                np.cumsum(counts, out=rowptr[1:])
                return CsrGraph(rowptr=rowptr, colind=new_col[mask],
                                vals=p.vals[mask], ncols=ncols)

            local_parts.append(rebuild(is_local, rpd))
            halo_parts.append(rebuild(~is_local, halo_rows))
        self._local_meta = self._ell_tables(local_parts, prefix="local_")
        self._halo_meta = self._ell_tables(halo_parts, prefix="halo_")
        self.halo_rows = halo_rows
        if not ring:
            self.host_arrays["send_idx"] = send_idx

    # ------------------------------------------------------------- devices

    def _shard_config(self, hybrid: bool) -> SpmmConfig:
        return dataclasses.replace(self.config,
                                   backend="hybrid" if hybrid else "ell")

    def _install(self) -> None:
        """Each shard's operands and exchange tables onto its device."""
        h = self.host_arrays
        rpd, nd = self.rows_per_dev, self.nd
        ag = self.exchange == "all_gather"
        self._ops, self._dev = [], {}
        for d, dev in enumerate(self.mesh.devices):
            main = shard_ell_host(h, self.ell_meta if ag else self._local_meta,
                                  d, "" if ag else "local_")
            main["core_dtype"] = np.str_(self.core_dtype or "float32")
            if self.hybrid_k_eff and self._hub_rows[d]:
                r = int(self._hub_rows[d])
                main.update(k=np.int64(r), core=h["core_slab"][d, :r],
                            core_nodes=h["core_own"][d, :r])
            if d in self._tile_shards:
                main.update(shard_bcsr_host(self, d, "bcsr_"))
            local = PreparedSpmm.from_host(
                main, self._shard_config(bool(self.hybrid_k_eff)), rpd,
                self.n_pad if ag else rpd, device=dev)
            ops = {"local": local}
            tabs = {"local": local.dev_arrays}
            if not ag:
                halo = PreparedSpmm.from_host(
                    shard_ell_host(h, self._halo_meta, d, "halo_"),
                    self._shard_config(False), rpd, self.halo_rows,
                    device=dev)
                ops["halo"] = halo
                tabs["halo"] = halo.dev_arrays
                if self.exchange == "ring":
                    tabs["send"] = [torch.from_numpy(
                        h[f"send_idx_{i}"][d]).to(dev) for i in range(nd - 1)]
                else:
                    tabs["send"] = torch.from_numpy(
                        h["send_idx"][d].reshape(-1)).to(dev)
            if self.hybrid_k_eff:
                key = "core_buf_nodes" if ag else "core_own"
                tabs["hub"] = torch.from_numpy(
                    h[key] if ag else h[key][d]).to(dev)
            self._ops.append(ops)
            self._dev[d] = tabs
        if self.order is not None:
            first = self.out_device
            self._dev["order"] = torch.from_numpy(h["order"]).to(first)
            self._dev["inv_order"] = torch.from_numpy(h["inv_order"]).to(first)

    @property
    def dev_arrays(self) -> dict:
        return self._dev

    @property
    def device_bytes(self) -> int:
        """Bytes of the tables on all devices."""
        def size(t):
            if isinstance(t, torch.Tensor):
                return t.numel() * t.element_size()
            if isinstance(t, dict):
                return sum(size(v) for v in t.values())
            return sum(size(v) for v in t)
        return size(self._dev)

    @property
    def out_device(self) -> torch.device:
        return self.mesh.devices[0]

    def transpose(self, graph=None) -> "PreparedSpmmHalo":
        """``Aᵀ`` on the same node mesh, configuration and exchange, in the
        resolved node order of this operand (the ``auto`` choice is not
        made again on Aᵀ): ``graph``, the graph this operand was prepared
        from, transposed and prepared at the first call and kept. The
        backward of ``ops/spmm.py:SpmmFunction`` runs on it."""
        if self._transpose is None:
            check_transpose_graph(graph, self._source_shape)
            self._transpose = PreparedSpmmHalo(
                transpose_graph(graph), self.mesh, self.config,
                self.exchange, order=self.order)
        return self._transpose

    # ----------------------------------------------------------------- run

    def _x_loc(self, x, dev: dict) -> list:
        """x in cluster order, padded to ``n_pad`` rows, as each shard's
        ``(rpd, H)`` rows on its device."""
        if x.dim() != 2 or x.shape[0] != self.nrows:
            raise ValueError(f"x shape {tuple(x.shape)} != ({self.nrows}, H)")
        x = as_payload(x)
        if x.dtype not in PAYLOADS:
            raise TypeError(f"the halo product takes a float32, bfloat16, "
                            f"int8, int16, int32 or int64 payload, got "
                            f"{x.dtype}")
        if self.order is not None:
            x = x.index_select(0, dev["order"].to(x.device))
        if self.n_pad != self.nrows:
            x = torch.nn.functional.pad(x, (0, 0, 0, self.n_pad - self.nrows))
        rpd = self.rows_per_dev
        return [aligned(x[d * rpd:(d + 1) * rpd].to(dv))
                for d, dv in enumerate(self.mesh.devices)]

    def _received(self, x_loc, dev: dict) -> list:
        """Each shard's exchange buffer: all of x (``all_gather``), its
        ``(nd · halo_k, H)`` slots (``all_to_all``) or its ring blocks one
        after the other (``ring``; None where ``nd`` is 1)."""
        devices = self.mesh.devices
        if self.exchange == "all_gather":
            return all_gather(x_loc, devices)
        if self.exchange == "all_to_all":
            send = [x_loc[d].index_select(0, dev[d]["send"]).reshape(
                self.nd, self.halo_k, -1) for d in range(self.nd)]
            return [aligned(r) for r in all_to_all(send, devices)]
        if self.nd == 1:
            return [None]
        blocks = [[] for _ in range(self.nd)]
        for i in range(self.nd - 1):
            snd = [x_loc[j].index_select(0, dev[j]["send"][i])
                   for j in range(self.nd)]
            for d, r in enumerate(ppermute(snd, i + 1, devices)):
                blocks[d].append(r)
        return [aligned(torch.cat(b)) for b in blocks]

    def _hub_buffer(self, x_loc, received, dev: dict) -> list:
        """Each shard's gathered hub features in slab-column order, padded
        with zero rows to its stored band width: the all_gathered x's rows
        ``core_buf_nodes`` (``all_gather``), else one all_gather of every
        shard's ``x_loc[core_own]``."""
        if self.exchange == "all_gather":
            cache = {}
            out = []
            for d in range(self.nd):
                key = received[d].data_ptr()
                if key not in cache:
                    cache[key] = received[d].index_select(0, dev[d]["hub"])
                out.append(cache[key])
        else:
            hs = [x_loc[d].index_select(0, dev[d]["hub"])
                  for d in range(self.nd)]
            out = all_gather(hs, self.mesh.devices)
        padded = []
        for d, buf in enumerate(out):
            op = self._ops[d]["local"]
            if not op.stair:
                padded.append(None)
                continue
            w = op.stair[0][2]
            padded.append(torch.nn.functional.pad(
                buf, (0, 0, 0, w - buf.shape[0])) if w > buf.shape[0]
                else buf)
        return padded

    def _shards(self, x_loc, dev: dict, plain: bool = False,
                parts=("local", "halo", "core", "bcsr")) -> list:
        """Every shard's float32 ``(rpd, H)`` output, on its device, of the
        tiers in ``parts`` on ``x_loc`` (:meth:`_x_loc`), added in the
        reference's order. The exchange runs only where a tier of
        ``parts`` reads its buffer: the halo tables, or on ``all_gather``
        the local tables and the core."""
        core = bool(self.hybrid_k_eff) and "core" in parts
        received = None
        if self.exchange == "all_gather":
            if "local" in parts or core:
                received = self._received(x_loc, dev)
        elif "halo" in parts:
            received = self._received(x_loc, dev)
        hub = self._hub_buffer(x_loc, received, dev) if core else None
        outs = []
        for d in range(self.nd):
            ops, tabs = self._ops[d], dev[d]
            local = ops["local"]
            kernels = local._kernels(tabs["local"], plain)
            out = torch.zeros((self.rows_per_dev, x_loc[d].shape[1]),
                              dtype=torch.float32, device=x_loc[d].device)
            if "local" in parts:
                src = received[d] if self.exchange == "all_gather" else x_loc[d]
                kernels[0](src, local.ell_tables(tabs["local"]), out)
            if "halo" in parts and "halo" in ops and received[d] is not None:
                halo = ops["halo"]
                halo._kernels(tabs["halo"], plain)[0](
                    received[d], halo.ell_tables(tabs["halo"]), out)
            if hub is not None and hub[d] is not None:
                local._core_add(None, tabs["local"], out, kernels, xc=hub[d])
            if "bcsr" in parts and local.has_bcsr:
                kernels[4](x_loc[d], *local.bcsr_tables(tabs["local"]), out)
            outs.append(out)
        return outs

    def _gather(self, outs) -> torch.Tensor:
        """The shards' outputs on the first device in the original order,
        ``(nrows, H)``."""
        first = self.out_device
        out = torch.cat([o.to(first) for o in outs])[:self.nrows]
        if self.order is not None:
            out = out.index_select(0, self._dev["inv_order"])
        return out

    def raw_mul(self, x, dev: dict):
        """``A @ x`` on the shard tables ``dev`` (:attr:`dev_arrays`)."""
        return self._gather(self._shards(self._x_loc(x, dev), dev))

    def mul(self, x):
        """``A @ x``: x ``(nrows, H)`` float32, bfloat16, int8, int16, int32
        or int64 (taken as int32) in the original node order; float32
        ``(nrows, H)`` on the first device. Each shard's tiers are the
        single-card operand's kernels."""
        return self.raw_mul(x, self._dev)

    def mul_plain(self, x):
        """The same product with every shard through the plain versions."""
        return self._gather(self._shards(self._x_loc(x, self._dev),
                                         self._dev, plain=True))

    def phase_times(self, x, iters: int = 3) -> dict:
        """Device times in ms (``pygim_tpu/parallel/halo.py:846-950``):
        ``mul_time`` (the whole product). ``all_to_all`` and ``ring``:
        ``local_time`` (every shard's local ELL tables on its ``x_loc``
        alone: no exchange, no halo tables), with a core ``core_time`` (the
        hub gather, its all_gather and the slab product), with tiles
        ``bcsr_time`` (the tier alone), and ``exchange_time``, the rest of
        ``mul_time``: the exchange, the halo tables and x's split.
        ``all_gather``: ``exchange_time`` (the all_gather alone) and
        ``local_time``, the rest."""
        d = self._dev
        total = device_time(self.mul, x, iters=iters) * 1e3
        out = {"mul_time(ms)": total}
        x_loc = self._x_loc(x, d)
        if self.exchange == "all_gather":
            exch = device_time(lambda: all_gather(x_loc, self.mesh.devices),
                               iters=iters) * 1e3
            out["exchange_time(ms)"] = exch
            out["local_time(ms)"] = max(0.0, total - exch)
            return out

        def only(part):
            return device_time(lambda: self._shards(x_loc, d, parts=(part,)),
                               iters=iters) * 1e3

        local = only("local")
        out["local_time(ms)"] = local
        core = bcsr = 0.0
        if self.hybrid_k_eff:
            core = only("core")
            out["core_time(ms)"] = core
        if self.has_bcsr:
            bcsr = only("bcsr")
            out["bcsr_time(ms)"] = bcsr
        out["exchange_time(ms)"] = max(0.0, total - local - core - bcsr)
        return out


def prepare_spmm_halo(graph, mesh: NodeMesh,
                      config: Optional[SpmmConfig] = None,
                      exchange: str = "all_to_all",
                      order=None) -> PreparedSpmmHalo:
    """Entry point: ``order`` None (contiguous ids), a permutation array,
    or ``"rcm"`` / ``"lp"`` / ``"metis"`` / ``"auto"`` (``core/cluster.py``),
    by which the rows are clustered before they are sharded."""
    return PreparedSpmmHalo(graph, mesh, config, exchange, order=order)
