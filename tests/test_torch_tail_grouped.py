"""K-tail's grouped form (every ELL table in one launch) on the CPU: the
host plan the kernel walks, a NumPy emulation of the kernel's unit order
and slot skipping against the plain version and the JAX reference, a
NumPy emulation of the bf16-row path (c) walk (8-column lanes, B slots in
flight, the flush from registers) on bf16 rows, the wrapper on CPU tensors, its checks and its path choice, and
the run path's width rule.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.

Tolerance: 1e-5 of each element's sum of |terms| (as in
test_torch_kernels_plain.py) — the emulation, the plain version and JAX
sum the same f32 products in different orders."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.core.graph import CooGraph
from pygim_tpu_torch.core.partition import build_ell_rows
from pygim_tpu_torch.ops import core_dot, ell_tail
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.ops.spmm import ell_step_tables

from test_torch_prepare import GRAPHS, KW, N, make_graph

REL = 1e-5


def ragged_graph(n: int, seed: int, hub_edges: int = 900):
    """(rows, cols, vals) with ragged rows, a hub row, the last row real
    and zero-valued edges, some in the middle of a row, some at its end."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(1.7, n).clip(1, 70)
    deg[7] = hub_edges
    deg[n - 1] = 5
    rows = np.repeat(np.arange(n), deg).astype(np.int32)
    cols = rng.integers(1, n, rows.size).astype(np.int32)  # col 0 unused
    vals = rng.standard_normal(rows.size).astype(np.float32)
    vals[rng.random(rows.size) < 0.08] = 0.0
    return rows, cols, vals


def tables_of(rows, cols, vals, n, budget=1024):
    """Multi-degree step tables through the port's planner."""
    csr = CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n).to_csr()
    cfg = tspmm.SpmmConfig(block_nnz_budget=budget)
    return [(*ell_step_tables(t.cols, t.vals, t.vrow_to_row, chunk), t.degree)
            for chunk, t in tspmm._plan_ell_tables(csr, cfg)]


def one_table(degree, chunk, n=300, seed=0):
    rows, cols, vals = ragged_graph(n, seed)
    csr = CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n).to_csr()
    t = build_ell_rows(csr, degree, row_chunk=chunk)
    return [(*ell_step_tables(t.cols, t.vals, t.vrow_to_row, chunk), degree)]


def plan_of(tables):
    vrows = [r.reshape(-1) for _c, _v, r, _d in tables]
    counts = [ell_tail.slot_counts(v, d) for _c, v, _r, d in tables]
    degrees = [d for *_t, d in tables]
    units, n_real = ell_tail.plan_units(vrows, counts, degrees)
    return units, n_real, counts


def emulate(x, tables, units, counts, out):
    """The kernel's arithmetic in NumPy: units in plan order; in each, the
    counted slots of its virtual rows as one stream, a row's sum added
    into ``out`` when the row ends."""
    for t, v0, n, _atomic in units:
        cols, vals, vrow, d = tables[t]
        cols, vals = cols.reshape(-1, d), vals.reshape(-1, d)
        vrow = vrow.reshape(-1)
        cur, acc = -1, None
        for v in range(v0, v0 + n):
            for s in range(counts[t][v]):
                if vrow[v] != cur:
                    if cur >= 0:
                        out[cur] += acc
                    cur, acc = vrow[v], np.zeros(x.shape[1], np.float32)
                acc += vals[v, s] * x[cols[v, s]]
        if cur >= 0:
            out[cur] += acc
    return out


def plain_np(x, tables, out):
    t = [tuple(torch.from_numpy(a) for a in tb[:3]) + (tb[3],) for tb in tables]
    return ell_tail.ell_tables_plain(torch.from_numpy(x), t,
                                     torch.from_numpy(out)).numpy()


def mag_np(x, tables, n):
    mag = np.zeros((n, x.shape[1]))
    for c, v, r, d in tables:
        np.add.at(mag, r.ravel(), (np.abs(v.reshape(-1, d, 1).astype(np.float64))
                                   * np.abs(x[c.reshape(-1, d)])).sum(1))
    return mag


# --- the plan ------------------------------------------------------------


@pytest.mark.parametrize("degree,chunk", [(2, 64), (6, 40), (32, 8),
                                          (64, 16), (512, 4)])
def test_plan_covers_every_real_virtual_row_once(degree, chunk):
    tables = one_table(degree, chunk, seed=degree)
    units, n_real, counts = plan_of(tables)
    vrow = tables[0][2].reshape(-1)
    covered = np.zeros(vrow.size, int)
    for t, v0, n, _a in units:
        assert t == 0 and 1 <= n <= ell_tail.unit_rows(degree)
        covered[v0:v0 + n] += 1
    assert np.all(covered[:n_real[0]] == 1)
    assert not covered[n_real[0]:].any()  # no pad row
    # what is left out is the planner's padding: val 0, row N - 1
    assert not tables[0][1].reshape(-1, degree)[n_real[0]:].any()
    assert np.all(vrow[n_real[0]:] == 299)
    assert counts[0][n_real[0] - 1] > 0


def test_slot_counts_keep_inner_zero_weights():
    vals = np.array([[1, 0, 2, 0],    # zero inside: kept; trailing: not
                     [0, 0, 0, 3],
                     [0, 0, 0, 0],
                     [5, 0, 0, 0],
                     [1, 2, 3, 4]], np.float32)
    np.testing.assert_array_equal(ell_tail.slot_counts(vals, 4),
                                  [3, 4, 0, 1, 4])
    # step layout: the same rows flattened two a step
    np.testing.assert_array_equal(
        ell_tail.slot_counts(vals[:4].reshape(2, 8), 4), [3, 4, 0, 1])


@pytest.mark.parametrize("degree,chunk", [(2, 64), (6, 40), (32, 8),
                                          (64, 16)])
def test_plan_splits_only_hub_runs(degree, chunk):
    tables = one_table(degree, chunk, seed=degree + 1)
    units, n_real, _ = plan_of(tables)
    vrow = tables[0][2].reshape(-1)[:n_real[0]]
    cap = ell_tail.unit_rows(degree)
    starts = np.flatnonzero(np.r_[True, vrow[1:] != vrow[:-1]])
    run_len = dict(zip(vrow[starts].tolist(),
                       np.diff(np.r_[starts, vrow.size]).tolist()))
    for _t, v0, n, atomic in units:
        rows = set(vrow[v0:v0 + n].tolist())
        if atomic:  # a piece of one run longer than a unit
            assert len(rows) == 1 and run_len[rows.pop()] > cap
        else:       # whole runs only
            assert all(run_len[r] <= cap for r in rows)
            assert v0 == 0 or vrow[v0 - 1] != vrow[v0]
            assert v0 + n == vrow.size or vrow[v0 + n] != vrow[v0 + n - 1]
    split = {int(vrow[v0]) for _t, v0, _n, a in units if a}
    assert split == {r for r, n in run_len.items() if n > cap}
    if degree <= 64:
        assert 7 in split  # the hub row


def test_plan_orders_units_by_slots_and_marks_shared_rows():
    tables = one_table(6, 40, seed=3) + one_table(6, 40, seed=3)
    units, _n_real, counts = plan_of(tables)
    slots = [counts[t][v0:v0 + n].sum() for t, v0, n, _a in units]
    assert np.all(np.diff(slots) <= 0)
    # two tables over the same rows: every unit adds atomically
    assert np.all(units[:, 3] == 1)
    with pytest.raises(ValueError, match="non-decreasing"):
        ell_tail.plan_units([np.array([3, 2], np.int32)],
                            [np.array([1, 1], np.int32)], [2])


@pytest.mark.parametrize("degree,chunk", [(6, 64), (2, 128), (32, 16)])
def test_plan_keeps_real_last_row_before_pads(degree, chunk):
    n = 300
    tables = one_table(degree, chunk, n=n, seed=11)
    units, n_real, counts = plan_of(tables)
    vrow = tables[0][2].reshape(-1)
    # the last real virtual row is row N - 1's, and pad rows (also aimed
    # at row N - 1) follow it
    assert vrow[n_real[0] - 1] == n - 1 and n_real[0] < vrow.size
    last = [(v0, k) for _t, v0, k, _a in units if v0 + k == n_real[0]]
    assert len(last) == 1
    x = np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32)
    got = emulate(x, tables, units, counts, np.zeros((n, 8), np.float32))
    want = plain_np(x, tables, np.zeros((n, 8), np.float32))
    mag = mag_np(x, tables, n)
    assert np.abs(got[n - 1]).sum() > 0
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


# --- the emulated kernel against the plain version and JAX --------------


@pytest.mark.parametrize("degree,chunk,h", [(2, 64, 16), (6, 40, 32),
                                            (32, 8, 24), (4, 1024, 8),
                                            (64, 16, 12)])
def test_emulation_matches_plain_and_ell_scan_spmm(degree, chunk, h):
    n = 300
    tables = one_table(degree, chunk, n=n, seed=degree + 7)
    units, _n_real, counts = plan_of(tables)
    x = np.random.default_rng(h).standard_normal((n, h)).astype(np.float32)
    out0 = np.random.default_rng(1).standard_normal((n, h)).astype(np.float32)
    got = emulate(x, tables, units, counts, out0.copy())
    plain = plain_np(x, tables, out0.copy())
    c3, v3, r3, _d = tables[0]
    want = out0 + np.asarray(jspmm.ell_scan_spmm(
        jnp.asarray(x), jnp.asarray(c3), jnp.asarray(v3), jnp.asarray(r3),
        chunk, degree, n))
    mag = mag_np(x, tables, n) + np.abs(out0)
    assert np.all(np.abs(got - plain) <= REL * mag + 1e-30)
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("kind", GRAPHS)
def test_emulation_matches_jax_on_multi_table_prepares(kind):
    rows, cols, vals = make_graph(kind)
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    assert len(tp.ell_meta) > 1
    tables = [(c.numpy(), v.numpy(), r.numpy(), d)
              for c, v, r, d in tp.ell_tables(tp.dev_arrays)]
    units, _n_real, counts = plan_of(tables)
    h = 16
    x = np.random.default_rng(5).standard_normal((N, h)).astype(np.float32)
    got = emulate(x, tables, units, counts, np.zeros((N, h), np.float32))
    want = np.zeros((N, h), np.float32)
    for (chunk, degree), (c3, v3, r3, _d) in zip(tp.ell_meta, tables):
        want += np.asarray(jspmm.ell_scan_spmm(
            jnp.asarray(x), jnp.asarray(c3), jnp.asarray(v3),
            jnp.asarray(r3), chunk, degree, N))
    mag = mag_np(x, tables, N)
    assert mag.any()
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


def test_emulation_reads_no_pad_slot():
    """The documented difference: a NaN x row that only pad slots reach
    (col 0, no real edge reads it) spreads NaN in the plain version, not
    in the kernel's order of work."""
    n = 300
    rows, cols, vals = ragged_graph(n, seed=2)
    tables = tables_of(rows, cols, vals, n)
    units, _n_real, counts = plan_of(tables)
    x = np.random.default_rng(3).standard_normal((n, 4)).astype(np.float32)
    x[0] = np.nan
    got = emulate(x, tables, units, counts, np.zeros((n, 4), np.float32))
    plain = plain_np(x, tables, np.zeros((n, 4), np.float32))
    assert np.isfinite(got).all()
    assert np.isnan(plain[n - 1]).all()  # the pad rows' target
    x[0] = 0.0
    want = plain_np(x, tables, np.zeros((n, 4), np.float32))
    assert np.all(np.abs(got - want) <= REL * mag_np(x, tables, n) + 1e-30)


# --- path (c): the bf16-row walk -----------------------------------------


def bf16_bits(x):
    """float32 ``x`` rounded to bf16 (RNE, as ``torch``), as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def widen8(words):
    """``csrc/ell_tail.cu:widen8`` on a lane's four 32-bit words: element
    2i is the low half of word i, each widened by a shift."""
    lo = (words << np.uint32(16)).view(np.float32)
    hi = (words & np.uint32(0xFFFF0000)).view(np.float32)
    return np.stack([lo, hi], -1).reshape(*words.shape[:-1], 8)


LANE_BATCH = 8  # csrc/ell_tail.cu: slots whose x rows a batch issues


def emulate_lanes(xbits, tables, units, counts, out):
    """``csrc/ell_tail.cu:tail_lanes_kernel`` in NumPy, as the source
    indexes it: per unit, its counted slots as one stream in chunks of 32
    (a slot ends its row where the next slot's row differs, the next
    chunk's first slot read for the last lane), each chunk in batches of
    ``LANE_BATCH`` slots whose x rows are loaded before any is applied;
    every lane of every 256-column slab loads its 8 columns as four 32-bit
    words of bf16 pairs (lanes past H load nothing); at a row's last slot
    the lanes' sums are added into the output row and zeroed."""
    n, h = xbits.shape
    assert h % 8 == 0
    words = np.ascontiguousarray(xbits).view(np.uint32).reshape(n, h // 2)
    slabs = -(-h // 256)
    for t, v0, nv, _atomic in units:
        cols, vals, vrow, d = tables[t]
        cols, vals = cols.reshape(-1, d), vals.reshape(-1, d)
        vrow = vrow.reshape(-1)
        stream = [(cols[v, s], vals[v, s], vrow[v])
                  for v in range(v0, v0 + nv) for s in range(counts[t][v])]
        T = len(stream)
        for sy in range(slabs):
            lanes = sy * 256 + 8 * np.arange(32)
            live = lanes < h
            c = lanes[live]  # first column of each live lane
            wsel = (c // 2)[:, None] + np.arange(4)  # its four words
            acc = np.zeros((live.sum(), 8), np.float32)
            for c0 in range(0, T, 32):
                m = min(32, T - c0)
                ends = [q == T - 1 or stream[q + 1][2] != stream[q][2]
                        for q in range(c0, c0 + m)]
                for b in range(0, m, LANE_BATCH):
                    ks = range(b, min(b + LANE_BATCH, m))
                    xv = {k: widen8(words[stream[c0 + k][0]][wsel])
                          for k in ks}
                    for k in ks:
                        col_, wgt, row = stream[c0 + k]
                        acc = (acc + np.float32(wgt) * xv[k]).astype(
                            np.float32)
                        if ends[k]:
                            idx = c[:, None] + np.arange(8)
                            out[row][idx] = (out[row][idx] + acc).astype(
                                np.float32)
                            acc[:] = 0
    return out


def bf16_plain(xbits, tables, out):
    x = torch.from_numpy(xbits.view(np.int16)).view(torch.bfloat16)
    t = [tuple(torch.from_numpy(a) for a in tb[:3]) + (tb[3],)
         for tb in tables]
    return ell_tail.ell_tables_plain(x, t, torch.from_numpy(out)).numpy()


def bf16_mag(xbits, tables, n):
    x = torch.from_numpy(xbits.view(np.int16)).view(torch.bfloat16)
    return mag_np(x.float().numpy(), tables, n)


@pytest.mark.parametrize("h", [8, 56, 248, 256, 264, 520])
def test_lanes_walk_matches_plain_with_split_hub_runs(h):
    """Ragged multi-degree tables with a hub run cut into atomic pieces:
    a slab's first lanes only, one slab short of its last lane, one whole
    slab, two slabs and three, onto a nonzero output."""
    n = 300
    rows, cols, vals = ragged_graph(n, seed=h + 8)
    tables = tables_of(rows, cols, vals, n)
    units, _n_real, counts = plan_of(tables)
    assert units[:, 3].any() and not units[:, 3].all()  # split hub run
    rng = np.random.default_rng(h)
    xbits = bf16_bits(rng.standard_normal((n, h)))
    out0 = rng.standard_normal((n, h)).astype(np.float32)
    got = emulate_lanes(xbits, tables, units, counts, out0.copy())
    want = bf16_plain(xbits, tables, out0.copy())
    mag = bf16_mag(xbits, tables, n) + np.abs(out0)
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("kind", GRAPHS)
def test_lanes_walk_matches_jax_on_multi_table_prepares(kind):
    rows, cols, vals = make_graph(kind)
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    assert len(tp.ell_meta) > 1
    tables = [(c.numpy(), v.numpy(), r.numpy(), d)
              for c, v, r, d in tp.ell_tables(tp.dev_arrays)]
    units, _n_real, counts = plan_of(tables)
    h = 16
    xbits = bf16_bits(np.random.default_rng(6).standard_normal((N, h)))
    got = emulate_lanes(xbits, tables, units, counts,
                        np.zeros((N, h), np.float32))
    xj = jnp.asarray(xbits.view(np.int16)).view(jnp.bfloat16)
    want = np.zeros((N, h), np.float32)
    for (chunk, degree), (c3, v3, r3, _d) in zip(tp.ell_meta, tables):
        part = jspmm.ell_scan_spmm(xj, jnp.asarray(c3), jnp.asarray(v3),
                                   jnp.asarray(r3), chunk, degree, N)
        assert part.dtype == jnp.float32  # result_type(f32 vals, bf16)
        want += np.asarray(part)
    mag = bf16_mag(xbits, tables, N)
    assert mag.any()
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)
    plain = bf16_plain(xbits, tables, np.zeros((N, h), np.float32))
    assert np.all(np.abs(got - plain) <= REL * mag + 1e-30)


def test_lanes_walk_reads_no_pad_slot():
    """The documented difference on path (c) too: a NaN bf16 x row that
    only pad slots reach spreads NaN in the plain version, not in the
    walk."""
    n = 300
    rows, cols, vals = ragged_graph(n, seed=2)
    tables = tables_of(rows, cols, vals, n)
    units, _n_real, counts = plan_of(tables)
    xbits = bf16_bits(np.random.default_rng(3).standard_normal((n, 8)))
    xbits[0] = bf16_bits(np.full((1, 8), np.nan))[0]
    got = emulate_lanes(xbits, tables, units, counts,
                        np.zeros((n, 8), np.float32))
    plain = bf16_plain(xbits, tables, np.zeros((n, 8), np.float32))
    assert np.isfinite(got).all()
    assert np.isnan(plain[n - 1]).all()  # the pad rows' target
    xbits[0] = 0
    want = bf16_plain(xbits, tables, np.zeros((n, 8), np.float32))
    assert np.all(np.abs(got - want)
                  <= REL * bf16_mag(xbits, tables, n) + 1e-30)


def test_widen8_is_the_bf16_value():
    xbits = bf16_bits(np.random.default_rng(0).standard_normal((3, 8)))
    words = xbits.view(np.uint32)
    want = torch.from_numpy(xbits.view(np.int16)).view(torch.bfloat16)
    np.testing.assert_array_equal(widen8(words), want.float().numpy())


# --- the wrapper ----------------------------------------------------------


@pytest.mark.parametrize("h", [1, 41, 256])
def test_tables_wrapper_on_cpu_is_the_plain_loop(h):
    n = 300
    rows, cols, vals = ragged_graph(n, seed=h)
    tables = [tuple(torch.from_numpy(a) for a in t[:3]) + (t[3],)
              for t in tables_of(rows, cols, vals, n)]
    assert len(tables) > 1
    x = torch.randn(n, h)
    out0 = torch.randn(n, h)
    want = out0.clone()
    for c, v, r, d in tables:
        ell_tail.ell_tail_plain(x, c, v, r, d, want)
    before = ell_tail.launches
    got = ell_tail.ell_tables_add(x, tables, out0.clone())
    assert torch.equal(got, want)
    assert torch.equal(ell_tail.ell_tail_add(x, *tables[0], out0.clone()),
                       ell_tail.ell_tail_plain(x, *tables[0], out0.clone()))
    assert ell_tail.launches == before  # the plain version is no launch


def test_tail_plan_packs_units_for_the_kernel():
    tables = [tuple(torch.from_numpy(a) for a in t[:3]) + (t[3],)
              for t in one_table(6, 40, seed=4) + one_table(32, 8, seed=5)]
    plan = ell_tail.tail_plan(tables)
    units = plan.units
    packed = plan.packed.numpy()
    assert packed.shape == (plan.n_units, 2) and packed.dtype == np.int32
    np.testing.assert_array_equal(packed[:, 0], units[:, 1])
    np.testing.assert_array_equal(packed[:, 1] & 0xFF, units[:, 0])
    np.testing.assert_array_equal((packed[:, 1] >> 8 & 31) + 1, units[:, 2])
    np.testing.assert_array_equal(packed[:, 1] >> 13 & 1, units[:, 3])
    tabs = plan.tabs.numpy()
    assert tabs.shape == (2, 5)
    for row, (c, v, r, d), cnt in zip(tabs, tables, plan.counts):
        assert list(row) == [c.data_ptr(), v.data_ptr(), r.data_ptr(),
                             cnt.data_ptr(), d]
        assert cnt.dtype == torch.int32 and cnt.numel() == r.numel()
    # the same plan from host copies the caller already holds
    again = ell_tail.tail_plan(
        tables, host=[(v.numpy(), r.numpy()) for _c, v, r, _d in tables])
    np.testing.assert_array_equal(again.units, units)


@pytest.mark.parametrize("bad", ["x_dtype", "cols_dtype", "vals_dtype",
                                 "vrow_dtype", "degree", "out_width",
                                 "noncontig", "device", "mixed_devices"])
def test_tables_wrapper_rejects(bad):
    tables = [tuple(torch.from_numpy(a) for a in t[:3]) + (t[3],)
              for t in one_table(6, 40, seed=4)]
    c, v, r, d = tables[0]
    x, out = torch.zeros(300, 8), torch.zeros(300, 8)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "cols_dtype":
        c = c.long()
    elif bad == "vals_dtype":
        v = v.double()
    elif bad == "vrow_dtype":
        r = r.long()
    elif bad == "degree":
        d = 4
    elif bad == "out_width":
        out = torch.zeros(300, 4)
    elif bad == "noncontig":
        x = torch.zeros(8, 300).t()
    elif bad == "device":
        x, c, v, r, out = (t.to("meta") for t in (x, c, v, r, out))
    else:
        out = out.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ell_tail.ell_tables_add(x, [(c, v, r, d)], out)


@pytest.mark.parametrize("dtype,h,offset,want", [
    (torch.bfloat16, 256, 0, "lanes"),
    (torch.bfloat16, 1104, 0, "lanes"),
    (torch.bfloat16, 36, 0, "registers"),
    (torch.bfloat16, 256, 1, "registers"),
    (torch.float32, 256, 0, "bulk"),
    (torch.float32, 41, 0, "registers"),
    (torch.float32, 256, 1, "registers"),
    (torch.int8, 48, 0, "bulk"),
    (torch.int8, 40, 0, "registers"),
    (torch.int16, 40, 0, "bulk"),
])
def test_kernel_path_rule(dtype, h, offset, want):
    """Path (c) takes bf16 rows at H % 8 == 0, 16-byte aligned; the other
    modes keep path (b) at rows of a multiple of 16 bytes; every other
    width or alignment path (a)."""
    buf = torch.zeros(8 * h + offset, dtype=dtype)
    x = buf[offset:].view(8, h)
    out = torch.zeros(8, h)
    assert ell_tail.kernel_path(x, out) == want


# --- the run path's width rule -------------------------------------------


@pytest.mark.parametrize("h", [41, 8, 1100])
def test_run_pads_only_the_core_to_a_multiple_of_8(h, monkeypatch):
    """The kernel side (``mul``, and ``raw_mul`` on a foreign dict) hands
    K-core a payload padded to a multiple of 8 and K-tail one at H; the
    yardstick ``mul_plain`` pads nothing. Both come back as (N, H)."""
    rows, cols, vals = make_graph("multigraph")
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    width = -(-h // 8) * 8
    seen = []

    def tail_fn(x, tables, out, plan=None):
        assert x.shape[1] == h and out.shape == (N, h)
        seen.append("tail")
        return ell_tail.ell_tables_plain(x, tables, out)

    def core_fn(bands, xc, cn, stair, out, plans=None):
        assert xc.shape[1] == width and out.shape == (N, width)
        assert not xc[:, h:].float().any()
        seen.append("core")
        return core_dot.core_bands_plain(bands, xc, cn, stair, out)

    def core_plain(bands, xc, cn, stair, out):
        assert xc.shape[1] == h and out.shape == (N, h)
        seen.append("plain core")
        return core_dot.core_bands_plain(bands, xc, cn, stair, out)

    monkeypatch.setattr(tspmm, "ell_tables_add", tail_fn)
    monkeypatch.setattr(tspmm, "core_bands_scatter_add", core_fn)
    monkeypatch.setattr(tspmm, "core_bands_plain", core_plain)
    x = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (N, h)).astype(np.float32))
    got = tp.mul(x)
    foreign = tp.raw_mul(x, dict(tp.dev_arrays))
    want = tp.mul_plain(x)
    assert seen == ["tail", "core"] * 2 + ["plain core"]
    for t in (got, foreign):
        assert t.shape == (N, h) and t.is_contiguous()
        assert torch.equal(t, want)
