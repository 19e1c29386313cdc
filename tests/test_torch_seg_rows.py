"""K-rows (``pygim_tpu_torch/ops/seg_rows.py``, ``csrc/seg_rows.cu``) on
the CPU: its host plan over the ``blocked`` and ``coo`` tables, and a
NumPy emulation of the kernel's walk over that plan, against the JAX
package's ``blocked`` and ``coo`` runs.

The emulation (:func:`emulate`) does what the kernel does, in the plan's
unit order: the output starts as garbage (a sentinel), the hub rows are
zeroed, each plain unit writes every row it owns once (its entries' sum
in stream order, or zeros), each piece of a hub row adds its partial sum
into the row; an f32 term is ``f32(w · x)`` added in f32 (the kernel's
``__fmul_rn`` then ``__fadd_rn``), an integer one wraps in uint32. The
plan must cover every stored entry once, but for a block's pads past its
rows, which the reference drops.

Tolerances: integer weights times an integer payload accumulate in
int32 on both sides, wrapping alike: bit-equal. Float products differ
from JAX's only in f32 summation order: within 1e-5 of the sum of
|terms| (``test_torch_blocked.py``'s bar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import _build, seg_rows
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import GRAPHS, N, make_graph

REL = 1e-5
SENTINEL = 7777


def edge_graph(kind):
    """(rows, cols, vals, n, config) of a case the plan must get right:
    ``full`` (row-balanced blocks of exactly 8 rows: every block fills
    rows_pad, so its pads land on its last row), ``hub`` (a row of 1000
    entries beside rows of one and empty rows: pieces), ``empty`` (no
    edge at all)."""
    rng = np.random.default_rng(11)
    if kind == "full":
        n = 64
        rows = np.sort(rng.integers(0, n, 300))
        cfg = dict(n_blocks=8, balance="row")
    elif kind == "hub":
        n = 300
        rows = np.r_[np.full(1000, 7), np.arange(0, n, 3)]
        rows = np.sort(rows)
        cfg = dict(block_nnz_budget=256)
    else:
        n = 40
        rows = np.zeros(0, np.int64)
        cfg = {}
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, n, cfg


def both(rows, cols, vals, n, backend, dtype="float32", **cfg):
    """Both packages' operands of one graph on ``backend``."""
    kw = dict(nrows=n, ncols=n, dtype=dtype)
    c = dict(backend=backend, **cfg)
    jp = jspmm.prepare_spmm(jgraph.CooGraph.from_edges(rows, cols, vals, **kw),
                            jspmm.SpmmConfig(**c))
    tp = tspmm.prepare_spmm(tgraph.CooGraph.from_edges(rows, cols, vals, **kw),
                            tspmm.SpmmConfig(**c), device="cpu")
    return jp, tp


def plan_of(tp):
    """The operand's K-rows plan (as prepare builds it on the card) and
    its flat tables ``(cols, vals, keys)`` with ``(nnz_pad, rows_pad)``
    (0 for coo), as numpy."""
    d = {k: v.numpy() for k, v in tp.dev_arrays.items()}
    if tp.config.backend == "blocked":
        plan = seg_rows.blocked_plan(d["rowloc"], d["row_slot"], tp.rows_pad,
                                     d["colind"], d["vals"])
        return plan, (d["colind"], d["vals"], d["rowloc"]), (
            d["colind"].shape[1], tp.rows_pad)
    plan = seg_rows.coo_plan(d["rows"], tp.nrows)
    return plan, (d["cols"], d["vals"], d["rows"]), (0, 0)


def unit_fields(plan):
    u = plan.units.astype(np.int64)
    return u[:, 0], u[:, 1], u[:, 2], u[:, 3] & 0x3FFFFFFF, u[:, 3] >> 30


def targets(plan, keys, e, pads):
    """The output row of flat entries ``e`` (blocked: through the inverse
    slot map; -1 where the slot holds no row)."""
    nnz_pad, rows_pad = pads
    if plan.inv is None:
        return keys[e].astype(np.int64)
    return plan.inv[(e // nnz_pad) * rows_pad + keys[e]].astype(np.int64)


def walk(plan, keys, pads):
    """Every unit's entries in plan order: (flat entry, unit, target)."""
    e0, n, *_ = unit_fields(plan)
    unit = np.repeat(np.arange(n.size), n)
    e = np.repeat(e0, n) + np.arange(int(n.sum())) - np.repeat(
        np.cumsum(n) - n, n)
    return e, unit, targets(plan, keys.reshape(-1), e, pads)


def check_plan(plan, tables, pads):
    """The plan's invariants: each stored entry in one unit at most; in
    none where the reference drops it, and otherwise in one, but for a
    zero-weight entry that repeats the one before it in its row (a full
    block's pads: the same term, which adding again changes not at all);
    every entry's row within its unit's rows and non-decreasing there; a
    piece holds one hub row; every other row owned by one plain unit.
    Returns the repeats left out."""
    cols, vals, keys = (t.reshape(-1) for t in tables)
    e0, n, r_lo, nr, atomic = unit_fields(plan)
    e, unit, tgt = walk(plan, keys, pads)
    seen = np.bincount(e, minlength=keys.size)
    every = targets(plan, keys, np.arange(keys.size), pads)
    assert seen.max(initial=0) <= 1 and not seen[every < 0].any()
    left = np.flatnonzero((every >= 0) & (seen == 0))
    assert (left > 0).all() and (vals[left] == 0).all()
    assert (cols[left] == cols[left - 1]).all()
    assert (vals[left - 1] == 0).all() and (every[left] == every[left - 1]).all()
    assert (tgt >= r_lo[unit]).all() and (tgt < (r_lo + nr)[unit]).all()
    same = unit[1:] == unit[:-1]
    assert (tgt[1:][same] >= tgt[:-1][same]).all()
    assert (nr[atomic == 1] == 1).all()
    assert set(r_lo[atomic == 1]) == set(plan.hub_rows.tolist())
    assert (n[atomic == 1] <= seg_rows.UNIT_ENTRIES).all()
    assert (n[atomic == 0] < 2 * seg_rows.UNIT_ENTRIES).all()
    assert (nr <= seg_rows.UNIT_ROWS).all()
    owned = np.zeros(plan.nrows, np.int64)
    p = atomic == 0
    np.add.at(owned, np.repeat(r_lo[p], nr[p]) + np.arange(int(nr[p].sum()))
              - np.repeat(np.cumsum(nr[p]) - nr[p], nr[p]), 1)
    hub = np.zeros(plan.nrows, bool)
    hub[plan.hub_rows] = True
    np.testing.assert_array_equal(owned, (~hub).astype(np.int64))
    assert (np.diff(n) <= 0).all()  # most entries first
    return left


def emulate(plan, tables, pads, x):
    """The kernel's walk (module docstring); x numpy of the payload's
    dtype (bf16 as float32 values)."""
    cols, vals, keys = (t.reshape(-1) for t in tables)
    integer = (np.issubdtype(vals.dtype, np.integer)
               and np.issubdtype(x.dtype, np.integer))
    acc_t = np.uint32 if integer else np.float32
    h = x.shape[1]
    xa = x.astype(np.int64).astype(np.uint32) if integer else x.astype(
        np.float32)
    va = vals.astype(np.int64).astype(np.uint32) if integer else vals.astype(
        np.float32)
    out = np.full((plan.nrows, h), SENTINEL, acc_t)
    out[plan.hub_rows] = 0
    e0, n, r_lo, nr, atomic = unit_fields(plan)
    p = atomic == 0
    rows_p = np.repeat(r_lo[p], nr[p]) + np.arange(int(nr[p].sum())) \
        - np.repeat(np.cumsum(nr[p]) - nr[p], nr[p])
    out[rows_p] = 0
    e, unit, tgt = walk(plan, keys, pads)
    if e.size == 0:
        return out
    # runs: consecutive entries of one unit and one row, summed in order
    start = np.r_[True, (unit[1:] != unit[:-1]) | (tgt[1:] != tgt[:-1])]
    rid = np.cumsum(start) - 1
    first = np.flatnonzero(start)
    pos = np.arange(e.size) - first[rid]
    acc = np.zeros((first.size, h), acc_t)
    with np.errstate(over="ignore"):
        for k in range(int(pos.max()) + 1):
            at = pos == k
            term = va[e[at]][:, None] * xa[cols[e[at]]]
            acc[rid[at]] = acc[rid[at]] + term.astype(acc_t)
    run_row, run_unit = tgt[first], unit[first]
    plain = atomic[run_unit] == 0
    out[run_row[plain]] = acc[plain]
    with np.errstate(over="ignore"):
        np.add.at(out, run_row[~plain], acc[~plain])
    return out


def mag_of(rows, cols, vals, n, x):
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    return dense @ np.abs(x.astype(np.float64))


BACKENDS = ["blocked", "coo"]
BLOCKS = [1, 7, 64]


@pytest.mark.parametrize("n_blocks", BLOCKS)
@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_covers_every_entry_once(backend, kind, n_blocks):
    """The test graphs (hub rows of more than a unit among them) at one,
    a few and many blocks or chunks; coo at several chunks has a row that
    straddles two."""
    rows, cols, vals = make_graph(kind)
    _, tp = both(rows, cols, vals, N, backend, n_blocks=n_blocks)
    plan, tables, pads = plan_of(tp)
    check_plan(plan, tables, pads)
    assert plan.hub_rows.size > 0
    if backend == "coo" and n_blocks > 1:
        r = tables[2]
        assert (r[1:, 0] == r[:-1, -1]).any()  # a straddling row


@pytest.mark.parametrize("kind", ["full", "hub", "empty"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_plan_edge_cases(backend, kind):
    """Blocks that fill rows_pad (their pads kept on a real row), a hub
    cut into pieces beside empty rows, and a zero-edge operand (only
    pads: on a real row where its one block fills rows_pad)."""
    rows, cols, vals, n, cfg = edge_graph(kind)
    _, tp = both(rows, cols, vals, n, backend, **cfg)
    plan, tables, pads = plan_of(tp)
    left = check_plan(plan, tables, pads)
    if kind == "hub":
        assert plan.hub_rows.tolist() == [7]
        assert (np.bincount(rows, minlength=n) == 0).any()
    if kind == "full" and backend == "blocked":
        # every block fills rows_pad: of each block's pads the first is
        # walked, on its last row; the rest repeat it
        assert (tp.plan.rows_per_block == tp.rows_pad).all()
        pads_b = (tables[1] == 0).sum(1)  # the edges' weights are normal
        assert left.size == np.maximum(pads_b - 1, 0).sum() > 0
        e, _, tgt = walk(plan, tables[2], pads)
        assert e.size == tables[2].size - left.size


@pytest.mark.parametrize("payload", ["int8", "int16", "int32", "int64"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_emulation_integer_bit_equal(backend, payload):
    """Integer weights times an integer payload, int32 sums wrapping (the
    int32 and int64 payloads at int32's ends, so sums pass 2^31):
    emulation, plain version and JAX bit for bit."""
    rows, cols, vals = make_graph("multigraph")
    vals = np.random.default_rng(2).integers(-5, 6, rows.size).astype(
        np.int32)
    jp, tp = both(rows, cols, vals, N, backend, "int32", n_blocks=5)
    info = np.iinfo(payload if payload != "int64" else "int32")
    x = np.random.default_rng(3).integers(info.min, info.max, (N, 24),
                                          endpoint=True).astype(payload)
    want = np.asarray(jp.mul(jnp.asarray(x)))
    assert want.dtype == np.int32
    plain = tp.mul_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(plain, want)
    plan, tables, pads = plan_of(tp)
    xk = x.astype(np.int32)  # int64 is taken as int32, as the reference
    got = emulate(plan, tables, pads, xk).view(np.int32)
    np.testing.assert_array_equal(got, want)
    if payload in ("int32", "int64"):
        exact = np.zeros((N, 24), np.int64)
        np.add.at(exact, rows, vals[:, None].astype(np.int64)
                  * xk[cols].astype(np.int64))
        assert (np.abs(exact) >= 1 << 31).any()  # the sums wrapped


@pytest.mark.parametrize("h", [41, 64, 256])
@pytest.mark.parametrize("payload", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_emulation_float_matches_jax(backend, payload, h):
    """Float weights with f32, bf16 and int32 payloads (f32 sums): the
    emulation and the plain version within 1e-5 of the sum of |terms| of
    JAX's run."""
    rows, cols, vals = make_graph("wide")
    vals = vals * np.random.default_rng(4).standard_normal(
        rows.size).astype(np.float32)
    jp, tp = both(rows, cols, vals, N, backend, n_blocks=3)
    rng = np.random.default_rng(h)
    if payload == "int32":
        x = rng.integers(-1000, 1000, (N, h)).astype(np.int32)
        jx, tx, xv = jnp.asarray(x), torch.from_numpy(x), x
    else:
        x = rng.standard_normal((N, h)).astype(np.float32)
        if payload == "bfloat16":
            tx = torch.from_numpy(x).to(torch.bfloat16)
            xv = tx.float().numpy()
            jx = jnp.asarray(x, jnp.bfloat16)
        else:
            jx, tx, xv = jnp.asarray(x), torch.from_numpy(x), x
    want = np.asarray(jp.mul(jx))
    assert want.dtype == np.float32
    mag = mag_of(rows, cols, vals, N, xv)
    plan, tables, pads = plan_of(tp)
    got = emulate(plan, tables, pads, xv)
    plain = tp.mul_plain(tx).numpy()
    for what in (got, plain):
        assert what.dtype == np.float32
        assert np.all(np.abs(what - want) <= REL * mag + 1e-30)


@pytest.mark.parametrize("kind", ["full", "hub", "empty"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_x0_spreads_as_reference(backend, kind):
    """A NaN in x[0] (the pads' column) gives NaN in exactly the rows JAX
    gives it in: the rows of real edges to column 0, a full block's last
    row, coo's last row (its pads); elsewhere the values agree."""
    rows, cols, vals, n, cfg = edge_graph(kind)
    jp, tp = both(rows, cols, vals, n, backend, **cfg)
    x = np.random.default_rng(5).standard_normal((n, 16)).astype(np.float32)
    x[0] = np.nan
    want = np.asarray(jp.mul(jnp.asarray(x)))
    plan, tables, pads = plan_of(tp)
    for got in (emulate(plan, tables, pads, x),
                tp.mul_plain(torch.from_numpy(x)).numpy()):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        xm = np.where(np.isnan(x), 0, x)
        mag = mag_of(rows, cols, vals, n, xm)
        assert np.all(np.abs(got[ok] - want[ok]) <= REL * mag[ok] + 1e-30)
    assert np.isnan(want).any()


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; ``mul`` and ``mul_plain`` agree bit for bit there."""
    rows, cols, vals = make_graph("multigraph")
    seg_rows.launches = seg_rows.coo_launches = 0
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (N, 8)).astype(np.float32))
    for backend in BACKENDS:
        _, tp = both(rows, cols, vals, N, backend, n_blocks=4)
        assert tp._seg_plan is None  # built at prepare on the card only
        assert torch.equal(tp.mul(x), tp.mul_plain(x))
    assert seg_rows.launches == seg_rows.coo_launches == 0


def test_kernel_dtypes_and_refusals():
    """The kernel's codes: f32 sums for float weights or payloads, int32
    for integer both; a float64 or float16 payload, or uint8 weights,
    have none. The wrappers refuse an operand that requires grad."""
    f32, i32 = torch.zeros(2), torch.zeros(2, dtype=torch.int32)
    assert seg_rows._codes(f32, torch.zeros(1, 1, dtype=torch.bfloat16)) == (
        0, 1, False)
    assert seg_rows._codes(i32, torch.zeros(1, 1, dtype=torch.int8)) == (
        1, 2, True)
    assert seg_rows._codes(i32, torch.zeros(1, 1)) == (1, 0, False)
    for v, x in ((f32, torch.zeros(1, 1, dtype=torch.float64)),
                 (f32, torch.zeros(1, 1, dtype=torch.float16)),
                 (torch.zeros(2, dtype=torch.uint8), i32[:, None])):
        with pytest.raises(TypeError, match="K-rows"):
            seg_rows._codes(v, x)
    rows, cols, vals = make_graph("simple")
    x = torch.zeros(N, 4, requires_grad=True)
    for backend in BACKENDS:
        _, tp = both(rows, cols, vals, N, backend)
        with pytest.raises(RuntimeError, match="requires grad"):
            tp.mul(x)
        with torch.no_grad():
            tp.mul(x)


def test_seg_rows_is_built_like_the_others():
    """The library's entry point is declared for ctypes beside the other
    kernels' (built from ``csrc/seg_rows.cu`` at first use)."""
    assert "seg_rows" in _build.SIGNATURES
    assert (_build.CSRC / "seg_rows.cu").exists()
    assert len(_build.SIGNATURES["seg_rows"]["seg_rows"]) == 18


def test_plan_reading_counts():
    """``SegPlan.reading`` counts the plan's units, the hub pieces among
    them, the hub rows and the entries the units walk (every stored
    entry but the repeats of a full block's pads)."""
    for kind in ("full", "hub"):
        rows, cols, vals, n, cfg = edge_graph(kind)
        for backend in BACKENDS:
            _, tp = both(rows, cols, vals, n, backend, **cfg)
            plan, tables, pads = plan_of(tp)
            left = check_plan(plan, tables, pads)
            r = plan.reading()
            _e0, cnt, _r, _nr, atomic = unit_fields(plan)
            assert r == dict(units=cnt.size, pieces=int(atomic.sum()),
                             hub_rows=plan.hub_rows.size,
                             entries=int(cnt.sum()))
            keys = tables[2].reshape(-1)
            live = targets(plan, keys, np.arange(keys.size), pads) >= 0
            assert r["entries"] == int(live.sum()) - left.size


def test_codes_are_cached_by_dtype_pair():
    """The wrapper's dtype codes come from a cache keyed by the dtype pair
    and equal a fresh computation; a pair without codes raises each time
    (nothing cached for it)."""
    pairs = [(torch.float32, torch.float32), (torch.int32, torch.int8),
             (torch.int16, torch.int32), (torch.int8, torch.bfloat16)]
    for v, x in pairs:
        got = seg_rows._codes(torch.zeros(1, dtype=v),
                              torch.zeros(1, 1, dtype=x))
        assert got == seg_rows._dtype_codes.__wrapped__(v, x)
        assert seg_rows._dtype_codes(v, x) is seg_rows._dtype_codes(v, x)
    for _ in range(2):
        with pytest.raises(TypeError, match="K-rows"):
            seg_rows._codes(torch.zeros(1), torch.zeros(1, 1,
                                                        dtype=torch.float64))
