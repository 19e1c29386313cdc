"""K-bcsr's work plan (``ops/bcsr.py:bcsr_plan``) on the CPU: its
invariants on prepared, random and edge-case tables, its byte model
against a direct count, its choice of bands, and a plain emulation of the
kernel's walk of it (zero-skipping adds included) held to ``bcsr_plain``
and to the JAX reference's ``bcsr_scan_spmm`` / ``bcsr_panel_scan_spmm``.

Tolerances: the emulation sums the same f32 products as ``bcsr_plain``
and the reference in another order, within 1e-5 of the sum of |terms|
per element (``tests/test_torch_bcsr.py``'s ``REL``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import bcsr as kbcsr
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_bcsr import REL, brmat

HS = 64  # the kernel's slab of output columns


def random_tier(kind, n, slots, tr, nodes, seed, tile_dtype=torch.bfloat16,
                n_rb=None, density=0.2):
    """A random tier: ``n`` virtual blocks / panels of ``slots`` tiles over
    ``nodes`` nodes, its panels and row blocks drawn at random (row kind:
    ``vblock_to_rb`` sorted, as ``core/bcsr.py`` lays it out). The arguments of
    ``bcsr_add`` after x."""
    g = torch.Generator().manual_seed(seed)
    n_panels = max(1, nodes // 128)
    n_rb = n_rb or max(1, nodes // tr)
    tiles = torch.randn(n, slots, tr, 128, generator=g)
    tiles *= torch.rand(n, slots, tr, 128, generator=g) < density
    tiles = tiles.to(tile_dtype)
    if kind == "row":
        pidx = torch.randint(0, n_panels, (n, slots), generator=g,
                             dtype=torch.int32)
        rb = torch.sort(torch.randint(0, n_rb, (n,), generator=g,
                                      dtype=torch.int32))[0]
    else:
        pidx = torch.sort(torch.randint(0, n_panels, (n,), generator=g,
                                        dtype=torch.int32))[0]
        rb = torch.randint(0, n_rb, (n, slots), generator=g,
                           dtype=torch.int32)
    pn = torch.randint(0, nodes, (n_panels * 128,), generator=g,
                       dtype=torch.int32)
    rn = torch.randint(0, nodes, (n_rb * tr,), generator=g, dtype=torch.int32)
    return kind, tiles, pidx, rb, pn, rn


def prepared_tier(layout, order):
    """A prepared tier of the reference's tile-capture graph (the smoke
    tiers' shape at a small size)."""
    rows, cols, vals, n = brmat()
    g = tgraph.CooGraph.from_edges(rows, cols, vals, nrows=n, ncols=n)
    tp = tspmm.prepare_spmm(g, tspmm.SpmmConfig(
        backend="hybrid", hybrid_k=0, bcsr_bytes=64 << 20, bcsr_tile=16,
        bcsr_order=order, bcsr_layout=layout, hidden_hint=16,
        bcsr_min_edges=8), device="cpu")
    assert tp.has_bcsr
    return tp.bcsr_tables(tp.dev_arrays)


def hub_tier():
    """Panel kind: one panel with 3 · ITEM_TILES + 5 tiles, so the plan
    splits it into items."""
    kind, tiles, pidx, rb, pn, rn = random_tier(
        "panel", 3 * kbcsr.ITEM_TILES + 9, 1, 16, 1200, 4)
    pidx = pidx.clone()
    pidx[:3 * kbcsr.ITEM_TILES + 5] = 2
    return kind, tiles, torch.sort(pidx)[0], rb, pn, rn


def pad_slot_tier():
    """Panel kind with a pad slot: a zero tile on row block 0."""
    kind, tiles, pidx, rb, pn, rn = random_tier("panel", 6, 3, 8, 700, 5)
    tiles[4, 2] = 0
    rb = rb.clone()
    rb[4, 2] = 0
    return kind, tiles, pidx, rb, pn, rn


def last_block_tier():
    """Row kind with a pad virtual block: zero tiles on panel 0 and the
    last row block, which the clamped row_nodes repeat."""
    kind, tiles, pidx, rb, pn, rn = random_tier("row", 9, 2, 16, 500, 6)
    tiles[-1] = 0
    pidx, rb, rn = pidx.clone(), rb.clone(), rn.clone()
    pidx[-1] = 0
    rb[-1] = rn.numel() // 16 - 1
    rn[-16:] = rn[-17]  # clamped at the last node
    return kind, tiles, pidx, rb, pn, rn


PLAN_TIERS = {
    "prepared panel lp": lambda: prepared_tier("panel", "lp"),
    "prepared row rcm": lambda: prepared_tier("row", "rcm"),
    "random panel": lambda: random_tier("panel", 120, 3, 16, 3000, 1),
    "random row": lambda: random_tier("row", 120, 1, 16, 3000, 2),
    "one tile": lambda: random_tier("panel", 1, 1, 16, 200, 3),
    "panel pad slot": pad_slot_tier,
    "clamped last row block": last_block_tier,
    "Tr 8": lambda: random_tier("row", 40, 2, 8, 900, 7),
    "Tr 64": lambda: random_tier("panel", 30, 2, 64, 900, 8),
    "hub panel split": hub_tier,
    "row S > 1": lambda: random_tier("row", 60, 4, 16, 1500, 9, n_rb=12),
}


def flat_of(kind, pidx, rb):
    """Every tile's (panel, row block) in the tables' flat order."""
    if kind == "panel":
        s = rb.shape[1]
        return np.repeat(pidx.numpy(), s), rb.numpy().reshape(-1)
    s = pidx.shape[1]
    return pidx.numpy().reshape(-1), np.repeat(rb.numpy(), s)


def direct_model(kind, pidx, rb, tr, h, band_rb, tile_bytes, plan):
    """The plan's byte model counted item by item, entry by entry."""
    panel, rows = flat_of(kind, pidx, rb)
    ent = plan.entries.numpy()
    row_bytes = tr * h * 4
    used = sorted(set(rows.tolist()))
    band_of = {r: (i // band_rb if band_rb else 0) for i, r in enumerate(used)}
    rbs, adds = {}, {}
    for r in used:
        rbs[band_of[r]] = rbs.get(band_of[r], 0) + 1
    for first, end, _p, b in plan.items.numpy().tolist():
        for e in range(first, end):
            if e == first or ent[e, 1] != ent[e - 1, 1]:
                adds[b] = adds.get(b, 0) + 1
    m = dict(tiles=panel.size * tr * 128 * tile_bytes,
             stages=plan.items.shape[0] * 128 * h * 4, adds_hbm=0.0,
             adds_l2=0.0, band_rows=0)
    for b, k in rbs.items():
        if k * row_bytes <= kbcsr.L2_BAND_BYTES:
            m["adds_l2"] += kbcsr.L2_ADD_COST * adds.get(b, 0) * 2 * row_bytes
            m["band_rows"] += k * 2 * row_bytes
        else:
            m["adds_hbm"] += adds.get(b, 0) * 2 * row_bytes
    return m


def check_plan(kind, tiles, pidx, rb, plan, band_rb):
    n, slots, tr, _ = tiles.shape
    panel, rows = flat_of(kind, pidx, rb)
    ent = plan.entries.numpy()
    items = plan.items.numpy()
    assert plan.entries.dtype == torch.int32 and ent.shape == (n * slots, 2)
    assert plan.items.dtype == torch.int32 and items.shape[1] == 4
    # every tile exactly once, pads included, with its own row block
    np.testing.assert_array_equal(np.sort(ent[:, 0]), np.arange(n * slots))
    np.testing.assert_array_equal(ent[:, 1], rows[ent[:, 0]])
    # items partition the entries; one panel and one band an item
    bounds = items[np.argsort(items[:, 0])]
    assert bounds[0, 0] == 0 and bounds[-1, 1] == n * slots
    np.testing.assert_array_equal(bounds[1:, 0], bounds[:-1, 1])
    assert (items[:, 1] > items[:, 0]).all()
    assert (items[:, 1] - items[:, 0] <= kbcsr.ITEM_TILES).all()
    used = np.unique(rows)
    band = np.searchsorted(used, ent[:, 1]) // band_rb if band_rb else \
        np.zeros(len(ent), np.int64)
    for first, end, p, b in items.tolist():
        assert (panel[ent[first:end, 0]] == p).all()
        assert (band[first:end] == b).all()
    # panel-major inside each band: (band, panel, row block) never falls
    key = np.stack([band, panel[ent[:, 0]], ent[:, 1]], axis=1)
    assert (np.diff(key[:, 0]) >= 0).all()
    same_band = np.diff(key[:, 0]) == 0
    assert (np.diff(key[:, 1])[same_band] >= 0).all()
    same_panel = same_band & (np.diff(key[:, 1]) == 0)
    assert (np.diff(key[:, 2])[same_panel] >= 0).all()
    # band-major, longest first inside a band
    lens = items[:, 1] - items[:, 0]
    for i in range(1, len(items)):
        assert items[i, 3] >= items[i - 1, 3]
        if items[i, 3] == items[i - 1, 3]:
            assert lens[i] <= lens[i - 1]
    assert plan.stages == len(items)
    return panel


@pytest.mark.parametrize("bands", [False, True])
@pytest.mark.parametrize("name", list(PLAN_TIERS))
def test_plan_invariants(name, bands):
    """Every tile once, pads included, in items of one panel and band,
    panel-major inside each band, longest first; the modelled bytes equal
    a direct count. ``bands`` forces bands of two row blocks."""
    kind, tiles, pidx, rb, pn, rn = PLAN_TIERS[name]()
    tr, h = tiles.shape[2], 41
    band_rb = 2 if bands else 0
    plan = kbcsr.plan_tables(kind, pidx, rb, tr, h, band_rb,
                             tiles.element_size())
    panel = check_plan(kind, tiles, pidx, rb, plan, band_rb)
    want = direct_model(kind, pidx, rb, tr, h, band_rb,
                        tiles.element_size(), plan)
    assert plan.model == pytest.approx(want)
    assert plan.model_bytes == pytest.approx(sum(want.values()))
    if not bands:  # each panel staged once, hub panels split
        per_panel = np.bincount(panel)
        want_items = (-(-per_panel[per_panel > 0] // kbcsr.ITEM_TILES)).sum()
        assert plan.stages == want_items
    if name == "hub panel split":
        assert (plan.items[:, 2] == 2).sum() >= 4


def diagonal_tables(n_panels=3000, per_panel=32, tr=16):
    """Panel kind, each panel's tiles on the row blocks beside it (the
    banded structure an RCM order gives): bands barely add stages, and
    the many adds a panel make the L2's discount pay."""
    pidx = np.repeat(np.arange(n_panels), 1).astype(np.int32)
    rb = (np.arange(n_panels)[:, None] * 2
          + np.arange(per_panel)[None, :] - per_panel // 2).clip(0)
    return pidx, rb.astype(np.int32), tr


def test_plan_takes_bands_where_they_pay():
    """Where out's rows are past the L2 and each panel's tiles stay near
    the diagonal, bands cost few extra stages and keep the adds in L2:
    the plan takes them. Where panels scatter over all row blocks, bands
    stage a panel once a band: it does not."""
    pidx, rb, tr = diagonal_tables()
    h = 1024  # 64 KB a row block: 6,000 of them are far past the L2
    plan = kbcsr.bcsr_plan("panel", pidx, rb, tr, h)
    assert plan.band_rb == kbcsr.L2_BAND_BYTES // (tr * h * 4)
    assert plan.bands > 1 and plan.model["adds_hbm"] == 0
    flat = kbcsr.plan_tables("panel", pidx, rb, tr, h, 0)
    assert plan.model_bytes < flat.model_bytes
    g = np.random.default_rng(0)
    rb = g.integers(0, 6000, rb.shape).astype(np.int32)
    plan = kbcsr.bcsr_plan("panel", pidx, rb, tr, h)
    assert plan.band_rb == 0 and plan.bands == 1
    # a tier whose out rows fit in the L2 has no bands, its adds at L2
    plan = kbcsr.bcsr_plan("panel", pidx[:100], rb[:100] % 50, tr, 256)
    assert plan.band_rb == 0 and plan.model["adds_hbm"] == 0


def test_plan_on_the_device_argument():
    kind, tiles, pidx, rb, pn, rn = random_tier("row", 10, 2, 8, 500, 11)
    plan = kbcsr.bcsr_plan(kind, pidx, rb, 8, 16, device="cpu")
    assert plan.entries.device.type == "cpu"
    assert plan.items.device.type == "cpu"


def emulate(x, kind, tiles, pidx, rb, pn, rn, out, plan, safe=None):
    """The kernel's walk of ``plan`` in plain PyTorch, into ``out``: per
    item and 64-column slab, the item's panel staged once in the compute
    dtype; each entry's tile times it, summed over consecutive entries of
    one row block; at a change of row block or the item's end, each
    4-column piece of the partial rows added unless all four values are
    exactly zero."""
    mode = kbcsr.compute_mode(tiles.dtype, x.dtype, safe)
    cdt = torch.bfloat16 if mode == "bf16" else torch.float32
    n, slots, tr, tc = tiles.shape
    t = tiles.reshape(n * slots, tr, tc).float()
    h = x.shape[1]
    ent = plan.entries.long()
    pnv, rnv = pn.long().view(-1, tc), rn.long().view(-1, tr)

    def flush(acc, held, c0):
        w = acc.shape[1]
        padded = torch.nn.functional.pad(acc, (0, -w % 4))
        keep = (padded.view(tr, -1, 4) != 0).any(-1)
        keep = keep.repeat_interleave(4, 1)[:, :w]
        r, c = keep.nonzero(as_tuple=True)
        out.index_put_((rnv[held][r], c0 + c), acc[r, c], accumulate=True)

    for first, end, panel, _band in plan.items.tolist():
        for c0 in range(0, h, HS):
            xs = x[pnv[panel], c0:c0 + HS]
            xp = kbcsr._payload(xs, safe, cdt)
            held, acc = int(ent[first, 1]), None
            for e in range(first, end):
                ti, r = int(ent[e, 0]), int(ent[e, 1])
                if r != held:
                    flush(acc, held, c0)
                    held, acc = r, None
                p = t[ti] @ xp
                acc = p if acc is None else acc + p
            flush(acc, held, c0)
    return out


def payload(nodes, h, dtype, seed):
    g = np.random.default_rng(seed)
    lim = {"int8": 127, "int16": 1 << 12, "int32": 1 << 20}
    if dtype in lim:
        return torch.from_numpy(g.integers(-lim[dtype], lim[dtype] + 1,
                                           (nodes, h))).to(
            getattr(torch, dtype))
    x = torch.from_numpy(g.standard_normal((nodes, h)).astype(np.float32))
    return x.to(getattr(torch, dtype.split()[0]))


EMULATION_CASES = [
    # kind, slots, Tr, tile dtype, payload, H, bands
    ("row", 3, 16, "bfloat16", "float32", 41, 0),
    ("panel", 4, 8, "bfloat16", "float32", 130, 2),
    ("row", 1, 64, "float32", "float32", 8, 0),
    ("panel", 2, 24, "bfloat16", "int16", 64, 0),
    ("row", 2, 8, "bfloat16", "float32 rounded", 70, 3),
    ("panel", 1, 32, "float32", "int8", 33, 0),
    ("row", 1, 16, "bfloat16", "bfloat16", 16, 1),
    ("panel", 3, 16, "bfloat16", "int32", 20, 0),
]


@pytest.mark.parametrize("case", EMULATION_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulation_matches_plain_and_jax(case):
    """The plan's walk, zero-skip included, gives the plain version's and
    the reference's product within REL of the sum of |terms|."""
    kind, slots, tr, tdt, xdt, h, band_rb = case
    nodes = 700
    kind, tiles, pidx, rb, pn, rn = random_tier(
        kind, 24, slots, tr, nodes, 31 + tr, getattr(torch, tdt))
    x = payload(nodes, h, xdt, tr + h)
    safe = None
    if xdt.endswith("rounded"):
        safe = (x.abs().max() * 2 / 2 ** 20).reshape(())
    plan = kbcsr.plan_tables(kind, pidx, rb, tr, h, band_rb,
                             tiles.element_size())
    got = emulate(x, kind, tiles, pidx, rb, pn, rn,
                  torch.zeros(nodes, h), plan, safe)
    want = kbcsr.bcsr_plain(x, kind, tiles, pidx, rb, pn, rn,
                            torch.zeros(nodes, h), safe)
    xa = x.abs() if x.is_floating_point() else x.to(torch.int32).abs()
    mag = kbcsr.bcsr_plain(xa, kind, tiles.abs(), pidx, rb, pn, rn,
                           torch.zeros(nodes, h), safe)
    assert torch.all((got - want).abs() <= REL * mag + 1e-30)
    # the reference's scan body of the same layout
    mode = kbcsr.compute_mode(tiles.dtype, x.dtype, safe)
    jt = jnp.asarray(tiles.float().numpy())
    if tiles.dtype == torch.bfloat16:
        jt = jt.astype(jnp.bfloat16)
    jx = jnp.asarray(x.float().numpy() if x.dtype == torch.bfloat16
                     else x.numpy())
    if x.dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    body = (jspmm.bcsr_panel_scan_spmm if kind == "panel"
            else jspmm.bcsr_scan_spmm)
    ref = body(jx, jnp.asarray(pn.numpy()), jt, jnp.asarray(pidx.numpy()),
               jnp.asarray(rb.numpy()), jnp.asarray(rn.numpy()),
               jnp.zeros((nodes, h), jnp.float32), step=1,
               q_scale=None if safe is None else jnp.float32(float(safe)),
               compute_dtype=jnp.float32 if mode == "f32" else None)
    ref = torch.from_numpy(np.array(ref))
    assert torch.all((got - ref).abs() <= REL * mag + 1e-30)


def test_emulation_skips_exact_zeros_only():
    """A piece whose partials are all exactly zero leaves out as it was
    (a -0.0 stays -0.0); a piece with a nonzero or a NaN partial is added,
    and a zero cell times a NaN x is a NaN partial."""
    kind, tiles, pidx, rb, pn, _ = random_tier("panel", 1, 1, 8, 200, 12)
    rn = torch.arange(8 * (200 // 8), dtype=torch.int32)
    tiles.zero_()
    tiles[0, 0, 0, 0] = 1.0  # row 0 reads panel row 0 only
    x = torch.zeros(200, 8)
    x[int(pn[0]), 1] = 2.0
    x[int(pn[5]), 6] = float("nan")
    out = torch.full((200, 8), -0.0)
    plan = kbcsr.plan_tables(kind, pidx, rb, 8, 8, 0, 2)
    emulate(x, kind, tiles, pidx, rb, pn, rn, out, plan)
    rows = rn[int(rb[0, 0]) * 8:][:8].long()
    assert out[rows[0], 1] == 2.0 and not torch.signbit(out[rows[0], :4]).any()
    assert torch.signbit(out[rows[1:], :4]).all()  # zero pieces skipped
    assert torch.isnan(out[rows, 6]).all()  # 0 x NaN spreads to every row
    assert not torch.signbit(out[rows][:, [4, 5, 7]]).any()  # added
    rest = torch.ones(200, dtype=torch.bool)
    rest[rows] = False
    assert torch.signbit(out[rest]).all()  # untouched
