"""K-bcsr: the BCSR tile tier's product, scatter-added.

Counterpart of ``pygim_tpu/ops/spmm.py:bcsr_scan_spmm`` (row-major,
``:690-745``) and ``bcsr_panel_scan_spmm`` (panel-major, ``:633-687``),
the XLA bodies of the hybrid's middle tier (``core/bcsr.py`` builds its
tables). The CUDA kernel is ``csrc/bcsr.cu``, one launch a product in
either layout. With ``P = panel_nodes`` viewed as ``(n_panels, 128)``
and ``R = row_nodes`` as ``(n_rb, Tr)``:

* row kind, every virtual block ``b`` (``rb = vblock_to_rb``)::

      out[R[rb[b], r]] += Σ_s tiles[b, s, r, :] @ X[P[panel_idx[b, s]]]

* panel kind, every virtual panel ``p`` and slot ``t`` (``rb =
  tile_rb``)::

      out[R[rb[p, t], r]] += tiles[p, t, r, :] @ X[P[panel_idx[p]]]

``X`` is the payload in the compute dtype of the reference's ``cdt``
(:func:`compute_mode`): bf16 tiles with a float32, bfloat16 or int8 x
multiply ``bf16(x)`` (rounded to nearest even; int8 is exact) with f32
sums; every other case (int16 or int32 x, a float32 x rounded to
``round(x / safe)``, which stands for the int32 quantized aggregate, f32
tiles) computes in f32. ``out`` is the port's float32 ``(N, H)``, added
into; the reference adds integer payloads' partials into an int32
output, which agrees wherever partial sums are integers below 2^24.

The kernel computes every case on the tensor cores, by one of the routes
of :func:`kernel_route`: ``bf16`` (one bf16 part of x, the reference's
bf16 cdt), ``bf16x2`` / ``bf16x3`` (x as f32 split into two or three
bf16 parts, each product exact: the reference's f32 cdt on bf16 tiles,
bit-equal wherever the partial sums are integers below 2^24), ``tf32x3``
(f32 tiles, 3xTF32: about 3 · 2^-22 of the sum of |terms|) and
``tf32x2`` (f32 tiles with an int8 or bf16 x, exact in TF32).

Pads read x as the reference's do: pad virtual blocks (zero tiles,
panel 0, the last row block), panel-kind pad slots (zero tiles, row
block 0) and the clamped ``panel_nodes`` past the rank-space end (x's
last rank against zero cells) all multiply x rows by zeros, so a
non-finite x there turns rows into NaN, in the plain version and in the
kernel alike.

The kernel walks a work plan (:func:`bcsr_plan`, built once a prepared
operand and width): every tile once, panel-major in either layout, so a
run of one panel's tiles stages it once (once a band, where bands of row
blocks whose output rows fit in L2 pay in its byte model), and the
partial rows of consecutive tiles of one row block are summed before
they are added.

:func:`bcsr_plain` is the same product in plain PyTorch, in bounded
groups (no panel table of all ``n_panels · 128`` rows and no
``(slots, H)`` buffer of the whole tier); the CPU tests hold it to the
reference and ``chip_smoke.py`` holds the kernel to it on the card.
:func:`bcsr_add` takes it for CPU tensors only. Counted in
:data:`launches`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pygim_tpu_torch.core.bcsr import TILE_COLS
from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (a plain int; launches only), and
# the same by route (:func:`route_key`)
launches = 0
route_launches: dict = {}

KINDS = ("row", "panel")
TILE_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the kernel's payload codes by x dtype; a float32 x rounded to
# round(x / safe) is 4 (csrc/payload.cuh)
PAYLOADS = {torch.float32: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
            torch.bfloat16: 5}
_QUANT = 4
MAX_TILE_ROWS = 64  # the kernel's Tr: up to four 16-row MMA tiles
GROUP_BYTES = 64 << 20  # the plain version's gather and partials a group


# the kernel's routes: (products a term, tensor-core rate) — bf16 parts on
# bf16 tiles, TF32 hi / lo on f32 tiles (csrc/bcsr.cu)
ROUTES = {"bf16": (1, "bf16"), "bf16x2": (2, "bf16"), "bf16x3": (3, "bf16"),
          "tf32x2": (2, "tf32"), "tf32x3": (3, "tf32")}


def compute_mode(tiles_dtype, x_dtype, safe=None) -> str:
    """``"bf16"`` or ``"f32"``: the reference's compute dtype of the tier
    (``cdt``, ``pygim_tpu/ops/spmm.py:663, 717, 1632-1641, 1863-1867``):
    bf16 tiles with a float32, bfloat16 or int8 x take bf16; int16 and
    int32 x (raw, or the int16 table), a rounded x (``safe``: the int32
    quantized aggregate; int8 and int16 read their integer tables) and
    f32 tiles take f32."""
    if (tiles_dtype == torch.bfloat16 and safe is None
            and x_dtype in (torch.float32, torch.bfloat16, torch.int8)):
        return "bf16"
    return "f32"


def kernel_route(tiles_dtype, x_dtype, safe=None):
    """The kernel's route for these operands (:data:`ROUTES`) and its
    payload parts: f32 tiles take ``tf32x2`` for an int8 or bfloat16 x
    (exact in TF32) and ``tf32x3`` for any other; bf16 tiles take ``bf16``
    where :func:`compute_mode` is bf16, ``bf16x2`` for an int16 x (every
    value of 16 significant bits is two bf16 parts) and ``bf16x3`` for an
    int32 x or a rounded x (any f32 is three). Returns ``(route,
    parts)``."""
    if tiles_dtype == torch.float32:
        exact = safe is None and x_dtype in (torch.int8, torch.bfloat16)
        return ("tf32x2", 1) if exact else ("tf32x3", 2)
    if compute_mode(tiles_dtype, x_dtype, safe) == "bf16":
        return "bf16", 1
    if safe is None and x_dtype == torch.int16:
        return "bf16x2", 2
    return "bf16x3", 3


def route_key(tiles_dtype, x_dtype, safe=None) -> str:
    """The launch counter's key of a launch: its route, and " rounded"
    for a rounded payload."""
    route = kernel_route(tiles_dtype, x_dtype, safe)[0]
    return route + (" rounded" if safe is not None else "")


def route_keys() -> list:
    """Every key :func:`route_key` gives: the routes, and the two a
    rounded payload takes."""
    return list(ROUTES) + ["bf16x3 rounded", "tf32x3 rounded"]


def _payload(x, safe, cdt):
    """x rows as the tier multiplies them, in f32: rounded to ``round(x /
    safe)`` where ``safe`` is given, then rounded to the compute dtype
    ``cdt`` and widened exactly."""
    if safe is not None:
        x = torch.round(x / safe)
    return x.to(cdt).float()


def bcsr_plain(x, kind, tiles, panel_idx, rb, panel_nodes, row_nodes, out,
               safe=None):
    """The tier's product into ``out`` (in place; returned) in plain
    PyTorch: per group of virtual blocks (row kind) or virtual panels
    (panel kind), the panels gathered from x, one batched f32 product of
    the tiles and the panels in the compute dtype's values
    (:func:`compute_mode`), and ``index_add_`` of
    the partial rows, as the reference's einsum and scatter-add. A group
    holds about :data:`GROUP_BYTES` of gathered rows and partials."""
    cdt = (torch.bfloat16 if compute_mode(tiles.dtype, x.dtype, safe) == "bf16"
           else torch.float32)
    n, slots, tr, tc = tiles.shape
    h = x.shape[1]
    if n == 0 or h == 0:
        return out
    pn = panel_nodes.long().view(-1, tc)
    rn = row_nodes.long().view(-1, tr)
    if kind == "row":
        per = (slots * tc + tr) * h * 4 + slots * tr * tc * 4
    else:
        per = (tc + slots * tr) * h * 4 + slots * tr * tc * 4
    group = max(1, GROUP_BYTES // per)
    for lo in range(0, n, group):
        hi = min(lo + group, n)
        t = tiles[lo:hi].float()
        p = _payload(x.index_select(0, pn[panel_idx[lo:hi].long()]
                                    .reshape(-1)), safe, cdt)
        if kind == "row":  # (g, Tr, S·128) @ (g, S·128, H)
            o = torch.bmm(t.permute(0, 2, 1, 3).reshape(hi - lo, tr,
                                                        slots * tc),
                          p.view(hi - lo, slots * tc, h))
        else:  # (g, T·Tr, 128) @ (g, 128, H)
            o = torch.bmm(t.view(hi - lo, slots * tr, tc),
                          p.view(hi - lo, tc, h))
        dest = rn[rb[lo:hi].long()]
        out.index_add_(0, dest.reshape(-1), o.reshape(-1, h))
    return out


# The work plan (bcsr_plan): a band's output rows at f32 take at most
# about half of the H100's 50 MB L2, so that its adds stay there; an add
# inside such a band is modelled at L2_ADD_COST of one to HBM, fitted to
# the full-size three-tier tiers timed with bands forced off and on
# (chip_smoke.py --bcsr-full: they paid on the panel tier and lost on the
# row tier; PERF.md §6); an item holds at most ITEM_TILES tiles of
# one panel, so a hub panel is split for the persistent grid.
L2_BAND_BYTES = 24 << 20
L2_ADD_COST = 0.8
ITEM_TILES = 64


@dataclasses.dataclass
class BcsrPlan:
    """K-bcsr's walk of a tier's tables (:func:`bcsr_plan`).

    ``entries`` int32 ``(n · slots, 2)``: every tile of the tables once,
    pads included, as (flat tile index into ``(n · slots)``, row block),
    in the kernel's order: band, then panel, then row block, then the
    tables' order. ``items`` int32 ``(n_items, 4)``: (first entry, end
    entry, panel, band), a run of one panel's entries in one band, at
    most :data:`ITEM_TILES` long; band-major, longest first inside a
    band. The rest is the byte model at ``h``: ``band_rb`` row blocks a
    band (0: no bands), ``bands``, ``stages`` (panels staged: one an
    item), ``adds`` (row-block flushes: runs of one row block inside an
    item), ``model`` (bytes by part) and ``model_bytes`` (their sum)."""

    entries: torch.Tensor
    items: torch.Tensor
    band_rb: int
    bands: int
    stages: int
    adds: int
    model: dict
    model_bytes: float

    def to(self, device) -> "BcsrPlan":
        return dataclasses.replace(self, entries=self.entries.to(device),
                                   items=self.items.to(device))


def _host(t) -> np.ndarray:
    """A table as int64 numpy, from a tensor on any device."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.asarray(t, dtype=np.int64)


def _flat(kind, panel_idx, rb):
    """Every tile's (panel, row block) in the tables' flat order."""
    pidx, rbs = _host(panel_idx), _host(rb)
    if kind == "panel":
        return np.repeat(pidx, rbs.shape[1]), rbs.reshape(-1)
    return pidx.reshape(-1), np.repeat(rbs, pidx.shape[1])


def plan_tables(kind, panel_idx, rb, tr, h, band_rb, tile_bytes=2,
                x_itemsize=4) -> BcsrPlan:
    """The plan of :func:`bcsr_plan` with ``band_rb`` row blocks a band
    (0: one band of all), on the CPU. ``panel_idx`` / ``rb`` are the
    tables of ``bcsr_add`` (numpy, or tensors on any device)."""
    panel, rows = _flat(kind, panel_idx, rb)
    n = panel.size
    _, compact = np.unique(rows, return_inverse=True)
    band = compact // band_rb if band_rb else np.zeros(n, np.int64)
    order = np.lexsort((np.arange(n), rows, panel, band))
    p, r, b = panel[order], rows[order], band[order]
    # runs of one (band, panel), cut into items of at most ITEM_TILES
    cut = np.flatnonzero((p[1:] != p[:-1]) | (b[1:] != b[:-1])) + 1
    runs = np.diff(np.concatenate([[0], cut, [n]]))
    starts = np.concatenate([[0], cut])
    pieces = -(-runs // ITEM_TILES)
    first, end = [], []
    for s, ln, k in zip(starts.tolist(), runs.tolist(), pieces.tolist()):
        bounds = [s + (ln * j) // k for j in range(k + 1)]
        first += bounds[:-1]
        end += bounds[1:]
    first, end = np.asarray(first, np.int64), np.asarray(end, np.int64)
    ib = b[first]
    # band-major, longest first inside a band, then in order
    io = np.lexsort((first, first - end, ib))
    first, end, ib = first[io], end[io], ib[io]
    items = np.stack([first, end, p[first], ib], axis=1)
    # a flush wherever the row block changes inside an item
    new_rb = np.ones(n, bool)
    new_rb[1:] = r[1:] != r[:-1]
    new_rb[first] = True
    adds = int(new_rb.sum())
    row_bytes = tr * h * 4  # a row block of out, f32
    model = dict(tiles=n * tr * 128 * tile_bytes,
                 stages=len(items) * 128 * h * x_itemsize,
                 adds_hbm=0.0, adds_l2=0.0, band_rows=0)
    n_bands = int(b.max()) + 1 if n else 0
    band_adds = np.bincount(b[new_rb], minlength=n_bands)
    n_rb = int(compact.max()) + 1 if n else 0
    band_rbs = np.bincount(np.arange(n_rb) // (band_rb or max(1, n_rb)),
                           minlength=n_bands)
    for k in range(n_bands):
        if band_rbs[k] * row_bytes <= L2_BAND_BYTES:
            model["adds_l2"] += L2_ADD_COST * band_adds[k] * 2 * row_bytes
            model["band_rows"] += int(band_rbs[k]) * 2 * row_bytes
        else:
            model["adds_hbm"] += float(band_adds[k]) * 2 * row_bytes
    entries = np.stack([order, r], axis=1)
    return BcsrPlan(
        entries=torch.from_numpy(entries.astype(np.int32)),
        items=torch.from_numpy(items.astype(np.int32)),
        band_rb=int(band_rb), bands=n_bands, stages=len(items), adds=adds,
        model=model, model_bytes=float(sum(model.values())))


def bcsr_plan(kind, panel_idx, rb, tr, h, tile_bytes=2, x_itemsize=4,
              device=None) -> BcsrPlan:
    """K-bcsr's work plan for a tier's tables at width ``h`` (on
    ``device``; built on the CPU): both layouts walked panel-major, so
    each panel is staged once, or once a band. Bands cut the tables'
    row blocks in use, in order, into groups whose ``h``-wide f32 output
    rows fit in :data:`L2_BAND_BYTES`; the plan takes them where its
    byte model (:class:`BcsrPlan`: the tiles, ``128 · h · x_itemsize`` a
    staged panel, ``2 · tr · h · 4`` an add, an add inside a band that
    fits in L2 at :data:`L2_ADD_COST` of that plus the band's output rows
    read and written once) is lower than without them."""
    panel_idx, rb = _host(panel_idx), _host(rb)
    band_rb = max(1, L2_BAND_BYTES // (tr * h * 4))
    plan = plan_tables(kind, panel_idx, rb, tr, h, 0, tile_bytes, x_itemsize)
    if plan.model["adds_l2"] == 0 and np.unique(rb).size > band_rb:
        banded = plan_tables(kind, panel_idx, rb, tr, h, band_rb, tile_bytes,
                             x_itemsize)
        if banded.model_bytes < plan.model_bytes:
            plan = banded
    return plan if device is None else plan.to(device)


def _check(x, kind, tiles, panel_idx, rb, panel_nodes, row_nodes, out,
           safe) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if x.dim() != 2 or x.dtype not in PAYLOADS:
        raise TypeError(f"x must be 2-D float32, bfloat16, int8, int16 or "
                        f"int32, got {x.dtype} {tuple(x.shape)}")
    if safe is not None and (x.dtype != torch.float32
                             or safe.dtype != torch.float32
                             or safe.dim() != 0 or safe.device != out.device):
        raise TypeError("a rounded payload takes a float32 x and safe a "
                        f"0-dim float32 tensor on {out.device}")
    if (tiles.dtype not in TILE_DTYPES or tiles.dim() != 4
            or tiles.shape[3] != TILE_COLS):
        raise TypeError(f"tiles must be bfloat16 or float32 (n, slots, Tr, "
                        f"{TILE_COLS}), got {tiles.dtype} "
                        f"{tuple(tiles.shape)}")
    n, slots, tr, _ = tiles.shape
    want = ((n, slots), (n,)) if kind == "row" else ((n,), (n, slots))
    for name, t, shape in (("panel_idx", panel_idx, want[0]),
                           ("rb", rb, want[1])):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be int32 {shape} for the {kind} "
                            f"kind, got {t.dtype} {tuple(t.shape)}")
    for name, t, q in (("panel_nodes", panel_nodes, TILE_COLS),
                       ("row_nodes", row_nodes, tr)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] % q:
            raise TypeError(f"{name} must be 1-D int32 of a multiple of {q}, "
                            f"got {t.dtype} {tuple(t.shape)}")
    if (out.dtype != torch.float32 or out.dim() != 2
            or out.shape[1] != x.shape[1]):
        raise TypeError(f"out must be float32 (N, {x.shape[1]}), got "
                        f"{out.dtype} {tuple(out.shape)}")
    devs = {t.device for t in (x, tiles, panel_idx, rb, panel_nodes,
                               row_nodes, out)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    for name, t in (("x", x), ("tiles", tiles), ("panel_idx", panel_idx),
                    ("rb", rb), ("panel_nodes", panel_nodes),
                    ("row_nodes", row_nodes), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bcsr_add(x, kind, tiles, panel_idx, rb, panel_nodes, row_nodes, out,
             safe=None, plan=None):
    """Add the tier's product into ``out`` (in place; returned): ``kind``
    "row" (``panel_idx`` ``(n, S)``, ``rb`` = ``vblock_to_rb`` ``(n,)``)
    or "panel" (``panel_idx`` ``(n,)``, ``rb`` = ``tile_rb`` ``(n, T)``);
    tiles bfloat16 or float32 ``(n, S or T, Tr, 128)``; x float32,
    bfloat16, int8, int16 or int32, or float32 rounded to ``round(x /
    safe)`` where ``safe`` is given. CPU tensors take :func:`bcsr_plain`;
    CUDA tensors launch the kernel once, on the route of
    :func:`kernel_route`, on ``plan``
    (:func:`bcsr_plan` of these tables on ``out``'s device; built here
    where it is None), any H and ``Tr <= 64``, tiles 16-byte aligned, or
    raise."""
    global launches
    _check(x, kind, tiles, panel_idx, rb, panel_nodes, row_nodes, out, safe)
    _build.refuse_grad("bcsr_add", x, out)
    if out.device.type == "cpu":
        return bcsr_plain(x, kind, tiles, panel_idx, rb, panel_nodes,
                          row_nodes, out, safe)
    if out.device.type != "cuda":
        raise ValueError(f"no K-bcsr kernel for device {out.device}")
    n, slots, tr, _ = tiles.shape
    if tr > MAX_TILE_ROWS:
        raise ValueError(f"K-bcsr takes tiles of at most {MAX_TILE_ROWS} "
                         f"rows, got {tr}")
    if tiles.data_ptr() % 16:
        raise ValueError("K-bcsr reads tiles in 16-byte pieces: tiles must "
                         "be 16-byte aligned")
    h = x.shape[1]
    if n == 0 or h == 0:
        return out
    if plan is None:
        plan = bcsr_plan(kind, panel_idx, rb, tr, h,
                         tile_bytes=tiles.element_size(), device=out.device)
    if (plan.entries.shape != (n * slots, 2) or plan.entries.device
            != out.device or plan.items.device != out.device):
        raise ValueError(f"a plan of {tuple(plan.entries.shape)} entries on "
                         f"{plan.entries.device} for {n * slots} tiles on "
                         f"{out.device}")
    _route, parts = kernel_route(tiles.dtype, x.dtype, safe)
    payload = PAYLOADS[x.dtype] if safe is None else _QUANT
    # the adds' width: four floats where every row of out is 16-byte
    # aligned, two where 8-byte aligned
    vec = next(v for v in (4, 2, 1)
               if h % v == 0 and out.data_ptr() % (4 * v) == 0)
    lib = _build.load("bcsr")
    with torch.cuda.device(out.device):
        err = lib.bcsr_add(
            tiles.data_ptr(), TILE_DTYPES[tiles.dtype], n * slots, tr,
            plan.entries.data_ptr(), plan.items.data_ptr(),
            plan.items.shape[0], panel_nodes.data_ptr(),
            row_nodes.data_ptr(), x.data_ptr(), payload,
            None if safe is None else safe.data_ptr(), parts,
            out.data_ptr(), h, vec, _build.stream_of(out))
    _build.check(err, "bcsr_add")
    launches += 1
    key = route_key(tiles.dtype, x.dtype, safe)
    route_launches[key] = route_launches.get(key, 0) + 1
    return out
