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
``round(x / safe)``, f32 tiles) computes in f32. ``out`` is the port's
float32 ``(N, H)``, added into; the reference adds integer payloads'
partials into an int32 output, which agrees wherever partial sums are
integers below 2^24.

Pads read x as the reference's do: pad virtual blocks (zero tiles,
panel 0, the last row block), panel-kind pad slots (zero tiles, row
block 0) and the clamped ``panel_nodes`` past the rank-space end (x's
last rank against zero cells) all multiply x rows by zeros, so a
non-finite x there turns rows into NaN, in the plain version and in the
kernel alike.

:func:`bcsr_plain` is the same product in plain PyTorch, in bounded
groups (no panel table of all ``n_panels · 128`` rows and no
``(slots, H)`` buffer of the whole tier); the CPU tests hold it to the
reference and ``chip_smoke.py`` holds the kernel to it on the card.
:func:`bcsr_add` takes it for CPU tensors only. Counted in
:data:`launches`.
"""

from __future__ import annotations

import torch

from pygim_tpu_torch.core.bcsr import TILE_COLS
from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (a plain int; launches only)
launches = 0

KINDS = ("row", "panel")
TILE_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the kernel's payload codes by x dtype; a float32 x rounded to
# round(x / safe) is 4 (csrc/payload.cuh)
PAYLOADS = {torch.float32: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
            torch.bfloat16: 5}
_QUANT = 4
MAX_TILE_ROWS = 64  # the kernel's Tr: up to four 16-row MMA tiles
MAX_GROUP = 32  # work items a block at most (work_group)
GROUP_BYTES = 64 << 20  # the plain version's gather and partials a group


def compute_mode(tiles_dtype, x_dtype, safe=None) -> str:
    """``"bf16"`` or ``"f32"``: the reference's compute dtype of the tier
    (``cdt``, ``pygim_tpu/ops/spmm.py:663, 717, 1632-1641, 1863-1867``):
    bf16 tiles with a float32, bfloat16 or int8 x take bf16; int16 and
    int32 x (raw, or the int16 table), a rounded x (``safe``) and f32
    tiles take f32."""
    if (tiles_dtype == torch.bfloat16 and safe is None
            and x_dtype in (torch.float32, torch.bfloat16, torch.int8)):
        return "bf16"
    return "f32"


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
    (:func:`compute_mode`), and ``index_add_`` of the partial rows, as the
    reference's einsum and scatter-add. A group holds about
    :data:`GROUP_BYTES` of gathered rows and partials."""
    cdt = (torch.bfloat16 if compute_mode(tiles.dtype, x.dtype, safe)
           == "bf16" else torch.float32)
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


def work_group(kind, n, n_panels, n_rb) -> int:
    """Consecutive work items a block of the kernel takes, for ``n``
    virtual blocks (row kind) or virtual panels (panel kind) over tables of
    ``n_panels`` panels and ``n_rb`` row blocks: the items a panel (panel
    kind: a block keeps a staged panel while its items read it) or a row
    block (row kind: a block sums a row block's items in registers), as
    the power of two at or below it, from 1 to :data:`MAX_GROUP`. The
    builders keep only the panels and row blocks in use and sort the items
    by them, so the quotient is the mean run of items that share one;
    fewer items a block, more blocks in flight."""
    per = n / max(1, n_panels if kind == "panel" else n_rb)
    g = 1
    while g * 2 <= min(per, MAX_GROUP):
        g *= 2
    return g


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
             safe=None):
    """Add the tier's product into ``out`` (in place; returned): ``kind``
    "row" (``panel_idx`` ``(n, S)``, ``rb`` = ``vblock_to_rb`` ``(n,)``)
    or "panel" (``panel_idx`` ``(n,)``, ``rb`` = ``tile_rb`` ``(n, T)``);
    tiles bfloat16 or float32 ``(n, S or T, Tr, 128)``; x float32,
    bfloat16, int8, int16 or int32, or float32 rounded to ``round(x /
    safe)`` where ``safe`` is given (module docstring). CPU tensors take
    :func:`bcsr_plain`; CUDA tensors launch the kernel once, any H and
    ``Tr <= 64``, tiles 16-byte aligned, or raise; a block takes
    :func:`work_group` work items."""
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
    mma = compute_mode(tiles.dtype, x.dtype, safe) == "bf16"
    payload = PAYLOADS[x.dtype] if safe is None else _QUANT
    # the adds' width: four floats where every row of out is 16-byte
    # aligned, two where 8-byte aligned
    vec = next(v for v in (4, 2, 1)
               if h % v == 0 and out.data_ptr() % (4 * v) == 0)
    lib = _build.load("bcsr")
    with torch.cuda.device(out.device):
        err = lib.bcsr_add(
            tiles.data_ptr(), TILE_DTYPES[tiles.dtype], panel_idx.data_ptr(),
            rb.data_ptr(), panel_nodes.data_ptr(), row_nodes.data_ptr(),
            KINDS.index(kind), n, slots, tr,
            work_group(kind, n, panel_nodes.shape[0] // TILE_COLS,
                       row_nodes.shape[0] // tr),
            x.data_ptr(), payload,
            None if safe is None else safe.data_ptr(), int(mma),
            out.data_ptr(), h, vec, _build.stream_of(out))
    _build.check(err, "bcsr_add")
    launches += 1
    return out
