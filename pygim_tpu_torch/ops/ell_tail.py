"""K-tail: the ELL gather-weight-reduce of the hybrid SpMM's tail.

Counterpart of ``pygim_tpu/ops/spmm.py:ell_scan_spmm`` /
``_ell_grouped_scan`` (the XLA body the reference runs per table). The
CUDA kernel is ``csrc/ell_tail.cu``: one launch over every ELL table of
an SpMM, walking a unit list built here on the host (:func:`tail_plan`).

A table in step layout holds ``cols2d`` / ``vals2d`` of shape
``(n_steps, chunk·D)`` and ``vrow_to_row`` of shape ``(n_steps, chunk)``,
non-decreasing. For every virtual row ``v``::

    out[vrow_to_row[v]] += Σ_d vals[v, d] · x[cols[v, d]]

x is one of four payload modes, each weighted by the f32 vals and
summed in f32: (i) float32 rows as they are (the float path; the tail
does not round to bf16); (ii) int8, int16 or int32 rows widened to f32
(``ell_scan_spmm`` on integer rows, whose accumulation dtype is f32);
(iii) float32 rows rounded in the consumer to ``round(x / safe)``, the
correctly rounded quotient rounded half to even, with ``safe`` a 0-dim
float32 tensor on x's device (``ell_scan_spmm_quant``, the int32
quantized aggregate); the kernel takes the quotient from one reciprocal
a thread and a correction step, not a division per element; (iv)
bfloat16 rows widened exactly to f32 (``ell_scan_spmm`` on a bf16
payload, ``pygim_tpu/ops/spmm.py:489-493``).
The kernel takes any width H on one of three paths (:func:`kernel_path`):
bf16 rows at H % 8 == 0 with x and out 16-byte aligned gather 16 bytes a
lane straight into registers (path (c)); the other modes at rows of a
multiple of 16 bytes so aligned bulk-copy x rows into shared memory
(path (b)); every other width or alignment reads x into registers
element by element (path (a)).
It reads only the slots up to each virtual row's last nonzero
weight, so a non-finite x row that only pad slots (or trailing zero
weights) reach does not spread NaN, where the plain version and the
reference spread it; for finite x the two agree up to f32 summation order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pygim_tpu_torch.ops import _build

# kernel launches since the last reset (plain ints; launches only): K-tail
# on float32 rows, K-tail-quant on integer or rounded rows, and K-tail on
# bf16 rows
launches = 0
quant_launches = 0
bf16_launches = 0

# the kernel's payload codes by x dtype (mode (iii), rounded f32, is 4)
PAYLOADS = {torch.float32: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
            torch.bfloat16: 5}
_QUANT = 4
_BF16 = PAYLOADS[torch.bfloat16]

UNIT_SLOTS = 128   # stored slots a work unit aims at (its rows follow D)
UNIT_MAX_ROWS = 32  # virtual rows a unit holds at most: one per lane
MAX_TABLES = 256   # tables one plan carries (8 bits of a unit's word)


def ell_tail_plain(x, cols2d, vals2d, vrow_to_row, degree: int, out,
                   safe=None):
    """The same sum in plain PyTorch, one step at a time as the reference
    scans, so the largest temporary is one step's (chunk·D, H) gather.
    ``safe`` selects payload mode (iii)."""
    h = x.shape[1]
    chunk = vrow_to_row.shape[1]
    for s in range(cols2d.shape[0]):
        g = x.index_select(0, cols2d[s])
        g = g.float() if safe is None else torch.round(g / safe)
        g = g * vals2d[s][:, None]
        out.index_add_(0, vrow_to_row[s], g.view(chunk, degree, h).sum(1))
    return out


def ell_tables_plain(x, tables, out, safe=None):
    """:func:`ell_tail_plain` over ``tables``, ``[(cols2d, vals2d,
    vrow_to_row, degree)]``, in order."""
    for cols2d, vals2d, vrow_to_row, degree in tables:
        ell_tail_plain(x, cols2d, vals2d, vrow_to_row, degree, out, safe)
    return out


def real_entries(tables):
    """``(rows, cols, vals)`` of the nonzero slots of step-layout
    ``tables`` (the entries K-tail reads), rows and cols int64."""
    rows_l, cols_l, vals_l = [], [], []
    for c, v, r, degree in tables:
        keep = v.reshape(-1) != 0
        rows_l.append(r.reshape(-1).repeat_interleave(degree)[keep])
        cols_l.append(c.reshape(-1)[keep])
        vals_l.append(v.reshape(-1)[keep])
    return (torch.cat(rows_l).long(), torch.cat(cols_l).long(),
            torch.cat(vals_l))


def _check_payload(x, safe, out) -> None:
    if x.dtype not in PAYLOADS or x.dim() != 2:
        raise TypeError(f"x must be 2-D float32, bfloat16, int8, int16 or "
                        f"int32, got {x.dtype} {tuple(x.shape)}")
    if safe is None:
        return
    if x.dtype != torch.float32:
        raise TypeError(f"a rounded payload (safe given) must be float32, "
                        f"got {x.dtype}")
    if (safe.dtype != torch.float32 or safe.dim() != 0
            or safe.device != out.device):
        raise TypeError(f"safe must be a 0-dim float32 tensor on {out.device}, "
                        f"got {safe.dtype} {tuple(safe.shape)} on {safe.device}")


def _check(x, cols2d, vals2d, vrow_to_row, degree, out) -> None:
    if cols2d.dtype != torch.int32 or cols2d.dim() != 2:
        raise TypeError(f"cols2d must be 2-D int32, got {cols2d.dtype}")
    if vals2d.dtype != torch.float32 or vals2d.shape != cols2d.shape:
        raise TypeError(
            f"vals2d must be float32 of shape {tuple(cols2d.shape)}, got "
            f"{vals2d.dtype} {tuple(vals2d.shape)}"
        )
    if vrow_to_row.dtype != torch.int32 or vrow_to_row.dim() != 2:
        raise TypeError(f"vrow_to_row must be 2-D int32, got {vrow_to_row.dtype}")
    n_steps, cd = cols2d.shape
    if (degree < 1 or vrow_to_row.shape[0] != n_steps
            or vrow_to_row.shape[1] * degree != cd):
        raise ValueError(
            f"tables disagree: cols2d {tuple(cols2d.shape)}, vrow_to_row "
            f"{tuple(vrow_to_row.shape)}, degree {degree}"
        )
    if out.dtype != torch.float32 or out.dim() != 2 or out.shape[1] != x.shape[1]:
        raise TypeError(
            f"out must be float32 (N, {x.shape[1]}), got {out.dtype} "
            f"{tuple(out.shape)}"
        )
    devs = {t.device for t in (x, cols2d, vals2d, vrow_to_row, out)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    for name, t in (("x", x), ("cols2d", cols2d), ("vals2d", vals2d),
                    ("vrow_to_row", vrow_to_row), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def slot_counts(vals2d: np.ndarray, degree: int) -> np.ndarray:
    """Per virtual row, 1 + the index of its last nonzero weight (0 for a
    row of zeros): the slots the kernel reads. A zero weight before a
    nonzero one is kept."""
    nz = np.asarray(vals2d).reshape(-1, degree) != 0
    last = degree - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), last, 0).astype(np.int32)


def unit_rows(degree: int) -> int:
    """Virtual rows a work unit holds: about :data:`UNIT_SLOTS` slots, at
    most :data:`UNIT_MAX_ROWS`."""
    return max(1, min(UNIT_MAX_ROWS, UNIT_SLOTS // degree))


def plan_units(vrows, counts, degrees) -> "tuple[np.ndarray, list[int]]":
    """The kernel's work list over tables with virtual-row targets
    ``vrows[i]`` (flat, non-decreasing) and slot counts ``counts[i]``.

    A table's virtual rows past its last counted one (the planner's pads)
    are in no unit. The rest are cut into units of at most
    ``unit_rows(D)`` virtual rows that hold whole runs of equal rows; a
    run longer than that is cut into pieces of its own, which add
    atomically. A unit whose rows another table also holds adds
    atomically too (the planner's tables hold disjoint rows). Units go
    with the most stored slots first.

    Returns ``(units, n_real)``: ``units`` int32 ``(n, 4)`` rows ``(table,
    first virtual row, count, atomic)``, and each table's count of
    scheduled virtual rows."""
    if len(vrows) > MAX_TABLES:
        raise ValueError(f"at most {MAX_TABLES} tables a plan, got {len(vrows)}")
    reals = []
    for r, c in zip(vrows, counts):
        live = np.flatnonzero(c)
        n = int(live[-1]) + 1 if live.size else 0
        if n and np.any(np.diff(r[:n]) < 0):
            raise ValueError("vrow_to_row must be non-decreasing")
        reals.append(n)
    seen = np.concatenate([np.unique(r[:n]) for r, n in zip(vrows, reals)]
                          + [np.zeros(0, np.int64)])
    rows, times = np.unique(seen, return_counts=True)
    shared = rows[times > 1]
    units, slots = [], []
    for t, (r, c, d, n) in enumerate(zip(vrows, counts, degrees, reals)):
        r = r[:n]
        cap = unit_rows(d)
        starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]]) if n else []
        lens = np.diff(np.r_[starts, n]).tolist()
        mine = []  # (first, count, atomic)
        first = count = 0
        for s, run in zip(np.asarray(starts).tolist(), lens):
            if run > cap:
                if count:
                    mine.append((first, count, 0))
                    count = 0
                mine.extend((s + o, min(cap, run - o), 1)
                            for o in range(0, run, cap))
            elif count + run <= cap:
                first = first if count else s
                count += run
            else:
                mine.append((first, count, 0))
                first, count = s, run
        if count:
            mine.append((first, count, 0))
        if not mine:
            continue
        m = np.asarray(mine, dtype=np.int64)
        csum = np.r_[0, np.cumsum(c[:n], dtype=np.int64)]
        hit = np.r_[0, np.cumsum(np.isin(r, shared), dtype=np.int64)]
        end = m[:, 0] + m[:, 1]
        atomic = m[:, 2] | (hit[end] > hit[m[:, 0]])
        units.append(np.stack([np.full(len(m), t), m[:, 0], m[:, 1], atomic], 1))
        slots.append(csum[end] - csum[m[:, 0]])
    if not units:
        return np.zeros((0, 4), np.int32), reals
    units = np.concatenate(units)
    order = np.argsort(-np.concatenate(slots), kind="stable")
    return units[order].astype(np.int32), reals


@dataclasses.dataclass
class TailPlan:
    """What one K-tail launch over fixed tables needs: each table's slot
    counts (on the tables' device), the unit list packed for the kernel,
    the kernel's table descriptors, and what they were built for (the
    tables' addresses and degrees). A plan is bound to its tables' storage
    and contents: a prepared operand's tables never change."""

    key: tuple
    n_real: list
    counts: list
    units: np.ndarray
    packed: torch.Tensor
    tabs: torch.Tensor

    @property
    def n_units(self) -> int:
        return int(self.units.shape[0])


def _key(tables) -> tuple:
    return tuple((c.data_ptr(), v.data_ptr(), r.data_ptr(), int(d))
                 for c, v, r, d in tables)


def tail_plan(tables, host=None) -> TailPlan:
    """The plan of one grouped call over ``tables``, ``[(cols2d, vals2d,
    vrow_to_row, degree)]``, built once and passed to every call of
    :func:`ell_tables_add`. ``host`` gives the tables' ``(vals2d,
    vrow_to_row)`` as numpy arrays where the caller has them; otherwise
    they are copied from the tables (a synchronising copy from the card).
    """
    if host is None:
        host = [(v.cpu().numpy(), r.cpu().numpy()) for _c, v, r, _d in tables]
    degrees = [int(d) for *_t, d in tables]
    counts = [slot_counts(v, d) for (v, _r), d in zip(host, degrees)]
    vrows = [np.asarray(r).reshape(-1) for _v, r in host]
    units, n_real = plan_units(vrows, counts, degrees)
    dev = tables[0][0].device if tables else torch.device("cpu")
    counts_t = [torch.from_numpy(c).to(dev) for c in counts]
    packed = units[:, 0] | (units[:, 2] - 1) << 8 | units[:, 3] << 13
    packed = torch.from_numpy(
        np.ascontiguousarray(np.stack([units[:, 1], packed], 1), np.int32)
    ).to(dev)
    tabs = torch.tensor(
        [[c.data_ptr(), v.data_ptr(), r.data_ptr(), n.data_ptr(), d]
         for (c, v, r, d), n in zip(tables, counts_t)],
        dtype=torch.int64,
    ).reshape(-1, 5).to(dev)
    return TailPlan(key=_key(tables), n_real=n_real, counts=counts_t,
                    units=units, packed=packed, tabs=tabs)


def kernel_path(x, out) -> str:
    """The path the kernel takes for ``x`` into ``out`` on the card
    (``csrc/ell_tail.cu``): where a row is a multiple of 16 bytes (H % 8
    for bf16 and int16, H % 4 for 4-byte rows, H % 16 for int8) and x and
    out are 16-byte aligned, ``"lanes"`` (c) for bf16 rows and ``"bulk"``
    (b) for the other modes; else ``"registers"`` (a)."""
    if (x.shape[1] * x.element_size() % 16 or x.data_ptr() % 16
            or out.data_ptr() % 16):
        return "registers"
    return "lanes" if x.dtype == torch.bfloat16 else "bulk"


def ell_tables_add(x, tables, out, plan=None, safe=None):
    """Add every ELL table's product into ``out`` (in place; returned):
    ``tables`` is ``[(cols2d, vals2d, vrow_to_row, degree)]``, each
    ``vrow_to_row`` non-decreasing, as prepare builds them; x float32,
    bfloat16, int8, int16 or int32, or float32 rounded to ``round(x /
    safe)`` where ``safe`` is given (module docstring). CPU tensors take
    :func:`ell_tables_plain`; CUDA tensors launch the kernel once for all
    tables, any H, or raise, on :func:`kernel_path`'s path.
    ``plan`` (:func:`tail_plan` of these tables) is built here when not
    given."""
    global launches, quant_launches, bf16_launches
    _check_payload(x, safe, out)
    _build.refuse_grad("ell_tables_add", x, out)
    for cols2d, vals2d, vrow_to_row, degree in tables:
        _check(x, cols2d, vals2d, vrow_to_row, degree, out)
    if out.device.type == "cpu":
        return ell_tables_plain(x, tables, out, safe)
    if out.device.type != "cuda":
        raise ValueError(f"no K-tail kernel for device {out.device}")
    if plan is None:
        plan = tail_plan(tables)
    elif plan.key != _key(tables) or plan.tabs.device != out.device:
        raise ValueError("K-tail plan was built for other tables")
    h = x.shape[1]
    if plan.n_units == 0 or h == 0 or x.shape[0] == 0:
        return out
    vec = kernel_path(x, out) != "registers"
    payload = PAYLOADS[x.dtype] if safe is None else _QUANT
    lib = _build.load("ell_tail")
    with torch.cuda.device(out.device):
        err = lib.ell_tables_add(
            plan.tabs.data_ptr(), plan.packed.data_ptr(), plan.n_units,
            x.data_ptr(), out.data_ptr(), h, int(vec), payload,
            None if safe is None else safe.data_ptr(), _build.stream_of(out),
        )
    _build.check(err, "ell_tables_add")
    if payload == _BF16:
        bf16_launches += 1
    elif payload:
        quant_launches += 1
    else:
        launches += 1
    return out


def ell_tail_add(x, cols2d, vals2d, vrow_to_row, degree: int, out):
    """One ELL table's product into ``out``: the one-table case of
    :func:`ell_tables_add` (on the card it plans the table each call)."""
    return ell_tables_add(x, [(cols2d, vals2d, vrow_to_row, degree)], out)
