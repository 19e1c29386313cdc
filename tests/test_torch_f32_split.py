"""K-f32's tensor-core route on the CPU: a NumPy emulation of its operand
split (TF32 rounding as ``cvt.rna``, the hi / lo split of f32 values, the
11-bit limbs of integer payloads and their recombination over two f32
accumulators) held to float64 and to the reference's ``_core_matmul``;
the payload prologue (``core_f32.payload_parts``) byte-equal to the
emulation's parts; the route each shape takes; the route's bound. The
CUDA kernel itself is held against ``core_f32_plain`` on the card by
chip_smoke.py.

Tolerances: where every partial sum of the reference's f32 dot is an
integer below 2^24 (a bf16 or small-integer f32 cell times an integer
payload, the sum of |terms| below 2^24) every product and sum of the
emulation is exact, so the two are bit-equal. Elsewhere 1e-5 of the sum
of |terms| (REL): the split drops ``a_lo b_lo`` and rounds the low parts
to TF32, about 3 · 2^-22 of each term, and the f32 sums of 512 terms
reorder, far inside 1e-5."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.ops import core_f32
from pygim_tpu_torch.utils.device import f32_bound, peaks

REL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16
NP = {torch.float32: np.float32, torch.bfloat16: ml_dtypes.bfloat16,
      torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32}


def np_tf32_rna(v):
    """f32 to TF32, to nearest, ties away from zero (``cvt.rna``): half a
    TF32 ulp added to the magnitude's bits, the low 13 bits cleared; NaN
    kept."""
    v = np.asarray(v, np.float32)
    bits = (v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(np.isnan(v), v, bits.view(np.float32))


def np_parts(x, cell):
    """The payload's parts, (K, H) each, f32 and exact in TF32."""
    pdt = {np.dtype(v): k for k, v in NP.items()}[x.dtype]
    kind = core_f32.PART_KINDS[(cell, pdt)]
    if kind == "exact":
        return [x.astype(np.float32)]
    if kind == "split":
        v = x.astype(np.float32)
        hi = np_tf32_rna(v)
        lo = np.where(np.isfinite(hi), v - hi, np.float32(0))
        return [hi, np_tf32_rna(lo)]
    q = x.astype(np.int64)
    n = 2 if x.dtype == np.int16 else 3
    out = []
    for _ in range(n - 1):
        d = ((q + 1024) & 2047) - 1024
        out.append(d)
        q = (q - d) >> 11
    out.append(q)
    return [(d.astype(np.float32) * np.float32(2.0 ** (11 * l)))
            for l, d in enumerate(out)]


def np_kernel(cells, cell, parts):
    """The kernel's arithmetic: f32 cells split in registers into a TF32
    hi and lo, bf16 cells whole; every product exact in f32; the first
    part's products (``a_hi b_0``, or a bf16 cell's low limb) into one f32
    accumulator, the rest (``a_hi b_1 + a_lo b_0``, or the upper limbs)
    into the other; their sum."""
    a = cells.astype(np.float32)
    if cell == F32:
        hi = np_tf32_rna(a)
        lo = np_tf32_rna(a - hi)
        acc0 = hi @ parts[0]
        acc1 = lo @ parts[0]
        if len(parts) > 1:
            acc1 = acc1 + hi @ parts[1]
    else:
        acc0 = a @ parts[0]
        acc1 = np.zeros_like(acc0)
        for p in parts[1:]:
            acc1 = acc1 + a @ p
    return (acc0.astype(np.float32) + acc1.astype(np.float32))


def core_matmul(cells, cell, x):
    """The reference's ``_core_matmul`` (f32 accumulation) as numpy."""
    core = jnp.asarray(cells, jnp.bfloat16 if cell == BF16 else jnp.float32)
    return np.asarray(jspmm._core_matmul(core, jnp.asarray(x), jnp.float32))


SPECIAL = np.array([0.0, -0.0, 1.0, 1.00048828125, -1.00048828125,
                    1.0009765625, 3.1415927, 2.0 ** -126, 2.0 ** -140,
                    -(2.0 ** -149), 3.4e38, -3.4e38, np.inf, -np.inf,
                    np.nan, 16777217.0, 65504.0, 1e-30], dtype=np.float32)


def test_tf32_rounding_matches_the_emulation():
    """The prologue's TF32 rounding equals the emulation's bit for bit,
    on ties (away from zero), subnormals, the largest finite values
    (rounding up to infinity), infinities, NaN and random values; it
    keeps 11 significant bits."""
    rng = np.random.default_rng(0)
    v = np.concatenate([SPECIAL, rng.standard_normal(4096)
                        * 2.0 ** rng.integers(-60, 60, 4096)]).astype(
                            np.float32)
    got = core_f32.tf32_rna(torch.from_numpy(v)).numpy()
    want = np_tf32_rna(v)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.all(got.view(np.uint32)[np.isfinite(got)] & 0x1FFF == 0)
    assert got[3] == np.float32(1.0009765625)   # a tie, away from zero
    assert got[4] == np.float32(-1.0009765625)
    fin = np.isfinite(v) & (np.abs(v) > 2.0 ** -126) & (np.abs(v) < 3e38)
    assert np.all(np.abs(got[fin] - v[fin]) <= np.abs(v[fin]) * 2.0 ** -11)


PAYLOADS = [(c, p) for c, p in core_f32.PART_KINDS]


def payload(p, rng, k, h, extremes=True):
    if p in (torch.float32, torch.bfloat16):
        x = (rng.standard_normal((k, h))
             * 2.0 ** rng.integers(-30, 30, (k, h))).astype(np.float32)
        if extremes:
            x.flat[:len(SPECIAL)] = SPECIAL
        return x.astype(NP[p])
    info = np.iinfo(NP[p])
    x = rng.integers(info.min, info.max, (k, h), endpoint=True)
    if extremes:
        x.flat[:4] = [info.min, info.max, -1, 0]
    return x.astype(NP[p])


@pytest.mark.parametrize("cell,pdt", PAYLOADS, ids=[
    f"{c}-{p}".replace("torch.", "") for c, p in PAYLOADS])
def test_payload_prologue_byte_equal_to_the_emulation(cell, pdt):
    """``payload_parts`` (the prologue the wrapper runs on the card, K-major
    and zero-padded) holds the emulation's parts byte for byte, and its
    part count is ``n_parts``; the parts add back to the payload exactly
    (to f32(x) for a split)."""
    rng = np.random.default_rng(len(str(cell)) * 7 + len(str(pdt)))
    k, h = 203, 41
    x = payload(pdt, rng, k, h)
    xt = torch.from_numpy(x.view(np.int16) if pdt == BF16 else x)
    if pdt == BF16:
        xt = xt.view(torch.bfloat16)
    got = core_f32.payload_parts(xt, cell, 128, 204).numpy()
    want = np_parts(x, cell)
    assert got.shape == (core_f32.n_parts(cell, pdt), 128, 204)
    assert len(want) == got.shape[0]
    for p, part in enumerate(want):
        np.testing.assert_array_equal(got[p, :h, :k].view(np.uint32),
                                      part.T.view(np.uint32))
    assert not got[:, h:].any() and not got[:, :, k:].any()
    for part in want:  # each part exact in TF32
        fin = np.isfinite(part)
        assert np.all(part[fin].view(np.uint32) & 0x1FFF == 0)
    total = np.sum([pt.astype(np.float64) for pt in want], axis=0)
    fin = np.isfinite(x.astype(np.float64))
    ref = x.astype(np.float32).astype(np.float64)
    kind = core_f32.PART_KINDS[(cell, pdt)]
    if kind == "limbs":
        np.testing.assert_array_equal(total, x.astype(np.float64))
    elif kind == "exact":
        np.testing.assert_array_equal(total[fin], ref[fin])
    else:  # normal values whose lo is normal too
        big = fin & (np.abs(ref) < 3e38) & (np.abs(ref) > 2.0 ** -100)
        assert np.all(np.abs(total[big] - ref[big])
                      <= np.abs(ref[big]) * 2.0 ** -22)


def test_balanced_limbs_stay_below_the_payload():
    """Balanced 11-bit limbs: |x_0| <= |x| and each upper limb's share
    no more than twice |x|, which is why every limb sum of an exact dot
    stays exact; every int32 is recombined exactly."""
    x = np.concatenate([np.arange(-5000, 5000),
                        np.random.default_rng(1).integers(
                            -2 ** 31, 2 ** 31, 20000),
                        [-2 ** 31, 2 ** 31 - 1, 1024, -1024, 1023, -1025]])
    limbs = core_f32.limbs(torch.from_numpy(x).to(torch.int32), 3)
    d = [t.numpy() for t in limbs]
    assert np.all(np.abs(d[0]) <= np.abs(x))
    assert np.all((d[0] >= -1024) & (d[0] < 1024))
    assert np.all((d[1] >= -1024) & (d[1] < 1024))
    assert np.all(np.abs(d[2]) <= 512)
    assert np.all(np.abs(d[1] * 2 ** 11 + d[2] * 2 ** 22)
                  <= np.abs(x) + 1024)
    np.testing.assert_array_equal(d[0] + d[1] * 2 ** 11 + d[2] * 2 ** 22, x)


BIT_EQUAL = [(BF16, torch.int16), (BF16, torch.int32), (BF16, torch.int8),
             (BF16, torch.bfloat16), (F32, torch.int8), (F32, torch.bfloat16)]


@pytest.mark.parametrize("cell,pdt", BIT_EQUAL, ids=[
    f"{c}-{p}".replace("torch.", "") for c, p in BIT_EQUAL])
def test_emulation_bit_equal_below_2_24(cell, pdt):
    """Integer cells (|c| <= 100, exact in TF32) times integer payloads
    whose sums of |terms| stay below 2^24 (payload magnitudes up to the
    bound that keeps 512 terms there, each column its own): the emulated
    kernel equals the reference's f32 dot bit for bit."""
    rng = np.random.default_rng(3)
    r, k, h = 96, 512, 64
    cells = rng.integers(-100, 101, (r, k)).astype(np.float32)
    top = (1 << 24) // (100 * k) - 1  # 326: every partial sum below 2^24
    hi = {torch.int8: 127, torch.bfloat16: 256}.get(pdt, top)
    m = np.unique(np.geomspace(1, min(hi, top), h).round()).astype(np.int64)
    x = (rng.integers(-1 << 20, 1 << 20, (k, len(m))) % (m + 1)) * \
        rng.choice([-1, 1], (k, len(m)))
    mag = np.abs(cells).astype(np.float64) @ np.abs(x).astype(np.float64)
    assert mag.max() < 2 ** 24
    xp = x.astype(NP[pdt])
    got = np_kernel(cells, cell, np_parts(xp, cell))
    want = core_matmul(cells, cell, xp.astype(np.float32) if pdt == BF16
                       else xp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (cells.astype(np.float64)
                                        @ x.astype(np.float64)))


@pytest.mark.parametrize("pdt", [torch.int16, torch.int32])
def test_limbs_exact_where_the_payload_is_wide(pdt):
    """bf16 integer cells times int16 / int32 payloads spanning their
    whole range, the sums of |terms| below 2^24 only through cancelling
    cells: wherever the sum of |terms| is below 2^24 the emulated limbs
    equal the exact product, which the reference's f32 dot only meets
    below 2^24 too; elsewhere within REL."""
    rng = np.random.default_rng(5)
    r, k, h = 64, 2048, 48
    cells = rng.integers(-8, 9, (r, k)).astype(np.float32)
    cells[:, k // 2:] = 0  # half the terms vanish
    info = np.iinfo(NP[pdt])
    m = np.geomspace(1, info.max, h).round().astype(np.int64)
    x = (rng.integers(info.min, info.max, (k, h)) % (m + 1)).astype(NP[pdt])
    got = np_kernel(cells, BF16, np_parts(x, BF16))
    exact = cells.astype(np.float64) @ x.astype(np.float64)
    mag = np.abs(cells).astype(np.float64) @ np.abs(x.astype(np.float64))
    below = mag < 2 ** 24
    assert below.any() and (~below).any()
    np.testing.assert_array_equal(got[below], exact[below])
    want = core_matmul(cells, BF16, x)
    np.testing.assert_array_equal(want[below], got[below])
    assert np.all(np.abs(got - exact) <= REL * mag)
    assert np.all(np.abs(got - want) <= REL * mag)


@pytest.mark.parametrize("case", ["wide", "cancelling"])
@pytest.mark.parametrize("cell,pdt", [(F32, torch.float32),
                                      (F32, torch.int32),
                                      (F32, torch.int16),
                                      (BF16, torch.float32)])
def test_emulation_within_rel_on_wide_and_cancelling_inputs(cell, pdt, case):
    """3xTF32 (f32 cells) and the hi / lo payload split (bf16 cells ×
    f32 rows) on values spread over 2^±30 and on sums that cancel to a
    tiny fraction of their terms: within REL of the sum of |terms| of the
    float64 product and, where the reference takes the f32 dot (f32
    cells; its bf16 core rounds a float payload to bf16, K-core's case),
    of the reference's."""
    rng = np.random.default_rng(7)
    r, k, h = 64, 512, 40
    if case == "wide":
        cells = rng.standard_normal((r, k)) * 2.0 ** rng.integers(-30, 30,
                                                                  (r, k))
        x = payload(pdt, rng, k, h, extremes=False)
    else:
        cells = rng.standard_normal((r, k))
        cells[:, k // 2:] = cells[:, :k // 2]
        x = payload(pdt, rng, k, h, extremes=False)
        x[k // 2:] = -x[:k // 2] if pdt != torch.int16 else \
            -(x[:k // 2].astype(np.int32)).clip(-32767, 32767)
    cells = cells.astype(np.float32)
    if cell == BF16:
        cells = cells.astype(ml_dtypes.bfloat16).astype(np.float32)
    got = np_kernel(cells, cell, np_parts(x, cell))
    exact = cells.astype(np.float64) @ x.astype(np.float32).astype(
        np.float64)
    mag = np.abs(cells).astype(np.float64) @ np.abs(
        x.astype(np.float32).astype(np.float64))
    assert np.all(np.abs(got - exact) <= REL * mag)
    if cell == F32:
        want = core_matmul(cells, cell, x)
        assert np.all(np.abs(got - want) <= REL * mag + 1e-30)
    if case == "cancelling":
        assert np.median(np.abs(exact) / mag) < 1e-3


def test_route_from_the_shapes():
    """The kernel's contract, from the bands alone: rows of 16-byte
    multiples (w % 4 f32, w % 8 bf16), 16-byte aligned, at any H (H 41
    and 40 alike); other bands are refused before a launch. The prepared
    operand's width rule meets it, and a CPU call takes the plain version
    whatever the shapes (an odd width at H 41 here)."""
    for cell, w, ok in ((F32, 200, True), (F32, 203, False),
                        (F32, 204, True), (BF16, 200, True),
                        (BF16, 204, False), (BF16, 16, True)):
        band = torch.zeros(64, w, dtype=cell)
        assert core_f32.tc_bands([band], [(0, 64, w)]) == ok
        if ok:
            core_f32._check_kernel_contract([band], [(0, 64, w)])
        else:
            with pytest.raises(ValueError, match="K-f32 kernel needs"):
                core_f32._check_kernel_contract([band], [(0, 64, w)])
    big = torch.zeros(64 * 256 + 1)
    assert not core_f32.tc_bands([big[1:].view(64, 256)], [(0, 64, 256)])
    assert core_f32.TC_WIDTH[F32] * 4 == core_f32.TC_WIDTH[BF16] * 2 == 16
    from pygim_tpu_torch.ops.spmm import WIDTH_RULE

    assert WIDTH_RULE["float32"] % core_f32.TC_WIDTH[F32] == 0
    assert WIDTH_RULE["bfloat16"] % core_f32.TC_WIDTH[BF16] == 0
    gen = torch.Generator().manual_seed(5)
    band = torch.randn(64, 203, generator=gen)
    xc = torch.randn(210, 41, generator=gen)
    rows = torch.randperm(100, generator=gen)[:64].to(torch.int32)
    out = torch.randn(100, 41, generator=gen)
    got = core_f32.core_f32_scatter_add([band], xc, rows, [(0, 64, 203)],
                                        out.clone())
    assert torch.equal(got, core_f32.core_f32_plain(
        [band], xc, rows, [(0, 64, 203)], out.clone()))


def test_parts_and_products_of_each_pair():
    """One TF32 product a payload part, and one more beside f32 cells:
    3xTF32 for f32 × f32 / int16 / int32, 2 for f32 × bf16 / int8; a bf16
    cell × int32 takes three limbs, × int16 two, × bf16 / int8 one."""
    want = {(F32, torch.float32): (2, 3), (F32, torch.int16): (2, 3),
            (F32, torch.int32): (2, 3), (F32, torch.bfloat16): (1, 2),
            (F32, torch.int8): (1, 2), (BF16, torch.float32): (2, 2),
            (BF16, torch.int16): (2, 2), (BF16, torch.int32): (3, 3),
            (BF16, torch.bfloat16): (1, 1), (BF16, torch.int8): (1, 1)}
    assert set(want) == set(core_f32.PART_KINDS)
    for (c, p), (parts, products) in want.items():
        assert core_f32.n_parts(c, p) == parts
        assert core_f32.n_products(c, p) == products


def test_bound_of_the_route_taken():
    """The reference's default hybrid at reddit scale, an f32 square of k
    32,768 at H 256: 550 GFLOP, 8.2 ms at the FFMA rate (one FFMA a term);
    three TF32 products a term at 495 TFLOP/s, 3.33 ms, above its 1.28 ms
    of bytes."""
    pk = peaks("NVIDIA H100 80GB HBM3")
    shapes = [(32768, 32768)]
    ffma, by = f32_bound(shapes, 256, pk, 4.0, 4.0, None)
    assert by == "operations" and ffma == pytest.approx(8.206, abs=1e-3)
    tc, by = f32_bound(shapes, 256, pk, 4.0, 4.0)
    assert by == "operations" and tc == pytest.approx(3.335, abs=1e-3)
    one, by = f32_bound(shapes, 256, pk, 4.0, 4.0, 1)
    assert by == "bytes" and one == pytest.approx(1.312, abs=1e-3)
