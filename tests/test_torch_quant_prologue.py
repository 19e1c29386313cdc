"""K-quant's plain versions (``ops/quant_prologue.py``) against the JAX
package on the CPU, bit for bit: ``max|x|`` with the scale and ``safe``
(NaN, ±inf, all-zero, subnormal and overflowing inputs), the integer
table against ``pygim_tpu.quant.symmetric_quantize`` (half-step ties
included), and K-int's limb payload against the reference's rounded
core gather (``pygim_tpu/ops/spmm.py:1618-1624``) split by the port's
``limb_split``, with the int32 wraparound. A NumPy model of the CUDA
payload kernel's tiles (``csrc/quant.cu:payload_kernel``) is held to
``limb_split`` at ragged rows and widths, every type and limb count and
a misaligned x, and the prepared operand's products are held to take
the payload route and to give the same values as before.
Every comparison is exact: the port rounds as the reference does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.quant import symmetric_quantize as jquantize
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import core_int
from pygim_tpu_torch.ops import quant_prologue as kq
from pygim_tpu_torch.ops import spmm as tspmm
from pygim_tpu_torch.quant import quant_scale, symmetric_quantize

from test_torch_train import N, small_graph

DTYPES = ["int8", "int16", "int32"]
K = {"int8": 5, "int16": 10, "int32": 20}
LIMBS = {"int8": 1, "int16": 2, "int32": 3}


def activations(case, dtype="int32", shape=(300, 24), seed=0):
    """float32 x of one of the cases the prologue must round alike."""
    rng = np.random.default_rng(seed)
    x = (2.5 * rng.standard_normal(shape)).astype(np.float32)
    half = 2 ** (K[dtype] - 1)  # max|x| = half gives scale 1
    if case in ("ties", "ties15"):
        step = 1.0 if case == "ties" else 1.5
        j = rng.integers(-half, half, shape)
        x = ((j + 0.5) * step).astype(np.float32)  # every value a half step
        x.flat[0] = half * step
    elif case == "zeros":
        x = np.zeros(shape, np.float32)
    elif case == "inf":
        x[3, 4] = -np.inf
    elif case == "nan":
        x[7, 1] = np.nan
    elif case == "tiny":
        x = (x * np.float32(1e-40)).astype(np.float32)  # subnormal scale
    elif case == "huge":
        x[2, 2] = np.float32(3e38)  # 2 · max|x| overflows to inf
    return x


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def same_float(got, want):
    got, want = np.float32(got), np.float32(want)
    return (np.isnan(got) and np.isnan(want)) or bits(got) == bits(want)


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "inf", "nan",
                                  "huge"])
@pytest.mark.parametrize("dtype", DTYPES + ["float32"])
def test_abs_max_scale_matches_jax(dtype, case):
    x = activations(case, dtype if dtype in K else "int32")
    jscale = float(jquantize(jnp.asarray(x), dtype)[0])
    abs_max, scale, safe = kq.abs_max_scale(torch.from_numpy(x), dtype)
    assert abs_max.dim() == scale.dim() == safe.dim() == 0
    assert same_float(abs_max, np.max(np.abs(x)))
    assert same_float(scale, jscale)
    assert same_float(safe, 1.0 if jscale == 0 else jscale)
    assert all(same_float(a, b) for a, b in zip(
        quant_scale(torch.from_numpy(x), dtype), (scale, safe)))


def test_abs_max_scale_subnormal():
    """A subnormal scale rounds once, as the ops' multiply by 2 and by
    2^-k does (the reference's CPU backend may flush it, so the exact
    value is the yardstick here)."""
    x = activations("tiny")
    abs_max, scale, safe = kq.abs_max_scale(torch.from_numpy(x), "int8")
    want = np.float32(np.float32(np.max(np.abs(x)) * np.float32(2))
                      * np.float32(2.0 ** -5))
    assert same_float(scale, want) and same_float(safe, want) and want != 0


@pytest.mark.parametrize("case", ["normal", "ties", "ties15", "zeros"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_table_matches_jax(dtype, case):
    x = activations(case, dtype)
    _s, jq = jquantize(jnp.asarray(x), dtype)
    xt = torch.from_numpy(x)
    _a, _scale, safe = kq.abs_max_scale(xt, dtype)
    got = kq.quant_table(xt, safe, dtype)
    assert got.dtype == getattr(torch, dtype)
    assert np.array_equal(got.numpy(), np.asarray(jq))
    if case.startswith("ties"):  # half to even, not away from zero
        assert (got.numpy() % 2 == 0).mean() > 0.99
    assert torch.equal(symmetric_quantize(xt, dtype)[1], got)


def test_quant_table_int64_and_refusals():
    x = torch.from_numpy(activations("ties", "int32"))
    safe = kq.abs_max_scale(x)[2]
    got = kq.quant_table(x, safe, torch.int64)
    assert got.dtype == torch.int64
    assert torch.equal(got, torch.round(x / safe).to(torch.int64))
    with pytest.raises(ValueError, match="int8, int16, int32 or int64"):
        kq.quant_table(x, safe, "float32")
    with pytest.raises(ValueError, match="no K-quant kernel"):
        kq.quant_table(x.to("meta"), safe.to("meta"), "int8")


def reference_core_gather(x, rows, dtype):
    """The reference's rounded core gather
    (``pygim_tpu/ops/spmm.py:1618-1624``) with its own scale: int32."""
    scale, _q = jquantize(jnp.asarray(x), dtype)
    safe = jnp.where(scale == 0, jnp.ones_like(scale), scale)
    xc = jnp.round(jnp.take(jnp.asarray(x), jnp.asarray(rows), axis=0)
                   / safe).astype(jnp.int32)
    return torch.from_numpy(np.asarray(xc))


@pytest.mark.parametrize("shape", [(300, 41), (500, 64), (90, 130)])
@pytest.mark.parametrize("case", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_core_payload_matches_reference(dtype, case, shape):
    x = activations(case, dtype, shape)
    rng = np.random.default_rng(shape[1])
    rows = rng.permutation(shape[0])[: shape[0] * 2 // 3].astype(np.int32)
    limbs = LIMBS[dtype]
    h_pad, k_pad = kq.payload_dims(rows.size + 5, shape[1])
    xt = torch.from_numpy(x)
    safe = kq.abs_max_scale(xt, dtype)[2]
    got = kq.core_payload(xt, torch.from_numpy(rows), safe, limbs, h_pad,
                          k_pad)
    want = core_int.limb_split(reference_core_gather(x, rows, dtype), limbs,
                               h_pad, k_pad)
    assert got.shape == (limbs, h_pad, k_pad) and got.dtype == torch.int8
    assert torch.equal(got, want)
    # the digits give back the rounded rows, the pads are zero
    q = core_int.limb_join(got, rows.size, shape[1])
    assert torch.equal(q, reference_core_gather(x, rows, dtype))
    assert not got[:, shape[1]:].any() and not got[:, :, rows.size:].any()


@pytest.mark.parametrize("limbs", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_core_payload_of_an_integer_table(dtype, limbs):
    """An integer x (the int8 / int16 table, a raw integer payload) is
    taken as it is; at four limbs every int32 survives, the wraparound
    included."""
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(limbs)
    x = torch.randint(info.min, info.max, (200, 41), generator=g,
                      dtype=torch.int64).to(dtype)
    x[0, :4] = torch.tensor([info.min, info.max, -1, 0], dtype=dtype)
    rows = torch.arange(198, -1, -3, dtype=torch.int32)  # row 0 last
    h_pad, k_pad = kq.payload_dims(rows.numel(), 41)
    got = kq.core_payload(x, rows, None, limbs, h_pad, k_pad)
    assert torch.equal(got, core_int.limb_split(x[rows.long()], limbs, h_pad,
                                                k_pad))
    if limbs == 4 or limbs >= core_int.RAW_LIMBS[dtype]:
        assert torch.equal(core_int.limb_join(got, rows.numel(), 41),
                           x[rows.long()].to(torch.int32))


def test_int32_wraparound_through_k_int():
    """K-int's product of a ready payload (the CPU joins it back) equals
    the product of the gathered rows, the wrapped int32 sums included."""
    g = torch.Generator().manual_seed(3)
    band = torch.randint(-128, 128, (40, 32), generator=g,
                         dtype=torch.int64).to(torch.int8)
    x = torch.randint(-(1 << 31), 1 << 31, (64, 24), generator=g,
                      dtype=torch.int64).to(torch.int32)
    x[:, 0] = (1 << 31) - 1  # every sum of that column wraps
    cn = torch.arange(40, dtype=torch.int32)
    rows = torch.arange(32, dtype=torch.int32) * 2
    stair = [(0, 40, 32)]
    want = core_int.core_int_scatter_add(
        [band], x[rows.long()], cn, stair, torch.zeros(64, 24), limbs=4)
    payload = kq.core_payload(x, rows, None, 4, *kq.payload_dims(32, 24))
    got = core_int.core_int_scatter_add([band], None, cn, stair,
                                        torch.zeros(64, 24), limbs=4,
                                        payload=payload)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="ready payload"):
        core_int.core_int_scatter_add([band], x, cn, stair,
                                      torch.zeros(64, 24), limbs=4,
                                      payload=payload)


def emulate_payload_kernel(x, rows, safe, limbs, h_pad, k_pad, base=0):
    """``csrc/quant.cu:payload_kernel`` in NumPy, as the CUDA source
    indexes it, with x at byte ``base`` of a memory of junk bytes: 64 x 64
    tiles; in pass p, warp g = warp + 8p takes chunks C·(g & 1) .. + C - 1
    (C = 32 / EPT, EPT = 16 / itemsize) of rows EPT·(g >> 1) .. + EPT - 1,
    lane i chunk i % C of row i / C, a 16-byte load where x is aligned and
    H % EPT == 0, else 4-byte elements one by one and narrower ones from
    the one or two aligned granules holding the chunk's bytes in its row
    (asserted inside x's first and last granules), shifted into place; its
    u words go to ``su[col]
    [row]`` (every word once, and each warp's 32 words in 32 banks at the
    odd row stride); thread t writes rows 32·(t >> 7) + 16·(t & 1) .. + 15
    of column (t >> 1) & 63, 16 bytes a limb (each warp's reads in 32
    banks). Every byte of ``out`` must be written once."""
    n_rows, h = rows.size, x.shape[1]
    sz = x.dtype.itemsize
    ept = 16 // sz
    cpw, passes = 32 // ept, 16 // ept
    vec = h % ept == 0 and base % 16 == 0
    mem = np.full(base + x.nbytes + 48, 0xAB, np.uint8)
    mem[base:base + x.nbytes] = np.ascontiguousarray(x).view(np.uint8).ravel()
    lo, hi = base // 16 * 16, -(-(base + x.nbytes) // 16) * 16
    bias = sum(128 << (8 * l) for l in range(limbs))
    out = np.zeros((limbs, h_pad, k_pad), np.uint8)
    written = np.zeros(out.shape, np.int64)
    t = np.arange(256)

    def chunk(a, valid):
        """The 16 bytes at ``a`` as the kernel reads them: one aligned
        load, 4-byte elements of ``[a, a + valid)``, or the aligned
        granules that hold a byte of it."""
        a0 = a // 16 * 16
        if vec:
            assert a == a0
        elif sz == 4:
            out = np.zeros(16, np.uint8)
            out[:valid] = mem[a:a + valid]
            return out
        got = []
        for g in (a0, a0 + 16):
            if g < a + valid and (g == a0 or a > a0):
                assert lo <= g and g + 16 <= hi
                got.append(mem[g:g + 16])
            else:
                got.append(np.zeros(16, np.uint8))
        return np.concatenate(got)[a - a0:a - a0 + 16]

    lane, warp = t & 31, t >> 5
    for bx in range(-(-k_pad // 64)):
        for by in range(h_pad // 64):
            j0, n0 = bx * 64, by * 64
            srow = np.array([rows[j0 + r] if j0 + r < n_rows else -1
                             for r in range(64)])
            su = np.full((64, 65), -1, np.int64)
            for p in range(passes):
                grp = warp + 8 * p
                jl = ept * (grp >> 1) + lane // cpw
                nl = ept * (cpw * (grp & 1) + lane % cpw)
                for tt in range(256):
                    r, n = srow[jl[tt]], n0 + nl[tt]
                    c = np.zeros(16, np.uint8)
                    if r >= 0 and n < h:
                        c = chunk(base + (int(r) * h + n) * sz,
                                  min(ept, h - n) * sz)
                    vals = c.view(x.dtype)
                    for e in range(ept):
                        col, row = nl[tt] + e, jl[tt]
                        u = bias
                        if r >= 0 and n + e < h:
                            q = (int(vals[e]) if safe is None else
                                 int(np.round(vals[e] / np.float32(safe))))
                            u = (q + bias) & 0xFFFFFFFF
                        assert su[col, row] == -1
                        su[col, row] = u
                # each warp's 32 words of one element index in 32 banks
                for e in range(ept):
                    banks = (((nl + e) * 65 + jl) % 32).reshape(8, 32)
                    assert all(len(set(b)) == 32 for b in banks)
            assert (su[:, :64] >= 0).all()
            nl = (t >> 1) & 63
            jw = 32 * (t >> 7) + 16 * (t & 1)
            banks = ((nl * 65 + jw) % 32).reshape(8, 32)
            assert all(len(set(b)) == 32 for b in banks)
            for tt in range(256):
                if j0 + jw[tt] >= k_pad:
                    continue
                u = su[nl[tt], jw[tt]:jw[tt] + 16]
                for l in range(limbs):
                    byte = ((u >> (8 * l)) & 0xFF) ^ 0x80
                    n, j = n0 + nl[tt], j0 + jw[tt]
                    out[l, n, j:j + 16] = byte
                    written[l, n, j:j + 16] += 1
    assert (written == 1).all()
    return torch.from_numpy(out.view(np.int8))


PAYLOAD_CASES = [  # (h, rows): rows not a multiple of 128; H 41, 100, 1104;
    # every row shorter than one load chunk (H 7); exact 64-wide tiles (64,
    # 64); H just past two tiles with few rows (130, 16)
    (41, 37), (100, 300), (1104, 130), (7, 200), (64, 64), (130, 16)]


@pytest.mark.parametrize("h,n_rows", PAYLOAD_CASES)
@pytest.mark.parametrize("limbs", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8", "int16", "int32"])
def test_kernel_tiles_match_limb_split(dtype, limbs, h, n_rows):
    """The emulated kernel against ``core_payload`` (the plain version)
    and the limb split of the reference's rounded gather, x 16-byte
    aligned (even limb counts) and one element off it (odd)."""
    rng = np.random.default_rng(h + limbs)
    if dtype == "float32":
        x = (300 * rng.standard_normal((n_rows + 9, h))).astype(np.float32)
        safe = np.float32(0.75)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, (n_rows + 9, h),
                         endpoint=True).astype(dtype)
        safe = None
    rows = rng.permutation(n_rows + 9)[:n_rows].astype(np.int32)
    h_pad, k_pad = kq.payload_dims(n_rows + 3, h)
    want = kq.core_payload(
        torch.from_numpy(x), torch.from_numpy(rows),
        None if safe is None else torch.tensor(safe), limbs, h_pad, k_pad)
    if safe is None:
        ref = torch.from_numpy(x[rows].astype(np.int32))
    else:
        ref = torch.from_numpy(np.array(jnp.round(
            jnp.asarray(x[rows]) / safe).astype(jnp.int32)))
    assert torch.equal(want, core_int.limb_split(ref, limbs, h_pad, k_pad))
    base = x.dtype.itemsize * (limbs % 2)  # odd limbs: x off 16 bytes
    got = emulate_payload_kernel(x, rows, safe, limbs, h_pad, k_pad, base)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,h,offset,want", [
    (torch.int8, 48, 0, "16 columns a 16-byte load"),
    (torch.int8, 47, 0, "16 columns a pair of 16-byte granules"),
    (torch.int16, 40, 0, "8 columns a 16-byte load"),
    (torch.int16, 41, 0, "8 columns a pair of 16-byte granules"),
    (torch.float32, 256, 0, "4 columns a 16-byte load"),
    (torch.float32, 256, 1, "4 columns 4 element loads"),
    (torch.float32, 41, 0, "4 columns 4 element loads")])
def test_payload_route(dtype, h, offset, want):
    """16-byte loads where each chunk lies whole in a 16-byte aligned row;
    elsewhere 4-byte elements one by one and narrower ones from the
    aligned granules holding the chunk."""
    x = torch.zeros(4 * h + offset, dtype=dtype)[offset:].view(4, h)
    assert kq.payload_route(x) == f"64x64 tiles, {want}"


def test_core_payload_checks_its_arguments():
    x = torch.zeros(10, 8)
    rows = torch.arange(4, dtype=torch.int32)
    safe = torch.tensor(1.0)
    with pytest.raises(ValueError, match="rounds a float32 x"):
        kq.core_payload(x, rows, None, 1, 64, 16)
    with pytest.raises(ValueError, match="rounds a float32 x"):
        kq.core_payload(x.to(torch.int8), rows, safe, 1, 64, 16)
    with pytest.raises(ValueError, match="h_pad % 64"):
        kq.core_payload(x, rows, safe, 1, 32, 16)
    with pytest.raises(ValueError, match="k_pad % 16"):
        kq.core_payload(x, torch.arange(20, dtype=torch.int32), safe, 1, 64,
                        16)
    with pytest.raises(ValueError, match="no K-quant kernel"):
        kq.core_payload(x.to("meta"), rows.to("meta"), safe.to("meta"), 1,
                        64, 16)
    with pytest.raises(RuntimeError, match="requires grad"):
        kq.abs_max_scale(torch.zeros(3, 3, requires_grad=True))


_PREPS = {}


def prepared(backend):
    if backend not in _PREPS:
        rows, cols, vals = small_graph()
        cfg = {"hybrid": dict(backend="hybrid", hybrid_shape="stair",
                              hybrid_dtype="int8",
                              hybrid_core_bytes=64 << 10),
               "square-int4": dict(backend="hybrid", hybrid_shape="square",
                                   hybrid_dtype="int4",
                                   hybrid_core_bytes=64 << 10),
               "ell": dict(backend="ell")}[backend]
        _PREPS[backend] = tspmm.prepare_spmm(
            tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
            tspmm.SpmmConfig(**cfg), device="cpu")
    return _PREPS[backend]


class Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", ["hybrid", "square-int4", "ell"])
def test_prepared_products_take_k_quant(backend, dtype, monkeypatch):
    """``mul_quantized`` takes K-quant's max|x| (and its table for int8
    and int16) and, on an int core, its payload; the plain route takes
    none of them and gives the same values, bit for bit; the undequantized
    product times its scale is the dequantized one."""
    prep = prepared(backend)
    x = torch.from_numpy(activations("normal", dtype, (N, 40), seed=5))
    spies = {n: Spy(getattr(tspmm, n)) for n in
             ("abs_max_scale", "quant_table", "core_payload")}
    for n, spy in spies.items():
        monkeypatch.setattr(tspmm, n, spy)
    got = prep.mul_quantized(x, dtype)
    calls = {n: s.calls for n, s in spies.items()}
    assert calls["abs_max_scale"] == 1
    assert calls["quant_table"] == (dtype != "int32")
    assert calls["core_payload"] == (backend != "ell")
    out, scale = prep.raw_mul_quantized(x, prep.dev_arrays, dtype,
                                        dequantize=False)
    assert torch.equal(out * scale, got)
    for s in spies.values():
        s.calls = 0
    want = prep.mul_quantized_plain(x, dtype)
    assert all(s.calls == 0 for s in spies.values())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.int32])
def test_integer_mul_takes_the_payload(dtype, monkeypatch):
    prep = prepared("hybrid")
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max, (N, 24),
                      generator=torch.Generator().manual_seed(1),
                      dtype=torch.int64).to(dtype)
    spy = Spy(tspmm.core_payload)
    monkeypatch.setattr(tspmm, "core_payload", spy)
    got = prep.mul(x)
    assert spy.calls == 1
    assert torch.equal(got, prep.mul_plain(x))
