"""The int4 (nibble-packed) core on the CPU: the plain K-core and K-int on
packed bands against the uint8 branches of the reference's
``_core_matmul`` and ``_wide_int_core_dot``, a CPU emulation of how the
two kernels unpack a packed stage into their ``wgmma`` A fragments, and
the int8-aggregated 2-layer GCN (tracked config 4's model) on a square
int4 core against JAX's ``gnn_apply``.

Integer products are exact and wrap mod 2^32 in both packages: compared
bit for bit. Float payloads: both round x to bf16 and sum exact int ×
bf16 products in f32 in different orders; within 1e-5 of the sum of
|terms|. Logits: as ``test_torch_model.py`` (1e-4 of their largest
magnitude: the dense layers' f32 sums run in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.nn.models import make_gnn as jmake_gnn
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.nn.models import GNN, params_from_jax
from pygim_tpu_torch.ops import core_dot, core_int
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import N, make_graph

REL = 1e-5


def packed_band(rng, r, w):
    """A packed band of r rows and w cells: every byte value, so every
    nibble -8..7 in both halves."""
    b = rng.integers(0, 256, (r, w // 2), dtype=np.int64).astype(np.uint8)
    b.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
    return b


def unpacked(band):
    """The reference's nibble planes, interleaved: (r, w) int8."""
    lo, hi = jspmm._nibble_halves(jnp.asarray(band), jnp.int8)
    return np.stack([np.asarray(lo), np.asarray(hi)], -1).reshape(
        band.shape[0], -1)


def test_unpack_nibbles_is_nibble_halves():
    band = packed_band(np.random.default_rng(0), 16, 64)
    got = core_dot.unpack_nibbles(torch.from_numpy(band)).numpy()
    np.testing.assert_array_equal(got, unpacked(band))
    assert got.min() == -8 and got.max() == 7


@pytest.mark.parametrize("r,w,h", [(37, 224, 41), (130, 512, 64),
                                   (64, 96, 300)])
def test_float_product_matches_core_matmul(r, w, h):
    rng = np.random.default_rng(r + w + h)
    band = packed_band(rng, r, w)
    x = rng.standard_normal((w + 3, h)).astype(np.float32)
    want = np.asarray(jspmm._core_matmul(jnp.asarray(band),
                                         jnp.asarray(x[:w]), jnp.float32))
    xc = torch.from_numpy(x).to(torch.bfloat16)
    rows = torch.arange(r, dtype=torch.int32)
    got = core_dot.core_band_plain(torch.from_numpy(band), xc, rows,
                                   torch.zeros(r, h)).numpy()
    mag = np.abs(unpacked(band).astype(np.float64)) @ np.abs(
        xc[:w].float().numpy().astype(np.float64))
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


# (limbs, payload dtype, magnitude): each limb count with its range
CASES = [(1, np.int8, 1 << 7), (2, np.int16, 1 << 9), (3, np.int32, 1 << 19),
         (3, np.int16, 1 << 15), (4, np.int32, 1 << 31)]
IDS = ["L1-int8", "L2-int16q", "L3-int32q", "L3-int16", "L4-int32"]


def payload(rng, shape, dtype, m):
    return rng.integers(-m, m, shape, dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("limbs,dtype,m", CASES, ids=IDS)
@pytest.mark.parametrize("r,w,h", [(37, 224, 41), (130, 512, 64),
                                   (300, 96, 300)])
def test_integer_product_matches_jax(limbs, dtype, m, r, w, h):
    """Bit-equal int32: the s8 branch for int8 payloads, the wide
    (wrapped) one otherwise; the limb emulation of the kernel too."""
    from test_torch_core_int import emulate_limbs

    rng = np.random.default_rng(r * w + h + limbs)
    band = packed_band(rng, r, w)
    xc = payload(rng, (w + 5, h), dtype, m)
    want = np.asarray(jspmm._core_matmul(jnp.asarray(band),
                                         jnp.asarray(xc[:w]), jnp.float32))
    assert want.dtype == np.int32
    got = core_int.band_product_plain(torch.from_numpy(band),
                                      torch.from_numpy(xc)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_limbs(unpacked(band), xc, limbs),
                                  want)


@pytest.mark.parametrize("q", [(1 << 31) - 7, -(1 << 31)])
def test_wraparound_matches_jax(q):
    """Every cell -8 (the nibble 0x8) times payloads at the ends of
    int32: every sum wraps mod 2^32."""
    r, w, h = 40, 1024, 24
    band = np.full((r, w // 2), 0x88, np.uint8)
    xc = np.full((w, h), q, np.int32)
    xc[::3] = -q if q != -(1 << 31) else q
    want = np.asarray(jspmm._wide_int_core_dot(jnp.asarray(band),
                                               jnp.asarray(xc)))
    got = core_int.band_product_plain(torch.from_numpy(band),
                                      torch.from_numpy(xc)).numpy()
    np.testing.assert_array_equal(got, want)
    exact = -8 * int(xc[:, 0].astype(np.int64).sum())
    assert exact != int(want[0, 0])  # the sum did wrap


def test_wide_product_multi_chunk_matches_jax(monkeypatch):
    """The reference's chunked wide product (row chunks of the packed
    core, the last clamped to overlap) and the plain version's row steps,
    both shrunk so several chunks run."""
    monkeypatch.setattr(jspmm, "_WIDE_INT_CHUNK_BYTES", 256 * 4 * 64)
    monkeypatch.setattr(core_int, "_ROWS_PER_STEP", 48)
    rng = np.random.default_rng(5)
    r, w, h = 700, 64, 40
    band = packed_band(rng, r, w)
    xc = payload(rng, (w, h), np.int32, 1 << 31)
    want = np.asarray(jspmm._core_matmul(jnp.asarray(band), jnp.asarray(xc),
                                         jnp.float32))
    got = core_int.band_product_plain(torch.from_numpy(band),
                                      torch.from_numpy(xc)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scatter_wrappers_on_cpu_take_packed_bands():
    rng = np.random.default_rng(1)
    r, w, h = 70, 224, 24
    band = torch.from_numpy(packed_band(rng, r, w))
    rows = torch.from_numpy(rng.permutation(3 * r)[:r].astype(np.int32))
    xc = torch.from_numpy(rng.standard_normal((w, h)).astype(np.float32))
    out = core_dot.core_band_scatter_add(band, xc.to(torch.bfloat16), rows,
                                         torch.zeros(3 * r, h))
    want = torch.zeros(3 * r, h).index_add_(
        0, rows, torch.from_numpy(unpacked(band.numpy())).float()
        @ xc.to(torch.bfloat16).float())
    assert torch.equal(out, want)
    xi = torch.from_numpy(payload(rng, (w, h), np.int32, 1 << 19))
    got = core_int.core_int_scatter_add([band], xi, rows, [(0, r, w)],
                                        torch.zeros(3 * r, h), 3)
    want = core_int.core_int_plain([band], xi, rows, [(0, r, w)],
                                   torch.zeros(3 * r, h))
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["odd-width", "shape", "mixed"])
def test_packed_band_checks(bad):
    band = torch.zeros(8, 16, dtype=torch.uint8)
    stair = [(0, 8, 32)]
    xc = torch.zeros(40, 8, dtype=torch.int8)
    rows = torch.arange(8, dtype=torch.int32)
    if bad == "odd-width":
        stair = [(0, 8, 33)]
    elif bad == "shape":
        stair = [(0, 8, 48)]
    bands = [band]
    if bad == "mixed":
        bands = [band, torch.zeros(8, 32, dtype=torch.int8)]
        stair = [(0, 8, 32), (8, 16, 32)]
        rows = torch.arange(16, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        core_int.core_int_scatter_add(bands, xc, rows, stair,
                                      torch.zeros(16, 8), 1)


# ---- the kernels' unpack, emulated on the CPU ------------------------------

BM, BK = 128, 64


def stage(band, m0, k0):
    """A packed stage as TMA lands it: 128 rows × 32 bytes, unswizzled,
    zero past the band's rows and bytes."""
    s = np.zeros((BM, BK // 2), np.uint8)
    part = band[m0:m0 + BM, k0 // 2:k0 // 2 + BK // 2]
    s[:part.shape[0], :part.shape[1]] = part
    return s


def words(row):
    """A 32-byte stage row as eight little-endian 32-bit words."""
    return [int(v) for v in row.view("<u4")]


def bf16_bits(v):
    return float(np.array([v << 16], np.uint32).view(np.float32)[0])


def nib2_to_bf16x2(b):
    """csrc/core_dot.cu:nib2_to_bf16x2, bit for bit: (lo, hi) floats."""
    t = ((b | (b << 12)) & 0x000F000F) ^ 0x43084308
    return bf16_bits(t & 0xFFFF) - 136.0, bf16_bits(t >> 16) - 136.0


def byte_perm(x, sel):
    """__byte_perm(x, 0, sel)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [0] * 4
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def nib4_to_s8x4(x, sel):
    """csrc/core_int.cu:nib4_to_s8x4, bit for bit: four s8 values."""
    t = byte_perm(x, sel)
    y = (t & 0x000F000F) | ((t >> 4) & 0x0F000F00)
    v = (y | ((y & 0x08080808) * 0x1E)) & 0xFFFFFFFF
    return [int(np.int8(np.uint8((v >> (8 * i)) & 0xFF))) for i in range(4)]


def kcore_fragments(st):
    """The A operand K-core's int4 mode hands the bf16 ``wgmma``s of one
    stage, rebuilt from every thread's registers (``load_a_packed``) by
    the m64k16 fragment layout: (128, 64) cells."""
    a = np.full((BM, BK), np.nan)
    for wg in range(2):
        for warp in range(4):
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                ra = 64 * wg + 16 * warp + g
                w0, w1 = words(st[ra]), words(st[ra + 8])
                sh = 8 * t4
                for s in range(4):
                    regs = [(w0[2 * s] >> sh) & 0xFF, (w1[2 * s] >> sh) & 0xFF,
                            (w0[2 * s + 1] >> sh) & 0xFF,
                            (w1[2 * s + 1] >> sh) & 0xFF]
                    for e, b in enumerate(regs):
                        row = ra + 8 * (e & 1)
                        col = 16 * s + 8 * (e >> 1) + 2 * t4
                        a[row, col:col + 2] = nib2_to_bf16x2(b)
    return a


def kint_fragments(st):
    """The same for K-int's int4 mode (``load_a_s8``) and the s8 m64k32
    fragment layout: (128, 64) cells."""
    a = np.full((BM, BK), np.nan)
    for wg in range(2):
        for warp in range(4):
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                ra = 64 * wg + 16 * warp + g
                sel = 0x3322 if t4 & 1 else 0x1100
                hw = t4 >> 1
                w0, w1 = words(st[ra]), words(st[ra + 8])
                for s in range(2):
                    p, q = w0[4 * s:4 * s + 4], w1[4 * s:4 * s + 4]
                    regs = [p[hw], q[hw], p[2 + hw], q[2 + hw]]
                    for e, x in enumerate(regs):
                        row = ra + 8 * (e & 1)
                        col = 32 * s + 16 * (e >> 1) + 4 * t4
                        a[row, col:col + 4] = nib4_to_s8x4(x, sel)
    return a


@pytest.mark.parametrize("which", ["K-core", "K-int"])
@pytest.mark.parametrize("m0,k0", [(0, 0), (128, 64), (128, 192)])
def test_kernel_unpack_emulation(which, m0, k0):
    """Each kernel's A fragments of a stage equal the reference's
    unpacked cells of the same rows and columns — every nibble value,
    and the zero fill past a ragged band's rows and width."""
    rng = np.random.default_rng(m0 + k0)
    band = packed_band(rng, 200, 224)  # 72 rows and 32 cells past
    st = stage(band, m0, k0)
    want = np.zeros((BM, BK))
    cells = unpacked(band)[m0:m0 + BM, k0:k0 + BK]
    want[:cells.shape[0], :cells.shape[1]] = cells
    got = (kcore_fragments if which == "K-core" else kint_fragments)(st)
    np.testing.assert_array_equal(got, want)


# ---- the int8 GCN on a square int4 core (tracked config 4's model) ---------

F, H, C = 24, 64, 7
KW4 = dict(backend="hybrid", hybrid_shape="square", hybrid_dtype="int4",
           hybrid_core_bytes=512 << 10)


class Recorder:
    """An aggregate that records the inputs and outputs of its fused
    quantized calls."""

    def __init__(self, agg):
        self.agg, self.calls = agg, []

    def __call__(self, v):
        return self.agg(v)

    def quantized(self, v, agg_dtype):
        out = self.agg.quantized(v, agg_dtype)
        self.calls.append((v.clone(), agg_dtype, out.clone()))
        return out


@pytest.mark.parametrize("kind", ["multigraph", "wide"])
def test_int8_gcn_on_square_int4_core_matches_jax(kind):
    """Each aggregate of the port's forward equals JAX's fused aggregate
    of the same input bit for bit (integer weights) or within REL of the
    sum of |terms| (the wide graph's fractional tail); the logits within
    1e-4 of their scale."""
    rows, cols, vals = make_graph(kind)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW4))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW4), device="cpu")
    assert tp.stair == [(0, tp.hybrid_k_eff, tp.hybrid_k_eff)]
    jgnn = jmake_gnn(jax.random.key(0), "gcn", F, H, C, num_layers=2,
                     agg_dtype="int8")
    m = GNN("gcn", F, H, C, agg_dtype="int8")
    m.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jgnn.params)))
    m.eval()
    x = np.random.default_rng(11).standard_normal((N, F)).astype(np.float32)
    rec = Recorder(tspmm.PreparedAggregate(tp))
    with torch.inference_mode():
        got = m(torch.from_numpy(x), rec).numpy()
    want = np.asarray(jgnn.apply(jnp.asarray(x), jspmm.PreparedAggregate(jp)))
    assert len(rec.calls) == 2
    dense = np.zeros((N, N))
    np.add.at(dense, (rows, cols), np.abs(vals.astype(np.float64)))
    for v, agg_dtype, out in rec.calls:
        assert agg_dtype == "int8"
        ref = np.asarray(jspmm.PreparedAggregate(jp).quantized(
            jnp.asarray(v.numpy()), "int8"))
        if kind == "wide":
            mag = dense @ np.abs(v.numpy().astype(np.float64))
            assert np.all(np.abs(out.numpy() - ref) <= REL * mag + 1e-30)
        else:
            np.testing.assert_array_equal(out.numpy(), ref)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype,w,ok", [(torch.uint8, 48, False),
                                        (torch.uint8, 64, True),
                                        (torch.int8, 48, True),
                                        (torch.int8, 40, False)])
def test_kernel_width_rule(dtype, w, ok):
    """The kernels' stored-width contract, checked before any launch: a
    packed row must be a multiple of 16 bytes (w % 32), an int8 one too
    (w % 16); a CUDA band that breaks it raises instead of falling back."""
    band = torch.zeros(64, w // 2 if dtype == torch.uint8 else w, dtype=dtype)
    stair = [(0, 64, w)]
    xc = torch.zeros(w, 8, dtype=torch.bfloat16)
    rows = torch.arange(64, dtype=torch.int32)
    checks = [lambda: core_int._check_kernel_contract([band], stair),
              lambda: core_dot._check_kernel_contract(
                  [band], xc, rows, stair, torch.zeros(64, 8))]
    for check in checks:
        if ok:
            check()
        else:
            q = core_dot.width_rule(dtype == torch.uint8)
            with pytest.raises(ValueError, match=f"% {q}"):
                check()
