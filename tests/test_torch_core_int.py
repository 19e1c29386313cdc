"""K-int on the CPU: its plain version and a CPU emulation of the
kernel's limb arithmetic against the JAX reference's integer core
products (``_core_matmul``'s s8 branch and ``_wide_int_core_dot``), the
limb split, the kernel's cluster schedule and the wrapper's checks. The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py.

Every comparison here is bit-equal int32: the products are exact
integers and both packages wrap them mod 2^32."""

import collections
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.ops import core_dot, core_int

from test_torch_core_grouped import SMOKE_STAIR

# (limbs, payload dtype, magnitude bound): every limb count with the
# range it is used for — raw int8, the quantized int16 and int32 ranges,
# raw int16 (three limbs) and any int32 (four)
CASES = [(1, np.int8, 1 << 7), (2, np.int16, 1 << 9), (3, np.int32, 1 << 19),
         (3, np.int16, 1 << 15), (4, np.int32, 1 << 31)]
IDS = ["L1-int8", "L2-int16q", "L3-int32q", "L3-int16", "L4-int32"]


def payload(rng, shape, dtype, m):
    return rng.integers(-m, m, shape, dtype=np.int64).astype(dtype)


def jax_product(band, xc):
    """The reference's core product of one band: int32."""
    w = band.shape[1]
    got = jspmm._core_matmul(jnp.asarray(band), jnp.asarray(xc[:w]),
                             jnp.float32)
    assert got.dtype == jnp.int32
    return np.asarray(got)


def emulate_limbs(band, xc, limbs):
    """The kernel's arithmetic on the CPU: split ``xc`` into int8 limbs as
    the wrapper does, one s8 product per limb with its int32 sum wrapped,
    then the recombination ``Σ P_l << 8l`` in uint32."""
    r, w = band.shape
    h = xc.shape[1]
    xct = core_int.limb_split(torch.from_numpy(xc[:w]), limbs, -(-h // 64) * 64,
                              -(-w // 16) * 16)
    a = torch.from_numpy(band).to(torch.int64)
    acc = torch.zeros((r, h), dtype=torch.int64)
    for l in range(limbs):
        p = a @ xct[l, :h, :w].t().to(torch.int64)
        p = ((p + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # an s32 accumulator
        acc = (acc + ((p & 0xFFFFFFFF) << (8 * l))) & 0xFFFFFFFF
    return (((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32).numpy()


@pytest.mark.parametrize("limbs,dtype,m", CASES, ids=IDS)
@pytest.mark.parametrize("r,w,h", [(37, 208, 41), (130, 512, 64),
                                   (64, 96, 300)])
def test_plain_and_limb_emulation_match_jax(limbs, dtype, m, r, w, h):
    rng = np.random.default_rng(r * w + h + limbs)
    band = rng.integers(-128, 128, (r, w)).astype(np.int8)
    xc = payload(rng, (w + 5, h), dtype, m)
    want = jax_product(band, xc)
    got = core_int.band_product_plain(torch.from_numpy(band),
                                      torch.from_numpy(xc)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_limbs(band, xc, limbs), want)


@pytest.mark.parametrize("limbs,q", [(3, (1 << 19) - 3), (3, -(1 << 19)),
                                     (4, (1 << 31) - 7), (4, -(1 << 31))])
def test_int32_wraparound_matches_jax(limbs, q):
    """A dense band of 127s times payloads at the top of each range: every
    int32 sum overflows, in the reference as in the port."""
    r, w, h = 24, 4096, 16
    band = np.full((r, w), 127, np.int8)
    xc = np.full((w, h), q, np.int64)
    xc[::3] = -q if q != -(1 << 31) else q
    xc = xc.astype(np.int32)
    exact = band.astype(np.int64) @ xc.astype(np.int64)
    assert np.any(np.abs(exact) >= 1 << 31)
    want = jax_product(band, xc)
    np.testing.assert_array_equal(
        want, (((exact + (1 << 31)) % (1 << 32)) - (1 << 31)).astype(np.int32))
    got = core_int.band_product_plain(torch.from_numpy(band),
                                      torch.from_numpy(xc)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_limbs(band, xc, limbs), want)


@pytest.mark.parametrize("limbs,dtype,m", CASES, ids=IDS)
def test_chunked_wide_reference_path(limbs, dtype, m, monkeypatch):
    """The reference's chunked ``_wide_int_core_dot`` branch (a small
    chunk budget; clamped, overlapping last chunk) against the port."""
    r, w, h = 700, 96, 24
    monkeypatch.setattr(jspmm, "_WIDE_INT_CHUNK_BYTES", 256 * 4 * w)
    rng = np.random.default_rng(limbs)
    band = rng.integers(-128, 128, (r, w)).astype(np.int8)
    xc = payload(rng, (w, h), np.int32 if dtype == np.int8 else dtype, m)
    want = np.asarray(jspmm._wide_int_core_dot(jnp.asarray(band),
                                               jnp.asarray(xc, jnp.int32)))
    got = core_int.band_product_plain(torch.from_numpy(band),
                                      torch.from_numpy(xc)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_limbs(band, xc, limbs), want)


@pytest.mark.parametrize("h", [16, 256])
def test_core_int_plain_matches_jax_core_scatter(h):
    """All bands of a stair against the reference's ``_core_scatter`` on an
    int32 payload: the f32 sums of int32 products, added once a row."""
    rng = np.random.default_rng(h)
    stair = [(0, 40, 320), (40, 72, 64), (72, 80, 16)]
    bands = [rng.integers(-128, 128, (hi - lo, w)).astype(np.int8)
             for lo, hi, w in stair]
    cn = rng.permutation(200)[:90].astype(np.int32)
    xc = payload(rng, (330, h), np.int32, 1 << 19)

    prep = types.SimpleNamespace(stair=stair)
    jdev = {"core_nodes": jnp.asarray(cn),
            **{f"stair{b}": jnp.asarray(t) for b, t in enumerate(bands)}}
    want = np.asarray(jspmm.PreparedSpmm._core_scatter(
        prep, jdev, jnp.zeros((200, h), jnp.float32), jnp.asarray(xc),
        jnp.float32))
    got = core_int.core_int_plain(
        [torch.from_numpy(t) for t in bands], torch.from_numpy(xc),
        torch.from_numpy(cn), stair, torch.zeros(200, h)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("limbs,dtype,m", CASES, ids=IDS)
def test_limb_split_layout_and_recombination(limbs, dtype, m):
    rng = np.random.default_rng(7)
    q = payload(rng, (50, 70), dtype, m)
    q[0, :4] = [m - 1, -m, 0, -1]
    xct = core_int.limb_split(torch.from_numpy(q), limbs, 128, 64)
    assert xct.dtype == torch.int8 and xct.shape == (limbs, 128, 64)
    assert xct.is_contiguous()
    assert not xct[:, 70:].any() and not xct[:, :, 50:].any()
    back = sum(xct[l, :70, :50].t().to(torch.int64) << (8 * l)
               for l in range(limbs))
    back = (((back + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).numpy()
    np.testing.assert_array_equal(back, q.astype(np.int64))


def test_two_limbs_do_not_hold_every_int16():
    """Why a raw int16 payload takes three limbs: two balanced int8 digits
    reach only [-32896, 32639]."""
    q = torch.tensor([[32639], [32640], [32767], [-32768]], dtype=torch.int16)
    xct = core_int.limb_split(q, 2, 64, 16)
    back = (xct[0, 0, :4].to(torch.int64)
            + 256 * xct[1, 0, :4].to(torch.int64)).tolist()
    assert back[0] == 32639 and back[3] == -32768
    assert back[1] != 32640 and back[2] != 32767
    assert core_int.RAW_LIMBS[torch.int16] == 3


def _check_cluster_schedule(stair, h, limbs, n_clusters, tiles, starts):
    """K-int's cluster schedule: each live block tile once, the blocks of
    a cluster tile on one band (so one contraction length) and one column
    tile at their place in the cluster, the blocks past the band's rows
    kept and marked not live, each cluster longest first, and the
    clusters balanced."""
    cm = core_int.CLUSTER_ROWS[limbs]
    bn = core_int.tile_columns(limbs)
    assert tiles.dtype == np.int32 and tiles.shape[1:] == (cm, 4)
    assert starts[0] == 0 and starts[-1] == len(tiles)
    assert np.all(np.diff(starts) >= 0)
    cells = sum(-(-(hi - lo) // (128 * cm)) * -(-h // bn)
                for lo, hi, _w in stair)
    assert len(starts) - 1 == min(n_clusters, cells) == min(n_clusters,
                                                            len(tiles))
    live = collections.Counter()
    dead = 0
    for ct in tiles.tolist():
        b, m0c, n0c, _live = ct[0]
        lo, hi, _w = stair[b]
        assert m0c % (128 * cm) == 0 and n0c % bn == 0
        assert m0c < hi - lo and n0c < h  # block 0 is always live
        for i, (bb, m0, n0, is_live) in enumerate(ct):
            assert (bb, m0, n0) == (b, m0c + 128 * i, n0c)
            assert is_live == int(m0 < hi - lo)
            if is_live:
                live[(b, m0, n0)] += 1
            else:
                dead += 1
    want = {(b, m0, n0) for b, (lo, hi, _w) in enumerate(stair)
            for m0 in range(0, hi - lo, 128) for n0 in range(0, h, bn)}
    assert set(live) == want and set(live.values()) == {1}
    assert dead == len(tiles) * cm - len(want)
    length = np.array([-(-stair[b][2] // 64) for b in tiles[:, 0, 0]])
    sizes = np.diff(starts)
    for c in range(len(sizes)):
        assert np.all(np.diff(length[starts[c]:starts[c + 1]]) <= 0)
    # no cluster idles while another holds two cluster tiles more
    assert sizes.min() > 0 or sizes.max() <= 1
    return dead


@pytest.mark.parametrize("limbs,bn,cm", [(1, 256, 1), (2, 128, 1),
                                         (3, 64, 1), (4, 64, 2)])
@pytest.mark.parametrize("h", [41, 256, 1100])
def test_kernel_tiles_cover_every_tile_once(limbs, bn, cm, h):
    assert core_int.tile_columns(limbs) == bn
    assert core_int.CLUSTER_ROWS[limbs] == cm
    n = 132 // cm  # the clusters an H100's 132 SMs hold
    for stair in (SMOKE_STAIR, [(0, 37, 208), (37, 45, 64)]):
        tiles, starts = core_int.cluster_schedule(stair, h, limbs, n)
        _check_cluster_schedule(stair, h, limbs, n, tiles, starts)


# a ragged stair: bands of an odd count of 128-row tiles (155, 15 and 177
# as in the smoke stair's), bands shorter than one tile, widths that are
# not multiples of the 64-deep stage
RAGGED_STAIR = [(0, 155 * 128 - 40, 1296), (19800, 19800 + 15 * 128, 208),
                (21720, 21757, 64), (21757, 21757 + 177 * 128 - 1, 96),
                (44412, 44420, 16)]


@pytest.mark.parametrize("n_clusters", [66, 5, 1])
@pytest.mark.parametrize("limbs", [3, 4])
@pytest.mark.parametrize("h", [41, 256, 1100])
@pytest.mark.parametrize("stair", ["smoke", "ragged"])
def test_cluster_schedule(stair, h, limbs, n_clusters):
    stair = SMOKE_STAIR if stair == "smoke" else RAGGED_STAIR
    tiles, starts = core_int.cluster_schedule(stair, h, limbs, n_clusters)
    dead = _check_cluster_schedule(stair, h, limbs, n_clusters, tiles,
                                   starts)
    # at four limbs (two row tiles a cluster) the odd row-tile counts
    # leave partners empty; single blocks leave none
    assert (dead > 0) == (limbs == 4)


def _inputs(seed=0, h=24, dtype=np.int32):
    rng = np.random.default_rng(seed)
    stair = [(0, 40, 320), (40, 72, 64), (72, 80, 16)]
    bands = [torch.from_numpy(rng.integers(-128, 128, (hi - lo, w))
                              .astype(np.int8)) for lo, hi, w in stair]
    xc = torch.from_numpy(payload(rng, (330, h), dtype, 1 << 7))
    cn = torch.from_numpy(rng.permutation(200)[:90].astype(np.int32))
    out = torch.from_numpy(rng.standard_normal((200, h)).astype(np.float32))
    return bands, xc, cn, stair, out


@pytest.mark.parametrize("built_for", ["k_core", "three_limbs"])
def test_launch_rejects_plans_of_another_schedule(built_for):
    """A launch takes only K-int's plans for its limb count: K-core's tile
    schedule and the three-limb one have the four-limb tile width (64
    columns), not its clusters of two row tiles."""
    bands, xc, cn, stair, out = _inputs()
    h = out.shape[1]
    if built_for == "k_core":
        tiles, starts = core_dot.tile_schedule(stair, h, 4, 64)
    else:
        tiles, starts = core_int.cluster_schedule(stair, h, 3, 4)
    plan = core_dot.CorePlan(
        group=list(range(len(stair))), ptrs=tuple(b.data_ptr() for b in bands),
        h=h, bn=core_int.tile_columns(4), maps=None, info=None,
        tiles=torch.from_numpy(tiles), starts=torch.from_numpy(starts),
        grid=len(starts) - 1)
    xct = core_int.limb_split(xc[:320], 4, 64, 320)
    with pytest.raises(ValueError, match="plans were built"):
        core_int.core_int_launch(bands, xct, cn, stair, out, [plan])


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    bands, xc, cn, stair, out0 = _inputs(dtype=dtype)
    before = core_int.launches
    got = core_int.core_int_scatter_add(bands, xc, cn, stair, out0.clone())
    want = core_int.core_int_plain(bands, xc, cn, stair, out0.clone())
    assert torch.equal(got, want)
    assert core_int.launches == before


@pytest.mark.parametrize("bad", ["xc_float", "xc_int64", "band_shape",
                                 "rows_dtype", "out_dtype", "out_width",
                                 "device"])
def test_wrapper_rejects(bad):
    bands, xc, cn, stair, out = _inputs()
    if bad == "xc_float":
        xc = xc.float()
    elif bad == "xc_int64":
        xc = xc.long()
    elif bad == "band_shape":
        bands[0] = bands[0][:, :256].contiguous()
    elif bad == "rows_dtype":
        cn = cn.long()
    elif bad == "out_dtype":
        out = out.double()
    elif bad == "out_width":
        out = out[:, :16].contiguous()
    else:
        out = out.to("meta")
    with pytest.raises((TypeError, ValueError)):
        core_int.core_int_scatter_add(bands, xc, cn, stair, out)


@pytest.mark.parametrize("bad", ["width", "align"])
def test_kernel_contract_is_checked(bad):
    bands, _xc, _cn, stair, _out = _inputs()
    if bad == "width":
        stair = [(0, 40, 312), *stair[1:]]
        bands[0] = bands[0][:, :312].contiguous()
    else:  # a band that starts one byte into its storage
        lo, hi, w = stair[1]
        bands[1] = torch.zeros((hi - lo) * w + 1, dtype=torch.int8)[1:].view(
            hi - lo, w)
    with pytest.raises(ValueError, match="K-int kernel needs"):
        core_int._check_kernel_contract(bands, stair)
    good = _inputs()
    core_int._check_kernel_contract(good[0], good[3])


def test_tile_columns_rejects_other_limb_counts():
    for limbs in (0, 5):
        with pytest.raises(ValueError):
            core_int.tile_columns(limbs)
