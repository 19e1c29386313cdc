"""K-core's grouped form (all staircase bands in one launch) on the CPU:
its plain version against the JAX reference's core contribution, the
host tile schedule the kernel walks, and the wrapper's checks. The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py.

Tolerance: as in test_torch_kernels_plain.py, 1e-5 of each element's sum
of |terms| — every int8 × bf16 product is exact in f32, and only the
order of the f32 sums differs between JAX and torch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pygim_tpu.core import graph as jgraph
from pygim_tpu.ops import spmm as jspmm
from pygim_tpu_torch.core import graph as tgraph
from pygim_tpu_torch.ops import core_dot
from pygim_tpu_torch.ops import spmm as tspmm

from test_torch_prepare import GRAPHS, KW, N, make_graph

REL = 1e-5

# the smoke configuration's bands (ogbn-arxiv stand-in, 256 MiB budget)
SMOKE_STAIR = [(0, 22424, 9728), (22424, 24360, 2048), (24360, 25384, 2560),
               (25384, 45224, 1280), (45224, 47128, 768), (47128, 51184, 512),
               (51184, 80584, 256), (80584, 103216, 256)]


@pytest.mark.parametrize("h", [32, 256])
@pytest.mark.parametrize("kind", GRAPHS)
def test_core_bands_plain_matches_jax_core_scatter(kind, h, monkeypatch):
    """All bands of a prepared small R-MAT against the reference's
    ``_core_scatter`` over the XLA ``_core_matmul`` (Pallas gate unset)."""
    monkeypatch.delenv("PYGIM_CORE_PALLAS", raising=False)
    rows, cols, vals = make_graph(kind)
    jp = jspmm.prepare_spmm(
        jgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        jspmm.SpmmConfig(**KW))
    tp = tspmm.prepare_spmm(
        tgraph.CooGraph.from_edges(rows, cols, vals, nrows=N, ncols=N),
        tspmm.SpmmConfig(**KW), device="cpu")
    assert tp.stair == jp.stair and len(tp.stair) > 1
    x = np.random.default_rng(h).standard_normal((N, h)).astype(np.float32)
    jdev = jp.dev_arrays
    jxc = jnp.take(jnp.asarray(x), jdev["core_nodes"], axis=0)
    want = np.asarray(jp._core_scatter(jdev, jnp.zeros((N, h), jnp.float32),
                                       jxc, jnp.float32))

    dev = tp.dev_arrays
    cn = dev["core_nodes"]
    bands = [dev[f"stair{b}"] for b in range(len(tp.stair))]
    xc = torch.from_numpy(x).index_select(0, cn.long()).to(torch.bfloat16)
    got = core_dot.core_bands_plain(bands, xc, cn, tp.stair,
                                    torch.zeros(N, h)).numpy()

    mag = np.zeros((N, h))
    xabs = np.abs(xc.float().numpy().astype(np.float64))
    for band, (lo, hi, w) in zip(bands, tp.stair):
        np.add.at(mag, cn[lo:hi].numpy(),
                  np.abs(band.numpy().astype(np.float64)) @ xabs[:w])
    assert mag.any()
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


def _check_schedule(stair, h, n_blocks, tiles, starts, bn=core_dot.BN):
    assert tiles.dtype == np.int32 and tiles.shape[1] == 3
    assert starts[0] == 0 and starts[-1] == len(tiles)
    assert np.all(np.diff(starts) >= 0)
    assert len(starts) - 1 == min(n_blocks, len(tiles))
    # every (band, row tile, column block) exactly once
    want = sorted((b, m0, n0) for b, (lo, hi, _w) in enumerate(stair)
                  for m0 in range(0, hi - lo, core_dot.BM)
                  for n0 in range(0, h, bn))
    assert sorted(map(tuple, tiles.tolist())) == want
    # each block runs its tiles longest contraction first (steps of 64)
    length = np.array([-(-stair[b][2] // 64) for b in tiles[:, 0]])
    for i in range(len(starts) - 1):
        assert np.all(np.diff(length[starts[i]:starts[i + 1]]) <= 0)


@pytest.mark.parametrize("n_blocks", [132, 7])
@pytest.mark.parametrize("h", [40, 256, 384])
def test_tile_schedule_covers_every_tile_once(h, n_blocks):
    for stair in (SMOKE_STAIR, SMOKE_STAIR[:1], [(0, 37, 208), (37, 45, 64)]):
        tiles, starts = core_dot.tile_schedule(stair, h, n_blocks)
        _check_schedule(stair, h, n_blocks, tiles, starts)


@pytest.mark.parametrize("n_bands", [1, 16, 17, 40])
def test_band_groups_cover_every_band_once(n_bands):
    # a stair of more bands than one launch carries takes one launch per
    # group; bands without cells take none
    rng = np.random.default_rng(n_bands)
    rows = rng.integers(0, 3, n_bands) * 64
    rows[0] = 64
    his = np.cumsum(rows)
    stair = [(int(hi - r), int(hi), int(w)) for hi, r, w in zip(
        his, rows, rng.integers(1, 5, n_bands) * 16)]
    groups = core_dot.band_groups(stair, 256)
    assert core_dot.band_groups(stair, 0) == []
    assert all(1 <= len(g) <= core_dot.MAX_BANDS for g in groups)
    flat = [b for g in groups for b in g]
    assert flat == [b for b, (lo, hi, _w) in enumerate(stair) if hi > lo]
    assert len(groups) == -(-len(flat) // core_dot.MAX_BANDS)
    for g in groups:
        sub = [stair[b] for b in g]
        _check_schedule(sub, 256, 132, *core_dot.tile_schedule(sub, 256, 132))


def _grouped_inputs(seed=0, h=24):
    rng = np.random.default_rng(seed)
    stair = [(0, 40, 320), (40, 72, 64), (72, 80, 16)]
    bands = [torch.from_numpy(rng.integers(-128, 128, (hi - lo, w))
                              .astype(np.int8)) for lo, hi, w in stair]
    xc = torch.from_numpy(rng.standard_normal((330, h)).astype(np.float32)
                          ).to(torch.bfloat16)
    cn = torch.from_numpy(rng.permutation(200)[:90].astype(np.int32))
    out = torch.from_numpy(rng.standard_normal((200, h)).astype(np.float32))
    return bands, xc, cn, stair, out


def test_grouped_wrapper_on_cpu_is_the_plain_version():
    bands, xc, cn, stair, out0 = _grouped_inputs()
    before = core_dot.launches
    got = core_dot.core_bands_scatter_add(bands, xc, cn, stair, out0.clone())
    want = core_dot.core_bands_plain(bands, xc, cn, stair, out0.clone())
    assert torch.equal(got, want)
    assert not torch.equal(got, out0)
    assert core_dot.launches == before  # the plain version is no launch
    # the per-band loop of the single-band wrapper gives the same sums
    loop = out0.clone()
    for band, (lo, hi, _w) in zip(bands, stair):
        core_dot.core_band_scatter_add(band, xc, cn[lo:hi], loop)
    assert torch.equal(loop, want)


@pytest.mark.parametrize("bad", [
    "band_dtype", "xc_dtype", "rows_dtype", "out_dtype", "band_shape",
    "count", "xc_short", "rows_short", "out_width", "device", "noncontig",
    "meta_device",
])
def test_grouped_wrapper_rejects(bad):
    bands, xc, cn, stair, out = _grouped_inputs(1)
    if bad == "band_dtype":
        bands[1] = bands[1].to(torch.int16)
    elif bad == "xc_dtype":
        xc = xc.float()
    elif bad == "rows_dtype":
        cn = cn.long()
    elif bad == "out_dtype":
        out = out.double()
    elif bad == "band_shape":
        bands[0] = bands[0][:, :256].contiguous()
    elif bad == "count":
        bands = bands[:2]
    elif bad == "xc_short":
        xc = xc[:300]
    elif bad == "rows_short":
        cn = cn[:79]
    elif bad == "out_width":
        out = out[:, :16].contiguous()
    elif bad == "device":
        out = out.to("meta")
    elif bad == "noncontig":
        bands[0] = bands[0].t().contiguous().t()
    else:
        bands = [t.to("meta") for t in bands]
        xc, cn, out = xc.to("meta"), cn.to("meta"), out.to("meta")
    with pytest.raises((TypeError, ValueError)):
        core_dot.core_bands_scatter_add(bands, xc, cn, stair, out)


@pytest.mark.parametrize("bad", ["width", "h", "align"])
def test_kernel_contract_is_checked(bad):
    bands, xc, cn, stair, out = _grouped_inputs(2, h=32)
    if bad == "width":
        stair = [(0, 40, 312), *stair[1:]]
        bands[0] = bands[0][:, :312].contiguous()
    elif bad == "h":
        xc, out = xc[:, :28].contiguous(), out[:, :28].contiguous()
    else:  # a band that starts one byte into its storage
        lo, hi, w = stair[1]
        bands[1] = torch.zeros((hi - lo) * w + 1, dtype=torch.int8)[1:].view(
            hi - lo, w)
    core_dot._check(bands, xc, cn, stair, out)  # the function is valid
    with pytest.raises(ValueError, match="K-core kernel needs"):
        core_dot._check_kernel_contract(bands, xc, cn, stair, out)
    good = _grouped_inputs(2, h=32)
    core_dot._check_kernel_contract(*good)
