"""K-core's stream-K schedule (split 0) on the CPU: the host work list the
kernel walks, held to its contract, and a NumPy emulation of the kernel's
arithmetic on that list against the plain version; which launches the
host model gives it. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py.

Tolerance of the emulated products: as test_torch_core_grouped.py, 1e-5
of each element's sum of |terms| (every product exact in f32, only the
order of the f32 sums differs)."""

import numpy as np
import pytest
import torch

from pygim_tpu_torch.ops import core_dot

from test_torch_core_grouped import (
    CONFIG4_SQUARE,
    H100_CLUSTERS,
    SMOKE_SQUARE,
    SMOKE_STAIR,
    _check_schedule,
)

REL = 1e-5
BM, BN, BK = core_dot.BM, core_dot.BN, core_dot.BK
# the H100's resident K-core blocks, stream-K included (one an SM)
H100 = {**H100_CLUSTERS, core_dot.STREAM: 132}
# the smoke configuration's bf16 cores (ogbn-arxiv stand-in, 256 MiB)
BF16_STAIR = [(0, 176, 80640), (176, 1016, 30720), (1016, 4136, 8192),
              (4136, 12584, 2816), (12584, 31200, 1280), (31200, 57928, 512),
              (57928, 60368, 256), (60368, 80584, 256)]
BF16_SQUARE = [(0, 11520, 11520)]
# reddit-sim's squares (bf16 12 GiB, int8 12 GiB, int4 8 GiB) and its bf16
# stair at 8 GiB
REDDIT = {"bf16": ([(0, 80128, 80128)], 2.0),
          "bf16 stair": ([(0, 12576, 115456), (12576, 30976, 61696),
                          (30976, 61568, 30976), (61568, 103056, 12800),
                          (103056, 145280, 4352), (145280, 180064, 1024),
                          (180064, 204816, 256), (204816, 213800, 256)],
                         2.0),
          "int8": ([(0, 113408, 113408)], 1.0),
          "int4": ([(0, 131072, 131072)], 0.5)}
RAGGED = [(0, 421, 5120), (421, 458, 256), (458, 1758, 2080),
          (1758, 1766, 128), (1766, 1942, 9984)]
CASES = {"bf16 stair": (BF16_STAIR, 2.0), "bf16 square": (BF16_SQUARE, 2.0),
         "ragged": (RAGGED, 1.0), "int8 stair": (SMOKE_STAIR, 1.0),
         "int4 square": (SMOKE_SQUARE, 0.5)}


def pieces(tiles, starts):
    """Each block's pieces as tuples, in the order the block runs them."""
    t = tiles[:, 0, :].tolist()
    return [[tuple(p) for p in t[starts[i]:starts[i + 1]]]
            for i in range(len(starts) - 1)]


def check_stream(stair, h, blocks, cell_bytes, tiles, starts):
    """The stream-K contract: every (tile, stage) exactly once, in pieces
    of whole stages; a tile's pieces in consecutive blocks, k rising with
    the block; each block's leading-piece hand-over (role 0) the first
    piece it runs and its only one; a tile's last piece in the last of
    those blocks with role = its piece count. Returns the pieces."""
    assert tiles.dtype == np.int32 and tiles.shape[1:] == (1, 6)
    assert starts[0] == 0 and starts[-1] == len(tiles)
    assert np.all(np.diff(starts) >= 1)  # no empty span
    assert len(starts) - 1 <= blocks
    per = pieces(tiles, starts)
    seen = {}
    for i, ps in enumerate(per):
        roles = [p[3] for p in ps]
        assert roles.count(0) <= 1
        if 0 in roles:
            assert roles[0] == 0
        for b, m0, n0, role, k0, k1 in ps:
            lo, hi, w = stair[b]
            assert m0 % BM == 0 and m0 < hi - lo and n0 % BN == 0 and n0 < h
            assert 0 <= k0 < k1 <= w and k0 % BK == 0
            assert k1 % BK == 0 or k1 == w
            seen.setdefault((b, m0, n0), []).append((i, role, k0, k1))
    want = {(b, m0, n0) for b, (lo, hi, _w) in enumerate(stair)
            for m0 in range(0, hi - lo, BM) for n0 in range(0, h, BN)}
    assert set(seen) == want
    for (b, _m0, _n0), ps in seen.items():
        ps.sort()
        blocks_of = [p[0] for p in ps]
        assert blocks_of == list(range(blocks_of[0], blocks_of[0] + len(ps)))
        # the pieces tile [0, w) in order, k rising with the block
        assert ps[0][2] == 0 and ps[-1][3] == stair[b][2]
        for (_i, _r, _k0, k1), (_j, _s, n0_, _n1) in zip(ps, ps[1:]):
            assert k1 == n0_
        assert [p[1] for p in ps] == [0] * (len(ps) - 1) + [len(ps)]
    return per


@pytest.mark.parametrize("blocks", [132, 37, 7])
@pytest.mark.parametrize("h", [40, 256, 384])
@pytest.mark.parametrize("case", list(CASES))
def test_stream_schedule_covers_every_tile_stage_once(case, h, blocks):
    stair, cell = CASES[case]
    tiles, starts = core_dot.stream_schedule(stair, h, BN, blocks, cell)
    check_stream(stair, h, blocks, cell, tiles, starts)
    # the same list every time: the kernel's sums run in its fixed order
    again = core_dot.stream_schedule(stair, h, BN, blocks, cell)
    assert np.array_equal(again[0], tiles)
    assert np.array_equal(again[1], starts)


@pytest.mark.parametrize("case", list(CASES))
def test_stream_spans_within_one_stage_of_equal(case):
    """The spans cut the modeled work (stages at ``step_cost``, an
    epilogue where a tile ends) at its 132 equal shares: each share's
    point has a span ending within one stage and one epilogue after it,
    and every span ends so. Where a share is smaller than that (the
    ragged stair's short tiles) spans merge, else there are 132."""
    stair, cell = CASES[case]
    tiles, starts = core_dot.stream_schedule(stair, 256, BN, 132, cell)
    step = core_dot.step_cost(cell)
    work = []
    for ps in pieces(tiles, starts):
        work.append(sum(-(-(k1 - k0) // BK) * step
                        + core_dot._EPILOGUE_COST * (role > 0)
                        for _b, _m, _n, role, k0, k1 in ps))
    total = sum(work)
    assert total == pytest.approx(
        sum(-(-w // BK) * step + core_dot._EPILOGUE_COST
            for lo, hi, w in stair for _m in range(0, hi - lo, BM)
            for _n in range(0, 256, BN)))
    shares = total * np.arange(1, 133) / 132
    ends = np.cumsum(work)
    slack = step + core_dot._EPILOGUE_COST
    for c in shares:
        assert np.any((ends >= c - 1e-6) & (ends <= c + slack))
    for end in ends:
        assert np.any((end >= shares - 1e-6) & (end <= shares + slack))
    if slack < total / 132:
        assert len(work) == 132


def test_stream_fixup_order_is_fixed():
    """A tile's last piece (role n) adds the partials of the blocks
    before it, b - 1 down to b - n + 1, each written there as that
    block's first piece: so a block waits only on blocks of lower index,
    whose partials wait on nothing, and the order of the sum is fixed."""
    tiles, starts = core_dot.stream_schedule(BF16_STAIR, 256, BN, 132, 2.0)
    per = pieces(tiles, starts)
    cut = 0
    for i, ps in enumerate(per):
        for b, m0, n0, role, k0, _k1 in ps:
            for q in range(1, role):
                lead = per[i - q][0]
                assert lead[:3] == (b, m0, n0) and lead[3] == 0
                assert lead[5] == (k0 if q == 1 else per[i - q + 1][0][4])
                cut += 1
    assert cut > 0


def test_stream_spreads_the_long_band_and_fills_the_card():
    """The smoke stair's 176 × 80,640 band goes to more than 8 blocks
    (the cluster schedule's split 4 runs it on 8); the smoke square's 90
    row tiles of k 11,520 fill all 132 blocks (at split 1, 42 SMs sat
    idle)."""
    tiles, starts = core_dot.stream_schedule(BF16_STAIR, 256, BN, 132, 2.0)
    per = pieces(tiles, starts)
    assert len(per) == 132
    on_band0 = [i for i, ps in enumerate(per) if any(p[0] == 0 for p in ps)]
    assert len(on_band0) > 8
    tiles, starts = core_dot.stream_schedule(BF16_SQUARE, 256, BN, 132, 2.0)
    assert len(starts) - 1 == 132
    assert {p[0] for ps in pieces(tiles, starts) for p in ps} == {0}


@pytest.mark.parametrize("clusters", [132, H100])
def test_model_gives_stream_k_where_it_predicts_a_gain(clusters):
    """The host model predicts a gain of stream-K over whole tiles of at
    least its margin on the smoke bf16 square and stair and the smoke
    int4 square (180 row tiles for 132 SMs); the other int8 and int4
    launches (the smoke int8 stair, config 4's square, reddit's squares)
    and the reddit-sim bf16 cores keep whole tiles (split 1), list for
    list, which is also the split the cluster model (K-int's) picks for
    them."""
    for stair, cell in ((BF16_STAIR, 2.0), (BF16_SQUARE, 2.0),
                        (SMOKE_SQUARE, 0.5), (SMOKE_SQUARE, 1.0)):
        assert core_dot.choose_schedule(stair, 256, BN, clusters,
                                        cell) == core_dot.STREAM
        assert core_dot.schedule_split(stair, 256, clusters,
                                       cell_bytes=cell) == [core_dot.STREAM]
        tiles, starts = core_dot.tile_schedule(stair, 256, clusters,
                                               cell_bytes=cell)
        check_stream(stair, 256, 132, cell, tiles, starts)
        assert core_dot.schedule_balance(stair, 256, clusters,
                                         cell_bytes=cell) < 1.25
    keep = [(SMOKE_STAIR, 1.0), (CONFIG4_SQUARE, 0.5), (CONFIG4_SQUARE, 1.0),
            *REDDIT.values()]
    counts = core_dot.cluster_counts(clusters)
    for stair, cell in keep:
        assert core_dot.choose_split(stair, 256, BN, counts,
                                     cell_bytes=cell) == 1
        assert core_dot.choose_schedule(stair, 256, BN, clusters,
                                        cell) == 1
        got = core_dot.tile_schedule(stair, 256, clusters, cell_bytes=cell)
        want = core_dot.cluster_schedule(stair, 256, BN, counts, split=1,
                                         cell_bytes=cell)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        _check_schedule(stair, 256, clusters, *got)


def test_stream_model_counts_the_hand_over():
    """A block's modeled work: its stages, an epilogue a tile it ends,
    one partial written or read a piece handed over."""
    tiles, starts = core_dot.stream_schedule(BF16_SQUARE, 256, BN, 132, 2.0)
    loads = core_dot.stream_loads(tiles, starts, 2.0)
    per = pieces(tiles, starts)
    for load, ps in zip(loads, per):
        want = sum(-(-(k1 - k0) // BK) * 1.2
                   + (core_dot._EPILOGUE_COST if role else 0)
                   + core_dot._PARTIAL_COST * (role - 1 if role else 1)
                   for _b, _m, _n, role, k0, k1 in ps)
        assert load == pytest.approx(want)


def emulate_stream(bands, xc, rows, stair, out, tiles, starts):
    """The kernel's arithmetic on a stream-K list, in NumPy f32: each
    piece's product; a leading piece's into its block's slot, a last
    piece's plus the slots of the blocks before it, b - 1 first, then
    scattered into ``out``."""
    slots = {}
    cells = [core_dot.band_cells(b).float().numpy() for b in bands]
    x = xc.float().numpy()
    for i, ps in enumerate(pieces(tiles, starts)):
        for b, m0, n0, role, k0, k1 in ps:
            a = cells[b][m0:m0 + BM, k0:k1]
            acc = (a @ x[k0:k1, n0:n0 + BN]).astype(np.float32)
            if role == 0:
                slots[i] = acc
                continue
            for q in range(1, role):
                acc = acc + slots.pop(i - q)
            lo = stair[b][0]
            ids = rows[lo + m0:lo + m0 + acc.shape[0]]
            out[ids, n0:n0 + acc.shape[1]] += acc
    assert not slots  # every partial read once
    return out


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("blocks", [132, 9])
def test_stream_emulation_matches_the_plain_version(blocks, packed):
    gen = torch.Generator().manual_seed(blocks + packed)
    stair = [(lo, hi, w * (2 if packed else 1)) for lo, hi, w in RAGGED]
    bands = []
    for lo, hi, w in stair:
        if packed:
            bands.append(torch.randint(0, 256, (hi - lo, w // 2),
                                       generator=gen).to(torch.uint8))
        else:
            bands.append(torch.randn(hi - lo, w,
                                     generator=gen).to(torch.bfloat16))
    n = stair[-1][1]
    h = 264
    w_max = max(w for *_, w in stair)
    xc = torch.randn(w_max, h, generator=gen).to(torch.bfloat16)
    rows = torch.randperm(2 * n, generator=gen)[:n].to(torch.int32)
    out0 = torch.randn(2 * n, h, generator=gen)
    tiles, starts = core_dot.stream_schedule(stair, h, BN, blocks,
                                             0.5 if packed else 2.0)
    got = emulate_stream(bands, xc, rows.numpy(), stair, out0.numpy().copy(),
                         tiles, starts)
    want = core_dot.core_bands_plain(bands, xc, rows, stair,
                                     out0.clone()).numpy()
    mag = core_dot.core_bands_plain(
        [core_dot.band_cells(b).abs() for b in bands], xc.abs(), rows, stair,
        out0.abs()).numpy()
    assert np.all(np.abs(got - want) <= REL * mag + 1e-30)


def test_stream_plans_carry_their_workspace():
    """A stream-K plan: split 0, its blocks from the card's resident
    count; its workspace (one 2 × 128 × 128 f32 partial and two flags a
    block) is made on the card only, by ``core_plans``."""
    band = torch.zeros(300, 256, dtype=torch.bfloat16)
    xc = torch.zeros(256, 256, dtype=torch.bfloat16)
    rows = torch.arange(300, dtype=torch.int32)
    out = torch.zeros(300, 256)
    tiles, starts = core_dot.stream_schedule([(0, 300, 256)], 256, BN, 3)
    plan = core_dot.CorePlan(
        group=[0], ptrs=(band.data_ptr(),), h=256, bn=BN, maps=None,
        info=None, tiles=torch.from_numpy(tiles),
        starts=torch.from_numpy(starts), grid=len(starts) - 1,
        split=core_dot.STREAM)
    assert plan.partials is None and plan.flags is None
    # on the CPU the plain version runs and the plans are not read
    core_dot.core_bands_scatter_add([band], xc, rows, [(0, 300, 256)], out,
                                    plans=[plan])
    assert core_dot.stream_blocks({1: 132, 2: 66, 4: 30}) == 132
    assert core_dot.stream_blocks(H100) == 132
    assert core_dot.stream_blocks(7) == 7


@pytest.mark.parametrize("split", [2, 4, 3])
def test_k_core_runs_whole_tiles_or_stream_k(split):
    """K-core's two schedules are whole tiles (split 1) and stream-K
    (split 0): a cluster split of a tile's contraction is K-int's alone,
    so K-core's work list refuses it, and the model chooses between the
    two on every shape (the smoke square, whose cluster model splits
    in 2, takes stream-K)."""
    assert core_dot.SCHEDULES == (core_dot.STREAM, 1)
    with pytest.raises(ValueError, match="split 1 or stream-K"):
        core_dot.tile_schedule(SMOKE_SQUARE, 256, H100, split=split)
    for stair, cell in ((SMOKE_SQUARE, 1.0), (SMOKE_SQUARE, 0.5),
                        (SMOKE_STAIR, 1.0), (BF16_STAIR, 2.0),
                        (CONFIG4_SQUARE, 0.5), *REDDIT.values()):
        assert core_dot.choose_schedule(stair, 256, BN, H100,
                                        cell) in core_dot.SCHEDULES
        tiles, _starts = core_dot.tile_schedule(stair, 256, H100,
                                                cell_bytes=cell)
        assert tiles.shape[1:] == (1, 6)
