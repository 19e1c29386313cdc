// K-bcsr: the BCSR tile tier of the hybrid SpMM, scatter-added into out,
// both layouts in one kernel, one launch a product, on a host work plan.
//
// Replaces the XLA bodies pygim_tpu/ops/spmm.py:bcsr_scan_spmm (row-major,
// :690-745) and bcsr_panel_scan_spmm (panel-major, :633-687): a gather of
// 128-row panels of x through panel_nodes, one (Tr, 128) @ (128, H)
// product per tile, and a scatter-add of the (Tr, H) partials into out at
// row_nodes. With P = panel_nodes as (n_panels, 128) and R = row_nodes as
// (n_rb, Tr), every tile t of the tables (n, slots, Tr, 128) row-major,
// flat index t = item * slots + slot, on panel p(t) and row block r(t):
//     out[R[r(t), i]] += tiles[t, i, :] @ X[P[p(t)]]
// (row kind: p from panel_idx (n, S), r from vblock_to_rb (n,); panel
// kind: p from panel_idx (n,), r from tile_rb (n, T)). out is f32 (N, h)
// row-major and added into (it may start at any f32 offset); x (N, h)
// row-major is one of the payload modes of payload.cuh.
//
// The plan (ops/bcsr.py:bcsr_plan, built on the host once a prepared
// operand and width) lists every tile once, pads included, as entries
// (tile, row block), ordered panel-major for either layout (by band of
// row blocks where bands pay, then panel, then row block), and cuts them
// into items: runs of one panel's entries, at most ITEM_TILES long (a hub
// panel is split), longest first. The kernel never reads panel_idx or the
// row-block tables: the plan carries both.
//
// Compute modes, the reference's cdt (the host picks, ops/bcsr.py:
// compute_mode):
//   MMA: bf16 tiles with an f32, bf16 or int8 x. x is rounded to bf16
//     (round to nearest even; bf16 and int8 are exact), the products are
//     exact in f32, the sums f32: wgmma m64nNk16 bf16 -> f32.
//   FFMA: every other case (int16 / int32 x, an f32 x rounded to
//     round(x / safe) by payload.cuh's reciprocal route, f32 tiles): both
//     operands in f32, one fmaf a term.
// Pads are computed as the reference's: zero tiles times x rows, so a
// non-finite x row that a pad reads spreads NaN where the reference's does.
//
// What bounds it on an H100: bytes. Each tile is read once from HBM (Tr x
// 128 cells) and does 2 * Tr * 128 * h operations on them, well under the
// card's operations per byte at bf16 rates. Beyond the least bytes (each
// tile, each x row of the panels and each out row of the row blocks
// once), what a walk moves is panels staged (128 x h each) and partial
// rows added (a read-modify-write of Tr x h f32 in HBM where out is past
// the L2). Walked in the tables' own order, a kernel stages a panel for
// almost every row-kind tile and adds every panel-kind tile with nothing
// in flight. Here the
// panel kind's adds remain the larger part of its time (tools/
// bcsr_diag.py times the kernel without them): every tile's live partial
// rows go out by red.global.add, bands of L2-resident rows or another
// item order barely cheapen them, and extra warps that only add measured
// slower (fewer blocks resident).
//
// The design:
// - A persistent grid (the card's resident blocks) walks units (item,
//   64-column slab of h) round robin; the slabs of one item are adjacent
//   units, so blocks read a tile together and the later reads hit L2.
//   Units of one slab keep the blocks small (four a multiprocessor at Tr
//   16), which measured faster than units of two or four slabs with
//   fewer blocks resident.
//   Any h >= 1: columns past h are zero in the panel and never added.
// - MMA: one warpgroup of consumers and one producer warp. The producer
//   brings each unit's panel, its 128 x rows as stored, into shared
//   memory by bulk copies (cp.async.bulk, one a row, on an mbarrier) one
//   unit ahead: it issues the next unit's panel once the first tile of
//   the current one is on its way, so the gather runs behind the current
//   unit's products (where x's rows are not 16-byte aligned the
//   consumers gather the panel themselves at the unit's start). It keeps
//   a ring of 3 to 8 tiles in flight (each by two TMA loads of 64 columns
//   x N rows, 128-byte swizzled; N = Tr rounded up to 8, 16, 32 or 64,
//   rows past Tr read from the next tile or zero filled and discarded).
//   The consumers convert the panel once a unit into wgmma's register A
//   fragments (bf16, round to nearest even) and compute, per tile,
//   out^T (64 x N) = X_slab^T (64 x 128) . tile^T (128 x N): A from
//   registers, B the tile as stored (K-major) by descriptor. Eight k16
//   steps a tile; the A operand never comes from shared memory again, so
//   a small N costs little shared bandwidth. The partial rows go through
//   a staging buffer, so that a thread adds four consecutive columns.
// - FFMA: a block of four warps stages each tile (widened to f32) and a
//   thread owns four consecutive columns and every eighth row.
// - The adds: consecutive entries of one row block sum in the
//   accumulators (the row kind at S > 1, pads); at a change of row block
//   or the item's end the partial rows go into out by vector atomics
//   (red.global.add of 4, 2 or 1 floats: vec by h and out's alignment).
//   A 4-column piece whose four partial values are all exactly zero is
//   not added: the test is on the computed values, so a partial that read
//   a NaN or an Inf is never skipped and NaN spreads as in the reference;
//   only the sign of a zero in out can differ from the plain version.
//   Sums differ from the plain version in f32 order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "payload.cuh"
#include "tma.cuh"

namespace {

constexpr int TC = 128;         // a tile's columns, a panel's rows
constexpr int HS = 64;          // output columns a unit: one slab of h
constexpr int CONSUMERS = 128;  // one warpgroup (MMA), four warps (FFMA)
constexpr int AF_LD = TC + 4;   // f32 tile row (FFMA): 528 B
constexpr int BF_LD = HS;       // f32 panel slab row (FFMA)

// mode (iii) as the host names it; the kernel picks QuantRcp or QuantDiv
// once, from the safe it reads
struct Quant {
  using In = float;
};

struct Args {
  const int2* entries;  // (flat tile index, row block), the plan's order
  const int4* items;    // (first entry, end entry, panel, band)
  int n_items;
  const int* panel_nodes;
  const int* row_nodes;
  int tr;
  const void* tiles;    // FFMA: read directly (MMA: through the TMA map)
  const void* x;
  const float* safe;
  float* out;
  int h;
  int vec;    // the adds' width: 4, 2 or 1 consecutive floats
  bool xbulk;  // x's rows can be bulk-copied: 16-byte aligned rows
};

template <int MT>
constexpr int ffma_smem_bytes() {
  return TC * 4 + MT * 16 * AF_LD * 4 + TC * BF_LD * 4;
}

// Add four consecutive columns of a row at o + c unless all four are
// exactly zero (c + 3 < h where vec is 4: h % 4 == 0 and out 16-byte
// aligned; pairs where vec is 2: h % 2 == 0 and out 8-byte aligned;
// single elements elsewhere). NaN != 0, so a NaN piece is added.
__device__ __forceinline__ void add4(float* o, int c, int h, int vec,
                                     float v0, float v1, float v2, float v3) {
  if (v0 == 0.f && v1 == 0.f && v2 == 0.f && v3 == 0.f) return;
  if (vec == 4) {
    if (c < h) atomicAdd(reinterpret_cast<float4*>(o + c),
                         make_float4(v0, v1, v2, v3));
  } else if (vec == 2) {
    if (c < h) atomicAdd(reinterpret_cast<float2*>(o + c), make_float2(v0, v1));
    if (c + 2 < h)
      atomicAdd(reinterpret_cast<float2*>(o + c + 2), make_float2(v2, v3));
  } else {
    if (c < h) atomicAdd(o + c, v0);
    if (c + 1 < h) atomicAdd(o + c + 1, v1);
    if (c + 2 < h) atomicAdd(o + c + 2, v2);
    if (c + 3 < h) atomicAdd(o + c + 3, v3);
  }
}

// ---- MMA mode: TMA tile ring, panel rows by bulk copy, wgmma ----

// Shared memory of the MMA kernel at N tile rows: the panel's x rows as
// they are stored (128 rows of the slab's 64 elements, each row padded by
// 16 bytes), the tile ring, the epilogue staging, the barriers (tile
// ring full / empty, panel full / empty).
template <int N, typename In>
struct MmaLayout {
  static constexpr int ROW = HS * sizeof(In) + 16;  // panel row bytes
  static constexpr int STAGE = N * TC * 2;  // two boxes of N x 128 B
  static constexpr int STAGES = N == 8 ? 8 : N == 64 ? 3 : 4;
  static constexpr int ST_LD = HS + 4;  // f32 staging row
  static constexpr int OFF_RING = 0;         // 1024-aligned: TMA swizzle
  static constexpr int OFF_PANEL = STAGES * STAGE;
  static constexpr int OFF_ST = OFF_PANEL + TC * ROW;
  static constexpr int OFF_BAR = OFF_ST + N * ST_LD * 4;
  // + 1024: the base is aligned up to 1024 B
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 2) * 8 + 1024;
};

// The panel's x rows into the panel buffer by the consumers themselves,
// as stored (zeros past h): where x's rows cannot be bulk-copied.
template <typename In>
__device__ __forceinline__ void gather_panel(const In* __restrict__ x,
                                             const int* __restrict__ pnodes,
                                             uint8_t* panel, int row_bytes,
                                             int col0, int h) {
  const int c = threadIdx.x & (HS - 1);
#pragma unroll 4
  for (int k = threadIdx.x / HS; k < TC; k += CONSUMERS / HS) {
    const long long row = static_cast<long long>(__ldg(pnodes + k)) * h;
    const int col = col0 + c;
    reinterpret_cast<In*>(panel + k * row_bytes)[c] =
        col < h ? x[row + col] : In(0);
  }
}

// This thread's wgmma A fragments of the panel (A = X_slab^T: rows are
// the slab's columns, k the panel's rows), for every k16 step:
// a[ks * 4 + i] = bf16 pairs {A[m][k], A[m][k + 1]} with m = 16 warp +
// g (+ 8 for i = 1, 3) and k = 16 ks + 2 t4 (+ 8 for i = 2, 3), read
// from the stored rows and rounded to bf16 (RNE). Past h, columns read
// zero.
template <typename P>
__device__ __forceinline__ void panel_fragments(const uint8_t* panel,
                                                int row_bytes, int col0,
                                                int h, float2 d,
                                                uint32_t* a) {
  using In = typename P::In;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 16 * warp + g + 8 * half;
    const bool live = col0 + m < h;
#pragma unroll
    for (int ks = 0; ks < TC / 16; ++ks) {
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int k = 16 * ks + 2 * t4 + 8 * kh;
        float v0 = 0.f, v1 = 0.f;
        if (live) {
          v0 = P::get(reinterpret_cast<const In*>(panel + k * row_bytes)[m], d);
          v1 = P::get(
              reinterpret_cast<const In*>(panel + (k + 1) * row_bytes)[m], d);
        }
        const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
        a[ks * 4 + half + 2 * kh] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
  }
}

// Descriptor of a tile stage (wgmma's B): K-major, 128-byte rows, 128-byte
// swizzle, SBO = 1024 B between groups of 8 tile rows (LBO unused). A k16
// step adds 32 B inside a 64-column box; the second box (k 64..127)
// follows the first at N * 128 B.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x N, f32) += A (64 x 16, bf16, registers) @ B (16 x N, bf16,
// shared, K-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, 1, 1, 1, 0;\n"
      : D4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, 1, "
      "0;\n"
      : D4(0), D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n"
      : D4(0), D4(4), D4(8), D4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
#undef D4

// Add the warpgroup's partial rows (acc: the wgmma m64nN fragment, rows =
// the slab's columns, columns = tile rows) into out at rows[0 .. tr), and
// zero acc. Through the staging buffer st (N x (HS + 4) f32), so that a
// thread adds four consecutive columns of one row.
template <int N>
__device__ __forceinline__ void flush_mma(float* acc, float* st,
                                          const int* __restrict__ rows,
                                          int tr, float* __restrict__ out,
                                          int h, int col0, int vec) {
  constexpr int LD = HS + 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int r = 8 * j + 2 * t4;
    st[r * LD + c] = acc[4 * j];
    st[(r + 1) * LD + c] = acc[4 * j + 1];
    st[r * LD + c + 8] = acc[4 * j + 2];
    st[(r + 1) * LD + c + 8] = acc[4 * j + 3];
  }
  named_bar_sync(1);
  constexpr int PIECES = HS / 4;  // four-column pieces of a row
  for (int p = tid; p < N * PIECES; p += CONSUMERS) {
    const int r = p / PIECES, c4 = (p % PIECES) * 4;
    if (r < tr) {
      const float4 v = *reinterpret_cast<const float4*>(st + r * LD + c4);
      add4(out + static_cast<long long>(__ldg(rows + r)) * h, col0 + c4, h,
           vec, v.x, v.y, v.z, v.w);
    }
  }
  named_bar_sync(1);  // the staging is free again
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
}

template <int N, typename P>
__device__ __forceinline__ void mma_body(const Args& a, const CUtensorMap* map,
                                         float2 d, uint8_t* smem) {
  using In = typename P::In;
  using L = MmaLayout<N, In>;
  const uint32_t s_base = smem_u32(smem);
  const uint32_t full0 = s_base + L::OFF_BAR;
  const uint32_t empty0 = full0 + 8 * L::STAGES;
  const uint32_t pfull = empty0 + 8 * L::STAGES, pempty = pfull + 8;
  const int n_slabs = (a.h + HS - 1) / HS;
  const long long n_units = static_cast<long long>(a.n_items) * n_slabs;
  const auto* x = static_cast<const In*>(a.x);
  uint8_t* panel = smem + L::OFF_PANEL;

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: the panels one unit ahead (bulk copies of x
    // rows, where x's rows allow them), the tiles in a ring (TMA) ----
    const int lane = threadIdx.x & 31;
    int stage = 0;
    uint32_t phase = 0, pphase = 0;
    // the panel of unit u into the panel buffer, once the consumers hold
    // the last one in registers
    auto issue_panel = [&](long long u) {
      const int4 it = __ldg(a.items + u / n_slabs);
      const int col0 = static_cast<int>(u % n_slabs) * HS;
      const uint32_t bytes =
          static_cast<uint32_t>(min(HS, a.h - col0)) * sizeof(In);
      wait_or_trap(pempty, pphase ^ 1);
      if (lane == 0) mbar_expect_tx(pfull, bytes * TC);
      __syncwarp();
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int k = lane; k < TC; k += 32) {
        const In* src =
            x + static_cast<long long>(
                    __ldg(a.panel_nodes + static_cast<long long>(it.z) * TC + k)) *
                    a.h +
            col0;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_u32(panel + k * L::ROW)),
            "l"(src), "r"(bytes), "r"(pfull)
            : "memory");
      }
      pphase ^= 1;
    };
    long long u = blockIdx.x;
    if (a.xbulk && u < n_units) issue_panel(u);
    for (; u < n_units; u += gridDim.x) {
      const int4 it = __ldg(a.items + u / n_slabs);
      for (int e = it.x; e < it.y; ++e) {
        if (lane == 0) {
          const int row = __ldg(&a.entries[e].x) * a.tr;
          const uint32_t full = full0 + 8 * stage;
          const uint32_t dst = s_base + L::OFF_RING + stage * L::STAGE;
          wait_or_trap(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, L::STAGE);
          tma_load_2d(dst, map, 0, row, full);
          tma_load_2d(dst + N * 128, map, 64, row, full);
        }
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
        // the next unit's panel, once the first tile of this one is on
        // its way (the consumers then hold this unit's panel)
        if (e == it.x && a.xbulk && u + gridDim.x < n_units)
          issue_panel(u + gridDim.x);
        __syncwarp();
      }
    }
    return;
  }

  // ---- consumers: one warpgroup ----
  const int tid = threadIdx.x;
  float* st = reinterpret_cast<float*>(smem + L::OFF_ST);
  uint32_t af[(TC / 16) * 4];
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0, pphase = 0;
  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int4 it = __ldg(a.items + u / n_slabs);
    const int col0 = static_cast<int>(u % n_slabs) * HS;
    if (a.xbulk) {
      wait_or_trap(pfull, pphase);
    } else {
      named_bar_sync(1);  // the last unit's readers of the buffer are done
      gather_panel<In>(x, a.panel_nodes + static_cast<long long>(it.z) * TC,
                           panel, L::ROW, col0, a.h);
      named_bar_sync(1);
    }
    panel_fragments<P>(panel, L::ROW, col0, a.h, d, af);
    if (a.xbulk) {
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(pempty);
    }
    pphase ^= 1;
    int held = __ldg(&a.entries[it.x].y);
    for (int e = it.x; e < it.y; ++e) {
      const int rb = __ldg(&a.entries[e].y);
      if (rb != held) {
        flush_mma<N>(acc, st,
                         a.row_nodes + static_cast<long long>(held) * a.tr,
                         a.tr, a.out, a.h, col0, a.vec);
        held = rb;
      }
      wait_or_trap(full0 + 8 * stage, phase);
      const uint64_t db = tile_desc(s_base + L::OFF_RING + stage * L::STAGE);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < TC / 16; ++k)
        wgmma_rs<N>(acc, af + k * 4,
                    db + (k >> 2) * static_cast<uint64_t>(N * 128 >> 4) +
                        2ull * (k & 3));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == L::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    flush_mma<N>(acc, st, a.row_nodes + static_cast<long long>(held) * a.tr,
                     a.tr, a.out, a.h, col0, a.vec);
  }
}

template <int N, typename P>
__global__ void __launch_bounds__(CONSUMERS + 32)
    bcsr_mma_kernel(const __grid_constant__ CUtensorMap map, Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  using L = MmaLayout<N, typename P::In>;
  if (threadIdx.x == 0) {
    const uint32_t bar0 = smem_u32(smem + L::OFF_BAR);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(bar0 + 8 * s, 1);                  // full: the producer
      mbar_init(bar0 + 8 * (L::STAGES + s), 4);    // empty: each warp
    }
    mbar_init(bar0 + 16 * L::STAGES, 1);      // panel full: the producer
    mbar_init(bar0 + 16 * L::STAGES + 8, 4);  // panel empty: each warp
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  mma_body<N, P>(a, &map, float2{}, smem);
}

// ---- FFMA mode: f32 tiles and panels in shared memory ----

// The panel's node ids, then its slab of x rows in f32: 128 rows x HS
// columns from col0, zeros past h.
template <typename P>
__device__ __forceinline__ void stage_panel_f32(
    const typename P::In* __restrict__ x, const int* __restrict__ pnodes,
    int* nodes, float* bs, int col0, int h, float2 d) {
  const int tid = threadIdx.x;
  nodes[tid] = __ldg(pnodes + tid);
  __syncthreads();
  const int c = tid & (HS - 1);
  const int col = col0 + c;
  const bool live = col < h;
#pragma unroll 8
  for (int k = tid / HS; k < TC; k += CONSUMERS / HS) {
    float v = 0.f;
    if (live) v = P::get(x[static_cast<long long>(nodes[k]) * h + col], d);
    bs[k * BF_LD + c] = v;
  }
}

// One tile (tr x 128 cells, contiguous) into shared memory in 16-byte
// pieces, widened to f32.
template <typename TileT>
__device__ __forceinline__ void stage_tile_f32(const TileT* __restrict__ t,
                                               int tr, float* as) {
  constexpr int PER = 16 / sizeof(TileT);
  const int pieces = tr * TC / PER;
  const uint4* src = reinterpret_cast<const uint4*>(t);
  for (int i = threadIdx.x; i < pieces; i += CONSUMERS) {
    const int r = (i * PER) / TC, c = (i * PER) % TC;
    const uint4 q = __ldg(src + i);
    float* dst = as + r * AF_LD + c;
    if constexpr (std::is_same_v<TileT, float>) {
      *reinterpret_cast<uint4*>(dst) = q;
    } else {  // bf16 bits widened exactly
      *reinterpret_cast<float4*>(dst) = make_float4(
          __uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
          __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
      *reinterpret_cast<float4*>(dst + 4) = make_float4(
          __uint_as_float(q.z << 16), __uint_as_float(q.z & 0xffff0000u),
          __uint_as_float(q.w << 16), __uint_as_float(q.w & 0xffff0000u));
    }
  }
}

// acc[4 i + j]: row threadIdx.x / 16 + 8 i, column 4 (threadIdx.x % 16) + j
// of the slab.
template <int MT>
__device__ __forceinline__ void ffma_tile(const float* as, const float* bs,
                                          float* acc) {
  const int c4 = (threadIdx.x & 15) * 4, rg = threadIdx.x >> 4;
#pragma unroll 2
  for (int k = 0; k < TC; k += 4) {
    float4 p[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[q] = *reinterpret_cast<const float4*>(bs + (k + q) * BF_LD + c4);
#pragma unroll
    for (int i = 0; i < MT * 2; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(as + (rg + 8 * i) * AF_LD + k);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[4 * i + 0] = fmaf(av[q], p[q].x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(av[q], p[q].y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(av[q], p[q].z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(av[q], p[q].w, acc[4 * i + 3]);
      }
    }
  }
}

// Add the block's partial rows into out at rows[0 .. tr), and zero acc.
template <int MT>
__device__ __forceinline__ void flush_ffma(float* acc,
                                           const int* __restrict__ rows,
                                           int tr, float* __restrict__ out,
                                           int h, int col0, int vec) {
  const int c = col0 + (threadIdx.x & 15) * 4, rg = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < MT * 2; ++i) {
    const int r = rg + 8 * i;
    if (r < tr)
      add4(out + static_cast<long long>(__ldg(rows + r)) * h, c, h, vec,
           acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
#pragma unroll
  for (int i = 0; i < MT * 8; ++i) acc[i] = 0.f;
}

template <int MT, typename TileT, typename P>
__device__ __forceinline__ void ffma_body(const Args& a, float2 d,
                                          uint8_t* smem) {
  const int n_slabs = (a.h + HS - 1) / HS;
  const long long n_units = static_cast<long long>(a.n_items) * n_slabs;
  int* nodes = reinterpret_cast<int*>(smem);
  float* as = reinterpret_cast<float*>(smem + TC * 4);
  float* bs = as + MT * 16 * AF_LD;
  const TileT* tiles = static_cast<const TileT*>(a.tiles);
  const long long tile_elems = static_cast<long long>(a.tr) * TC;
  const auto* x = static_cast<const typename P::In*>(a.x);
  float acc[MT * 8];
#pragma unroll
  for (int i = 0; i < MT * 8; ++i) acc[i] = 0.f;
  for (long long u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int4 it = __ldg(a.items + u / n_slabs);
    const int col0 = static_cast<int>(u % n_slabs) * HS;
    __syncthreads();  // the last unit's readers of the panel are done
    stage_panel_f32<P>(x, a.panel_nodes + static_cast<long long>(it.z) * TC,
                       nodes, bs, col0, a.h, d);
    int held = __ldg(&a.entries[it.x].y);
    for (int e = it.x; e < it.y; ++e) {
      const int2 en = __ldg(a.entries + e);
      if (en.y != held) {
        flush_ffma<MT>(acc, a.row_nodes + static_cast<long long>(held) * a.tr,
                       a.tr, a.out, a.h, col0, a.vec);
        held = en.y;
      }
      stage_tile_f32<TileT>(tiles + en.x * tile_elems, a.tr, as);
      __syncthreads();
      ffma_tile<MT>(as, bs, acc);
      __syncthreads();
    }
    flush_ffma<MT>(acc, a.row_nodes + static_cast<long long>(held) * a.tr,
                   a.tr, a.out, a.h, col0, a.vec);
  }
}

template <int MT, typename TileT, typename P>
__global__ void __launch_bounds__(CONSUMERS) bcsr_ffma_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_ffma[];
  if constexpr (std::is_same_v<P, Quant>) {
    const float2 d = divisor(a.safe);
    if (rcp_route(d))
      ffma_body<MT, TileT, QuantRcp>(a, d, smem_ffma);
    else
      ffma_body<MT, TileT, QuantDiv>(a, d, smem_ffma);
  } else {
    ffma_body<MT, TileT, P>(a, float2{}, smem_ffma);
  }
}

// ---- launches: a persistent grid of the card's resident blocks ----

template <typename K>
int launch_grid(K kernel, int threads, int smem, const Args& a, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return ERR_ARGS;
  const long long units =
      static_cast<long long>(a.n_items) * ((a.h + HS - 1) / HS);
  const long long resident = static_cast<long long>(occ) * sms;
  *grid = static_cast<int>(units < resident ? units : resident);
  return 0;
}

template <int N, typename P>
int launch_mma(const Args& a, long long n_tiles, cudaStream_t s) {
  using L = MmaLayout<N, typename P::In>;
  CUtensorMap map;
  // the tiles as (n_tiles * tr) rows of 128 bf16 cells: boxes of 64
  // cells x N rows, 128-byte swizzle; rows past the end read as zero
  int err = encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.tiles, TC,
                      n_tiles * a.tr, TC * 2, 64, N,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  int grid = 0;
  err = launch_grid(bcsr_mma_kernel<N, P>, CONSUMERS + 32, L::SMEM, a, &grid);
  if (err) return err;
  bcsr_mma_kernel<N, P><<<grid, CONSUMERS + 32, L::SMEM, s>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, typename TileT, typename P>
int launch_ffma(const Args& a, cudaStream_t s) {
  constexpr int smem = ffma_smem_bytes<MT>();
  int grid = 0;
  const int err = launch_grid(bcsr_ffma_kernel<MT, TileT, P>, CONSUMERS,
                              smem, a, &grid);
  if (err) return err;
  bcsr_ffma_kernel<MT, TileT, P><<<grid, CONSUMERS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int mma_by_rows(const Args& a, long long n_tiles, cudaStream_t s) {
  if (a.tr <= 8) return launch_mma<8, P>(a, n_tiles, s);
  if (a.tr <= 16) return launch_mma<16, P>(a, n_tiles, s);
  if (a.tr <= 32) return launch_mma<32, P>(a, n_tiles, s);
  if (a.tr <= 64) return launch_mma<64, P>(a, n_tiles, s);
  return ERR_ARGS;
}

template <typename TileT, typename P>
int ffma_by_rows(const Args& a, cudaStream_t s) {
  if (a.tr <= 16) return launch_ffma<1, TileT, P>(a, s);
  if (a.tr <= 32) return launch_ffma<2, TileT, P>(a, s);
  if (a.tr <= 64) return launch_ffma<4, TileT, P>(a, s);
  return ERR_ARGS;
}

template <typename TileT>
int ffma_by_payload(const Args& a, int payload, cudaStream_t s) {
  switch (payload) {
    case 0:
      return ffma_by_rows<TileT, AsIs>(a, s);
    case 1:
      return ffma_by_rows<TileT, Widen<int8_t>>(a, s);
    case 2:
      return ffma_by_rows<TileT, Widen<int16_t>>(a, s);
    case 3:
      return ffma_by_rows<TileT, Widen<int32_t>>(a, s);
    case 4:
      return a.safe ? ffma_by_rows<TileT, Quant>(a, s) : ERR_ARGS;
    case 5:
      return ffma_by_rows<TileT, Bf16>(a, s);
    default:
      return ERR_ARGS;
  }
}

}  // namespace

// tiles: (n_tiles, tr, 128) bf16 bits (tile_f32 0) or f32 (1), 16-byte
// aligned, n_tiles = n * slots; entries int32 (n_tiles, 2) and items int32
// (n_items, 4): the plan (ops/bcsr.py:bcsr_plan); panel_nodes
// (n_panels * 128,), row_nodes (n_rb * tr,) int32; payload: 0 f32, 1 int8,
// 2 int16, 3 int32, 4 f32 rounded to round(x / *safe) (safe an f32 on the
// card; null otherwise), 5 bf16; mma 1 for the bf16 tensor-core mode (bf16
// tiles with payload 0, 1 or 5), 0 for the f32 mode; tr <= 64; vec 4
// where h % 4 == 0 and out is 16-byte aligned, 2 where h % 2 == 0 and out
// is 8-byte aligned, else 1 (the widths of the adds).
// Returns 0 or an error code (cudaError_t, 901: arguments refused, or the
// TMA encoder's codes of tma.cuh).
extern "C" int bcsr_add(const void* tiles, int tile_f32, long long n_tiles,
                        int tr, const void* entries, const void* items,
                        int n_items, const void* panel_nodes,
                        const void* row_nodes, const void* x, int payload,
                        const void* safe, int mma, void* out, int h, int vec,
                        void* stream) {
  if (n_items <= 0 || h <= 0) return 0;
  if (tr <= 0 || tr > 64 || n_tiles <= 0 ||
      n_tiles * tr + 64 > 0x7fffffffLL || (vec != 1 && vec != 2 && vec != 4))
    return ERR_ARGS;
  // x's element size by payload code; the panel's rows come in by bulk
  // copies where every row of x starts 16-byte aligned
  const int itemsize = payload == 1 ? 1 : payload == 2 || payload == 5 ? 2 : 4;
  const bool xbulk = (static_cast<long long>(h) * itemsize) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Args a{static_cast<const int2*>(entries),
               static_cast<const int4*>(items),
               n_items,
               static_cast<const int*>(panel_nodes),
               static_cast<const int*>(row_nodes),
               tr,
               tiles,
               x,
               static_cast<const float*>(safe),
               static_cast<float*>(out),
               h,
               vec,
               xbulk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (tile_f32) return ERR_ARGS;
    switch (payload) {
      case 0:
        return mma_by_rows<AsIs>(a, n_tiles, s);
      case 1:
        return mma_by_rows<Widen<int8_t>>(a, n_tiles, s);
      case 5:
        return mma_by_rows<Bf16>(a, n_tiles, s);
      default:
        return ERR_ARGS;
    }
  }
  return tile_f32 ? ffma_by_payload<float>(a, payload, s)
                  : ffma_by_payload<uint16_t>(a, payload, s);
}
