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
// Routes, every one on the tensor cores (the host picks, ops/bcsr.py:
// kernel_route; the reference's compute dtype is ops/bcsr.py:
// compute_mode):
//   bf16 (PARTS = 1): bf16 tiles with an f32, bf16 or int8 x: x rounded
//     to bf16 (nearest even), products exact in f32, f32 sums: wgmma
//     m64nNk16 bf16 -> f32, the reference's bf16 cdt.
//   bf16x2, bf16x3 (PARTS = 2, 3): bf16 tiles with an int16 x (2), or an
//     int32 x or an x rounded to round(x / safe), the int32 quantized
//     aggregate's payload (3): the reference's f32 cdt. Each payload value v (as f32: the reference's convert) is
//     split into bf16 parts v = b0 + b1 [+ b2]: b0 = bf16(v), b1 =
//     bf16(v - b0), b2 = v - b0 - b1 (each difference exact in f32; two
//     parts hold any value of 16 significant bits, three any f32). A bf16
//     tile cell times a bf16 part is exact in f32, so every product is
//     exact and only the f32 sums round: bit-equal to the plain version
//     wherever its partial sums are integers below 2^24 (integer tiles and
//     payloads: the parts and all their partial sums are integers too),
//     else within f32 order. Eight-bit parts on bf16 wgmma rather than
//     K-f32's 11-bit limbs on TF32: the tile ring stays the bf16 mode's as
//     it is, and a k16 bf16 step runs at twice a k8 TF32 step's rate, so
//     three bf16 parts cost less than two TF32 limbs of a tile converted
//     to f32 in shared memory.
//   tf32x3 (f32 tiles, any payload): 3xTF32 as K-f32 (core_f32.cu): the x
//     slab as a TF32 hi (hi = cvt.rna.tf32(v)) in registers and its lo
//     (cvt.rna.tf32(v - hi)) in shared memory, K-major and swizzled, as
//     wgmma's A by descriptor (both in registers took 226 registers a
//     thread and left one block a multiprocessor; capping registers for
//     two spilled and slowed the other routes, PERF.md); each tile
//     arrives by TMA as f32 and the consumers write its hi over it and its
//     lo beside it once; products a_hi b_hi + a_hi b_lo + a_lo b_hi on
//     wgmma m64nNk8 .tf32 (dropping a_lo b_lo): about 3 * 2^-22 of the sum
//     of |terms|. An int8 or bf16 x is exact in TF32 (lo = 0): two
//     products (tf32x2).
// Pads are computed as the reference's: zero tiles times x rows, so a
// non-finite x row that a pad reads spreads NaN where the reference's does
// (a part or lo whose hi is not finite is 0, so a NaN or Inf keeps its
// value in the first part).
//
// What bounds it on an H100: bytes. Each tile is read once from HBM (Tr x
// 128 cells) and does 2 * Tr * 128 * h operations on them, well under the
// card's operations per byte at bf16 rates (3 parts: 3 times the
// products; tf32x3: 3 products at half the bf16 rate). Beyond the least
// bytes (each tile, each x row of the panels and each out row of the row
// blocks once), what a walk moves is panels staged (128 x h each) and
// partial rows added (a read-modify-write of Tr x h f32 in HBM where out is
// past the L2). Walked in the tables' own order, a kernel stages a panel
// for almost every row-kind tile and adds every panel-kind tile with
// nothing in flight. Here the panel kind's adds remain the larger part of
// its time (tools/bcsr_diag.py times the kernel without them): every
// tile's live partial rows go out by red.global.add, bands of
// L2-resident rows or another item order barely cheapen them, and extra
// warps that only add measured slower (fewer blocks resident).
//
// The design:
// - A persistent grid (the card's resident blocks) walks units (item,
//   64-column slab of h) round robin; the slabs of one item are adjacent
//   units, so blocks read a tile together and the later reads hit L2.
//   Units of one slab keep the blocks small (four a multiprocessor at Tr
//   16), which measured faster than units of two or four slabs with
//   fewer blocks resident.
//   Any h >= 1: columns past h are zero in the panel and never added.
// - One warpgroup of consumers and one producer warp. The producer
//   brings each unit's panel, its 128 x rows as stored, into shared
//   memory by bulk copies (cp.async.bulk, one a row, on an mbarrier) one
//   unit ahead: it issues the next unit's panel once the first tile of
//   the current one is on its way, so the gather runs behind the current
//   unit's products (where x's rows are not 16-byte aligned the
//   consumers gather the panel themselves at the unit's start). It keeps
//   a ring of tiles in flight (each by TMA loads of 128-byte boxes of N
//   rows, 128-byte swizzled: two of 64 bf16 cells, four of 32 f32 cells;
//   N = Tr rounded up to 8, 16, 32 or 64, rows past Tr read from the next
//   tile or zero filled and discarded).
//   The consumers convert the panel once a unit into wgmma's register A
//   fragments (the route's parts) and compute, per tile,
//   out^T (64 x N) = X_slab^T (64 x 128) . tile^T (128 x N): A from
//   registers, B the tile as stored (K-major) by descriptor. Eight k16
//   steps a part (bf16) or sixteen k8 steps of three products (tf32) a
//   tile; the A operand never comes from shared memory again, so a small N
//   costs little shared bandwidth. The partial rows go through a staging
//   buffer, so that a thread adds four consecutive columns.
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
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int FRAG = (TC / 16) * 4;  // bf16 A registers a part (8 k16 steps)
constexpr int FRAG32 = (TC / 8) * 4;  // TF32 A registers a part (16 k8 steps)

// mode (iii) as the host names it: the reciprocal route where safe allows
// it (QuantRcp), else a true division (QuantDiv); the test is the same for
// every element
struct Quant {
  using In = float;
  __device__ __forceinline__ static float get(float v, float2 d) {
    return rcp_route(d) ? QuantRcp::get(v, d) : QuantDiv::get(v, d);
  }
};

// an int8 or bf16 payload is exact in TF32: no lo part
template <typename P>
constexpr bool TF32_EXACT =
    std::is_same_v<P, Bf16> || std::is_same_v<P, Widen<int8_t>>;

struct Args {
  const int2* entries;  // (flat tile index, row block), the plan's order
  const int4* items;    // (first entry, end entry, panel, band)
  int n_items;
  const int* panel_nodes;
  const int* row_nodes;
  int tr;
  const void* x;
  const float* safe;
  float* out;
  int h;
  int vec;    // the adds' width: 4, 2 or 1 consecutive floats
  bool xbulk;  // x's rows can be bulk-copied: 16-byte aligned rows
};

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

// ---- TMA tile ring, panel rows by bulk copy, wgmma ----

// Shared memory at N tile rows: the tile ring (bf16: two 128-byte boxes a
// tile row; TF32: four), the tiles' lo parts (TF32 only), the panel's x
// rows as they are stored (128 rows of the slab's 64 elements, each row
// padded by 16 bytes), the epilogue staging, the barriers (tile ring full
// / empty, panel full / empty).
template <int N, typename In, bool TF32, bool XLO = false>
struct MmaLayout {
  static constexpr int ROW = HS * sizeof(In) + 16;  // panel row bytes
  static constexpr int BOXES = TF32 ? 4 : 2;
  static constexpr int STAGE = N * 128 * BOXES;
  static constexpr int STAGES = TF32 ? (N == 8 ? 6 : N == 16 ? 4 : 3)
                                     : (N == 8 ? 8 : N == 64 ? 3 : 4);
  static constexpr int ST_LD = HS + 4;  // f32 staging row
  static constexpr int OFF_RING = 0;         // 1024-aligned: TMA swizzle
  static constexpr int OFF_LO = STAGES * STAGE;
  // the x slab's TF32 lo as wgmma's A by descriptor (XLO): 64 x 128 f32,
  // K-major in four 128-byte-swizzled boxes of 32 columns (1024-aligned)
  static constexpr int OFF_ALO = OFF_LO + (TF32 ? STAGE : 0);
  static constexpr int OFF_PANEL = OFF_ALO + (XLO ? HS * TC * 4 : 0);
  static constexpr int OFF_ST = OFF_PANEL + TC * ROW;
  static constexpr int OFF_BAR = OFF_ST + N * ST_LD * 4;
  // + 1024: the base is aligned up to 1024 B
  static constexpr int SMEM = OFF_BAR + (2 * STAGES + 2) * 8 + 1024;
};
static_assert(MmaLayout<64, float, true, true>::SMEM <= 232448, "tf32 ring");

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

// v is neither an Inf nor a NaN: its exponent is not all ones
__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// v less its part, or 0 where the part is not finite (a NaN or an Inf
// stays whole in the first part)
__device__ __forceinline__ float rest(float v, float part) {
  return finite(part) ? v - part : 0.f;
}

// This thread's bf16 wgmma A fragments of the panel (A = X_slab^T: rows
// are the slab's columns, k the panel's rows), for every k16 step and
// part: a[p * FRAG + ks * 4 + i] = bf16 pairs of part p of {A[m][k],
// A[m][k + 1]} with m = 16 warp + g (+ 8 for i = 1, 3) and k = 16 ks + 2
// t4 (+ 8 for i = 2, 3), read from the stored rows as the payload mode
// gives them (f32) and split into PARTS bf16 parts, each rounded to
// nearest even (v = sum of the parts exactly for PARTS = 3; for PARTS = 2
// where v has at most 16 significant bits). Past h, columns read zero.
template <typename P, int PARTS>
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
#pragma unroll
        for (int p = 0; p < PARTS; ++p) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(v0, v1);
          a[p * FRAG + ks * 4 + half + 2 * kh] =
              *reinterpret_cast<const uint32_t*>(&b);
          if (p + 1 < PARTS) {
            v0 = rest(v0, __low2float(b));
            v1 = rest(v1, __high2float(b));
          }
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v as a TF32 hi and lo: hi = rna(v), lo = rna(v - hi) (0 where hi is not
// finite)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  const float h = __uint_as_float(hi);
  lo = finite(h) ? tf32_rna(v - h) : 0u;
}

// This thread's TF32 wgmma A fragments of the panel for the 16 k8 steps:
// hi[s * 4 + i] = {A[m][k]} with m = 16 warp + g (+ 8 for i = 1, 3) and k
// = 8 s + t4 (+ 4 for i = 2, 3), the value as the payload mode gives it,
// rounded to TF32 (split_tf32's hi); where XLO, its lo goes to alo, the
// 64 x 128 A operand K-major as four 128-byte-swizzled boxes of 32 k
// (16-byte piece c of row m at c ^ (m & 7)), read by descriptor: the
// thread writes the rows of its own warp, which only that warp's part of
// a wgmma reads.
template <typename P, bool XLO>
__device__ __forceinline__ void panel_fragments_tf32(const uint8_t* panel,
                                                     int row_bytes, int col0,
                                                     int h, float2 d,
                                                     uint32_t* hi,
                                                     uint8_t* alo) {
  using In = typename P::In;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 16 * warp + g + 8 * half;
    const bool live = col0 + m < h;
#pragma unroll
    for (int s = 0; s < TC / 8; ++s) {
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int k = 8 * s + t4 + 4 * kh;
        const In* row = reinterpret_cast<const In*>(panel + k * row_bytes);
        const float v = live ? P::get(row[m], d) : 0.f;
        const int i = s * 4 + half + 2 * kh;
        if constexpr (XLO) {
          uint32_t lo;
          split_tf32(v, hi[i], lo);
          const int kk = k & 31;
          *reinterpret_cast<uint32_t*>(
              alo + (k >> 5) * (HS * 128) + m * 128 +
              (((kk >> 2) ^ (m & 7)) << 4) + (kk & 3) * 4) = lo;
        } else {
          hi[i] = tf32_rna(v);  // exact
        }
      }
    }
  }
}

// The f32 tile of a ring stage split in place: its TF32 hi over it, its lo
// into the same offsets of lo_buf (the swizzle is a permutation of 16-byte
// pieces, so both keep the stage's layout and its descriptors).
template <int BYTES>
__device__ __forceinline__ void split_stage(uint8_t* stage, uint8_t* lo_buf) {
  float4* s = reinterpret_cast<float4*>(stage);
  float4* l = reinterpret_cast<float4*>(lo_buf);
#pragma unroll 4
  for (int i = threadIdx.x; i < BYTES / 16; i += CONSUMERS) {
    const float4 v = s[i];
    uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
    split_tf32(v.x, h0, l0);
    split_tf32(v.y, h1, l1);
    split_tf32(v.z, h2, l2);
    split_tf32(v.w, h3, l3);
    s[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                       __uint_as_float(h2), __uint_as_float(h3));
    l[i] = make_float4(__uint_as_float(l0), __uint_as_float(l1),
                       __uint_as_float(l2), __uint_as_float(l3));
  }
}

// Descriptor of a tile stage (wgmma's B): K-major, 128-byte rows, 128-byte
// swizzle, SBO = 1024 B between groups of 8 tile rows (LBO unused). A k16
// bf16 step or a k8 TF32 step adds 32 B inside a 128-byte box; box b
// follows at b * N * 128 B.
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

// d (64 x N, f32) += A (64 x 8, TF32, registers) @ B (8 x N, TF32, shared,
// K-major)
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, 1, 1, 1;\n"
      : D4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, 1, 1, "
      "1;\n"
      : D4(0), D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      : D4(0), D4(4), D4(8), D4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// d (64 x N, f32) += A (64 x 8, TF32, shared, K-major) @ B (8 x N, TF32,
// shared, K-major), both by descriptor
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t da,
                                              uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<8>(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, 1, 1, 1;\n"
      : D4(0)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1;\n"
      : D4(0), D4(4)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, 1, 1, 1;\n"
      : D4(0), D4(4), D4(8), D4(12)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float* d, uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, 1, 1, 1;\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
      : "l"(da), "l"(db));
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

template <int N, typename P, int PARTS, bool TF32>
__device__ __forceinline__ void mma_body(const Args& a, const CUtensorMap* map,
                                         float2 d, uint8_t* smem) {
  using In = typename P::In;
  constexpr bool XLO = TF32 && !TF32_EXACT<P>;
  using L = MmaLayout<N, In, TF32, XLO>;
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
#pragma unroll
          for (int b = 0; b < L::BOXES; ++b)
            tma_load_2d(dst + b * N * 128, map, b * (TF32 ? 32 : 64), row,
                        full);
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
  constexpr int AREGS = TF32 ? FRAG32 : FRAG * PARTS;
  uint32_t af[AREGS];
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
    if constexpr (TF32) {
      panel_fragments_tf32<P, XLO>(panel, L::ROW, col0, a.h, d, af,
                                   smem + L::OFF_ALO);
      if constexpr (XLO) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_bar_sync(1);
      }
    } else {
      panel_fragments<P, PARTS>(panel, L::ROW, col0, a.h, d, af);
    }
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
      const uint32_t ring = s_base + L::OFF_RING + stage * L::STAGE;
      const uint64_t db = tile_desc(ring);
      constexpr uint64_t BOX = (N * 128) >> 4;  // a box, in 16-byte units
      if constexpr (TF32) {
        named_bar_sync(1);  // every warp's products of the last tile done
        split_stage<L::STAGE>(smem + L::OFF_RING + stage * L::STAGE,
                              smem + L::OFF_LO);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_bar_sync(1);
        const uint64_t dl = tile_desc(s_base + L::OFF_LO);
        const uint64_t da = tile_desc(s_base + L::OFF_ALO);
        constexpr uint64_t ABOX = (HS * 128) >> 4;  // an A box
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int k = 0; k < TC / 8; ++k) {
          const uint64_t off = (k >> 2) * BOX + 2ull * (k & 3);
          wgmma_tf32<N>(acc, af + k * 4, db + off);
          wgmma_tf32<N>(acc, af + k * 4, dl + off);
          if constexpr (XLO)
            wgmma_tf32_ss<N>(acc, da + (k >> 2) * ABOX + 2ull * (k & 3),
                             db + off);
        }
      } else {
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int k = 0; k < TC / 16; ++k) {
          const uint64_t off = (k >> 2) * BOX + 2ull * (k & 3);
#pragma unroll
          for (int p = 0; p < PARTS; ++p)
            wgmma_rs<N>(acc, af + p * FRAG + k * 4, db + off);
        }
      }
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

template <int N, typename P, bool TF32>
using LayoutOf = MmaLayout<N, typename P::In, TF32, TF32 && !TF32_EXACT<P>>;

template <int N, typename P, int PARTS, bool TF32>
__global__ void __launch_bounds__(CONSUMERS + 32)
    bcsr_mma_kernel(const __grid_constant__ CUtensorMap map, Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  using L = LayoutOf<N, P, TF32>;
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
  float2 d{};
  if constexpr (std::is_same_v<P, Quant>) d = divisor(a.safe);
  mma_body<N, P, PARTS, TF32>(a, &map, d, smem);
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

template <int N, typename P, int PARTS, bool TF32>
int launch_mma(const Args& a, const void* tiles, long long n_tiles,
               cudaStream_t s) {
  using L = LayoutOf<N, P, TF32>;
  CUtensorMap map;
  // the tiles as (n_tiles * tr) rows of 128 cells: boxes of 128 bytes (64
  // bf16 or 32 f32 cells) x N rows, 128-byte swizzle; rows past the end
  // read as zero
  int err = TF32 ? encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, tiles, TC,
                             n_tiles * a.tr, TC * 4, 32, N,
                             CU_TENSOR_MAP_SWIZZLE_128B)
                 : encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, tiles,
                             TC, n_tiles * a.tr, TC * 2, 64, N,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  int grid = 0;
  err = launch_grid(bcsr_mma_kernel<N, P, PARTS, TF32>, CONSUMERS + 32,
                    L::SMEM, a, &grid);
  if (err) return err;
  bcsr_mma_kernel<N, P, PARTS, TF32><<<grid, CONSUMERS + 32, L::SMEM, s>>>(
      map, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, int PARTS, bool TF32>
int by_rows(const Args& a, const void* tiles, long long n_tiles,
            cudaStream_t s) {
  if (a.tr <= 8) return launch_mma<8, P, PARTS, TF32>(a, tiles, n_tiles, s);
  if (a.tr <= 16) return launch_mma<16, P, PARTS, TF32>(a, tiles, n_tiles, s);
  if (a.tr <= 32) return launch_mma<32, P, PARTS, TF32>(a, tiles, n_tiles, s);
  if (a.tr <= 64) return launch_mma<64, P, PARTS, TF32>(a, tiles, n_tiles, s);
  return ERR_ARGS;
}

}  // namespace

// tiles: (n_tiles, tr, 128) bf16 bits (tile_f32 0) or f32 (1), 16-byte
// aligned, n_tiles = n * slots; entries int32 (n_tiles, 2) and items int32
// (n_items, 4): the plan (ops/bcsr.py:bcsr_plan); panel_nodes
// (n_panels * 128,), row_nodes (n_rb * tr,) int32; payload: 0 f32, 1 int8,
// 2 int16, 3 int32, 4 f32 rounded to round(x / *safe) (safe an f32 on the
// card; null otherwise), 5 bf16; parts: bf16 tiles' payload parts (1 for
// payload 0, 1 or 5; 2 for 2; 3 for 3 or 4; the host's
// ops/bcsr.py:kernel_route), ignored for f32 tiles (TF32); tr <= 64; vec 4
// where h % 4 == 0 and out is 16-byte aligned, 2 where h % 2 == 0 and out
// is 8-byte aligned, else 1 (the widths of the adds).
// Returns 0 or an error code (cudaError_t, 901: arguments refused, or the
// TMA encoder's codes of tma.cuh).
extern "C" int bcsr_add(const void* tiles, int tile_f32, long long n_tiles,
                        int tr, const void* entries, const void* items,
                        int n_items, const void* panel_nodes,
                        const void* row_nodes, const void* x, int payload,
                        const void* safe, int parts, void* out, int h, int vec,
                        void* stream) {
  if (n_items <= 0 || h <= 0) return 0;
  if (tr <= 0 || tr > 64 || n_tiles <= 0 ||
      n_tiles * tr + 64 > 0x7fffffffLL || (vec != 1 && vec != 2 && vec != 4) ||
      (payload == 4) != (safe != nullptr))
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
               x,
               static_cast<const float*>(safe),
               static_cast<float*>(out),
               h,
               vec,
               xbulk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_f32) {
    switch (payload) {
      case 0:
        return by_rows<AsIs, 1, true>(a, tiles, n_tiles, s);
      case 1:
        return by_rows<Widen<int8_t>, 1, true>(a, tiles, n_tiles, s);
      case 2:
        return by_rows<Widen<int16_t>, 1, true>(a, tiles, n_tiles, s);
      case 3:
        return by_rows<Widen<int32_t>, 1, true>(a, tiles, n_tiles, s);
      case 4:
        return by_rows<Quant, 1, true>(a, tiles, n_tiles, s);
      case 5:
        return by_rows<Bf16, 1, true>(a, tiles, n_tiles, s);
      default:
        return ERR_ARGS;
    }
  }
  switch (parts * 8 + payload) {
    case 8 + 0:
      return by_rows<AsIs, 1, false>(a, tiles, n_tiles, s);
    case 8 + 1:
      return by_rows<Widen<int8_t>, 1, false>(a, tiles, n_tiles, s);
    case 8 + 5:
      return by_rows<Bf16, 1, false>(a, tiles, n_tiles, s);
    case 16 + 2:
      return by_rows<Widen<int16_t>, 2, false>(a, tiles, n_tiles, s);
    case 24 + 3:
      return by_rows<Widen<int32_t>, 3, false>(a, tiles, n_tiles, s);
    case 24 + 4:
      return by_rows<Quant, 3, false>(a, tiles, n_tiles, s);
    default:
      return ERR_ARGS;
  }
}
