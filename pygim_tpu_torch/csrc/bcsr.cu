// K-bcsr: the BCSR tile tier of the hybrid SpMM, scatter-added into out,
// both layouts in one kernel, one launch a product.
//
// Replaces the XLA bodies pygim_tpu/ops/spmm.py:bcsr_scan_spmm (row-major,
// :690-745) and bcsr_panel_scan_spmm (panel-major, :633-687): a gather of
// 128-row panels of x through panel_nodes, one (Tr, 128) @ (128, H)
// product per tile, and a scatter-add of the (Tr, H) partials into out at
// row_nodes. With P = panel_nodes as (n_panels, 128) and R = row_nodes as
// (n_rb, Tr), tiles (n, slots, Tr, 128) row-major:
//   row kind (kind 0), every virtual block b, rb = vblock_to_rb (n,):
//     out[R[rb[b], r]] += sum_s tiles[b, s, r, :] @ X[P[panel_idx[b, s]]]
//   panel kind (kind 1), every virtual panel p and slot t, rb = tile_rb
//   (n, T):
//     out[R[rb[p, t], r]] += tiles[p, t, r, :] @ X[P[panel_idx[p]]]
// out is f32 (N, h) row-major and added into (it may start at any f32
// offset); x (N, h) row-major is one of the payload modes of payload.cuh.
// No (n_panels * 128, h) panel table is built: each block gathers its
// panel's rows itself.
//
// Compute modes, the reference's cdt (the host picks, ops/bcsr.py:
// compute_mode):
//   MMA: bf16 tiles with an f32, bf16 or int8 x. x is rounded to bf16
//     (round to nearest even; bf16 and int8 are exact), the products are
//     exact in f32, the sums f32: mma.sync m16n8k16 bf16 -> f32.
//   FFMA: every other case (int16 / int32 x, an f32 x rounded to
//     round(x / safe) by payload.cuh's reciprocal route, f32 tiles): both
//     operands in f32, one fmaf a term.
// Pads are computed as the reference's: zero tiles times x rows, so a
// non-finite x row that a pad reads spreads NaN where the reference's does.
//
// What bounds it on an H100: bytes. Each tile is read once from HBM (Tr x
// 128 cells) and does 2 * Tr * 128 * h operations on them, well under the
// card's operations per byte at bf16 rates; the panels are read once a
// virtual block's slot (row kind) or once a virtual panel (panel kind),
// and every partial row is read and written by atomics.
//
// The design (simple first):
// - a block of four warps takes `group` consecutive virtual blocks /
//   virtual panels (the host's choice, ops/bcsr.py:work_group: about the
//   items that share a panel or a row block) and one 64-column slab of h
//   (the slab index varies fastest, so the blocks of one tile run
//   together and its later reads hit L2); any h >= 1, columns past h
//   masked;
// - the block stages a panel's 128 node ids, then its 128 x 64 slab of
//   x rows (converted to the compute type) into shared memory, and keeps
//   it while the next work item reads the same panel (the builders sort
//   panel-kind items by panel, and choose S = T = 1, which pads no slot:
//   a panel's tiles are consecutive items), then each tile (16-byte
//   loads); rows are padded so the fragment loads are free of bank
//   conflicts;
// - MMA: warp w owns columns 16w .. 16w + 15 of the slab, every 16-row
//   MMA tile of Tr (MT = ceil(Tr / 16) of them, rows past Tr discarded);
//   B fragments by ldmatrix.trans from the row-major panel slab, A
//   fragments by 32-bit shared loads;
// - FFMA: a thread owns four consecutive columns and every eighth row;
// - row kind sums the slots of consecutive virtual blocks of one row
//   block (vblock_to_rb is sorted) in registers and adds when the row
//   block changes; panel kind adds after every slot (a panel's tiles
//   hit different row blocks). Adds are f32 atomics: a row block spans
//   several virtual blocks and groups, panel-kind tiles hit rows
//   independently, and row_nodes repeats the last node in the last
//   block. Sums differ from the plain version in f32 order.
// wgmma, TMA and a persistent schedule are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "payload.cuh"

namespace {

constexpr int TC = 128;         // a tile's columns, a panel's rows
constexpr int HS = 64;          // output columns a block: one slab of h
constexpr int THREADS = 128;    // four warps; one a panel row id
constexpr int A_LD = TC + 8;    // bf16 tile row in shared memory: 272 B
constexpr int B_LD = HS + 8;    // bf16 panel slab row: 144 B
constexpr int AF_LD = TC + 4;   // f32 tile row: 528 B
constexpr int BF_LD = HS;       // f32 panel slab row
static_assert(THREADS == TC, "a thread stages one panel row's node id");

// mode (iii) as the host names it; the kernel picks QuantRcp or QuantDiv
// once, from the safe it reads
struct Quant {
  using In = float;
};

struct Args {
  const void* tiles;
  const int* panel_idx;
  const int* rb;
  const int* panel_nodes;
  const int* row_nodes;
  int kind;   // 0 row, 1 panel
  int n;      // virtual blocks or virtual panels
  int slots;  // S or T
  int tr;
  int group;  // consecutive work items a block
  int vec;    // the adds' width: 4, 2 or 1 consecutive floats
  const void* x;
  const float* safe;
  float* out;
  int h;
};

template <bool MMA, int MT>
constexpr int smem_bytes() {
  return TC * 4 + (MMA ? MT * 16 * A_LD * 2 + TC * B_LD * 2
                       : MT * 16 * AF_LD * 4 + TC * BF_LD * 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The panel's node ids, then its slab of x rows: 128 rows x HS columns
// from col0, in the compute type (bf16 bits or f32), zeros past h.
template <bool MMA, typename P>
__device__ __forceinline__ void stage_panel(const typename P::In* __restrict__ x,
                                            const int* __restrict__ pnodes,
                                            int* nodes, void* bs, int col0,
                                            int h, float2 d) {
  const int tid = threadIdx.x;
  nodes[tid] = __ldg(pnodes + tid);
  __syncthreads();
  const int c = tid & (HS - 1);
  const int col = col0 + c;
  const bool live = col < h;
#pragma unroll 8
  for (int k = tid / HS; k < TC; k += THREADS / HS) {
    float v = 0.f;
    if (live) v = P::get(x[static_cast<long long>(nodes[k]) * h + col], d);
    if constexpr (MMA) {
      reinterpret_cast<__nv_bfloat16*>(bs)[k * B_LD + c] =
          __float2bfloat16_rn(v);
    } else {
      reinterpret_cast<float*>(bs)[k * BF_LD + c] = v;
    }
  }
}

// One tile (tr x 128 cells, contiguous) into shared memory in 16-byte
// pieces: bf16 bits as they are (MMA), or widened to f32 (FFMA).
template <bool MMA, typename TileT>
__device__ __forceinline__ void stage_tile(const TileT* __restrict__ t, int tr,
                                           void* as) {
  constexpr int PER = 16 / sizeof(TileT);
  const int pieces = tr * TC / PER;
  const uint4* src = reinterpret_cast<const uint4*>(t);
  for (int i = threadIdx.x; i < pieces; i += THREADS) {
    const int r = (i * PER) / TC, c = (i * PER) % TC;
    const uint4 q = __ldg(src + i);
    if constexpr (MMA) {
      *reinterpret_cast<uint4*>(reinterpret_cast<uint16_t*>(as) + r * A_LD +
                                c) = q;
    } else if constexpr (std::is_same_v<TileT, float>) {
      *reinterpret_cast<uint4*>(reinterpret_cast<float*>(as) + r * AF_LD +
                                c) = q;
    } else {  // bf16 bits widened exactly
      float* dst = reinterpret_cast<float*>(as) + r * AF_LD + c;
      *reinterpret_cast<float4*>(dst) = make_float4(
          __uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
          __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
      *reinterpret_cast<float4*>(dst + 4) = make_float4(
          __uint_as_float(q.z << 16), __uint_as_float(q.z & 0xffff0000u),
          __uint_as_float(q.w << 16), __uint_as_float(q.w & 0xffff0000u));
    }
  }
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[(mt * 2 + nt) * 4 + i]: MMA tile mt's rows, n-tile nt (8 columns)
// of the warp's 16, fragment element i (m16n8 accumulator layout).
template <int MT>
__device__ __forceinline__ void mma_tile(const uint16_t* as,
                                         const uint16_t* bs, float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = warp * 16;
#pragma unroll
  for (int k0 = 0; k0 < TC; k0 += 16) {
    uint32_t b0, b1, b2, b3;
    const uint16_t* bp =
        bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * B_LD + n0 +
        (lane >> 4) * 8;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
        : "r"(smem_u32(bp)));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint16_t* ap = as + (mt * 16 + g) * A_LD + k0 + 2 * t4;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * A_LD);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 8);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(ap + 8 * A_LD + 8);
      mma_bf16(acc + (mt * 2) * 4, a0, a1, a2, a3, b0, b1);
      mma_bf16(acc + (mt * 2 + 1) * 4, a0, a1, a2, a3, b2, b3);
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

// Add four consecutive columns of a row at o + c (c + 3 < h where vec is
// 4: h % 4 == 0 and out 16-byte aligned; pairs where vec is 2: h % 2 ==
// 0 and out 8-byte aligned; single elements elsewhere).
__device__ __forceinline__ void add4(float* o, int c, int h, int vec,
                                     float v0, float v1, float v2, float v3) {
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

// Add the block's partial rows into out at rows[0 .. tr), and zero acc.
// MMA: the two lanes of a pair trade halves of their fragment (a shuffle)
// so that each holds four consecutive columns of one row.
template <bool MMA, int MT>
__device__ __forceinline__ void flush(float* acc, const int* __restrict__ rows,
                                      int tr, float* __restrict__ out, int h,
                                      int col0, int vec) {
  if constexpr (MMA) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const bool even = (t4 & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* v = acc + (mt * 2 + nt) * 4;
        // the even lane sends row g + 8's pair, the odd lane row g's
        const float s0 = __shfl_xor_sync(0xffffffffu, even ? v[2] : v[0], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, even ? v[3] : v[1], 1);
        const int r = mt * 16 + g + (even ? 0 : 8);
        const int c = col0 + warp * 16 + nt * 8 + 2 * (t4 & ~1);
        if (r < tr) {
          float* o = out + static_cast<long long>(__ldg(rows + r)) * h;
          if (even)
            add4(o, c, h, vec, v[0], v[1], s0, s1);
          else
            add4(o, c, h, vec, s0, s1, v[2], v[3]);
        }
      }
    }
  } else {
    const int c = col0 + (threadIdx.x & 15) * 4, rg = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < MT * 2; ++i) {
      const int r = rg + 8 * i;
      if (r < tr)
        add4(out + static_cast<long long>(__ldg(rows + r)) * h, c, h, vec,
             acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
#pragma unroll
  for (int i = 0; i < MT * 8; ++i) acc[i] = 0.f;
}

template <bool MMA, int MT, typename TileT, typename P>
__device__ __forceinline__ void bcsr_body(const Args& a, float2 d,
                                          unsigned char* smem) {
  const int n_slabs = (a.h + HS - 1) / HS;
  const int blk = blockIdx.x / n_slabs;
  const int col0 = (blockIdx.x - blk * n_slabs) * HS;
  int* nodes = reinterpret_cast<int*>(smem);
  void* as = smem + TC * 4;
  void* bs = smem + TC * 4 +
             (MMA ? MT * 16 * A_LD * 2 : MT * 16 * AF_LD * 4);
  const TileT* tiles = static_cast<const TileT*>(a.tiles);
  const long long tile_elems = static_cast<long long>(a.tr) * TC;
  const auto* x = static_cast<const typename P::In*>(a.x);
  float acc[MT * 8];
#pragma unroll
  for (int i = 0; i < MT * 8; ++i) acc[i] = 0.f;
  const bool panel = a.kind == 1;
  const int w1 = min((blk + 1) * a.group, a.n);
  int staged = -1;  // the panel whose slab shared memory holds
  int held = -1;    // row kind: the row block acc sums
  for (int w = blk * a.group; w < w1; ++w) {
    if (!panel) {
      const int rb = __ldg(a.rb + w);
      if (rb != held) {
        if (held >= 0)
          flush<MMA, MT>(acc, a.row_nodes + static_cast<long long>(held) *
                                                a.tr,
                         a.tr, a.out, a.h, col0, a.vec);
        held = rb;
      }
    }
    for (int j = 0; j < a.slots; ++j) {
      const long long ti = static_cast<long long>(w) * a.slots + j;
      const int p = __ldg(a.panel_idx + (panel ? w : ti));
      if (p != staged) {
        stage_panel<MMA, P>(x, a.panel_nodes + static_cast<long long>(p) * TC,
                            nodes, bs, col0, a.h, d);
        staged = p;
      }
      stage_tile<MMA, TileT>(tiles + ti * tile_elems, a.tr, as);
      __syncthreads();
      if constexpr (MMA) {
        mma_tile<MT>(static_cast<const uint16_t*>(as),
                     static_cast<const uint16_t*>(bs), acc);
      } else {
        ffma_tile<MT>(static_cast<const float*>(as),
                      static_cast<const float*>(bs), acc);
      }
      if (panel)
        flush<MMA, MT>(acc, a.row_nodes + static_cast<long long>(
                                              __ldg(a.rb + ti)) * a.tr,
                       a.tr, a.out, a.h, col0, a.vec);
      __syncthreads();
    }
  }
  if (held >= 0)
    flush<MMA, MT>(acc, a.row_nodes + static_cast<long long>(held) * a.tr,
                   a.tr, a.out, a.h, col0, a.vec);
}

template <bool MMA, int MT, typename TileT, typename P>
__global__ void __launch_bounds__(THREADS) bcsr_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same_v<P, Quant>) {
    const float2 d = divisor(a.safe);
    if (rcp_route(d))
      bcsr_body<MMA, MT, TileT, QuantRcp>(a, d, smem);
    else
      bcsr_body<MMA, MT, TileT, QuantDiv>(a, d, smem);
  } else {
    bcsr_body<MMA, MT, TileT, P>(a, float2{}, smem);
  }
}

template <bool MMA, int MT, typename TileT, typename P>
int launch(const Args& a, cudaStream_t s) {
  constexpr int smem = smem_bytes<MMA, MT>();
  const long long grid =
      static_cast<long long>((a.n + a.group - 1) / a.group) *
      ((a.h + HS - 1) / HS);
  if (grid > 0x7fffffffLL) return 901;
  cudaError_t e = cudaFuncSetAttribute(
      bcsr_kernel<MMA, MT, TileT, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bcsr_kernel<MMA, MT, TileT, P>
      <<<static_cast<unsigned>(grid), THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool MMA, typename TileT, typename P>
int by_rows(const Args& a, cudaStream_t s) {
  if (a.tr <= 16) return launch<MMA, 1, TileT, P>(a, s);
  if (a.tr <= 32) return launch<MMA, 2, TileT, P>(a, s);
  if (a.tr <= 64) return launch<MMA, 4, TileT, P>(a, s);
  return 901;
}

template <bool MMA, typename TileT>
int by_payload(const Args& a, int payload, cudaStream_t s) {
  switch (payload) {
    case 0:
      return by_rows<MMA, TileT, AsIs>(a, s);
    case 1:
      return by_rows<MMA, TileT, Widen<int8_t>>(a, s);
    case 5:
      return by_rows<MMA, TileT, Bf16>(a, s);
    default:
      break;
  }
  if constexpr (!MMA) {
    switch (payload) {
      case 2:
        return by_rows<false, TileT, Widen<int16_t>>(a, s);
      case 3:
        return by_rows<false, TileT, Widen<int32_t>>(a, s);
      case 4:
        return a.safe ? by_rows<false, TileT, Quant>(a, s) : 901;
      default:
        break;
    }
  }
  return 901;
}

}  // namespace

// tiles: (n, slots, tr, 128) bf16 bits (tile_f32 0) or f32 (1), 16-byte
// aligned; panel_idx / rb int32: row kind (n, slots) / (n,), panel kind
// (n,) / (n, slots); panel_nodes (n_panels * 128,), row_nodes
// (n_rb * tr,) int32; payload: 0 f32, 1 int8, 2 int16, 3 int32, 4 f32
// rounded to round(x / *safe) (safe an f32 on the card; null otherwise),
// 5 bf16; mma 1 for the bf16 tensor-core mode (bf16 tiles with payload 0,
// 1 or 5), 0 for the f32 mode; tr <= 64; group >= 1 work items a block;
// vec 4 where h % 4 == 0 and out is 16-byte aligned, 2 where h % 2 == 0
// and out is 8-byte aligned, else 1 (the widths of the adds).
// Returns 0 or an error code (cudaError_t, or 901: arguments refused).
extern "C" int bcsr_add(const void* tiles, int tile_f32, const void* panel_idx,
                        const void* rb, const void* panel_nodes,
                        const void* row_nodes, int kind, int n, int slots,
                        int tr, int group, const void* x, int payload,
                        const void* safe, int mma, void* out, int h, int vec,
                        void* stream) {
  if (n <= 0 || h <= 0) return 0;
  if (slots <= 0 || tr <= 0 || group <= 0 || (kind != 0 && kind != 1) ||
      (vec != 1 && vec != 2 && vec != 4))
    return 901;
  const Args a{tiles, static_cast<const int*>(panel_idx),
               static_cast<const int*>(rb),
               static_cast<const int*>(panel_nodes),
               static_cast<const int*>(row_nodes), kind, n, slots, tr, group,
               vec, x, static_cast<const float*>(safe),
               static_cast<float*>(out), h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) return tile_f32 ? 901 : by_payload<true, uint16_t>(a, payload, s);
  return tile_f32 ? by_payload<false, float>(a, payload, s)
                  : by_payload<false, uint16_t>(a, payload, s);
}
