// K-int: int8 staircase bands x integer payload, exact int32 product
// (mod 2^32), scatter-added as f32, all bands of one SpMM in one persistent
// launch.
//
// Replaces the XLA bodies of pygim_tpu/ops/spmm.py:_core_matmul's s8 branch
// (dot(int8 band, int8 xc) -> int32, :598-600) and _wide_int_core_dot
// (:520-568, the wrapped int32 product of an int8 band with an int16 or
// int32 payload), with the scatter of _core_scatter
// (out.at[core_nodes[lo:hi]].add(f32(P))). For every band b = (lo, hi, w):
//
//     P[i, :] = sum_{j < w} band_b[i, j] * q[j, :]      (int32, wraps)
//     out[nodes[lo + i], :] += f32(P[i, :])
//
// The payload q (w_max x h) comes as L int8 limbs, q = sum_l 2^(8l) * limb_l
// (mod 2^32; ops/core_int.py:limb_split), stored K-major as xcT
// (L, h_pad, k_pad) int8: limb l of q[j, n] sits at xcT[l, n, j], rows past h
// and columns past w_max are zero. Every step below is a ring homomorphism
// mod 2^32, so P = sum_l (band @ limb_l) << 8l, summed in uint32, is the
// reference's wrapped int32 product bit for bit, also where one limb's own
// int32 sum wraps. The wgmma runs without .satfinite: saturation would
// break that.
//
// Contract (the wrapper checks it): band widths w % 16 == 0 (the TMA row
// stride is w bytes), h_pad % 64 == 0, k_pad % 16 == 0, 16-byte aligned
// bands and xcT, at most MAX_BANDS bands a launch; any h (16-byte stores
// where vec is set: h % 4 == 0 and out 16-byte aligned).
//
// What bounds it on an H100 SXM: per band 2 * r * w * h * L int8 tensor
// operations against r * w band bytes (plus the output rows, read and
// written once): at h = 256 the s8 rate (1,979 TOP/s) puts L = 1 under the
// bytes and L = 3 (the int32 path) over them.
//
// What the design does about it:
// - wgmma m64nNk32 .s32.s8.s8, both operands K-major from shared memory
//   (an 8-bit wgmma has no transpose, hence the K-major xcT); the band is
//   read by TMA as stored (row-major (r, w) is K-major already), never
//   widened.
// - The limbs lie along N in blocks of 64 columns: block g * L + l holds
//   limb l of the tile's output columns 64g..64g + 63. One B stage carries
//   every limb of the tile, A is read once for all limbs, and wgmma's
//   accumulator layout (column 8i + 2 * (lane % 4) + {0, 1}) keeps all limbs
//   of an output element in one thread, so the recombination is in
//   registers. N = 256 (L = 1, 2, 4: 256, 128 and 64 output columns a tile)
//   or 192 (L = 3: 64 columns).
// - The skeleton is K-core's (core_dot.cu): one producer thread keeps a
//   STAGES-deep ring of TMA loads in flight (mbarrier full/empty pairs,
//   zero fill at the ragged row and contraction edges), two consumer
//   warpgroups of 64 band rows each, one persistent block per SM walking
//   a host-built, longest-first tile list (ops/core_dot.py:tile_schedule)
//   with whole contractions, so the epilogue needs no atomics. The band
//   maps are K-core's (core_dot.cu:core_encode_band_map: 64 x 128 boxes,
//   64-byte swizzle), and so is the xcT map's swizzle.
// - A consumer keeps one stage's wgmmas in flight while it waits for the
//   next stage, and releases a stage when its products have retired.
// - The epilogue recombines the limbs, converts to f32 (round to nearest,
//   as XLA's convert), stages each 64-column slice through shared memory
//   and adds it into out[nodes[lo + i], :] along each row, every row's load
//   issued before any store.

#include <string.h>

#include "tma.cuh"

namespace {

constexpr int MAX_BANDS = 16;
constexpr int BM = 128;           // band rows per tile (2 warpgroups x 64)
constexpr int BK = 64;            // contraction per ring stage (bytes = k)
constexpr int STAGES = 6;
constexpr int THREADS = 384;      // consumer WG 0, 1; producer WG 2
constexpr int A_STAGE = BM * BK;  // int8, 64-byte swizzle
constexpr int B_BOX = 64 * BK;    // 64 rows (n) x BK int8, 64-byte swizzle
constexpr int B_STAGE = 4 * B_BOX;  // up to N = 256 rows
constexpr int EPI_LD = 72;          // f32 row stride of staging
constexpr int EPI_WG = 64 * EPI_LD * 4;
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + STAGES * A_STAGE;
constexpr int OFF_EPI = OFF_B + STAGES * B_STAGE;
constexpr int OFF_BAR = OFF_EPI + 2 * EPI_WG;
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment

struct __align__(64) Params {
  CUtensorMap band[MAX_BANDS];
  CUtensorMap xct;
  int lo[MAX_BANDS], r[MAX_BANDS], w[MAX_BANDS];
};

// Shared-memory matrix descriptor of a K-major int8 operand in 64-byte
// rows, 64-byte swizzle: SBO = 8 rows x 64 B between 8-row groups (LBO is
// unused for swizzled K-major layouts); both in 16-byte units. Adding 2
// advances 32 bytes (one k32 step) inside the swizzle atom.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

#define R8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64 x 256] (s32) += A[64 x 32] @ B[32 x 256], both s8 and K-major in
// shared memory (descriptors); integer products wrap mod 2^32
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56), R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 192] (s32) += A[64 x 32] @ B[32 x 192], both s8 and K-major in
// shared memory (descriptors); integer products wrap mod 2^32
__device__ __forceinline__ void wgmma_s8_n192(int* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56), R8(64), R8(72), R8(80), R8(88)
      : "l"(da), "l"(db), "r"(1));
}
#undef R8

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  if constexpr (N == 256)
    wgmma_s8_n256(d, da, db);
  else
    wgmma_s8_n192(d, da, db);
}

template <int L>
__global__ void __launch_bounds__(THREADS, 1)
core_int_kernel(const __grid_constant__ Params p, const int* __restrict__ tiles,
                const int* __restrict__ starts, const int* __restrict__ nodes,
                float* __restrict__ out, int h, int h_pad, int vec) {
  constexpr int N = L == 3 ? 192 : 256;  // wgmma width: L limbs x G blocks
  constexpr int G = N / (64 * L);        // 64-column output blocks a tile
  constexpr int NACC = N / 2;            // s32 accumulators a thread

  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle patterns are address-based: align the ring to 1024 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t full0 = s_base + OFF_BAR;
  const uint32_t empty0 = full0 + STAGES * 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int t_begin = starts[blockIdx.x], t_end = starts[blockIdx.x + 1];
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const int b = tiles[3 * t], m0 = tiles[3 * t + 1],
                  n0 = tiles[3 * t + 2];
        const int ng = min(G, (h - n0 + 63) / 64);  // blocks inside h
        const CUtensorMap* amap = &p.band[b];
        for (int k0 = 0; k0 < p.w[b]; k0 += BK) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, A_STAGE + ng * L * B_BOX);
          tma_load_2d(s_base + OFF_A + stage * A_STAGE, amap, k0, m0, full);
          for (int g = 0; g < ng; ++g)
            for (int l = 0; l < L; ++l)
              tma_load_2d(s_base + OFF_B + stage * B_STAGE + (g * L + l) * B_BOX,
                          &p.xct, k0, l * h_pad + n0 + 64 * g, full);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma on a 64 x N half of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    float* epi = reinterpret_cast<float*>(smem + OFF_EPI + wg * EPI_WG);
    int stage = 0;
    uint32_t phase = 0;

    for (int t = t_begin; t < t_end; ++t) {
      const int b = tiles[3 * t], m0 = tiles[3 * t + 1], n0 = tiles[3 * t + 2];
      const int r = p.r[b], lo = p.lo[b], w = p.w[b];
      int acc[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0;

      int held = -1;  // the stage whose wgmmas may still run
      for (int k0 = 0; k0 < w; k0 += BK) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint64_t da =
            kmajor_desc(s_base + OFF_A + stage * A_STAGE + wg * 64 * BK);
        const uint64_t db = kmajor_desc(s_base + OFF_B + stage * B_STAGE);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        wgmma_s8<N>(acc, da, db);
        wgmma_s8<N>(acc, da + 2, db + 2);  // the second 32 bytes of k
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // the previous stage's group has retired: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);
        held = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (held >= 0 && lane == 0) mbar_arrive(empty0 + 8 * held);

      // ---- epilogue: out[nodes[lo + row], n0 + col] += f32(P) ----
      int ids[8];  // output rows of this thread's epilogue reads
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = m0 + 64 * wg + (tid >> 4) + 8 * k;
        ids[k] = row < r ? nodes[lo + row] : -1;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (n0 + 64 * g >= h) break;
        named_bar_sync(1 + wg);  // the previous slice's readers are done
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t v = 0;
#pragma unroll
            for (int l = 0; l < L; ++l)
              v += static_cast<uint32_t>(acc[32 * (g * L + l) + 4 * j + e])
                   << (8 * l);
            f[e] = __int2float_rn(static_cast<int>(v));
          }
          const int col = 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(epi + (16 * warp + g8) * EPI_LD + col) =
              make_float2(f[0], f[1]);
          *reinterpret_cast<float2*>(epi + (16 * warp + g8 + 8) * EPI_LD + col) =
              make_float2(f[2], f[3]);
        }
        named_bar_sync(1 + wg);
        const int col = n0 + 64 * g + 4 * (tid & 15);
        if (col >= h) continue;
        float4 s[8], v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          s[k] = *reinterpret_cast<const float4*>(
              epi + ((tid >> 4) + 8 * k) * EPI_LD + 4 * (tid & 15));
        if (vec) {  // h % 4 == 0: the whole float4 is inside
          // all eight loads in flight before any store
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (ids[k] >= 0)
              v[k] = *reinterpret_cast<const float4*>(
                  out + static_cast<int64_t>(ids[k]) * h + col);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (ids[k] < 0) continue;
            v[k].x += s[k].x;
            v[k].y += s[k].y;
            v[k].z += s[k].z;
            v[k].w += s[k].w;
            *reinterpret_cast<float4*>(
                out + static_cast<int64_t>(ids[k]) * h + col) = v[k];
          }
        } else {  // ragged or unaligned: element by element
          const int n = h - col;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (ids[k] < 0) continue;
            float* o = out + static_cast<int64_t>(ids[k]) * h + col;
            o[0] += s[k].x;
            if (n > 1) o[1] += s[k].y;
            if (n > 2) o[2] += s[k].z;
            if (n > 3) o[3] += s[k].w;
          }
        }
      }
    }
  }
}

template <int L>
int launch(const Params& p, const void* tiles, const void* starts, int grid,
           const void* nodes, void* out, int h, int h_pad, int vec,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      core_int_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  core_int_kernel<L><<<grid, THREADS, SMEM_BYTES, stream>>>(
      p, static_cast<const int*>(tiles), static_cast<const int*>(starts),
      static_cast<const int*>(nodes), static_cast<float*>(out), h, h_pad, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over all bands: `band_maps` holds n_bands maps encoded by
// core_dot.cu:core_encode_band_map (host), `band_info` (lo, r, w) per band
// (host); xct is the (limbs, h_pad, k_pad) int8 limb payload; `tiles`
// (int32 triples: band, m0, n0, n0 in steps of 64 * G columns) and `starts`
// (grid + 1 offsets into tiles, one segment per block) are on the device.
// vec: h % 4 == 0 and out 16-byte aligned. Returns 0 or an error code
// (cudaError_t, or the codes of tma.cuh).
extern "C" int core_int_scatter_add(const void* band_maps, const int* band_info,
                                    int n_bands, const void* xct,
                                    long long k_pad, int h_pad, int limbs,
                                    const void* tiles, const void* starts,
                                    int grid, const void* nodes, void* out,
                                    int h, int vec, void* stream) {
  if (n_bands < 1 || n_bands > MAX_BANDS || grid < 1 || h < 1 ||
      h_pad % 64 || h_pad < h || k_pad % 16 || limbs < 1 || limbs > 4)
    return ERR_ARGS;
  Params p;
  memset(&p, 0, sizeof p);
  memcpy(p.band, band_maps, n_bands * sizeof(CUtensorMap));
  for (int i = 0; i < n_bands; ++i) {
    p.lo[i] = band_info[3 * i];
    p.r[i] = band_info[3 * i + 1];
    p.w[i] = band_info[3 * i + 2];
  }
  int err = encode_2d(&p.xct, CU_TENSOR_MAP_DATA_TYPE_UINT8, xct, k_pad,
                      static_cast<long long>(limbs) * h_pad, k_pad, BK, 64,
                      CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 1:
      return launch<1>(p, tiles, starts, grid, nodes, out, h, h_pad, vec, s);
    case 2:
      return launch<2>(p, tiles, starts, grid, nodes, out, h, h_pad, vec, s);
    case 3:
      return launch<3>(p, tiles, starts, grid, nodes, out, h, h_pad, vec, s);
    default:
      return launch<4>(p, tiles, starts, grid, nodes, out, h, h_pad, vec, s);
  }
}
