// K-core: int8 staircase bands x bf16 payload, f32 accumulate, scatter-add,
// all bands of one SpMM in one persistent launch.
//
// Replaces the TPU kernel pygim_tpu/ops/pallas_core.py:_dequant_core_dot
// (bf16(int8 core) @ bf16(x), f32 accumulation) together with the XLA
// scatter of its product, out.at[core_nodes[lo:hi]].add(...) in
// pygim_tpu/ops/spmm.py:_core_scatter. For every band b = (lo, hi, w) it
// computes
//
//     out[nodes[lo + i], :] += sum_{j < w} f32(band_b[i, j]) * f32(xc[j, :])
//
// with band_b int8 (hi - lo, w) row-major, xc bf16 (>= w, h) row-major,
// nodes int32 (distinct over all bands: the staircase bands tile disjoint
// row ranges, so every output element belongs to exactly one tile and a
// whole tile needs no atomics), out f32 (N, h) row-major. Contract (the wrapper
// checks it): w % 16 == 0 (the TMA row stride is w bytes), h % 8 == 0,
// 16-byte aligned operands, at most MAX_BANDS bands per launch (the wrapper
// launches once per group of MAX_BANDS bands).
//
// What bounds it on an H100 SXM: 2*r*w*h operations against r*w bytes of
// int8 band, i.e. 2*h = 512 operations per band byte at h = 256, above the
// card's ~295 bf16 operations per HBM byte: the bf16 tensor-core rate.
//
// What the design does about it:
// - wgmma (m64n256k16, bf16 in, f32 accumulate) is the only instruction
//   that reaches Hopper's tensor-core rate. Each block runs two consumer
//   warpgroups on a 128 x 256 output tile, 128 f32 accumulators a thread;
//   setmaxnreg moves registers from the producer warpgroup to them.
// - A comes from registers: each consumer thread reads its fragment's
//   int8 bytes from shared memory and widens them to bf16 with byte
//   permutes and one f32 add per value (exact for |v| <= 128; the band is
//   never widened in memory). B (xc) is read by wgmma straight from
//   shared memory in its own row-major (K, N) layout, i.e. MN-major with
//   the transpose bit, 128-byte swizzled by TMA.
// - One producer thread keeps a 4-stage ring of TMA loads in flight
//   (cp.async.bulk.tensor, mbarrier full/empty pairs). TMA's zero fill
//   takes the ragged row and column edges; k16 steps past w are skipped.
// - One persistent block per SM walks its share of a host-built tile list
//   (band, m0, n0): longest contraction first, spread over the blocks by
//   a greedy longest-first assignment, so short bands fill the SMs that
//   the long ones leave idle. One launch covers every band, and each
//   tile runs its whole contraction, so no epilogue needs atomics.
// - The epilogue stages each 64-column slice of the tile through shared
//   memory and adds it into out[nodes[lo + i], n0:n0 + 256] with 16-byte
//   read-modify-writes along each row.

#include <cuda_bf16.h>
#include <string.h>

#include "tma.cuh"

namespace {

constexpr int MAX_BANDS = 16;
constexpr int BM = 128;             // band rows per tile (2 warpgroups x 64)
constexpr int BN = 256;             // output columns per tile
constexpr int BK = 64;              // contraction per ring stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;        // consumer WG 0, 1; producer WG 2
constexpr int A_STAGE = BM * BK;                // int8, 64-byte swizzle
constexpr int B_BOX = 64 * BK * 2;              // 64 columns x BK rows bf16
constexpr int B_STAGE = (BN / 64) * B_BOX;      // 128-byte swizzle
constexpr int EPI_LD = 72;                      // f32 row stride of staging
constexpr int EPI_WG = 64 * EPI_LD * 4;
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + STAGES * A_STAGE;
constexpr int OFF_EPI = OFF_B + STAGES * B_STAGE;
constexpr int OFF_BAR = OFF_EPI + 2 * EPI_WG;
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment

struct __align__(64) Params {
  CUtensorMap band[MAX_BANDS];
  CUtensorMap xc;
  int lo[MAX_BANDS], r[MAX_BANDS], w[MAX_BANDS];
};

// Shared-memory matrix descriptor of one 64-row (k) x 256-column (n) bf16
// B stage: four 64-column boxes of 64 rows x 128 bytes, 128-byte swizzle.
// MN-major: LBO = stride between 64-column boxes (8192 B), SBO = stride
// between 8-row groups (1024 B); both in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(B_BOX >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Four int8 (bytes of q) -> two bf16x2 (lo: bytes 0, 1; hi: bytes 2, 3),
// the lower byte in the lower half. 2^23 + 128 + v is exact in f32; the
// subtraction leaves v, whose bf16 is the top half of its f32.
__device__ __forceinline__ void s8x4_to_bf16x4(uint32_t q, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t x = q ^ 0x80808080u;
  const uint32_t magic = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(x, magic, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(x, magic, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(x, magic, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(x, magic, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

#define D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] += a[64 x 16] (registers, bf16) @ B[16 x 256] (shared, bf16,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_m64n256k16(float* d, const uint32_t* a,
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64),
        D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
#undef D8

// This thread's m64k16 A fragments for the four k16 steps of one stage:
// a[s] = {row g, cols 2t4..+1}, {row g+8, same}, {row g, cols 2t4+8..+9},
// {row g+8, same}, read as int8 from the 64-byte-swizzled stage and
// widened to bf16x2
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* As,
                                       int a_off0, int a_off1, int swz) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = (s ^ swz) << 4;
    const uint32_t q0 =
        *reinterpret_cast<const uint16_t*>(As + a_off0 + c) |
        (static_cast<uint32_t>(
             *reinterpret_cast<const uint16_t*>(As + a_off0 + c + 8))
         << 16);
    const uint32_t q1 =
        *reinterpret_cast<const uint16_t*>(As + a_off1 + c) |
        (static_cast<uint32_t>(
             *reinterpret_cast<const uint16_t*>(As + a_off1 + c + 8))
         << 16);
    s8x4_to_bf16x4(q0, a[s][0], a[s][2]);
    s8x4_to_bf16x4(q1, a[s][1], a[s][3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
core_bands_kernel(const __grid_constant__ Params p,
                  const int* __restrict__ tiles,
                  const int* __restrict__ starts,
                  const int* __restrict__ nodes, float* __restrict__ out,
                  int h) {
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
        const int nbox = min(BN / 64, (h - n0 + 63) / 64);
        const CUtensorMap* amap = &p.band[b];
        for (int k0 = 0; k0 < p.w[b]; k0 += BK) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, A_STAGE + nbox * B_BOX);
          tma_load_2d(s_base + OFF_A + stage * A_STAGE, amap, k0, m0, full);
          for (int j = 0; j < nbox; ++j)
            tma_load_2d(s_base + OFF_B + stage * B_STAGE + j * B_BOX, &p.xc,
                        n0 + 64 * j, k0, full);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma on a 64 x 256 half of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    // this thread's A rows in the tile: ra and ra + 8 (same swizzle row)
    const int ra = 64 * wg + 16 * warp + g;
    const int swz = (ra >> 1) & 3;  // 64-byte swizzle: chunk ^= bits 7..8
    const int a_off0 = ra * BK + 2 * t4;
    const int a_off1 = a_off0 + 8 * BK;
    float* epi = reinterpret_cast<float*>(smem + OFF_EPI + wg * EPI_WG);
    int stage = 0;
    uint32_t phase = 0;

    for (int t = t_begin; t < t_end; ++t) {
      const int b = tiles[3 * t], m0 = tiles[3 * t + 1], n0 = tiles[3 * t + 2];
      const int r = p.r[b], lo = p.lo[b], w = p.w[b];
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;

      // The A fragments of stage k + 1 are read and widened while the
      // wgmmas of stage k run; a wgmma's registers stay untouched until
      // wait_group has retired it.
      uint32_t a[4][4], a_next[4][4];
      mbar_wait(full0 + 8 * stage, phase);
      load_a(a, smem + OFF_A + stage * A_STAGE, a_off0, a_off1, swz);
      for (int k0 = 0; k0 < w; k0 += BK) {
        const uint64_t desc = b_desc(s_base + OFF_B + stage * B_STAGE);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        if (w - k0 >= BK) {
#pragma unroll
          for (int s = 0; s < 4; ++s)  // 16 rows of B = 128 descriptor units
            wgmma_m64n256k16(acc, a[s], desc + 128ull * s);
        } else {  // the last k16 steps of a width that is not a BK multiple
          const int ksteps = (w - k0) >> 4;
#pragma unroll
          for (int s = 0; s < 3; ++s)
            if (s < ksteps) wgmma_m64n256k16(acc, a[s], desc + 128ull * s);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        int next = stage + 1;
        uint32_t next_phase = phase;
        if (next == STAGES) {
          next = 0;
          next_phase ^= 1;
        }
        if (k0 + BK < w) {
          mbar_wait(full0 + 8 * next, next_phase);
          load_a(a_next, smem + OFF_A + next * A_STAGE, a_off0, a_off1, swz);
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        stage = next;
        phase = next_phase;
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[s][e] = a_next[s][e];
      }

      // ---- epilogue: out[nodes[lo + row], n0 + col] += acc ----
      int ids[8];  // output rows of this thread's epilogue reads
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = m0 + 64 * wg + (tid >> 4) + 8 * k;
        ids[k] = row < r ? nodes[lo + row] : -1;
      }
#pragma unroll
      for (int c4 = 0; c4 < BN / 64; ++c4) {
        if (n0 + 64 * c4 >= h) break;
        named_bar_sync(1 + wg);  // the previous slice's readers are done
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const int i = 32 * c4 + 4 * j;  // compile-time after unrolling
          *reinterpret_cast<float2*>(epi + (16 * warp + g) * EPI_LD + col) =
              make_float2(acc[i], acc[i + 1]);
          *reinterpret_cast<float2*>(epi + (16 * warp + g + 8) * EPI_LD + col) =
              make_float2(acc[i + 2], acc[i + 3]);
        }
        named_bar_sync(1 + wg);
        const int col = n0 + 64 * c4 + 4 * (tid & 15);
        if (col < h) {  // h % 8 == 0: the whole float4 is inside
          float4 s[8], v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            s[k] = *reinterpret_cast<const float4*>(
                epi + ((tid >> 4) + 8 * k) * EPI_LD + 4 * (tid & 15));
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
        }
      }
    }
  }
}

}  // namespace

// Encode the TMA map of one int8 band (r, w) into `map` (128 bytes of host
// memory). Returns 0 or an error code.
extern "C" int core_encode_band_map(void* map, const void* band, long long r,
                                    long long w) {
  CUtensorMap m;
  const int err = encode_2d(&m, CU_TENSOR_MAP_DATA_TYPE_UINT8, band, w, r, w,
                            BK, BM, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0) memcpy(map, &m, sizeof m);
  return err;
}

// One launch over all bands: `band_maps` holds n_bands encoded maps (host),
// `band_info` (lo, r, w) per band (host); `tiles` (int32 triples: band,
// m0, n0) and `starts` (grid + 1 offsets into tiles, one segment per block) are on
// the device. Returns 0 or an error code (cudaError_t, or the codes above).
extern "C" int core_bands_scatter_add(const void* band_maps,
                                      const int* band_info, int n_bands,
                                      const void* xc, long long n_xc,
                                      const void* tiles, const void* starts,
                                      int grid, const void* nodes, void* out,
                                      int h, void* stream) {
  if (n_bands < 1 || n_bands > MAX_BANDS || grid < 1 || h % 8) return ERR_ARGS;
  Params p;
  memset(&p, 0, sizeof p);
  memcpy(p.band, band_maps, n_bands * sizeof(CUtensorMap));
  for (int i = 0; i < n_bands; ++i) {
    p.lo[i] = band_info[3 * i];
    p.r[i] = band_info[3 * i + 1];
    p.w[i] = band_info[3 * i + 2];
  }
  int err = encode_2d(&p.xc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xc, h, n_xc,
                      2ll * h, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      core_bands_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  core_bands_kernel<<<grid, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(tiles), static_cast<const int*>(starts),
      static_cast<const int*>(nodes), static_cast<float*>(out), h);
  return static_cast<int>(cudaGetLastError());
}
