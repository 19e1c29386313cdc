// K-f32: hub-core bands (f32 cells, or bf16 cells widened exactly) x a
// payload, an f32-accurate product on the tensor cores, scatter-added, all
// bands of one SpMM in one launch.
//
// Replaces two XLA bodies of pygim_tpu/ops/spmm.py:_core_matmul together
// with the scatter of their product (out.at[core_nodes[lo:hi]].add in
// _core_scatter): the f32 core's product (:630, dot(core, f32(x)): the
// reference's default hybrid core on a float graph), and the bf16 core's
// product with a wide integer payload (:615-628: both operands promoted to
// f32, the int16 / int32 quantized aggregates on a bf16 core). For every
// band b = (lo, hi, w) it computes
//
//     out[nodes[lo + i], :] += sum_{j < w} f32(band_b[i, j]) * f32(xc[j, :])
//
// with band_b (hi - lo, w) row-major of f32 or bf16 cells, xc (>= w, h) of
// f32, bf16, int8, int16 or int32, nodes int32 distinct over all bands (no
// atomics: every output element belongs to one tile) and out f32 (N, h)
// row-major.
//
// What bounds it on an H100 SXM: operations. In f32 FFMAs, 2*r*w*h
// operations against r*w*4 bytes of band (2 for bf16) are h / 2 = 128 a
// byte at h = 256, far above the card's 67 TFLOP/s / 3.35 TB/s = 20; the
// tensor cores' TF32 rate (495 TFLOP/s) is 7.4 times the FFMA rate, so
// even three TF32 products a term beat one FFMA product (the SIMT FFMA
// kernel this one replaced ran at about a third of the FFMA rate), and
// the work is P * 2*r*w*h at 495 TFLOP/s for P TF32 products a term.
//
// Contract (the wrapper checks it): band widths w % 4 == 0 for f32 cells
// and w % 8 == 0 for bf16, 16-byte aligned bands (the TMA's 16-byte row
// stride; the prepared operand pads its bands to this rule), any h. The
// product is an f32-accurate operand split, never a TF32 rounding of the
// product.
// - TF32 keeps 11 significant bits. An f32 value a is a_hi + a_lo with
//   a_hi = cvt.rna.tf32(a) and a_lo = cvt.rna.tf32(a - a_hi) (a - a_hi is
//   exact in f32). f32 cells are split so in registers; bf16 cells are
//   exact in TF32 (8 bits) and go whole.
// - The payload is split once a SpMM by the wrapper into P parts, written
//   K-major as xcT (P, h_pad, k_pad) f32 (ops/core_f32.py:payload_parts):
//   bf16 and int8 rows exact in TF32 (one part); f32 rows, and int16 /
//   int32 rows beside f32 cells (converted to f32 first, as the
//   reference's convert), as a TF32 hi and lo (two parts); int16 and int32
//   rows beside bf16 cells as balanced limbs of 11 bits, pre-scaled
//   (x0 + 2^11 x1 [+ 2^22 x2], each x_l in [-1024, 1024) but the last:
//   two or three parts, each exact in TF32).
// - Products, each exact in f32 (an 11-bit by 11-bit or 8-bit product),
//   on wgmma m64n128k8 .f32.tf32.tf32 with A from registers: f32 cells
//   a_hi b_hi + a_hi b_lo + a_lo b_hi (3xTF32, dropping a_lo b_lo: about
//   3 * 2^-22 of the sum of |terms|, inside the 1e-5 bar; two products
//   beside a one-part payload), bf16 cells one product a part. Two f32
//   accumulators: the first part's products (a_hi b_hi; a bf16 cell's low
//   limb) and the rest; the epilogue adds them and then out. For integer
//   limbs that keeps the result bit-equal to the reference's f32 dot
//   wherever its partial sums are integers below 2^24: each accumulator's
//   partial sums are then integers below 2^24 (|x0| <= |x|, and the upper
//   limbs' sums are multiples of 2^11 below 2^35), so each is exact, and
//   so is their sum, an integer below 2^24.
// - wgmma's TF32 form takes both shared-memory operands K-major (the
//   transpose bits are for 16-bit types), hence the K-major xcT; the band,
//   row-major, is K-major as stored and is read into registers from a
//   128-byte-swizzled stage (64-byte for bf16; conflict-free).
// - A block is a 128 x 128 output tile of one band, its whole
//   contraction: two consumer warpgroups of 64 rows, one producer thread
//   keeping a ring of TMA stages (32 cells deep: the A box and P payload
//   boxes) in flight, as many stages as fit in 227 KB (4 to 6); every
//   ring wait traps after about 2 s instead of hanging the card. One
//   launch covers up to MAX_BANDS bands: the host lists every tile (band,
//   m0, n0), the widest bands' first.
// - The epilogue adds a thread's column pairs into out with 8-byte
//   read-modify-writes where h is even and out 8-byte aligned (every pair
//   then starts on an 8-byte boundary), else element by element; the
//   payload parts are zero-padded to whole 128-column tiles, so an odd h
//   (a 41-class GCN's second aggregate) runs the same wgmmas.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

namespace {

constexpr int MAX_BANDS = 16;

namespace tc {

constexpr int BM = 128;       // band rows per tile (2 warpgroups x 64)
constexpr int BN = 128;       // output columns per tile
constexpr int BK = 32;        // contraction per ring stage (cells)
constexpr int THREADS = 384;  // consumer WG 0, 1; producer WG 2
constexpr int F32 = 0, BF16 = 1;  // cell types (the host's `cell`)

// The shared-memory layout of a cell type and payload part count: the A
// ring (f32: 128 rows x 128 B, 128-byte swizzle; bf16: 128 rows x 64 B,
// 64-byte swizzle), the payload ring (NB boxes of 128 xcT rows x 128 B,
// 128-byte swizzle), then the full / empty barriers
template <int CELL, int NB>
struct Layout {
  static constexpr int A_STAGE = BM * BK * (CELL == F32 ? 4 : 2);
  static constexpr int B_PART = BN * BK * 4;
  static constexpr int STAGE = A_STAGE + NB * B_PART;
  static constexpr int FIT = (232448 - 2048) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int OFF_B = STAGES * A_STAGE;
  static constexpr int OFF_BAR = OFF_B + STAGES * NB * B_PART;
  static constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;
};
static_assert(Layout<BF16, 3>::STAGES >= 4, "bf16 x 3 parts: ring too small");
static_assert(Layout<F32, 2>::STAGES >= 4, "f32 x 2 parts: ring too small");
static_assert(Layout<BF16, 3>::SMEM_BYTES <= 232448, "ring too large");

struct __align__(64) Params {
  CUtensorMap band[MAX_BANDS];
  CUtensorMap xct;
  int lo[MAX_BANDS], r[MAX_BANDS], w[MAX_BANDS];
  int h_pad;
};

// Shared-memory matrix descriptor of a K-major f32 operand in 128-byte
// rows, 128-byte swizzle: SBO = 8 rows x 128 B between 8-row groups (LBO
// is unused for swizzled K-major layouts); both in 16-byte units. Adding
// 2 advances 32 bytes (one k8 step) inside the swizzle atom.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

#define D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] += a[64 x 8] (registers, tf32) @ B[8 x 128] (shared, tf32,
// K-major)
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#undef D8

// This thread's m64k8 A fragments for the four k8 steps of one stage:
// a[s] = {row g, cell 8s + t4}, {row g + 8, same}, {row g, cell 8s + 4 +
// t4}, {row g + 8, same}, as TF32 bits: an f32 stage (128-byte rows,
// 128-byte swizzle: 16-byte chunk c of row i at c ^ (i & 7)) split into
// hi and lo; a bf16 stage (64-byte rows, 64-byte swizzle: chunk c at c ^
// ((i >> 1) & 3)) widened, exact (lo unused)
template <int CELL>
__device__ __forceinline__ void load_a(uint32_t (&hi)[4][4],
                                       uint32_t (&lo)[4][4],
                                       const uint8_t* As, int ra, int t4) {
  if constexpr (CELL == F32) {
    const uint8_t* r0 = As + ra * 128;
    const uint8_t* r1 = As + (ra + 8) * 128;
    const int sw = ra & 7;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c0 = (((2 * s) ^ sw) << 4) + 4 * t4;
      const int c1 = (((2 * s + 1) ^ sw) << 4) + 4 * t4;
      const float v[4] = {*reinterpret_cast<const float*>(r0 + c0),
                          *reinterpret_cast<const float*>(r1 + c0),
                          *reinterpret_cast<const float*>(r0 + c1),
                          *reinterpret_cast<const float*>(r1 + c1)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[s][e] = tf32_rna(v[e]);
        lo[s][e] = tf32_rna(v[e] - __uint_as_float(hi[s][e]));
      }
    }
  } else {
    const uint8_t* r0 = As + ra * 64;
    const uint8_t* r1 = As + (ra + 8) * 64;
    const int sw = (ra >> 1) & 3;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int c = ((s ^ sw) << 4) + 2 * t4;
      hi[s][0] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(r0 + c)) << 16;
      hi[s][1] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(r1 + c)) << 16;
      hi[s][2] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(r0 + c + 8)) << 16;
      hi[s][3] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(r1 + c + 8)) << 16;
    }
  }
}

template <int CELL, int NB>
__global__ void __launch_bounds__(THREADS, 1)
core_f32_tc_kernel(const __grid_constant__ Params p,
                   const int* __restrict__ tiles,
                   const int* __restrict__ nodes, float* __restrict__ out,
                   int h) {
  using L = Layout<CELL, NB>;
  constexpr int STAGES = L::STAGES, A_STAGE = L::A_STAGE,
                B_PART = L::B_PART, OFF_B = L::OFF_B, OFF_BAR = L::OFF_BAR;
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

  const int* e = tiles + 3 * blockIdx.x;
  const int b = e[0], m0 = e[1], n0 = e[2];
  const int w = p.w[b];
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = 0; k0 < w; k0 += BK) {
        const uint32_t full = full0 + 8 * stage;
        wait_or_trap(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, A_STAGE + NB * B_PART);
        tma_load_2d(s_base + stage * A_STAGE, &p.band[b], k0, m0, full);
#pragma unroll
        for (int q = 0; q < NB; ++q)
          tma_load_2d(s_base + OFF_B + (stage * NB + q) * B_PART, &p.xct, k0,
                      q * p.h_pad + n0, full);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
    return;
  }

  // ---- consumers: wgmma on a 64 x 128 half of the tile each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = 64 * wg + 16 * warp + g;  // this thread's rows ra, ra + 8
  float acc0[64], acc1[64];  // the first part's products; the rest
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int k0 = 0; k0 < w; k0 += BK) {
    uint32_t hi[4][4], lo[4][4];
    wait_or_trap(full0 + 8 * stage, phase);
    load_a<CELL>(hi, lo, smem + stage * A_STAGE, ra, t4);
    const uint64_t d0 = kmajor_desc(s_base + OFF_B + stage * NB * B_PART);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t db = d0 + 2ull * s;
      wgmma_tf32(acc0, hi[s], db);
      if constexpr (NB >= 2)
        wgmma_tf32(acc1, hi[s], db + (B_PART >> 4));
      if constexpr (NB >= 3)
        wgmma_tf32(acc1, hi[s], db + 2 * (B_PART >> 4));
      if constexpr (CELL == F32) wgmma_tf32(acc1, lo[s], db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ---- epilogue: out[nodes[lo + row], n0 + col] += acc0 + acc1 ----
  // pairs (col, col + 1) as one 8-byte access where every pair is aligned
  const bool pairs =
      h % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const int r = p.r[b], lo_b = p.lo[b];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + ra + 8 * half;
    if (row >= r) continue;
    float* o = out + static_cast<int64_t>(nodes[lo_b + row]) * h;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      const int i = 4 * j + 2 * half;
      const float s0 = acc0[i] + acc1[i], s1 = acc0[i + 1] + acc1[i + 1];
      if (col >= h) continue;
      if (pairs) {  // h even: col + 1 < h too
        float2 v = *reinterpret_cast<const float2*>(o + col);
        v.x += s0;
        v.y += s1;
        *reinterpret_cast<float2*>(o + col) = v;
      } else {
        o[col] += s0;
        if (col + 1 < h) o[col + 1] += s1;
      }
    }
  }
}

typedef void (*KernelFn)(Params, const int*, const int*, float*, int);

template <int CELL>
KernelFn kernel_of_parts(int nb) {
  switch (nb) {
    case 1:
      return core_f32_tc_kernel<CELL, 1>;
    case 2:
      return core_f32_tc_kernel<CELL, 2>;
    case 3:
      return core_f32_tc_kernel<CELL, 3>;
  }
  return nullptr;
}

int smem_of(int cell, int nb) {
  static const int bytes[2][3] = {
      {Layout<F32, 1>::SMEM_BYTES, Layout<F32, 2>::SMEM_BYTES,
       Layout<F32, 3>::SMEM_BYTES},
      {Layout<BF16, 1>::SMEM_BYTES, Layout<BF16, 2>::SMEM_BYTES,
       Layout<BF16, 3>::SMEM_BYTES}};
  return bytes[cell][nb - 1];
}

// The kernel of the cell type and part count, with its shared memory
// granted; nullptr for another (or where the card refuses it). f32 cells
// take at most two payload parts.
KernelFn kernel_of(int cell, int nb) {
  if (nb < 1 || nb > 3 || (cell == F32 && nb > 2)) return nullptr;
  KernelFn k = cell == F32    ? kernel_of_parts<F32>(nb)
               : cell == BF16 ? kernel_of_parts<BF16>(nb)
                              : nullptr;
  if (k != nullptr &&
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_of(cell, nb)) != cudaSuccess)
    k = nullptr;
  return k;
}

}  // namespace tc

}  // namespace

// Encode the TMA map of one band of r rows and w cells (`cell` 0 f32: boxes
// of 128 rows x 32 cells, 128-byte swizzle; 1 bf16: 128 rows x 32 cells,
// 64-byte swizzle) into `map` (128 bytes of host memory). Returns 0 or an
// error code.
extern "C" int core_f32_encode_band_map(void* map, const void* band,
                                        long long r, long long w, int cell) {
  CUtensorMap m;
  int err;
  if (cell == tc::F32)
    err = encode_2d(&m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, band, w, r, 4 * w,
                    tc::BK, tc::BM, CU_TENSOR_MAP_SWIZZLE_128B);
  else if (cell == tc::BF16)
    err = encode_2d(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, band, w, r, 2 * w,
                    tc::BK, tc::BM, CU_TENSOR_MAP_SWIZZLE_64B);
  else
    return ERR_ARGS;
  if (err == 0) memcpy(map, &m, sizeof m);
  return err;
}

// One tensor-core launch over n_bands bands of one cell type: `band_maps`
// holds their encoded maps and `band_info` their (lo, r, w), both in host
// memory; `xct` the payload's n_parts parts K-major, f32 (n_parts, h_pad,
// k_pad) on the device, h_pad a multiple of 128; `tiles` (int32 (n_tiles,
// 3) on the device) each block's (band, m0, n0); any h >= 1. Returns 0 or
// an error code.
extern "C" int core_f32_tc_scatter_add(const void* band_maps,
                                       const int* band_info, int n_bands,
                                       int cell, const void* xct, int n_parts,
                                       long long k_pad, int h_pad,
                                       const void* tiles, int n_tiles,
                                       const void* nodes, void* out, int h,
                                       void* stream) {
  const tc::KernelFn k = tc::kernel_of(cell, n_parts);
  if (n_bands < 1 || n_bands > MAX_BANDS || k == nullptr || h < 1 ||
      h_pad % tc::BN || h_pad < h)
    return ERR_ARGS;
  if (n_tiles < 1) return 0;
  tc::Params p;
  memset(&p, 0, sizeof p);
  memcpy(p.band, band_maps, n_bands * sizeof(CUtensorMap));
  for (int i = 0; i < n_bands; ++i) {
    p.lo[i] = band_info[3 * i];
    p.r[i] = band_info[3 * i + 1];
    p.w[i] = band_info[3 * i + 2];
  }
  p.h_pad = h_pad;
  int err = encode_2d(&p.xct, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xct, k_pad,
                      static_cast<long long>(n_parts) * h_pad, 4 * k_pad,
                      tc::BK, tc::BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  k<<<n_tiles, tc::THREADS, tc::smem_of(cell, n_parts),
      static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(tiles), static_cast<const int*>(nodes),
      static_cast<float*>(out), h);
  return static_cast<int>(cudaGetLastError());
}
