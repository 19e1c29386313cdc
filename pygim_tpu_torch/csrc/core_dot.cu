// K-core: int8 staircase band x bf16 payload, f32 accumulate, scatter-add.
//
// Replaces the TPU kernel pygim_tpu/ops/pallas_core.py:_dequant_core_dot
// (bf16(int8 core) @ bf16(x), f32 accumulation) together with the XLA
// scatter of its product, out.at[core_nodes[lo:hi]].add(...) in
// pygim_tpu/ops/spmm.py:_core_scatter. It computes, for one band of r
// rows and width w:
//
//     out[rows[i], :] += sum_j f32(band[i, j]) * f32(xc[j, :])
//
// with band int8 (r, w) row-major, xc bf16 (>= w, h) row-major, rows
// int32 (r,) distinct, out f32 (N, h) row-major. The Pallas kernel was
// square (k % 256 == 0); here the band is rectangular (w may exceed r),
// rows need not be a multiple of the tile, widths need not be either.
//
// What bounds it on an H100 SXM: 2*r*w*h operations against r*w bytes of
// int8 band (the other operands are small), i.e. 2*h = 512 operations
// per band byte at h = 256. The card balances bf16 tensor work and HBM
// traffic at about 295 operations per byte, so at h = 256 the bound is
// the bf16 tensor-core rate, not HBM.
//
// What the design does about it:
// - the products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   f32 accumulate); each int8 x bf16 product is exact, so only the
//   order of the f32 sums differs from the plain version;
// - the int8 band is read from HBM once, as int8, and widened to bf16
//   on its way into shared memory: no bf16 copy of the band exists;
// - a 128 x 128 output tile per block reuses each band tile over 128
//   columns and each xc tile over 128 band rows;
// - the contraction over w is a loop inside the block (the Pallas grid's
//   sequential axis), with the next tile's global loads issued before
//   the current tile's products;
// - the scatter is the epilogue: each block adds its tile into the
//   output rows once. Rows within a band are distinct and bands run in
//   stream order, so no atomics are needed.
// This is a simple first kernel: no wgmma, no TMA, no multi-stage ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // band rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 32;         // contraction tile
constexpr int LDS = BK + 8;    // padded shared row (bf16): conflict-free fragment loads
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct TileRegs {
  uint32_t a[4];     // 16 band bytes of one row, little-endian
  uint32_t b0[4];    // 8 bf16 of xc row k
  uint32_t b1[4];    // 8 bf16 of xc row k + 1
};

__device__ __forceinline__ void load_tile(
    TileRegs& t, const int8_t* __restrict__ band,
    const __nv_bfloat16* __restrict__ xc, int r, int w, int h, int vec_a,
    int m0, int n0, int k0, int tid) {
  // A: 128 rows x 32 bytes, 16 bytes per thread
  const int a_row = m0 + (tid >> 1);
  const int a_k = k0 + (tid & 1) * 16;
  const int8_t* ap = band + (int64_t)a_row * w + a_k;
  if (a_row < r && vec_a && a_k + 16 <= w) {
    const int4 q = *reinterpret_cast<const int4*>(ap);
    t.a[0] = (uint32_t)q.x; t.a[1] = (uint32_t)q.y;
    t.a[2] = (uint32_t)q.z; t.a[3] = (uint32_t)q.w;
  } else {
    // ragged edge: bytes past the band's rows or width read as zero
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = 4 * q + b;
        const uint32_t v =
            (a_row < r && a_k + i < w) ? (uint32_t)(uint8_t)ap[i] : 0u;
        word |= v << (8 * b);
      }
      t.a[q] = word;
    }
  }
  // B: 32 rows (k) x 128 columns; each thread takes rows k, k+1 of one
  // 8-column chunk so it can pack (k, k+1) pairs for the transposed store
  const int kp = tid & 15;
  const int nc = (tid >> 4) * 8;
  const int gk = k0 + 2 * kp;
  const int gn = n0 + nc;
  uint4 z = make_uint4(0, 0, 0, 0);
  uint4 q0 = z, q1 = z;
  if (gn < h) {
    if (gk < w)
      q0 = *reinterpret_cast<const uint4*>(xc + (int64_t)gk * h + gn);
    if (gk + 1 < w)
      q1 = *reinterpret_cast<const uint4*>(xc + (int64_t)(gk + 1) * h + gn);
  }
  t.b0[0] = q0.x; t.b0[1] = q0.y; t.b0[2] = q0.z; t.b0[3] = q0.w;
  t.b1[0] = q1.x; t.b1[1] = q1.y; t.b1[2] = q1.z; t.b1[3] = q1.w;
}

__device__ __forceinline__ void store_tile(
    const TileRegs& t, __nv_bfloat16 (*As)[LDS], uint32_t (*Bs)[LDS / 2],
    int tid) {
  // A: widen 16 int8 to bf16 (exact for |v| <= 128) and store 32 bytes;
  // word i holds columns (2i, 2i+1), the lower column in the lower half
  uint32_t wv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int8_t lo = (int8_t)(t.a[i >> 1] >> (16 * (i & 1)));
    const int8_t hi = (int8_t)(t.a[i >> 1] >> (16 * (i & 1) + 8));
    wv[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)lo)) |
            ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)hi))
             << 16);
  }
  uint4* dst = reinterpret_cast<uint4*>(&As[tid >> 1][(tid & 1) * 16]);
  dst[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
  dst[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
  // B: transposed, Bs[n][k/2] holds the bf16 pair (k, k+1) of column n,
  // lower half = row k (the mma operand layout)
  const int kp = tid & 15;
  const int nc = (tid >> 4) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = t.b0[i], hi = t.b1[i];
    Bs[nc + 2 * i][kp] = (lo & 0xFFFFu) | (hi << 16);
    Bs[nc + 2 * i + 1][kp] = (lo >> 16) | (hi & 0xFFFF0000u);
  }
}

__global__ void __launch_bounds__(THREADS)
core_band_kernel(const int8_t* __restrict__ band,
                 const __nv_bfloat16* __restrict__ xc,
                 const int32_t* __restrict__ rows, float* __restrict__ out,
                 int r, int w, int h, int vec_a) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(16) uint32_t Bs[BN][LDS / 2];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2;  // 64-row slab of the tile
  const int wn = warp & 3;   // 32-column slab of the tile
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  TileRegs regs;
  load_tile(regs, band, xc, r, w, h, vec_a, m0, n0, 0, tid);
  for (int k0 = 0; k0 < w; k0 += BK) {
    store_tile(regs, As, Bs, tid);
    __syncthreads();
    if (k0 + BK < w)
      load_tile(regs, band, xc, r, w, h, vec_a, m0, n0, k0 + BK, tid);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int rr = wm * 64 + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[rr][ks + 2 * t4]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][ks + 2 * t4]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[rr][ks + 2 * t4 + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[rr + 8][ks + 2 * t4 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int nn = wn * 32 + ni * 8 + g;
        bfr[ni][0] = Bs[nn][ks / 2 + t4];
        bfr[ni][1] = Bs[nn][ks / 2 + t4 + 4];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  // epilogue: scatter-add the tile into its output rows
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (lr >= r) continue;
      float* orow = out + (int64_t)rows[lr] * h;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
        if (col < h) {  // h % 8 == 0, so col + 1 < h as well
          float2* p = reinterpret_cast<float2*>(orow + col);
          float2 o = *p;
          o.x += acc[mi][ni][2 * half];
          o.y += acc[mi][ni][2 * half + 1];
          *p = o;
        }
      }
    }
  }
}

}  // namespace

extern "C" int core_band_scatter_add(const void* band, const void* xc,
                                     const void* rows, void* out, int r,
                                     int w, int h, int vec_a, void* stream) {
  dim3 grid((h + BN - 1) / BN, (r + BM - 1) / BM);
  core_band_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(band),
      static_cast<const __nv_bfloat16*>(xc),
      static_cast<const int32_t*>(rows), static_cast<float*>(out), r, w, h,
      vec_a);
  return static_cast<int>(cudaGetLastError());
}
