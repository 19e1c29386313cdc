// K-f32: hub-core bands (f32 cells, or bf16 cells widened exactly) x a
// payload converted to f32 as it is loaded, f32 FFMA accumulation,
// scatter-add, all bands of one SpMM in one launch.
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
// with band_b (hi - lo, w) row-major of f32 or bf16 cells (template C), xc
// (>= w, h) row-major of f32, bf16, int8, int16 or int32 (template X; a
// conversion to f32 that is exact for bf16 and for integers up to 2^24, and
// rounds to nearest beyond, as XLA's convert), nodes int32 distinct over
// all bands (no atomics: every output element belongs to one tile) and out
// f32 (N, h) row-major. Any w, any h >= 1, no alignment: every load is a
// bounds-checked scalar.
//
// No TF32 anywhere: every product and sum is an f32 FFMA, so the result
// differs from the reference's f32 dot only in the order of the f32 sums
// (the partial sums of an integer payload round once they pass 2^24, in
// both).
//
// What bounds it on an H100 SXM: operations. 2*r*w*h f32 operations
// against r*w*4 bytes of f32 band (2 for bf16), i.e. h / 2 = 128
// operations a byte at h = 256, above the card's 67 TFLOP/s / 3.35 TB/s =
// 20 f32 operations a byte outside the tensor cores.
//
// What the design does about it (a plain tiled SIMT product, right before
// fast):
// - a block of 256 threads computes a 128 x 128 output tile of one band
//   over its whole contraction, 16 deep at a time; each thread holds an
//   8 x 8 register block (rows ty*4.. and 64 + ty*4.., columns tx*4.. and
//   64 + tx*4..), so a k step is 4 float4 shared loads for 64 FFMAs;
// - the next k tile is read from global memory into registers while the
//   current one is multiplied (register double buffering), and converted
//   to f32 on the way into shared memory; A is stored transposed, (k, m),
//   with a row pad of 4 floats against bank conflicts;
// - one launch covers up to MAX_BANDS bands: the host lists every tile
//   (band, m0, n0), the widest bands' first.
// Its yardstick is torch.matmul in f32 (TF32 off) with index_add_; a
// 3xTF32 split on wgmma, or bf16 limbs through K-core, is the redesign.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MAX_BANDS = 16;
constexpr int BM = 128;      // band rows per tile
constexpr int BN = 128;      // output columns per tile
constexpr int BK = 16;       // contraction per shared-memory tile
constexpr int THREADS = 256;
constexpr int A_LD = BM + 4;  // padded row of the transposed A tile
constexpr int ERR_ARGS = 901;

struct Params {
  const void* band[MAX_BANDS];
  int lo[MAX_BANDS], r[MAX_BANDS], w[MAX_BANDS];
};

// one element of a band or payload as f32; bf16 is held as its 16 bits
struct Bf16Bits {
  uint16_t v;
};
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(Bf16Bits v) {
  return __uint_as_float(static_cast<uint32_t>(v.v) << 16);  // exact
}
__device__ __forceinline__ float to_f32(int8_t v) { return v; }
__device__ __forceinline__ float to_f32(int16_t v) { return v; }
__device__ __forceinline__ float to_f32(int32_t v) { return __int2float_rn(v); }

// This thread's loads of the k tile at k0, converted to f32: A rows
// (tid >> 4) + 16 i at k = k0 + (tid & 15) (two rows of 16 consecutive
// cells a warp); B rows k0 + (tid >> 7) + 2 i at column n0 + (tid & 127)
// (32 consecutive columns a warp); zeros outside the band and x.
template <typename C, typename X>
__device__ __forceinline__ void load_tile(float (&ra)[8], float (&rb)[8],
                                          const C* __restrict__ A,
                                          const X* __restrict__ xc, int r,
                                          int w, int h, int m0, int n0,
                                          int k0, int tid) {
  const int ka = k0 + (tid & 15);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (tid >> 4) + 16 * i;
    ra[i] = row < r && ka < w
                ? to_f32(A[static_cast<int64_t>(row) * w + ka])
                : 0.f;
  }
  const int col = n0 + (tid & 127);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kb = k0 + (tid >> 7) + 2 * i;
    rb[i] = kb < w && col < h
                ? to_f32(xc[static_cast<int64_t>(kb) * h + col])
                : 0.f;
  }
}

template <typename C, typename X>
__global__ void __launch_bounds__(THREADS, 2)
core_f32_kernel(const __grid_constant__ Params p, const int* __restrict__ tiles,
                const X* __restrict__ xc, const int* __restrict__ nodes,
                float* __restrict__ out, int h) {
  __shared__ __align__(16) float As[BK][A_LD];  // (k, m)
  __shared__ __align__(16) float Bs[BK][BN];    // (k, n)
  const int* e = tiles + 3 * blockIdx.x;
  const int b = e[0], m0 = e[1], n0 = e[2];
  const C* __restrict__ A = static_cast<const C*>(p.band[b]);
  const int r = p.r[b], w = p.w[b], lo = p.lo[b];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  float ra[8], rb[8];  // the next k tile, in flight

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_tile(ra, rb, A, xc, r, w, h, m0, n0, 0, tid);
  for (int k0 = 0; k0 < w; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      As[tid & 15][(tid >> 4) + 16 * i] = ra[i];
      Bs[(tid >> 7) + 2 * i][tid & 127] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < w)  // in flight while this tile multiplies
      load_tile(ra, rb, A, xc, r, w, h, m0, n0, k0 + BK, tid);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // out[nodes[lo + row], col] += acc: each row of the tile is one block's
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= r) continue;
    float* o = out + static_cast<int64_t>(nodes[lo + row]) * h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col < h) o[col] += acc[i][j];
    }
  }
}

template <typename C, typename X>
int launch(const Params& p, const void* tiles, int n_tiles, const void* xc,
           const void* nodes, void* out, int h, cudaStream_t s) {
  core_f32_kernel<C, X><<<n_tiles, THREADS, 0, s>>>(
      p, static_cast<const int*>(tiles), static_cast<const X*>(xc),
      static_cast<const int*>(nodes), static_cast<float*>(out), h);
  return static_cast<int>(cudaGetLastError());
}

template <typename C>
int launch_payload(const Params& p, int payload, const void* tiles,
                   int n_tiles, const void* xc, const void* nodes, void* out,
                   int h, cudaStream_t s) {
  switch (payload) {
    case 0:
      return launch<C, float>(p, tiles, n_tiles, xc, nodes, out, h, s);
    case 1:
      return launch<C, Bf16Bits>(p, tiles, n_tiles, xc, nodes, out, h, s);
    case 2:
      return launch<C, int8_t>(p, tiles, n_tiles, xc, nodes, out, h, s);
    case 3:
      return launch<C, int16_t>(p, tiles, n_tiles, xc, nodes, out, h, s);
    case 4:
      return launch<C, int32_t>(p, tiles, n_tiles, xc, nodes, out, h, s);
  }
  return ERR_ARGS;
}

}  // namespace

// One launch over n_bands bands of one cell type (`cell`: 0 f32, 1 bf16):
// `band_ptrs` holds their device addresses and `band_info` their (lo, r,
// w), both in host memory; `tiles` (int32 (n_tiles, 3) on the device) each
// block's (band, m0, n0); xc's element type is `payload` (0 f32, 1 bf16,
// 2 int8, 3 int16, 4 int32). Returns 0 or an error code (cudaError_t, or
// 901: arguments refused).
extern "C" int core_f32_scatter_add(const void* band_ptrs, const int* band_info,
                                    int n_bands, int cell, const void* xc,
                                    int payload, const void* tiles,
                                    int n_tiles, const void* nodes, void* out,
                                    int h, void* stream) {
  if (n_bands < 1 || n_bands > MAX_BANDS || h < 1) return ERR_ARGS;
  if (n_tiles < 1) return 0;
  Params p;
  memset(&p, 0, sizeof p);
  memcpy(p.band, band_ptrs, n_bands * sizeof(void*));
  for (int i = 0; i < n_bands; ++i) {
    p.lo[i] = band_info[3 * i];
    p.r[i] = band_info[3 * i + 1];
    p.w[i] = band_info[3 * i + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cell == 0)
    return launch_payload<float>(p, payload, tiles, n_tiles, xc, nodes, out,
                                 h, s);
  if (cell == 1)
    return launch_payload<Bf16Bits>(p, payload, tiles, n_tiles, xc, nodes,
                                    out, h, s);
  return ERR_ARGS;
}
