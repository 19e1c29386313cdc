// K-quant: the quantize prologue of the quantized aggregate, three entry
// points.
//
// Replaces the XLA prologue of pygim_tpu/ops/spmm.py:raw_mul_quantized
// and of pygim_tpu/quant/__init__.py:symmetric_quantize (:25-43):
//   (a) quant_abs_max (:1576-1578): max|x| over the whole of x, then
//       scale = max|x| * 2 / 2^k and safe = (scale == 0 ? 1 : scale),
//       each a 0-dim f32 written on the card;
//   (b) quant_table (:1587): round(x / safe) cast to int8, int16, int32
//       or int64, the integer table every tier of an int8 or int16
//       aggregate reads, and the unfused round trip's payload;
//   (c) quant_core_payload (:1618-1624 and ops/core_int.py:limb_split):
//       the rank gather x[rows], rounded to round(x / safe) where x is f32
//       (an integer x is taken as it is), written straight into K-int's
//       K-major payload of balanced int8 limbs, (limbs, h_pad, k_pad).
//
// Numerics, each equal bit for bit to the PyTorch ops of the plain
// versions (ops/quant_prologue.py):
// - max|x| is an unsigned max over the bits of |x| (the sign bit
//   cleared): for non-negative floats the bit order is the value order,
//   and every NaN's bits lie above +inf's, so a NaN anywhere gives NaN,
//   as torch.linalg.vector_norm(x, inf) does. scale multiplies by 2 and
//   then by 2^-k, exactly as PyTorch divides by the Python scalar 2^k (by
//   its reciprocal, which is exact).
// - round(x / safe) is payload.cuh's rounding, shared with K-tail-quant:
//   the correctly rounded quotient (QuantRcp's reciprocal route where
//   2^-100 <= safe <= 2^100, a true division elsewhere), rounded half to
//   even, then converted to the integer type by the same C++ cast as
//   PyTorch's copy kernel. The build has no --use_fast_math.
// - The limbs: u = q + 128 * sum_l 256^l (mod 2^32); limb l is byte l of
//   u with its top bit flipped, read as int8 (ops/core_int.py:limb_split).
//   Rows past the gathered ones, columns past h and the pads up to h_pad
//   and k_pad are zero.
//
// What bounds it on an H100: bytes. (a) reads x once; (b) reads x and
// writes the table; (c) reads the gathered rows and writes limbs bytes an
// element. A few operations an element, far below the card's operations
// per byte.
//
// What the design does about it:
// - (a) and (b) walk x as one flat array in 16-byte accesses (4 elements
//   a thread and step) where the pointers allow; (a) reduces in
//   registers, then a warp (__reduce_max_sync), then a block, and writes
//   one partial a block; a one-block launch reduces the partials and
//   writes max|x|, scale and safe (no atomics, nothing to zero first);
// - (c) is a tiled transpose: a block gathers a 64-row by 64-column tile
//   of x (4 consecutive columns a thread, one access where the row allows),
//   rounds it and keeps the 32-bit u of each element in shared memory, then
//   writes each limb's 64 columns of 64 bytes (4 bytes a thread,
//   contiguous across the warp) of the K-major payload.

#include <cuda_runtime.h>
#include <stdint.h>

#include "payload.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;
constexpr int TILE = 64;  // (c): payload rows (j) and columns (n) a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// (a) pass 1: one partial max of |x|'s bits a block.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    abs_max_kernel(const float* __restrict__ x, long long numel,
                   unsigned* __restrict__ partial) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  unsigned m = 0;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = t; i < numel / 4; i += stride) {
      const float4 v = __ldcs(x4 + i);
      m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)),
                     max(abs_bits(v.z), abs_bits(v.w))));
    }
    for (long long i = numel / 4 * 4 + t; i < numel; i += stride)
      m = max(m, abs_bits(__ldcs(x + i)));
  } else {
    for (long long i = t; i < numel; i += stride) m = max(m, abs_bits(__ldcs(x + i)));
  }
  __shared__ unsigned warp_max[THREADS / 32];
  m = __reduce_max_sync(FULL, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(FULL, m);
    if (threadIdx.x == 0) partial[blockIdx.x] = m;
  }
}

// (a) pass 2: out = (max|x|, scale, safe).
__global__ void __launch_bounds__(THREADS)
    abs_max_finish(const unsigned* __restrict__ partial, int n,
                   float inv_2k, float* __restrict__ out) {
  unsigned m = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) m = max(m, partial[i]);
  __shared__ unsigned warp_max[THREADS / 32];
  m = __reduce_max_sync(FULL, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(FULL, m);
    if (threadIdx.x == 0) {
      const float abs_max = __uint_as_float(m);
      const float scale = __fmul_rn(__fmul_rn(abs_max, 2.0f), inv_2k);
      out[0] = abs_max;
      out[1] = scale;
      out[2] = scale == 0.0f ? 1.0f : scale;
    }
  }
}

__device__ __forceinline__ float quant_round(float v, float2 d, bool rcp) {
  return rcp ? QuantRcp::get(v, d) : QuantDiv::get(v, d);
}

template <typename T>
struct Vec4;
template <>
struct Vec4<float> { using V = float4; };
template <>
struct Vec4<int32_t> { using V = int4; };
template <>
struct Vec4<int16_t> { using V = short4; };
template <>
struct Vec4<int8_t> { using V = char4; };
template <>
struct Vec4<int64_t> { using V = longlong4; };

// (b): out[i] = T(round(x[i] / safe)).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    table_kernel(const float* __restrict__ x, long long numel,
                 const float* __restrict__ safe_p, T* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const float2 d = divisor(safe_p);
  const bool rcp = rcp_route(d);
  long long i0 = 0;
  if constexpr (VEC) {
    using V = typename Vec4<T>::V;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    V* o4 = reinterpret_cast<V*>(out);
    for (long long i = t; i < numel / 4; i += stride) {
      const float4 v = __ldcs(x4 + i);
      V q;
      q.x = static_cast<T>(quant_round(v.x, d, rcp));
      q.y = static_cast<T>(quant_round(v.y, d, rcp));
      q.z = static_cast<T>(quant_round(v.z, d, rcp));
      q.w = static_cast<T>(quant_round(v.w, d, rcp));
      o4[i] = q;
    }
    i0 = numel / 4 * 4;
  }
  for (long long i = i0 + t; i < numel; i += stride)
    out[i] = static_cast<T>(quant_round(__ldcs(x + i), d, rcp));
}

// (c): one TILE x TILE tile of the payload a block: payload rows
// j0 .. j0 + 63 (gathered x rows) by columns n0 .. n0 + 63.
template <typename T, bool ROUND, bool VEC>
__global__ void __launch_bounds__(THREADS)
    payload_kernel(const T* __restrict__ x, const int32_t* __restrict__ rows,
                   int n_rows, const float* __restrict__ safe_p, int limbs,
                   unsigned bias, int h, int h_pad, int k_pad,
                   int8_t* __restrict__ out) {
  __shared__ unsigned su[TILE][TILE + 1];  // [column][row]: u of each element
  const int j0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int tr = threadIdx.x >> 4, tc = (threadIdx.x & 15) * 4;
  float2 d = make_float2(1.0f, 1.0f);
  bool rcp = false;
  if (ROUND) {
    d = divisor(safe_p);
    rcp = rcp_route(d);
  }
#pragma unroll
  for (int p = 0; p < TILE / 16; ++p) {
    const int jl = tr + 16 * p, j = j0 + jl;
    const int n = n0 + tc;
    unsigned u[4] = {bias, bias, bias, bias};
    if (j < n_rows && n < h) {
      const T* src = x + static_cast<long long>(__ldg(rows + j)) * h + n;
      T v[4];
      if (VEC) {  // h % 4 == 0, so all four columns are in the row
        const typename Vec4<T>::V w = *reinterpret_cast<const typename Vec4<T>::V*>(src);
        v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = n + e < h ? src[e] : T(0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n + e >= h) continue;
        int32_t q;
        if constexpr (ROUND)
          q = static_cast<int32_t>(quant_round(static_cast<float>(v[e]), d, rcp));
        else
          q = static_cast<int32_t>(v[e]);
        u[e] = static_cast<unsigned>(q) + bias;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) su[tc + e][jl] = u[e];
  }
  __syncthreads();
  // writes: 16 threads a column (4 payload rows each), 16 columns a pass
  const int jw = (threadIdx.x & 15) * 4, cr = threadIdx.x >> 4;
  if (j0 + jw >= k_pad) return;
  for (int l = 0; l < limbs; ++l) {
#pragma unroll
    for (int p = 0; p < TILE / 16; ++p) {
      const int nl = cr + 16 * p;
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        word |= (((su[nl][jw + e] >> (8 * l)) & 0xffu) ^ 0x80u) << (8 * e);
      const long long off =
          (static_cast<long long>(l) * h_pad + n0 + nl) * k_pad + j0 + jw;
      *reinterpret_cast<unsigned*>(out + off) = word;
    }
  }
}

int blocks_for(long long items) {
  long long b = (items + THREADS - 1) / THREADS;
  if (b > MAX_BLOCKS) b = MAX_BLOCKS;
  return b < 1 ? 1 : static_cast<int>(b);
}

template <typename T>
int launch_table(const float* x, long long numel, int vec, const float* safe,
                 void* out, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  if (vec)
    table_kernel<T, true><<<blocks_for(numel / 4), THREADS, 0, s>>>(x, numel, safe, o);
  else
    table_kernel<T, false><<<blocks_for(numel), THREADS, 0, s>>>(x, numel, safe, o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ROUND>
int launch_payload(const void* x, const int32_t* rows, int n_rows,
                   const float* safe, int limbs, int h, int h_pad, int k_pad,
                   int vec, int8_t* out, cudaStream_t s) {
  unsigned bias = 0;
  for (int l = 0; l < limbs; ++l) bias += 128u << (8 * l);
  const dim3 grid((k_pad + TILE - 1) / TILE, h_pad / TILE);
  const T* x_ = static_cast<const T*>(x);
  if (vec)
    payload_kernel<T, ROUND, true><<<grid, THREADS, 0, s>>>(
        x_, rows, n_rows, safe, limbs, bias, h, h_pad, k_pad, out);
  else
    payload_kernel<T, ROUND, false><<<grid, THREADS, 0, s>>>(
        x_, rows, n_rows, safe, limbs, bias, h, h_pad, k_pad, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (a): x f32 (numel,); partial unsigned scratch of at least MAX_BLOCKS
// entries; out f32 (3,) = (max|x|, scale, safe); inv_2k = 2^-k. vec: x
// 16-byte aligned.
extern "C" int quant_abs_max(const void* x, long long numel, int vec,
                             void* partial, float inv_2k, void* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x_ = static_cast<const float*>(x);
  unsigned* part = static_cast<unsigned*>(partial);
  const int blocks = blocks_for(vec ? numel / 4 : numel);
  if (vec)
    abs_max_kernel<true><<<blocks, THREADS, 0, s>>>(x_, numel, part);
  else
    abs_max_kernel<false><<<blocks, THREADS, 0, s>>>(x_, numel, part);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  abs_max_finish<<<1, THREADS, 0, s>>>(part, blocks, inv_2k,
                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// (b): x f32 (numel,), safe 0-dim f32, out of type code (1 int8, 2 int16,
// 3 int32, 6 int64). vec: x 16-byte aligned and out aligned to 4
// elements.
extern "C" int quant_table(const void* x, long long numel, int vec,
                           const void* safe, void* out, int out_type,
                           void* stream) {
  if (numel <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x_ = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(safe);
  switch (out_type) {
    case 1: return launch_table<int8_t>(x_, numel, vec, sp, out, s);
    case 2: return launch_table<int16_t>(x_, numel, vec, sp, out, s);
    case 3: return launch_table<int32_t>(x_, numel, vec, sp, out, s);
    case 6: return launch_table<int64_t>(x_, numel, vec, sp, out, s);
    default: return 901;
  }
}

// (c): x (N, h) row-major of type code (0 f32, rounded by safe; 1 int8,
// 2 int16, 3 int32, taken as they are), rows int32 (n_rows,), out int8
// (limbs, h_pad, k_pad) with h_pad % 64 == 0, k_pad % 16 == 0, n_rows <=
// k_pad. vec: h % 4 == 0 and x aligned to 4 elements.
extern "C" int quant_core_payload(const void* x, int x_type, const void* rows,
                                  int n_rows, const void* safe, int limbs,
                                  int h, int h_pad, int k_pad, int vec,
                                  void* out, void* stream) {
  if (limbs < 1 || limbs > 4 || h_pad % TILE || k_pad % 16 || n_rows > k_pad
      || h > h_pad || (vec && h % 4))
    return 901;
  if (h_pad == 0 || k_pad == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* sp = static_cast<const float*>(safe);
  int8_t* o = static_cast<int8_t*>(out);
  switch (x_type) {
    case 0:
      return sp ? launch_payload<float, true>(x, r, n_rows, sp, limbs, h,
                                              h_pad, k_pad, vec, o, s)
                : 901;
    case 1:
      return launch_payload<int8_t, false>(x, r, n_rows, sp, limbs, h, h_pad,
                                           k_pad, vec, o, s);
    case 2:
      return launch_payload<int16_t, false>(x, r, n_rows, sp, limbs, h, h_pad,
                                            k_pad, vec, o, s);
    case 3:
      return launch_payload<int32_t, false>(x, r, n_rows, sp, limbs, h, h_pad,
                                            k_pad, vec, o, s);
    default:
      return 901;
  }
}
