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
// - (c) is a tiled transpose: a block takes a 64-row by 64-column tile of
//   the payload. It loads the tile's 64 row indices into shared memory
//   once, before any x load; each thread then issues all of its 16-byte
//   loads (16 / sizeof(T) consecutive columns of a row each: 4 for f32
//   and int32, 8 for int16, 16 for int8; where a chunk could cross its
//   row's end or x is not 16-byte aligned, 4-byte elements one by one and
//   int8 or int16 ones as the one or two aligned 16-byte granules that
//   hold the chunk's bytes, shifted into place in registers) before it
//   rounds any, and keeps the 32-bit u of each element in a [column][row]
//   shared tile whose odd row stride, with the lanes laid out as C chunks
//   by 32 / C rows, puts a warp's 32 words in 32 banks; then each thread
//   writes 16 contiguous K-major bytes of one (limb, column) a limb, two
//   threads a 32-byte sector.
// A granule read past a row's bytes or x's first or last byte stays inside
// that 16-byte granule, which lies in x's allocation (the caching allocator
// hands out blocks of 512 bytes); the bytes outside the row are never used.
// PERF.md has this design's times and those of the designs tried and not
// kept (blocks of 128 rows, their slices staged or transposed in
// registers).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "payload.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;
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

// (c): one TILE x TILE tile of the payload a block: payload rows j0 ..
// j0 + 63 (gathered x rows) by columns n0 .. n0 + 63. A thread's load is
// a 16-byte chunk of EPT = 16 / sizeof(T) consecutive columns of a row.
// Load and rounding: in pass p, warp g = warp + 8p of the block takes
// chunks C·(g & 1) .. + C - 1 (C = 32 / EPT) of rows EPT·(g >> 1) .. + EPT
// - 1, lane i chunk i % C of row i / C. Stores: thread t writes rows
// 32·(t >> 7) + 16·(t & 1) .. + 15 of column (t >> 1) & 63.
constexpr int TILE = 64;

__device__ __forceinline__ unsigned word_of(const uint4& c, int i) {
  return i == 0 ? c.x : i == 1 ? c.y : i == 2 ? c.z : c.w;
}

// element e (a compile-time index) of a 16-byte chunk of T
template <typename T>
__device__ __forceinline__ T element(const uint4& c, int e) {
  constexpr int SZ = static_cast<int>(sizeof(T));
  const unsigned w = word_of(c, e * SZ / 4);
  if constexpr (std::is_same_v<T, float>)
    return __uint_as_float(w);
  else
    return static_cast<T>(w >> (8 * ((e * SZ) & 3)));
}

// bytes s .. s + 15 of the 32 bytes a, b (s < 16, known only at run time)
__device__ __forceinline__ uint4 bytes_from(const uint4& a, const uint4& b,
                                            int s) {
  unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  if (s & 4) {  // move by whole words, in registers
#pragma unroll
    for (int i = 0; i < 7; ++i) w[i] = w[i + 1];
  }
  if (s & 8) {
#pragma unroll
    for (int i = 0; i < 6; ++i) w[i] = w[i + 2];
  }
  const unsigned r = 8 * (s & 3);
  return make_uint4(__funnelshift_r(w[0], w[1], r), __funnelshift_r(w[1], w[2], r),
                    __funnelshift_r(w[2], w[3], r), __funnelshift_r(w[3], w[4], r));
}

template <typename T, bool ROUND, bool VEC>
__global__ void __launch_bounds__(THREADS)
    payload_kernel(const T* __restrict__ x, const int32_t* __restrict__ rows,
                   int n_rows, const float* __restrict__ safe_p, int limbs,
                   unsigned bias, int h, int h_pad, int k_pad,
                   int8_t* __restrict__ out) {
  constexpr int EPT = 16 / static_cast<int>(sizeof(T));  // elements a load
  constexpr int C = 32 / EPT;         // a warp's chunks of one row
  constexpr int PASSES = 16 / EPT;    // loads a thread
  // [column][row]: u of each element; the odd row stride puts a warp's
  // 32 words in 32 banks in both phases
  __shared__ unsigned su[TILE][TILE + 1];
  __shared__ int srow[TILE];
  const int j0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float2 d = make_float2(1.0f, 1.0f);
  bool rcp = false;
  if (ROUND) {
    d = divisor(safe_p);
    rcp = rcp_route(d);
  }
  if (t < TILE) srow[t] = j0 + t < n_rows ? __ldg(rows + j0 + t) : -1;
  __syncthreads();
  // every pass's chunk loaded before any is used: one 16-byte load
  // (VEC: h % EPT == 0 and x 16-byte aligned, so the chunk is whole and
  // aligned); else 4-byte elements one by one, and narrower ones as the
  // one or two aligned 16-byte granules holding the chunk's bytes in the
  // row, shifted into place in registers (PERF.md: each the faster there)
  uint4 g[PASSES], hi[PASSES];
  int shift[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int grp = warp + 8 * p;
    const int jl = EPT * (grp >> 1) + lane / C;
    const int n = n0 + EPT * (C * (grp & 1) + lane % C);
    const int r = srow[jl];
    g[p] = hi[p] = make_uint4(0u, 0u, 0u, 0u);
    shift[p] = 0;
    if (r < 0 || n >= h) continue;
    const uintptr_t a = reinterpret_cast<uintptr_t>(
        x + static_cast<long long>(r) * h + n);
    if (VEC) {
      g[p] = __ldg(reinterpret_cast<const uint4*>(a));
    } else if constexpr (sizeof(T) == 4) {  // 4 loads of 4 bytes
      const T* src = reinterpret_cast<const T*>(a);
      unsigned w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = n + e < h ? __ldg(reinterpret_cast<const unsigned*>(src + e))
                         : 0u;
      g[p] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
      const uintptr_t end = a + min(EPT, h - n) * static_cast<int>(sizeof(T));
      shift[p] = static_cast<int>(a - a0);
      g[p] = __ldg(reinterpret_cast<const uint4*>(a0));
      if (shift[p] && a0 + 16 < end)
        hi[p] = __ldg(reinterpret_cast<const uint4*>(a0 + 16));
    }
  }
  if (!VEC && sizeof(T) < 4) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) g[p] = bytes_from(g[p], hi[p], shift[p]);
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int grp = warp + 8 * p;
    const int jl = EPT * (grp >> 1) + lane / C;
    const int nl = EPT * (C * (grp & 1) + lane % C);
    const bool row_live = srow[jl] >= 0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      unsigned u = bias;
      if (row_live && n0 + nl + e < h) {
        const T v = element<T>(g[p], e);
        int32_t q;
        if constexpr (ROUND)
          q = static_cast<int32_t>(quant_round(v, d, rcp));
        else
          q = static_cast<int32_t>(v);
        u = static_cast<unsigned>(q) + bias;
      }
      su[nl + e][jl] = u;
    }
  }
  __syncthreads();
  // 16 rows of one column a thread, a 16-byte store a limb
  const int nl = (t >> 1) & (TILE - 1), jw = 32 * (t >> 7) + 16 * (t & 1);
  if (j0 + jw >= k_pad) return;  // k_pad % 16 == 0
  unsigned u[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) u[k] = su[nl][jw + k];
  for (int l = 0; l < limbs; ++l) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[q] |= (((u[4 * q + e] >> (8 * l)) & 0xffu) ^ 0x80u) << (8 * e);
    }
    const long long off =
        (static_cast<long long>(l) * h_pad + n0 + nl) * k_pad + j0 + jw;
    *reinterpret_cast<uint4*>(out + off) = make_uint4(w[0], w[1], w[2], w[3]);
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
                   int8_t* out, cudaStream_t s) {
  unsigned bias = 0;
  for (int l = 0; l < limbs; ++l) bias += 128u << (8 * l);
  const dim3 grid((k_pad + TILE - 1) / TILE, h_pad / TILE);
  const T* x_ = static_cast<const T*>(x);
  // 16-byte loads where every chunk lies whole in its row, aligned
  if (h % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
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
// 2 int16, 3 int32, taken as they are), any h and alignment; rows int32
// (n_rows,); out int8 (limbs, h_pad, k_pad), 16-byte aligned, with h_pad
// % 64 == 0, k_pad % 16 == 0, n_rows <= k_pad.
extern "C" int quant_core_payload(const void* x, int x_type, const void* rows,
                                  int n_rows, const void* safe, int limbs,
                                  int h, int h_pad, int k_pad, void* out,
                                  void* stream) {
  if (limbs < 1 || limbs > 4 || h_pad % 64 || k_pad % 16 || n_rows > k_pad
      || h > h_pad || reinterpret_cast<uintptr_t>(out) % 16)
    return 901;
  if (h_pad == 0 || k_pad == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const float* sp = static_cast<const float*>(safe);
  int8_t* o = static_cast<int8_t*>(out);
  switch (x_type) {
    case 0:
      return sp ? launch_payload<float, true>(x, r, n_rows, sp, limbs, h,
                                              h_pad, k_pad, o, s)
                : 901;
    case 1:
      return launch_payload<int8_t, false>(x, r, n_rows, sp, limbs, h, h_pad,
                                           k_pad, o, s);
    case 2:
      return launch_payload<int16_t, false>(x, r, n_rows, sp, limbs, h, h_pad,
                                            k_pad, o, s);
    case 3:
      return launch_payload<int32_t, false>(x, r, n_rows, sp, limbs, h, h_pad,
                                            k_pad, o, s);
    default:
      return 901;
  }
}
