// K-bn: the training forward's BatchNorm -> ReLU -> dropout block and its
// backward, in four kernels.
//
// Replaces the XLA fusion, and its autodiff, that the reference's training
// forward makes of pygim_tpu/nn/layers.py:batchnorm_train_apply (:72-86),
// jax.nn.relu and dropout (:89-95) inside pygim_tpu/nn/models.py:gnn_apply
// (:105-121) under the jit of pygim_tpu/nn/train.py:make_train_step
// (:53-59). Over z (n, h) f32 row-major, per column:
//
//     mean = mean(z), var = mean((z - mean)^2)         (biased, as jnp.var)
//     xhat = (z - mean) * inv,  inv = rsqrt(var + eps)  (the wrapper's inv)
//     u    = xhat * gamma + beta,  y = relu(u)
//     out  = keep ? y * s : 0,  s = 1 / (1 - rate)      (inverted dropout)
//
// and the backward, with g_b = (keep and not u <= 0) ? g * s : 0:
//
//     sum_gb = sum(g_b), sum_gbx = sum(g_b * xhat)     (= dbeta, dgamma)
//     dz = (a * g_b - m_b) - xhat * m_x,  a = gamma * inv,
//          m_b = a * (sum_gb / n),  m_x = a * (sum_gbx / n)
//
// The kernels (ops/bn_train.py holds the plain versions, the wrappers and
// the autograd Function):
//
// * bn_stats: the column mean and biased variance by Welford's update in
//   each thread (f32, over the rows of its lane in a chunk of rows), Chan's
//   merge across the block's row lanes and across the chunks (f64, each in
//   a fixed order: the result is the same run to run; no float atomics).
// * bn_fwd: one read of z, one write of out. Every step rounded alone
//   (__fsub_rn, __fmul_rn, __fadd_rn: nothing contracts into an FMA), in
//   the order of the plain version's PyTorch ops, the ReLU keeping NaN as
//   torch.relu does (K-epi's relu_keep_nan), then the mask and the scale:
//   given the same mean, inv and key it equals the plain version on the
//   card bit for bit. PyTorch on CUDA divides a tensor by a Python scalar
//   as a multiply by the reciprocal rounded to f32, so s is that
//   reciprocal, computed once by the wrapper.
// * bn_bwd_stats: sum_gb and sum_gbx per column, the mask and the ReLU's
//   sign recomputed from z and the key (no (n, h) mask is ever stored);
//   f64 sums, merged across lanes and chunks in a fixed order.
// * bn_bwd: dz, one read each of z and g and one write, every step rounded
//   alone in the plain version's order (four roundings an element, each
//   term at dz's scale; a, m_b and m_x come from the wrapper, per column).
//
// The mask. Element e = row * h + col is kept where (word >> 8) < t, with
// word the (e % 4)-th output of Philox4x32-10 (Salmon et al., SC'11; the
// Random123 constants, written out here) at counter (lo32(e / 4),
// hi32(e / 4), 0, 0) and the site's key: two 32-bit words the wrapper
// draws from the caller's generator onto the card, read here by pointer
// (no host synchronisation). t = round((1 - rate) * 2^24) is an integer
// the wrapper computes once, so the kernels and the plain version agree
// on every element.
//
// What bounds it on an H100: bytes. Per element the statistics read 4
// bytes, the forward 8, the backward's sums 8 and dz 12, against some 30
// integer operations of Philox for four elements and a handful of f32
// ones: far below the card's operations per byte.
//
// What the design does about it: each pass reads its inputs once, in
// 16-byte accesses where h % 4 == 0 and every pointer is 16-byte aligned
// (single elements elsewhere, so h 41 and unaligned slices run; Philox then
// runs once an element), with streaming loads and stores. The elementwise
// passes are grid-stride loops whose stride is a whole number of rows'
// worth of column groups, so a thread keeps its column group and its
// parameters in registers for the whole launch (as K-epi). The reductions
// give each block 32 column groups (coalesced reads along a row) and 8 row
// lanes over a chunk of rows, and one small launch merges the chunks'
// partials.

#include <cuda_runtime.h>
#include <stdint.h>

namespace bn_train {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 2048;
constexpr int TX = 32, TY = 8;   // partial sums: column groups x row lanes
constexpr int MX = 32, MY = 16;  // merge: columns x chunk lanes

constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// Philox4x32-10 at counter (lo32(q), hi32(q), 0, 0), key (k0, k1).
__device__ __forceinline__ uint4 philox(unsigned long long q, uint32_t k0,
                                        uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(q), c1 = static_cast<uint32_t>(q >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int i) {
  return i == 0 ? w.x : (i == 1 ? w.y : (i == 2 ? w.z : w.w));
}

__device__ __forceinline__ bool kept(uint32_t word, uint32_t t) {
  return (word >> 8) < t;
}

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v > 0.0f ? v : (v != v ? v : 0.0f);
}

struct Params {
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  const long long* key;  // (2,) words < 2^32, or null: no dropout
  uint32_t thresh;       // keep where (word >> 8) < thresh
  float s;               // f32(1 / f32(1 - rate))
};

struct Col {
  float mean, inv, gamma, beta;
};

__device__ __forceinline__ float xhat_of(float z, const Col& c) {
  return __fmul_rn(__fsub_rn(z, c.mean), c.inv);
}

template <bool DROP>
__device__ __forceinline__ float fwd_one(float z, const Col& c, uint32_t word,
                                         const Params& p) {
  float v = __fadd_rn(__fmul_rn(xhat_of(z, c), c.gamma), c.beta);
  v = relu_keep_nan(v);
  if constexpr (DROP) v = kept(word, p.thresh) ? __fmul_rn(v, p.s) : 0.0f;
  return v;
}

// g after the dropout's and the ReLU's backward: torch's threshold_backward
// passes g unless the ReLU's output is <= 0 (a NaN passes)
template <bool DROP>
__device__ __forceinline__ float grad_b(float g, float xhat, const Col& c,
                                        uint32_t word, const Params& p) {
  const float u = __fadd_rn(__fmul_rn(xhat, c.gamma), c.beta);
  bool drop = u <= 0.0f;
  if constexpr (DROP) drop = drop || !kept(word, p.thresh);
  return drop ? 0.0f : (DROP ? __fmul_rn(g, p.s) : g);
}

__device__ __forceinline__ void key_of(const Params& p, uint32_t& k0,
                                       uint32_t& k1) {
  k0 = p.key ? static_cast<uint32_t>(__ldg(p.key)) : 0u;
  k1 = p.key ? static_cast<uint32_t>(__ldg(p.key + 1)) : 0u;
}

__device__ __forceinline__ Col col_scalar(const Params& p, int j) {
  return Col{__ldg(p.mean + j), __ldg(p.inv + j), __ldg(p.gamma + j),
             __ldg(p.beta + j)};
}

// the four columns of group g
__device__ __forceinline__ void col_vec(const Params& p, int g, Col c[4]) {
  const float4 m = __ldg(reinterpret_cast<const float4*>(p.mean) + g);
  const float4 i = __ldg(reinterpret_cast<const float4*>(p.inv) + g);
  const float4 a = __ldg(reinterpret_cast<const float4*>(p.gamma) + g);
  const float4 b = __ldg(reinterpret_cast<const float4*>(p.beta) + g);
  c[0] = Col{m.x, i.x, a.x, b.x};
  c[1] = Col{m.y, i.y, a.y, b.y};
  c[2] = Col{m.z, i.z, a.z, b.z};
  c[3] = Col{m.w, i.w, a.w, b.w};
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ void set(float4& v, int i, float x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

// ---------------------------------------------------------------- forward

// one column group (4 columns, VEC) or one column a thread; `stride` a
// multiple of `groups`, so column (group) t % groups stays the thread's
template <bool VEC, bool DROP>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const float* __restrict__ z, float* __restrict__ out,
               long long total, long long stride, int groups, Params p) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= stride) return;
  const int g = static_cast<int>(t % groups);
  uint32_t k0, k1;
  key_of(p, k0, k1);
  if constexpr (VEC) {
    Col c[4];
    col_vec(p, g, c);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long i = t; i < total; i += stride) {
      const float4 v = __ldcs(z4 + i);
      const uint4 w = DROP ? philox(static_cast<unsigned long long>(i), k0, k1)
                           : make_uint4(0u, 0u, 0u, 0u);
      float4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        set(o, j, fwd_one<DROP>(get(v, j), c[j], word_of(w, j), p));
      __stcs(o4 + i, o);
    }
  } else {
    const Col c = col_scalar(p, g);
    for (long long i = t; i < total; i += stride) {
      uint32_t word = 0u;
      if constexpr (DROP)
        word = word_of(philox(static_cast<unsigned long long>(i) >> 2, k0, k1),
                       static_cast<int>(i & 3));
      __stcs(out + i, fwd_one<DROP>(__ldcs(z + i), c, word, p));
    }
  }
}

// ---------------------------------------------------------------- backward

template <bool VEC, bool DROP>
__global__ void __launch_bounds__(THREADS)
    bwd_kernel(const float* __restrict__ gin, const float* __restrict__ z,
               float* __restrict__ dz, long long total, long long stride,
               int groups, Params p, const float* __restrict__ fa,
               const float* __restrict__ fb, const float* __restrict__ fx) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= stride) return;
  const int g = static_cast<int>(t % groups);
  uint32_t k0, k1;
  key_of(p, k0, k1);
  if constexpr (VEC) {
    Col c[4];
    col_vec(p, g, c);
    const float4 a = __ldg(reinterpret_cast<const float4*>(fa) + g);
    const float4 mb = __ldg(reinterpret_cast<const float4*>(fb) + g);
    const float4 mx = __ldg(reinterpret_cast<const float4*>(fx) + g);
    const float4* g4 = reinterpret_cast<const float4*>(gin);
    const float4* z4 = reinterpret_cast<const float4*>(z);
    float4* d4 = reinterpret_cast<float4*>(dz);
    for (long long i = t; i < total; i += stride) {
      const float4 gv = __ldcs(g4 + i), zv = __ldcs(z4 + i);
      const uint4 w = DROP ? philox(static_cast<unsigned long long>(i), k0, k1)
                           : make_uint4(0u, 0u, 0u, 0u);
      float4 o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xh = xhat_of(get(zv, j), c[j]);
        const float gb = grad_b<DROP>(get(gv, j), xh, c[j], word_of(w, j), p);
        const float v = __fsub_rn(__fmul_rn(get(a, j), gb), get(mb, j));
        set(o, j, __fsub_rn(v, __fmul_rn(xh, get(mx, j))));
      }
      __stcs(d4 + i, o);
    }
  } else {
    const Col c = col_scalar(p, g);
    const float a = __ldg(fa + g), mb = __ldg(fb + g), mx = __ldg(fx + g);
    for (long long i = t; i < total; i += stride) {
      uint32_t word = 0u;
      if constexpr (DROP)
        word = word_of(philox(static_cast<unsigned long long>(i) >> 2, k0, k1),
                       static_cast<int>(i & 3));
      const float xh = xhat_of(__ldcs(z + i), c);
      const float gb = grad_b<DROP>(__ldcs(gin + i), xh, c, word, p);
      const float v = __fsub_rn(__fmul_rn(a, gb), mb);
      __stcs(dz + i, __fsub_rn(v, __fmul_rn(xh, mx)));
    }
  }
}

// ------------------------------------------------------------ reductions
//
// Partials are (chunks, h) double2. Statistics: (mean, M2) of the chunk's
// rows (its count follows from the chunk), merged with Chan's formula.
// Backward: (sum g_b, sum g_b * xhat), added.

struct Welford {
  double n, mean, m2;
};

__device__ __forceinline__ void chan(Welford& a, const Welford& b) {
  if (b.n == 0.0) return;
  const double n = a.n + b.n;
  const double d = b.mean - a.mean;
  a.mean += d * (b.n / n);
  a.m2 += b.m2 + d * d * (a.n * b.n / n);
  a.n = n;
}

// block (TX, TY): column group blockIdx.x * TX + x, rows of chunk
// blockIdx.y in lanes of TY; MODE 0 statistics, 1 backward sums
template <bool VEC, int MODE, bool DROP>
__global__ void __launch_bounds__(TX * TY)
    partial_kernel(const float* __restrict__ z, const float* __restrict__ gin,
                   long long n, int h, long long chunk_rows, Params p,
                   double2* __restrict__ partials) {
  constexpr int W = VEC ? 4 : 1;
  __shared__ double2 sh[TY][TX * W];
  __shared__ double cnt[TY];
  const int groups = VEC ? h / 4 : h;
  const int g = blockIdx.x * TX + threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk_rows;
  const long long r1 = r0 + chunk_rows < n ? r0 + chunk_rows : n;
  float mean[W], m2[W];     // MODE 0: Welford in f32
  double sa[W], sx[W];      // MODE 1: sums in f64
#pragma unroll
  for (int j = 0; j < W; ++j) {
    mean[j] = m2[j] = 0.0f;
    sa[j] = sx[j] = 0.0;
  }
  float k = 0.0f;
  if (g < groups) {
    uint32_t k0 = 0u, k1 = 0u;
    Col c[W];
    if constexpr (MODE == 1) {
      key_of(p, k0, k1);
      if constexpr (VEC) col_vec(p, g, c);
      else c[0] = col_scalar(p, g);
    }
#pragma unroll 4
    for (long long r = r0 + threadIdx.y; r < r1; r += TY) {
      const long long e = r * h + static_cast<long long>(g) * W;  // first element
      float zv[W], gv[W];
      if constexpr (VEC) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(z + e));
        zv[0] = v.x; zv[1] = v.y; zv[2] = v.z; zv[3] = v.w;
        if constexpr (MODE == 1) {
          const float4 u = __ldcs(reinterpret_cast<const float4*>(gin + e));
          gv[0] = u.x; gv[1] = u.y; gv[2] = u.z; gv[3] = u.w;
        }
      } else {
        zv[0] = __ldcs(z + e);
        if constexpr (MODE == 1) gv[0] = __ldcs(gin + e);
      }
      if constexpr (MODE == 0) {
        k += 1.0f;
        const float rk = __frcp_rn(k);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float d = zv[j] - mean[j];
          mean[j] += d * rk;
          m2[j] += d * (zv[j] - mean[j]);
        }
      } else {
        uint4 w = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (DROP) w = philox(static_cast<unsigned long long>(e) >> 2, k0, k1);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float xh = xhat_of(zv[j], c[j]);
          const int wi = VEC ? j : static_cast<int>(e & 3);
          const float gb = grad_b<DROP>(gv[j], xh, c[j], word_of(w, wi), p);
          sa[j] += static_cast<double>(gb);
          sx[j] += static_cast<double>(__fmul_rn(gb, xh));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    sh[threadIdx.y][threadIdx.x * W + j] =
        MODE == 0 ? make_double2(mean[j], m2[j]) : make_double2(sa[j], sx[j]);
  if (threadIdx.x == 0) cnt[threadIdx.y] = k;
  __syncthreads();
  if (threadIdx.y != 0 || g >= groups) return;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    double2 acc;
    if constexpr (MODE == 0) {
      Welford a{cnt[0], sh[0][threadIdx.x * W + j].x,
                sh[0][threadIdx.x * W + j].y};
      for (int y = 1; y < TY; ++y)
        chan(a, Welford{cnt[y], sh[y][threadIdx.x * W + j].x,
                        sh[y][threadIdx.x * W + j].y});
      acc = make_double2(a.mean, a.m2);
    } else {
      acc = sh[0][threadIdx.x * W + j];
      for (int y = 1; y < TY; ++y) {
        acc.x += sh[y][threadIdx.x * W + j].x;
        acc.y += sh[y][threadIdx.x * W + j].y;
      }
    }
    partials[static_cast<long long>(blockIdx.y) * h + g * W + j] = acc;
  }
}

// block (MX, MY): column blockIdx.x * MX + x, chunks in lanes of MY, each
// lane in chunk order, then the lanes in order
template <int MODE>
__global__ void __launch_bounds__(MX * MY)
    merge_kernel(const double2* __restrict__ partials, int chunks, int h,
                 long long n, long long chunk_rows, float* __restrict__ out0,
                 float* __restrict__ out1) {
  __shared__ double3 sh[MY][MX];
  const int col = blockIdx.x * MX + threadIdx.x;
  Welford a{0.0, 0.0, 0.0};
  if (col < h) {
    for (int k = threadIdx.y; k < chunks; k += MY) {
      const double2 v = partials[static_cast<long long>(k) * h + col];
      if constexpr (MODE == 0) {
        // a chunk past the last row (chunks > ceil(n / chunk_rows)) is empty
        const long long rows = n - k * chunk_rows < chunk_rows
                                   ? n - k * chunk_rows : chunk_rows;
        if (rows > 0) chan(a, Welford{static_cast<double>(rows), v.x, v.y});
      } else {
        a.mean += v.x;
        a.m2 += v.y;
      }
    }
  }
  sh[threadIdx.y][threadIdx.x] = make_double3(a.n, a.mean, a.m2);
  __syncthreads();
  if (threadIdx.y != 0 || col >= h) return;
  for (int y = 1; y < MY; ++y) {
    const double3 b = sh[y][threadIdx.x];
    if constexpr (MODE == 0) {
      chan(a, Welford{b.x, b.y, b.z});
    } else {
      a.mean += b.y;
      a.m2 += b.z;
    }
  }
  if constexpr (MODE == 0) {
    out0[col] = static_cast<float>(a.mean);
    out1[col] = static_cast<float>(a.m2 / static_cast<double>(n));
  } else {
    out0[col] = static_cast<float>(a.mean);
    out1[col] = static_cast<float>(a.m2);
  }
}

// ------------------------------------------------------------ launchers

long long elementwise_grid(long long n, int groups, long long& stride) {
  const long long total = n * groups;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const long long least = (groups + THREADS - 1) / THREADS;  // one row
  if (blocks < least) blocks = least;
  stride = blocks * THREADS / groups * groups;
  return blocks;
}

template <bool VEC, bool DROP>
int launch_fwd(const float* z, float* out, long long n, int h,
               const Params& p, cudaStream_t s) {
  const int groups = VEC ? h / 4 : h;
  long long stride;
  const long long blocks = elementwise_grid(n, groups, stride);
  fwd_kernel<VEC, DROP><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      z, out, n * groups, stride, groups, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC, bool DROP>
int launch_bwd(const float* g, const float* z, float* dz, long long n, int h,
               const Params& p, const float* fa, const float* fb,
               const float* fx, cudaStream_t s) {
  const int groups = VEC ? h / 4 : h;
  long long stride;
  const long long blocks = elementwise_grid(n, groups, stride);
  bwd_kernel<VEC, DROP><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      g, z, dz, n * groups, stride, groups, p, fa, fb, fx);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_reduce(const float* z, const float* g, long long n, int h, int vec,
                  int chunks, const Params& p, double2* partials, float* out0,
                  float* out1, cudaStream_t s) {
  const long long chunk_rows = (n + chunks - 1) / chunks;
  const int groups = vec ? h / 4 : h;
  const dim3 grid((groups + TX - 1) / TX, chunks);
  const dim3 block(TX, TY);
  const bool drop = MODE == 1 && p.key != nullptr;
  if (vec && drop)
    partial_kernel<true, MODE, true><<<grid, block, 0, s>>>(z, g, n, h, chunk_rows, p, partials);
  else if (vec)
    partial_kernel<true, MODE, false><<<grid, block, 0, s>>>(z, g, n, h, chunk_rows, p, partials);
  else if (drop)
    partial_kernel<false, MODE, true><<<grid, block, 0, s>>>(z, g, n, h, chunk_rows, p, partials);
  else
    partial_kernel<false, MODE, false><<<grid, block, 0, s>>>(z, g, n, h, chunk_rows, p, partials);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  merge_kernel<MODE><<<(h + MX - 1) / MX, dim3(MX, MY), 0, s>>>(
      partials, chunks, h, n, chunk_rows, out0, out1);
  return static_cast<int>(cudaGetLastError());
}

Params params(const void* mean, const void* inv, const void* gamma,
              const void* beta, const void* key, int thresh, float scale) {
  return Params{static_cast<const float*>(mean), static_cast<const float*>(inv),
                static_cast<const float*>(gamma), static_cast<const float*>(beta),
                static_cast<const long long*>(key),
                static_cast<uint32_t>(thresh), scale};
}

bool refused(long long n, int h, int vec, int chunks) {
  return n <= 0 || h <= 0 || (vec && h % 4) || chunks <= 0 || chunks > 65535 ||
         chunks > n;
}

}  // namespace bn_train

using namespace bn_train;

// z f32 (n, h) row-major; partials f64 (chunks, h, 2) scratch; mean, var
// (h,) out. vec: h % 4 == 0 and z 16-byte aligned (the wrapper checks).
// Returns the launches' cudaError_t (901: arguments refused).
extern "C" int bn_stats(const void* z, long long n, int h, int vec, int chunks,
                        void* partials, void* mean, void* var, void* stream) {
  if (refused(n, h, vec, chunks)) return 901;
  const Params p{};
  return launch_reduce<0>(static_cast<const float*>(z), nullptr, n, h, vec,
                          chunks, p, static_cast<double2*>(partials),
                          static_cast<float*>(mean), static_cast<float*>(var),
                          static_cast<cudaStream_t>(stream));
}

// out = dropout(relu(((z - mean) * inv) * gamma + beta)); key (2,) int64 on
// the card or null (no dropout), thresh and scale as in the header.
extern "C" int bn_fwd(const void* z, void* out, long long n, int h, int vec,
                      const void* mean, const void* inv, const void* gamma,
                      const void* beta, const void* key, int thresh,
                      float scale, void* stream) {
  if (refused(n, h, vec, 1)) return 901;
  const Params p = params(mean, inv, gamma, beta, key, thresh, scale);
  const float* z_ = static_cast<const float*>(z);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return key ? launch_fwd<true, true>(z_, o, n, h, p, s)
                      : launch_fwd<true, false>(z_, o, n, h, p, s);
  return key ? launch_fwd<false, true>(z_, o, n, h, p, s)
             : launch_fwd<false, false>(z_, o, n, h, p, s);
}

// sum_gb, sum_gbx (h,) out: the column sums of g_b and g_b * xhat.
extern "C" int bn_bwd_stats(const void* g, const void* z, long long n, int h,
                            int vec, const void* mean, const void* inv,
                            const void* gamma, const void* beta,
                            const void* key, int thresh, float scale,
                            int chunks, void* partials, void* sum_gb,
                            void* sum_gbx, void* stream) {
  if (refused(n, h, vec, chunks)) return 901;
  const Params p = params(mean, inv, gamma, beta, key, thresh, scale);
  return launch_reduce<1>(static_cast<const float*>(z),
                          static_cast<const float*>(g), n, h, vec, chunks, p,
                          static_cast<double2*>(partials),
                          static_cast<float*>(sum_gb),
                          static_cast<float*>(sum_gbx),
                          static_cast<cudaStream_t>(stream));
}

// dz = (a * g_b - m_b) - xhat * m_x; a, m_b, m_x (h,) as the wrapper
// computes them from gamma, inv and the column sums.
extern "C" int bn_bwd(const void* g, const void* z, void* dz, long long n,
                      int h, int vec, const void* mean, const void* inv,
                      const void* gamma, const void* beta, const void* key,
                      int thresh, float scale, const void* a, const void* m_b,
                      const void* m_x, void* stream) {
  if (refused(n, h, vec, 1)) return 901;
  const Params p = params(mean, inv, gamma, beta, key, thresh, scale);
  const float* g_ = static_cast<const float*>(g);
  const float* z_ = static_cast<const float*>(z);
  float* d = static_cast<float*>(dz);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(m_b);
  const float* fx = static_cast<const float*>(m_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return key ? launch_bwd<true, true>(g_, z_, d, n, h, p, fa, fb, fx, s)
                      : launch_bwd<true, false>(g_, z_, d, n, h, p, fa, fb, fx, s);
  return key ? launch_bwd<false, true>(g_, z_, d, n, h, p, fa, fb, fx, s)
             : launch_bwd<false, false>(g_, z_, d, n, h, p, fa, fb, fx, s);
}
