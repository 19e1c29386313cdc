// K-epi: the layer epilogue of an evaluation forward, in one pass.
//
// Replaces the XLA fusion of the reference's evaluation forward around
// each BatchNorm: pygim_tpu/nn/layers.py:batchnorm_apply (:65-69), the
// conv bias of gcn_conv_apply (:133-138) or a linear's bias
// (linear_apply, :49-53), the dequantize out * scale of
// pygim_tpu/ops/spmm.py:raw_mul_quantized (:1654), and the ReLU of
// pygim_tpu/nn/models.py:gnn_apply (:112-121). For a (n, h) f32 row-major
// it writes y (n, h) f32:
//
//     y = relu(((a * s + c) - mean) * inv * gamma + beta)
//
// with s an optional 0-dim f32 on the card (read once a thread: no host
// synchronisation), c an optional (h,) bias, and inv = rsqrt(var + eps),
// which the wrapper (ops/epilogue.py) computes once per column so that the
// kernel and the plain version use the same inv. Every step is rounded on
// its own (__fmul_rn, __fadd_rn, __fsub_rn: nothing contracts into an
// FMA), in the order of the PyTorch ops of the plain version, so y equals
// them bit for bit; the ReLU keeps a NaN, as torch.relu and jax.nn.relu
// do (no fmaxf, which would drop it).
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (8 bytes) for seven flops, far below the card's operations per
// byte; the per-column parameters are 5 h floats.
//
// What the design does about it: one read of a and one write of y, in
// 16-byte accesses where h % 4 == 0 and every pointer is 16-byte aligned
// (single elements elsewhere, so a ragged h such as 41 runs too). The
// grid-stride loop's stride is a whole number of rows' worth of column
// groups, so a thread keeps one column group for the whole launch and
// holds its parameters in registers, loaded once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 2048;

__device__ __forceinline__ float relu_keep_nan(float v) {
  return v > 0.0f ? v : (v != v ? v : 0.0f);
}

template <bool HAS_S, bool HAS_C>
__device__ __forceinline__ float epi(float v, float s, float c, float mean,
                                     float inv, float gamma, float beta) {
  if (HAS_S) v = __fmul_rn(v, s);
  if (HAS_C) v = __fadd_rn(v, c);
  v = __fsub_rn(v, mean);
  v = __fmul_rn(v, inv);
  v = __fmul_rn(v, gamma);
  v = __fadd_rn(v, beta);
  return relu_keep_nan(v);
}

struct Params {
  const float* scale;  // 0-dim, or null
  const float* bias;   // (h,), or null
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
};

// One column group (4 columns, VEC) or one column a thread; `groups` the
// groups of a row, `total` the groups of all rows, `stride` a multiple of
// `groups`, so column (group) t % groups stays the thread's.
template <bool VEC, bool HAS_S, bool HAS_C>
__global__ void __launch_bounds__(THREADS)
    epilogue_kernel(const float* __restrict__ a, float* __restrict__ y,
                    long long total, long long stride, int groups, Params p) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= stride) return;
  const int g = static_cast<int>(t % groups);
  const float s = HAS_S ? __ldg(p.scale) : 0.0f;
  if constexpr (VEC) {
    const float4 mean = __ldg(reinterpret_cast<const float4*>(p.mean) + g);
    const float4 inv = __ldg(reinterpret_cast<const float4*>(p.inv) + g);
    const float4 gam = __ldg(reinterpret_cast<const float4*>(p.gamma) + g);
    const float4 bet = __ldg(reinterpret_cast<const float4*>(p.beta) + g);
    const float4 c = HAS_C ? __ldg(reinterpret_cast<const float4*>(p.bias) + g)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* a4 = reinterpret_cast<const float4*>(a);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (long long i = t; i < total; i += stride) {
      const float4 v = __ldcs(a4 + i);
      float4 o;
      o.x = epi<HAS_S, HAS_C>(v.x, s, c.x, mean.x, inv.x, gam.x, bet.x);
      o.y = epi<HAS_S, HAS_C>(v.y, s, c.y, mean.y, inv.y, gam.y, bet.y);
      o.z = epi<HAS_S, HAS_C>(v.z, s, c.z, mean.z, inv.z, gam.z, bet.z);
      o.w = epi<HAS_S, HAS_C>(v.w, s, c.w, mean.w, inv.w, gam.w, bet.w);
      __stcs(y4 + i, o);
    }
  } else {
    const float mean = __ldg(p.mean + g), inv = __ldg(p.inv + g);
    const float gam = __ldg(p.gamma + g), bet = __ldg(p.beta + g);
    const float c = HAS_C ? __ldg(p.bias + g) : 0.0f;
    for (long long i = t; i < total; i += stride)
      __stcs(y + i, epi<HAS_S, HAS_C>(__ldcs(a + i), s, c, mean, inv, gam, bet));
  }
}

template <bool VEC, bool HAS_S, bool HAS_C>
int launch(const float* a, float* y, long long n, int h, const Params& p,
           cudaStream_t stream) {
  const int groups = VEC ? h / 4 : h;
  const long long total = n * groups;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const long long least = (groups + THREADS - 1) / THREADS;  // one row
  if (blocks < least) blocks = least;
  const long long stride = blocks * THREADS / groups * groups;
  epilogue_kernel<VEC, HAS_S, HAS_C><<<static_cast<unsigned>(blocks), THREADS,
                                       0, stream>>>(a, y, total, stride,
                                                    groups, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch(const float* a, float* y, long long n, int h, const Params& p,
             cudaStream_t s) {
  if (p.scale && p.bias) return launch<VEC, true, true>(a, y, n, h, p, s);
  if (p.scale) return launch<VEC, true, false>(a, y, n, h, p, s);
  if (p.bias) return launch<VEC, false, true>(a, y, n, h, p, s);
  return launch<VEC, false, false>(a, y, n, h, p, s);
}

}  // namespace

// a, y f32 (n, h) row-major; scale 0-dim or null; bias (h,) or null; mean,
// inv, gamma, beta (h,); vec: h % 4 == 0 and every pointer 16-byte
// aligned (the wrapper checks). Returns the launch's cudaError_t.
extern "C" int epilogue(const void* a, void* y, long long n, int h, int vec,
                        const void* scale, const void* bias, const void* mean,
                        const void* inv, const void* gamma, const void* beta,
                        void* stream) {
  if (n <= 0 || h <= 0) return 0;
  if (vec && h % 4) return 901;
  const Params p{static_cast<const float*>(scale),
                 static_cast<const float*>(bias),
                 static_cast<const float*>(mean),
                 static_cast<const float*>(inv),
                 static_cast<const float*>(gamma),
                 static_cast<const float*>(beta)};
  const float* a_ = static_cast<const float*>(a);
  float* y_ = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<true>(a_, y_, n, h, p, s)
             : dispatch<false>(a_, y_, n, h, p, s);
}
