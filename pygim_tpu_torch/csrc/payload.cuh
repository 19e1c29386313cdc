// Payload modes shared by K-tail (ell_tail.cu) and K-bcsr (bcsr.cu):
// the element type of x's rows and how one element becomes the f32 value
// a kernel multiplies. Mode (iii), rounding to round(x / safe) by the
// reciprocal route (QuantRcp) or a true division (QuantDiv), is derived
// in ell_tail.cu's header comment.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// d: mode (iii)'s divisor safe and its reciprocal, (safe, RN(1 / safe)).
struct AsIs {
  using In = float;
  __device__ __forceinline__ static float get(float v, float2) { return v; }
};
template <typename T>
struct Widen {
  using In = T;
  __device__ __forceinline__ static float get(T v, float2) {
    return static_cast<float>(v);  // round to nearest, as XLA's convert
  }
};
// Mode (iv): bf16 rows, held as their 16 bits
struct Bf16 {
  using In = uint16_t;
  __device__ __forceinline__ static float get(uint16_t v, float2) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);  // exact
  }
};
struct QuantRcp {
  using In = float;
  __device__ __forceinline__ static float get(float v, float2 d) {
    const float y0 = __fmul_rn(v, d.y);
    const float y = __fmaf_rn(__fmaf_rn(-y0, d.x, v), d.y, y0);  // faithful
    const float rem = __fmaf_rn(-y, d.x, v);                     // exact
    return rintf(__fmaf_rn(rem, d.y, y));
  }
};
struct QuantDiv {
  using In = float;
  __device__ __forceinline__ static float get(float v, float2 d) {
    return rintf(__fdiv_rn(v, d.x));
  }
};

// Mode (iii)'s divisor (safe, RN(1 / safe)), read once; the reciprocal
// route (QuantRcp) holds where safe lies in [2^-100, 2^100], and a NaN
// fails both tests.
__device__ __forceinline__ float2 divisor(const float* safe_p) {
  const float safe = __ldg(safe_p);
  return make_float2(safe, __frcp_rn(safe));
}
__device__ __forceinline__ bool rcp_route(float2 d) {
  return d.x >= 0x1p-100f && d.x <= 0x1p100f;
}

