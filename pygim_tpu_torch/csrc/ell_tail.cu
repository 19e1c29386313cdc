// K-tail: the ELL gather-weight-reduce of the hybrid SpMM's tail.
//
// Replaces the XLA body of pygim_tpu/ops/spmm.py:ell_scan_spmm /
// _ell_grouped_scan (one lax.scan per table: take(x, cols) into a
// (chunk, D, H) block, weight by vals, sum over D, then a sorted
// scatter-add of the (chunk, H) partials at vrow_to_row). For one table
// in step layout, flattened to n_vrows = n_steps * chunk virtual rows of
// degree D, it computes
//
//     out[vrow_to_row[v], :] += sum_d vals[v, d] * x[cols[v, d], :]
//
// with x f32 (N, h) row-major, cols int32 / vals f32 (n_vrows, D),
// vrow_to_row int32 (n_vrows,) non-decreasing, out f32 (N, h). A hub
// row spans several consecutive virtual rows; pad virtual rows carry
// val 0 and point at row N - 1.
//
// What bounds it on an H100: bytes, and in practice the latency of
// dependent random reads. Each slot moves one x row (4h bytes, 1 KiB at
// h = 256) chosen by an index that must be read first, and does one
// multiply-add per element, far below the card's operations-per-byte
// balance. The rows of x it needs are read at most once per slot, from
// HBM or, where a row is reused soon enough, from the 50 MB L2; x itself
// (N * h * 4 bytes) is larger than the L2 on the graphs this path serves.
//
// What the design does about it:
// - one warp per virtual row; each lane reads 16 bytes of an x row, so
//   a row read is a whole 512-byte coalesced transaction per 128 columns;
// - the D row reads of a virtual row are independent, and the loop over
//   D is unrolled so several are in flight per warp;
// - the weighted sum stays in registers: the (chunk * D, h) gather that
//   torch's index_select would write to HBM never exists;
// - the output is written once per row run, not once per virtual row:
//   a block's 8 consecutive virtual rows park their partials in shared
//   memory, and the first virtual row of each run of equal rows sums the
//   run and adds it into out. A run that the sorted order proves to be
//   the whole row (its neighbours outside the block hold other rows) is
//   added with plain 16-byte read-modify-writes; only runs cut by a
//   block edge (hub rows, the pad rows at N - 1) use f32 atomics.
//   Per-virtual-row atomics measured slower: they made every output
//   element one contended atomic (PERF.md).
// Summation order: the D products in order, then the run's partials in
// order, then the atomics of a cut run in no fixed order — the result
// differs from the plain version only in f32 summation order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // virtual rows per block

template <int NJ>  // float4 column groups per lane: h <= 128 * NJ
__global__ void __launch_bounds__(WARPS * 32)
ell_tail_kernel(const float* __restrict__ x, const int32_t* __restrict__ cols,
                const float* __restrict__ vals,
                const int32_t* __restrict__ vrow, float* __restrict__ out,
                int64_t n_vrows, int degree, int h) {
  __shared__ float4 part[WARPS][NJ * 32];
  __shared__ int32_t srow[WARPS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t v0 = (int64_t)blockIdx.x * WARPS;
  const int64_t v = v0 + warp;
  const bool live = v < n_vrows;
  const int h4 = h >> 2;

  float4 s[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (live) {
    const int32_t* c = cols + v * degree;
    const float* a = vals + v * degree;
#pragma unroll 4
    for (int d = 0; d < degree; ++d) {
      const float wgt = __ldg(a + d);
      const float4* xr =
          reinterpret_cast<const float4*>(x + (int64_t)__ldg(c + d) * h);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col4 = lane + 32 * j;
        if (col4 < h4) {
          const float4 xv = __ldg(xr + col4);
          s[j].x += wgt * xv.x;
          s[j].y += wgt * xv.y;
          s[j].z += wgt * xv.z;
          s[j].w += wgt * xv.w;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) part[warp][lane + 32 * j] = s[j];
  if (lane == 0) srow[warp] = live ? __ldg(vrow + v) : -1;
  __syncthreads();

  if (!live) return;
  const int row = srow[warp];
  if (warp > 0 && srow[warp - 1] == row) return;  // not the head of its run
  int end = warp + 1;
  while (end < WARPS && srow[end] == row) ++end;
  const bool cut =
      (warp == 0 && v0 > 0 && __ldg(vrow + v0 - 1) == row) ||
      (end == WARPS && v0 + WARPS < n_vrows && __ldg(vrow + v0 + WARPS) == row);

  float4* o = reinterpret_cast<float4*>(out + (int64_t)row * h);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col4 = lane + 32 * j;
    if (col4 >= h4) continue;
    float4 t = part[warp][col4];
    for (int k = warp + 1; k < end; ++k) {
      const float4 p = part[k][col4];
      t.x += p.x;
      t.y += p.y;
      t.z += p.z;
      t.w += p.w;
    }
    if (cut) {
      float* of = reinterpret_cast<float*>(o + col4);
      atomicAdd(of + 0, t.x);
      atomicAdd(of + 1, t.y);
      atomicAdd(of + 2, t.z);
      atomicAdd(of + 3, t.w);
    } else {
      float4 cur = o[col4];
      cur.x += t.x;
      cur.y += t.y;
      cur.z += t.z;
      cur.w += t.w;
      o[col4] = cur;
    }
  }
}

template <int NJ>
void launch(const float* x, const int32_t* cols, const float* vals,
            const int32_t* vrow, float* out, int64_t n_vrows, int degree,
            int h, cudaStream_t stream) {
  const int64_t blocks = (n_vrows + WARPS - 1) / WARPS;
  ell_tail_kernel<NJ><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      x, cols, vals, vrow, out, n_vrows, degree, h);
}

}  // namespace

// h % 4 == 0, h <= 1024, x and out 16-byte aligned; the caller checks.
extern "C" int ell_tail_add(const void* x, const void* cols, const void* vals,
                            const void* vrow, void* out, long long n_vrows,
                            int degree, int h, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const int32_t* cp = static_cast<const int32_t*>(cols);
  const float* vp = static_cast<const float*>(vals);
  const int32_t* rp = static_cast<const int32_t*>(vrow);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (h / 4 + 31) / 32;
  if (groups <= 1)
    launch<1>(xp, cp, vp, rp, op, n_vrows, degree, h, s);
  else if (groups <= 2)
    launch<2>(xp, cp, vp, rp, op, n_vrows, degree, h, s);
  else if (groups <= 4)
    launch<4>(xp, cp, vp, rp, op, n_vrows, degree, h, s);
  else
    launch<8>(xp, cp, vp, rp, op, n_vrows, degree, h, s);
  return static_cast<int>(cudaGetLastError());
}
