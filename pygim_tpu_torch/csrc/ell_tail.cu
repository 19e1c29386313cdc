// K-tail: the ELL gather-weight-reduce of the hybrid SpMM's tail, every
// ELL table of one SpMM in one launch.
//
// Replaces the XLA body of pygim_tpu/ops/spmm.py:ell_scan_spmm /
// _ell_grouped_scan (one lax.scan per table: take(x, cols) into a
// (chunk, D, H) block, weight by vals, sum over D, then a sorted
// scatter-add of the (chunk, H) partials at vrow_to_row). For every table,
// cols int32 / vals f32 (n_vrows, D) and vrow_to_row int32 (n_vrows,)
// non-decreasing, it computes
//
//     out[vrow_to_row[v], :] += sum_d vals[v, d] * x[cols[v, d], :]
//
// with out f32 (N, h) row-major; out is added into, not assumed zero. A
// hub row spans several consecutive virtual rows. x (N, h) row-major is one
// of the payload modes (template parameter P), each multiplied by the f32
// vals and summed in f32:
//   (i)   f32 rows as they are (AsIs; the float path);
//   (ii)  int8, int16 or int32 rows widened to f32 (Widen<T>; the
//         quantized aggregate's integer table, and prep.mul on an integer
//         payload: ell_scan_spmm on integer rows, whose accumulation dtype
//         is f32);
//   (iii) f32 rows rounded to the quantization grid in the consumer,
//         rintf(RN(g / safe)) with safe read from the card (Quant;
//         replaces ell_scan_spmm_quant, pygim_tpu/ops/spmm.py:452): the
//         correctly rounded quotient and a round half to even, as the
//         reference's round(g / scale). |q| <= 2^19 + 1 is exact in f32,
//         so the reference's cast through int32 changes nothing. The
//         divisor is one float for the whole launch, so the quotient is
//         not an IEEE division per element (a MUFU reciprocal and a
//         correction sequence with a slow path) but Markstein's
//         correction of a product with the correctly rounded reciprocal
//         r = RN(1 / safe), taken once a thread:
//             y0 = RN(g * r),  y = fma(fma(-y0, safe, g), r, y0),
//             rem = fma(-y, safe, g),  q = fma(rem, r, y).
//         y0 can be more than an ulp off the quotient (a divisor with an
//         all-ones mantissa can do that); one correction makes y faithful
//         (within an ulp), so rem is exact and Markstein's theorem gives
//         q = RN(g / safe) for every safe, where no step underflows or
//         overflows. The tests hold a model of these steps
//         (tests/test_torch_quant_spmm.py) and, on the card,
//         chip_smoke.py's sweep over every value within 4 ulps of each
//         half step to the true division. For 2^-100 <= safe <= 2^100
//         (QuantRcp) nothing underflows for a quotient that can round
//         away from 0: |g / safe| >= 1/4 puts g, y * safe and the
//         residuals' last bits above the subnormal range. Any other safe (a tiny max|x|, or an
//         inf or NaN in x) keeps __fdiv_rn (QuantDiv), a branch taken once
//         a launch on the value read from the card. The library is built
//         without --use_fast_math (ops/_build.py); the steps use the _rn
//         intrinsics, which no contraction changes;
//   (iv)  bf16 rows widened exactly to f32 (Bf16; ell_scan_spmm on a bf16
//         payload, whose accumulation dtype, result_type(f32 vals, bf16),
//         is f32: pygim_tpu/ops/spmm.py:489-493). A bf16 value is the top
//         half of its f32, so the widen is one shift.
//
// The host plan (ops/ell_tail.py:tail_plan) gives each table a count per
// virtual row, cnt[v] = 1 + the index of its last nonzero weight (0 if it
// has none), and a list of work units (table, first virtual row, at most
// 32 virtual rows). A unit holds whole runs of equal rows, except that a
// run longer than a unit is cut into pieces of its own, each flagged to
// add atomically. Only the first cnt[v] slots of a virtual row are read,
// and the virtual rows past a table's last counted one (the planner's pad
// rows: col 0, val 0, row N - 1) are in no unit.
//
// The one difference from the plain version and the reference: a slot
// past cnt[v] reads no x row, so a non-finite x row that only such slots
// reach (pad slots, or zero weights at the end of a virtual row) does not
// turn their zero weights into NaN in the rows they point at.
//
// What bounds it on an H100: bytes. Each counted slot moves one x row
// slice (h elements, 1 KiB at h = 256 in f32, 512 B in bf16), chosen by an
// index that must be read first, and does one multiply-add per element,
// far below the card's operations per byte; each touched output row is
// read and written once.
// x is larger than the 50 MB L2 on the graphs this path serves.
//
// What the design does about it:
// - one launch for all tables: a grid over the unit list (a warp a unit,
//   four a block, the units with the most slots first) times one grid row
//   per 256-column slab of h, so any h >= 1 runs;
// - a warp lays its unit's counted slots out as one stream (a prefix sum
//   of cnt over its virtual rows, one per lane), so no pad slot costs a
//   read and a D = 2 table streams x rows as densely as a D = 512 one;
// - path (c), bf16 rows wherever h % 8 == 0 and x and out are 16-byte
//   aligned: a lane owns 8 consecutive columns of a 256-column slab, so
//   one 16-byte load a lane gathers a 512-byte bf16 row slice straight
//   into registers (no bulk copy, no mbarrier a row); a warp issues the x
//   rows of B = 8 slots (4 KiB, as many bytes as path (b)'s ring holds in
//   f32) before it uses any, widens by a shift and keeps the sums in
//   registers; a row is added into out from registers where its last slot
//   is used, its output row read and written as streaming (evict-first)
//   accesses so the L2 keeps more of x; the path holds no shared memory,
//   so more warps fit an SM;
// - path (b), the other modes wherever h * sizeof(element) % 16 == 0 (h %
//   4 for 4-byte rows, h % 16 for int8, h % 8 for int16) and x and out
//   are 16-byte aligned:
//   lane 0 keeps a ring of RING shared-memory stages per warp filled with
//   cp.async.bulk row copies completed on mbarriers, the next copy issued
//   as soon as a stage is read, and the warp applies the weights from
//   shared memory; the copies hold no registers, so more warps fit on an
//   SM;
// - path (a), every other width or alignment: each lane issues its
//   columns of BATCH independent x row reads into registers before it
//   uses any;
// - paths (a) and (b) keep the weighted sums in registers; a finished
//   row's sum is parked in shared memory, and the parked rows are added
//   into out together, every row's load issued before any store, so a
//   table of one-slot rows does not pay a memory latency per row;
// - a run that the unit holds whole is added with plain read-modify-
//   writes; only the pieces of a split hub run use f32 atomics;
// PERF.md has the times of the paths, of path (c)'s variants that lost
// (B = 16, the output rows read with the batch's x rows, no streaming
// accesses) and of path (c) on f32 rows, and of L2 cache hints on path
// (b) (x rows evict_last, the other streams evict first) that were tried
// and lost on the smoke tables.
// Summation order: a row's counted slots in order within a unit, then the
// pieces of a split run in no fixed order — the result differs from the
// plain version only in f32 summation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "payload.cuh"

namespace {

constexpr int WARPS = 4;         // units (one a warp) per block
constexpr int BATCH = 8;         // x rows a warp reads before using any
constexpr int PARK = BATCH + 1;  // finished row sums a warp parks
constexpr int RING = 4;          // shared-memory stages a warp (path b)
constexpr unsigned FULL = 0xffffffffu;

// one plan table: five 64-bit words (ops/ell_tail.py:tail_plan)
struct Table {
  const int32_t* cols;
  const float* vals;
  const int32_t* vrow;
  const int32_t* cnt;
  long long degree;
};

// Mode (iii) as the host names it; each kernel picks QuantRcp or
// QuantDiv once, from the safe it reads (divisor()).
struct Quant {
  using In = float;
};

// four consecutive elements of a row, as one load
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename P>
__device__ __forceinline__ float4 get4(const Vec4<typename P::In>& q,
                                       float2 d) {
  return make_float4(P::get(q.v[0], d), P::get(q.v[1], d),
                     P::get(q.v[2], d), P::get(q.v[3], d));
}

__device__ __forceinline__ void zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void zero(float& a) { a = 0.f; }
__device__ __forceinline__ void fma_to(float4& a, float w, const float4& b) {
  a.x = fmaf(w, b.x, a.x);
  a.y = fmaf(w, b.y, a.y);
  a.z = fmaf(w, b.z, a.z);
  a.w = fmaf(w, b.w, a.w);
}
__device__ __forceinline__ void fma_to(float& a, float w, float b) {
  a = fmaf(w, b, a);
}
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void atomic_to(float4* p, const float4& v) {
  float* f = reinterpret_cast<float*>(p);
  atomicAdd(f + 0, v.x);
  atomicAdd(f + 1, v.y);
  atomicAdd(f + 2, v.z);
  atomicAdd(f + 3, v.w);
}
__device__ __forceinline__ void atomic_to(float* p, float v) { atomicAdd(p, v); }

// A warp's unit: its table, first virtual row and stream length T (the
// counted slots of all its virtual rows); lane i < n holds virtual row
// v0 + i's row r and first stream position s (lanes >= n hold s = T).
struct Unit {
  Table tb;
  int v0, T, s, r;
  bool atomic;
};

__device__ __forceinline__ Unit load_unit(const Table* tabs, const int2* units,
                                          int u, int lane) {
  const int2 w = units[u];
  Unit U;
  U.tb = tabs[w.y & 0xff];
  const int n = ((w.y >> 8) & 31) + 1;
  U.atomic = (w.y >> 13) & 1;
  U.v0 = w.x;
  int c = 0;
  U.r = -1;
  if (lane < n) {
    c = __ldg(U.tb.cnt + U.v0 + lane);
    U.r = __ldg(U.tb.vrow + U.v0 + lane);
  }
  int e = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, e, o);
    if (lane >= o) e += y;
  }
  U.T = __shfl_sync(FULL, e, 31);
  U.s = lane < n ? e - c : U.T;
  return U;
}

// Stream entry q (one a lane): its x row, weight and output row. The
// virtual row is the last lane i with s_i <= q (s is non-decreasing).
struct Entry {
  int col;
  float val;
  int row;
};

__device__ __forceinline__ Entry load_entry(const Unit& U, int q) {
  int i = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int si = __shfl_sync(FULL, U.s, i + step);
    if (si <= q) i += step;
  }
  Entry e;
  const int d = q - __shfl_sync(FULL, U.s, i);
  e.row = __shfl_sync(FULL, U.r, i);
  e.col = 0;
  e.val = 0.f;
  if (q < U.T) {
    const int64_t off = static_cast<int64_t>(U.v0 + i) * U.tb.degree + d;
    e.col = __ldg(U.tb.cols + off);
    e.val = __ldg(U.tb.vals + off);
  }
  return e;
}

// Park a finished row's sum: lane k of the warp keeps slot k's row.
template <typename V, int NJ>
__device__ __forceinline__ void park(V* pk, int& prow, int& n, int row,
                                     const V (&acc)[NJ], int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) pk[n * NJ * 32 + lane + 32 * j] = acc[j];
  if (lane == n) prow = row;
  ++n;
}

// Add the n parked sums into out: f32 atomics for the pieces of a split
// run, else plain read-modify-writes with every row's load issued before
// any store. live: bit j set where element j of this lane is inside h.
template <typename V, int NJ>
__device__ __forceinline__ void flush(const V* pk, int prow, int n,
                                      bool atomic, float* out, int h, int col0,
                                      int lane, unsigned live) {
  if (atomic) {
    for (int f = 0; f < n; ++f) {
      const int row = __shfl_sync(FULL, prow, f);
      V* o = reinterpret_cast<V*>(out + static_cast<int64_t>(row) * h + col0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (live >> j & 1) atomic_to(o + lane + 32 * j, pk[f * NJ * 32 + lane + 32 * j]);
    }
    return;
  }
  V cur[PARK][NJ];
  int rows[PARK];
#pragma unroll
  for (int f = 0; f < PARK; ++f) {
    rows[f] = __shfl_sync(FULL, prow, f);
    if (f < n) {
      const V* o = reinterpret_cast<const V*>(
          out + static_cast<int64_t>(rows[f]) * h + col0);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (live >> j & 1) cur[f][j] = o[lane + 32 * j];
    }
  }
#pragma unroll
  for (int f = 0; f < PARK; ++f) {
    if (f < n) {
      V* o = reinterpret_cast<V*>(out + static_cast<int64_t>(rows[f]) * h + col0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (live >> j & 1) {
          V v = cur[f][j];
          add_to(v, pk[f * NJ * 32 + lane + 32 * j]);
          o[lane + 32 * j] = v;
        }
      }
    }
  }
}

// W: floats an element (4 for float4)
template <int W, int NJ>
__device__ __forceinline__ unsigned live_mask(int h, int col0, int lane) {
  unsigned live = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (col0 + W * (lane + 32 * j) < h) live |= 1u << j;
  return live;
}

// Path (a): x rows read into registers, BATCH rows at a time, one element
// a lane. pk: this warp's PARK * NJ * 32 parked floats.
template <int NJ, typename P>
__device__ __forceinline__ void tail_regs(const Table* __restrict__ tabs,
                                          const int2* __restrict__ units,
                                          int u, const typename P::In* __restrict__ x,
                                          float2 d, float* __restrict__ out,
                                          int h, float* pk) {
  using V = float;
  using In = typename P::In;
  constexpr int SLAB = 32 * NJ;
  const int lane = threadIdx.x & 31;
  const Unit U = load_unit(tabs, units, u, lane);
  const int col0 = blockIdx.y * SLAB;
  const unsigned live = live_mask<1, NJ>(h, col0, lane);

  V acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) zero(acc[j]);
  int cur = -1, n_park = 0, prow = -1;
  for (int c0 = 0; c0 < U.T; c0 += 32) {
    const Entry e = load_entry(U, c0 + lane);
    const int m = min(32, U.T - c0);
    for (int b = 0; b < m; b += BATCH) {
      V xv[BATCH][NJ];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int col = __shfl_sync(FULL, e.col, b + k);
        const In* xr = x + static_cast<int64_t>(col) * h + col0;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (b + k < m && (live >> j & 1))
            xv[k][j] = P::get(__ldg(xr + lane + 32 * j), d);
          else
            zero(xv[k][j]);
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int row = __shfl_sync(FULL, e.row, b + k);
        const float wgt = __shfl_sync(FULL, e.val, b + k);
        if (b + k < m) {
          if (row != cur) {
            if (cur >= 0) park<V, NJ>(pk, prow, n_park, cur, acc, lane);
            cur = row;
#pragma unroll
            for (int j = 0; j < NJ; ++j) zero(acc[j]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) fma_to(acc[j], wgt, xv[k][j]);
        }
      }
      if (c0 + b + BATCH >= U.T) park<V, NJ>(pk, prow, n_park, cur, acc, lane);
      if (n_park) {
        flush<V, NJ>(pk, prow, n_park, U.atomic, out, h, col0, lane, live);
        n_park = 0;
      }
    }
  }
}

template <int NJ, typename P>
__global__ void __launch_bounds__(WARPS * 32, 4)
tail_regs_kernel(const Table* __restrict__ tabs, const int2* __restrict__ units,
                 int n_units, const typename P::In* __restrict__ x,
                 const float* __restrict__ safe_p, float* __restrict__ out,
                 int h) {
  __shared__ float parked[WARPS][PARK * NJ * 32];
  const int warp = threadIdx.x >> 5;
  const int u = blockIdx.x * WARPS + warp;
  if (u >= n_units) return;
  float* pk = parked[warp];
  if constexpr (std::is_same_v<P, Quant>) {
    const float2 d = divisor(safe_p);
    if (rcp_route(d))
      tail_regs<NJ, QuantRcp>(tabs, units, u, x, d, out, h, pk);
    else
      tail_regs<NJ, QuantDiv>(tabs, units, u, x, d, out, h, pk);
  } else {
    tail_regs<NJ, P>(tabs, units, u, x, float2{}, out, h, pk);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for phase `parity` of an mbarrier. A copy that never lands traps
// after about 2^32 cycles (~2 s) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

__device__ __forceinline__ void bulk_row(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bytes of one ring stage: a slab row of NJ * 32 groups of four elements
template <int NJ, typename P>
__host__ __device__ constexpr int stage_bytes() {
  return NJ * 32 * static_cast<int>(sizeof(Vec4<typename P::In>));
}

template <int NJ, typename P>
constexpr int bulk_smem_bytes() {
  return WARPS * RING * stage_bytes<NJ, P>() + WARPS * PARK * NJ * 32 * 16 +
         WARPS * RING * 8;
}

// Path (b): x rows copied into a shared-memory ring of RING stages a warp
// by the bulk-copy engine (vector widths only: 16-byte aligned rows and
// sizes).
template <int NJ, typename P>
__device__ __forceinline__ void tail_bulk(const Table* __restrict__ tabs,
                                          const int2* __restrict__ units,
                                          int u, const typename P::In* __restrict__ x,
                                          float2 d, float* __restrict__ out,
                                          int h, unsigned char* smem) {
  using In = typename P::In;
  constexpr int SL4 = NJ * 32;  // groups of four elements of one slab row
  constexpr int STAGE = stage_bytes<NJ, P>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Vec4<In>* ring =
      reinterpret_cast<const Vec4<In>*>(smem + warp * RING * STAGE);
  float4* pk = reinterpret_cast<float4*>(smem + WARPS * RING * STAGE) +
               warp * PARK * SL4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + WARPS * RING * STAGE + WARPS * PARK * SL4 * 16) +
                   warp * RING;

  const Unit U = load_unit(tabs, units, u, lane);
  const int col0 = blockIdx.y * SL4 * 4;
  const unsigned live = live_mask<4, NJ>(h, col0, lane);
  const uint32_t bytes =
      static_cast<uint32_t>(min(SL4 * 4, h - col0)) * sizeof(In);
  const uint32_t ring0 = smem_u32(ring), bar0 = smem_u32(bars);
  if (lane == 0) {
    for (int s = 0; s < RING; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * s)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncwarp();

  Entry e0 = load_entry(U, lane);       // stream positions 0..31
  Entry e1 = load_entry(U, 32 + lane);  // and 32..63
#pragma unroll
  for (int q = 0; q < RING; ++q) {
    const int col = __shfl_sync(FULL, e0.col, q);
    if (lane == 0 && q < U.T)
      bulk_row(ring0 + q * STAGE, x + static_cast<int64_t>(col) * h + col0,
               bytes, bar0 + 8 * q);
  }

  float4 acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) zero(acc[j]);
  int cur = -1, n_park = 0, prow = -1;
  for (int q = 0; q < U.T; ++q) {
    if (q > 0 && (q & 31) == 0) {
      e0 = e1;
      e1 = load_entry(U, q + 32 + lane);
    }
    const int st = q % RING;
    mbar_wait(bar0 + 8 * st, (q / RING) & 1);
    float4 xv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (live >> j & 1)
        xv[j] = get4<P>(ring[st * SL4 + lane + 32 * j], d);
      else
        zero(xv[j]);
    }
    __syncwarp();
    // refill the stage just read with entry q + RING
    const int qn = q + RING;
    const int ca = __shfl_sync(FULL, e0.col, qn & 31);
    const int cb = __shfl_sync(FULL, e1.col, qn & 31);
    if (lane == 0 && qn < U.T) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const int col = (qn >> 5) == (q >> 5) ? ca : cb;
      bulk_row(ring0 + st * STAGE, x + static_cast<int64_t>(col) * h + col0,
               bytes, bar0 + 8 * st);
    }
    const int row = __shfl_sync(FULL, e0.row, q & 31);
    const float wgt = __shfl_sync(FULL, e0.val, q & 31);
    if (row != cur) {
      if (cur >= 0) park<float4, NJ>(pk, prow, n_park, cur, acc, lane);
      cur = row;
#pragma unroll
      for (int j = 0; j < NJ; ++j) zero(acc[j]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) fma_to(acc[j], wgt, xv[j]);
    if (q == U.T - 1) park<float4, NJ>(pk, prow, n_park, cur, acc, lane);
    if (n_park == BATCH || q == U.T - 1) {
      flush<float4, NJ>(pk, prow, n_park, U.atomic, out, h, col0, lane, live);
      n_park = 0;
    }
  }
}

template <int NJ, typename P>
__global__ void __launch_bounds__(WARPS * 32)
tail_bulk_kernel(const Table* __restrict__ tabs, const int2* __restrict__ units,
                 int n_units, const typename P::In* __restrict__ x,
                 const float* __restrict__ safe_p, float* __restrict__ out,
                 int h) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int u = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u >= n_units) return;
  if constexpr (std::is_same_v<P, Quant>) {
    const float2 d = divisor(safe_p);
    if (rcp_route(d))
      tail_bulk<NJ, QuantRcp>(tabs, units, u, x, d, out, h, smem);
    else
      tail_bulk<NJ, QuantDiv>(tabs, units, u, x, d, out, h, smem);
  } else {
    tail_bulk<NJ, P>(tabs, units, u, x, float2{}, out, h, smem);
  }
}

// Path (c): a lane's 8 consecutive bf16 elements of a row, one 16-byte
// word; B slots' x rows issued a batch
constexpr int LANE_ELEMS = 8;
constexpr int LANE_SLAB = 32 * LANE_ELEMS;  // columns a warp covers
constexpr int LANE_BATCH = 8;

// element 2i is the low half of word i; widened by a shift (exact)
__device__ __forceinline__ void widen8(uint4 r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Path (c) for one unit: the stream in chunks of 32 entries (one a lane,
// the next chunk's loaded a chunk ahead), each chunk in batches of
// LANE_BATCH slots. A batch first issues every slot's x row slice, then
// applies the weights in slot order; at a row's last slot its sum is
// added into out from registers, the output row read and written as
// streaming (evict-first) accesses, and zeroed.
__global__ void __launch_bounds__(WARPS * 32, 4)
tail_lanes_kernel(const Table* __restrict__ tabs, const int2* __restrict__ units,
                  int n_units, const uint16_t* __restrict__ x,
                  float* __restrict__ out, int h) {
  const int u = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u >= n_units) return;
  const int lane = threadIdx.x & 31;
  const Unit U = load_unit(tabs, units, u, lane);
  const int col = blockIdx.y * LANE_SLAB + LANE_ELEMS * lane;
  const bool live = col < h;  // h % 8 == 0: all 8 columns or none
  float acc[LANE_ELEMS];
#pragma unroll
  for (int i = 0; i < LANE_ELEMS; ++i) acc[i] = 0.f;
  Entry e = load_entry(U, lane);
  for (int c0 = 0; c0 < U.T; c0 += 32) {
    const Entry en = load_entry(U, c0 + 32 + lane);
    // slot c0 + lane ends its row where the next slot's row differs
    int next = __shfl_down_sync(FULL, e.row, 1);
    const int first = __shfl_sync(FULL, en.row, 0);
    if (lane == 31) next = first;
    const int q = c0 + lane;
    const unsigned ends =
        __ballot_sync(FULL, q < U.T && (q == U.T - 1 || next != e.row));
    const int m = min(32, U.T - c0);
    for (int b = 0; b < m; b += LANE_BATCH) {
      uint4 xv[LANE_BATCH];
#pragma unroll
      for (int k = 0; k < LANE_BATCH; ++k) {
        const int cx = __shfl_sync(FULL, e.col, b + k);
        if (b + k < m && live)
          xv[k] = __ldg(reinterpret_cast<const uint4*>(
              x + static_cast<int64_t>(cx) * h + col));
      }
#pragma unroll
      for (int k = 0; k < LANE_BATCH; ++k) {
        if (b + k >= m) break;
        const float wgt = __shfl_sync(FULL, e.val, b + k);
        const int r = __shfl_sync(FULL, e.row, b + k);
        if (live) {
          float v[LANE_ELEMS];
          widen8(xv[k], v);
#pragma unroll
          for (int i = 0; i < LANE_ELEMS; ++i) acc[i] = fmaf(wgt, v[i], acc[i]);
        }
        if (ends >> (b + k) & 1) {
          if (live) {
            float* o = out + static_cast<int64_t>(r) * h + col;
            if (U.atomic) {
#pragma unroll
              for (int i = 0; i < LANE_ELEMS; ++i) atomicAdd(o + i, acc[i]);
            } else {
              float4* o4 = reinterpret_cast<float4*>(o);
              float4 a0 = __ldcs(o4), a1 = __ldcs(o4 + 1);
              a0.x += acc[0];
              a0.y += acc[1];
              a0.z += acc[2];
              a0.w += acc[3];
              a1.x += acc[4];
              a1.y += acc[5];
              a1.z += acc[6];
              a1.w += acc[7];
              __stcs(o4, a0);
              __stcs(o4 + 1, a1);
            }
          }
#pragma unroll
          for (int i = 0; i < LANE_ELEMS; ++i) acc[i] = 0.f;
        }
      }
    }
    e = en;
  }
}

struct Args {
  const Table* tabs;
  const int2* units;
  int n_units;
  const void* x;
  const float* safe;
  float* out;
  int h;
};

template <int NJ, typename P>
int launch_bulk(const Args& a, cudaStream_t s) {
  constexpr int smem = bulk_smem_bytes<NJ, P>();
  const dim3 grid((a.n_units + WARPS - 1) / WARPS,
                  (a.h + 128 * NJ - 1) / (128 * NJ));
  cudaError_t e = cudaFuncSetAttribute(
      tail_bulk_kernel<NJ, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  tail_bulk_kernel<NJ, P><<<grid, WARPS * 32, smem, s>>>(
      a.tabs, a.units, a.n_units, static_cast<const typename P::In*>(a.x),
      a.safe, a.out, a.h);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ, typename P>
int launch_regs(const Args& a, cudaStream_t s) {
  const dim3 grid((a.n_units + WARPS - 1) / WARPS,
                  (a.h + 32 * NJ - 1) / (32 * NJ));
  tail_regs_kernel<NJ, P><<<grid, WARPS * 32, 0, s>>>(
      a.tabs, a.units, a.n_units, static_cast<const typename P::In*>(a.x),
      a.safe, a.out, a.h);
  return static_cast<int>(cudaGetLastError());
}

int launch_lanes(const Args& a, cudaStream_t s) {
  const dim3 grid((a.n_units + WARPS - 1) / WARPS,
                  (a.h + LANE_SLAB - 1) / LANE_SLAB);
  tail_lanes_kernel<<<grid, WARPS * 32, 0, s>>>(
      a.tabs, a.units, a.n_units, static_cast<const uint16_t*>(a.x), a.out,
      a.h);
  return static_cast<int>(cudaGetLastError());
}

// vec: path (c) for bf16 rows, (b) for the others; else (a)
template <typename P>
int launch(const Args& a, int vec, cudaStream_t s) {
  if (!vec) return a.h <= 64 ? launch_regs<2, P>(a, s) : launch_regs<8, P>(a, s);
  if constexpr (std::is_same_v<P, Bf16>) {
    return a.h % LANE_ELEMS ? 901 : launch_lanes(a, s);
  } else {
    return a.h <= 128 ? launch_bulk<1, P>(a, s) : launch_bulk<2, P>(a, s);
  }
}

}  // namespace

// tabs: int64 (n_tables, 5) on the card (cols, vals, vrow, cnt pointers and
// degree of each table); units: int32 (n_units, 2), (first virtual row,
// table | (count - 1) << 8 | atomic << 13). payload: 0 f32, 1 int8, 2 int16,
// 3 int32 rows, 4 f32 rows rounded to multiples of *safe (a float on the
// card; null otherwise), 5 bf16 rows. vec: h * sizeof(element) % 16 == 0
// and x, out 16-byte aligned (the caller checks); path (c) for bf16 rows
// and path (b) for the others where it holds, else (a).
// Returns 0 or an error code (cudaError_t, or 901: arguments refused).
extern "C" int ell_tables_add(const void* tabs, const void* units, int n_units,
                              const void* x, void* out, int h, int vec,
                              int payload, const void* safe, void* stream) {
  if (n_units <= 0 || h <= 0) return 0;
  const Args a{static_cast<const Table*>(tabs), static_cast<const int2*>(units),
               n_units, x, static_cast<const float*>(safe),
               static_cast<float*>(out), h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (payload) {
    case 0:
      return launch<AsIs>(a, vec, s);
    case 1:
      return launch<Widen<int8_t>>(a, vec, s);
    case 2:
      return launch<Widen<int16_t>>(a, vec, s);
    case 3:
      return launch<Widen<int32_t>>(a, vec, s);
    case 4:
      return safe ? launch<Quant>(a, vec, s) : 901;
    case 5:
      return launch<Bf16>(a, vec, s);
    default:
      return 901;
  }
}
