// K-rows: the row-sorted gather-weight-sum of the blocked and coo
// backends, one launch over a backend's whole tables.
//
// Replaces two XLA bodies of the reference, each a lax.scan of jnp.take
// plus jax.ops.segment_sum:
//   blocked  pygim_tpu/ops/spmm.py:blocked_spmm (136-161): per row block b,
//            take(x, colind[b]) * vals[b] summed into the block's rows_pad
//            padded rows at rowloc[b], then a take of every row's slot
//            (row_slot) out of the (n_blocks * rows_pad, h) padded output;
//   coo      the coo backend's run (pygim_tpu/ops/spmm.py:1883-1897): per
//            chunk of the row-sorted edges, take(x, cols) * vals added by
//            row into the output; a row may straddle chunks.
// Both compute, for every output row r,
//
//     out[r, :] = sum over the row's stored entries e of  val[e] * x[col[e], :]
//
// in the accumulation dtype of ops/reference.py:accum_dtype: f32 (Acc =
// float) wherever the weights or the payload are float, the product
// rounded and then added as the reference's multiply and segment_sum do;
// int32 wrapping (Acc = uint32_t: unsigned products and sums, whose wrap
// is defined, reinterpreted by the caller) for integer weights times an
// integer payload.
//
// The tables are the backends' own, read in place (ops/seg_rows.py):
//   blocked  cols = colind, vals, keys = rowloc, all (n_blocks, nnz_pad);
//            the entry e of block b = e / nnz_pad lands in row
//            inv[b * rows_pad + rowloc[e]], inv the inverse of row_slot
//            built on the host at prepare. Entries whose slot holds no row
//            (the pads of a block with fewer than rows_pad rows) are in no
//            unit; a full block's pads (col 0, val 0) join its last row,
//            so 0 * x[0] spreads a non-finite x[0] there, as the reference
//            (the plan walks one of them: the same term again changes
//            nothing, and a row-balanced plan pads every block to the
//            densest one's entries);
//   coo      cols, vals, keys = rows, (n_chunks, chunk_nnz) read as one
//            flat stream, the row of entry e being keys[e] (inv null), the
//            pads (row nrows - 1, col 0, val 0) summed as stored.
// The host plan (ops/seg_rows.py:plan_units) cuts the rows into units:
// int4 (first entry, entries, first row, rows | atomic << 30). A plain
// unit owns its rows: it writes each of them once, its sum or zeros for a
// row without entries, so the output needs no zeroing pass. A row longer
// than a unit (a hub) is cut into pieces, each a unit flagged atomic that
// adds its partial sum with atomics into the row, zeroed first by a small
// kernel over the plan's hub rows. Integer atomic adds are exact in any
// order, so the integer product stays equal to the plain version's.
//
// What bounds it on an H100: bytes. Each entry moves one x row slice (1
// KiB at h = 256 in f32) chosen by an index that must be read first, and
// does 2h operations, far below the card's operations per byte; every
// output row is written once. x is larger than the 50 MB L2 on the graphs
// this path serves. What the design does about it (K-tail's lessons,
// csrc/ell_tail.cu):
// - one warp a unit, four a block, the units with the most entries first;
//   a grid row per slab of h (256 columns at 16-byte loads), so any h >= 1
//   runs;
// - each lane loads one entry's column, weight and row (the inverse slot
//   map read here, once an entry), 32 entries at a time, coalesced; the
//   next 32 are loaded before the current ones are used, and the warp
//   broadcasts each entry by shuffle;
// - x rows: a batch of rows' loads issued before any is used (2 at
//   16 bytes a lane, Vec4, where h % 4 == 0 and x and out are aligned;
//   4 at one element a lane elsewhere): few registers, so many warps an
//   SM keep rows in flight;
// - the sums stay in registers and each row is stored once; only the
//   pieces of a hub row use atomics.
// K-tail's shared-memory ring of bulk x row copies (its path (b)) was
// carried over and ran slower here (PERF.md): its waits and one-lane
// copy issues come once an entry, and every entry here is a new row of
// x. K-tail's entries, like these, stay in registers.
// Staged panels were built and measured slower too (PERF.md): panels of
// consecutive plain units of about 4,096 entries, each panel's x rows
// read by two or more of its entries (at most 256) staged once a
// 64-column slab into shared memory by a block of 8 warps that then
// walked the panel's units from the stage. On the graphs this path
// serves few x rows repeat within a panel that fits an SM (a sixth of
// the stand-in's row reads came from a stage), and the stage's blocks
// left too few warps resident: 2.3 to 2.8 times the walk's time.
// Summation order: a row's entries in stream order within a unit, then
// the pieces of a hub row in no fixed order — f32 results differ from the
// plain version only in summation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;  // units (one a warp) per block
// x rows a warp loads before using any, at 16-byte and at scalar loads:
// few registers, so many resident warps keep rows in flight (PERF.md has
// the times of other batches and of 8 warps a block)
constexpr int BATCH_VEC = 2;
constexpr int BATCH_SCALAR = 4;
constexpr unsigned FULL = 0xffffffffu;

// four consecutive elements of a row, as one load
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// One load of T (a Vec4 or a scalar element) through the read-only path:
// the built-in type of its size, reinterpreted.
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  T v;
  if constexpr (sizeof(T) == 16)
    *reinterpret_cast<uint4*>(&v) = __ldg(reinterpret_cast<const uint4*>(p));
  else if constexpr (sizeof(T) == 8)
    *reinterpret_cast<uint2*>(&v) = __ldg(reinterpret_cast<const uint2*>(p));
  else if constexpr (sizeof(T) == 4)
    *reinterpret_cast<unsigned int*>(&v) =
        __ldg(reinterpret_cast<const unsigned int*>(p));
  else if constexpr (sizeof(T) == 2)
    *reinterpret_cast<unsigned short*>(&v) =
        __ldg(reinterpret_cast<const unsigned short*>(p));
  else
    *reinterpret_cast<unsigned char*>(&v) =
        __ldg(reinterpret_cast<const unsigned char*>(p));
  return v;
}

// one payload element as the accumulation type (uint16_t: bf16 bits)
template <typename Acc, typename X>
__device__ __forceinline__ Acc widen(X v) {
  if constexpr (std::is_same_v<Acc, float>) {
    if constexpr (std::is_same_v<X, float>)
      return v;
    else if constexpr (std::is_same_v<X, uint16_t>)
      return __uint_as_float(static_cast<uint32_t>(v) << 16);  // bf16, exact
    else
      return static_cast<float>(v);  // round to nearest, as XLA's convert
  } else {
    return static_cast<uint32_t>(static_cast<int32_t>(v));
  }
}

// val_code: 0 f32, 1 int32, 2 int16, 3 int8 weights
template <typename Acc>
__device__ __forceinline__ Acc load_val(const void* vals, int code,
                                        int64_t e) {
  if constexpr (std::is_same_v<Acc, float>) {
    switch (code) {
      case 0:
        return __ldg(static_cast<const float*>(vals) + e);
      case 1:
        return static_cast<float>(__ldg(static_cast<const int32_t*>(vals) + e));
      case 2:
        return static_cast<float>(__ldg(static_cast<const int16_t*>(vals) + e));
      default:
        return static_cast<float>(
            __ldg(static_cast<const signed char*>(vals) + e));
    }
  } else {
    switch (code) {
      case 1:
        return static_cast<uint32_t>(__ldg(static_cast<const int32_t*>(vals) + e));
      case 2:
        return static_cast<uint32_t>(static_cast<int32_t>(
            __ldg(static_cast<const int16_t*>(vals) + e)));
      default:
        return static_cast<uint32_t>(static_cast<int32_t>(
            __ldg(static_cast<const signed char*>(vals) + e)));
    }
  }
}

// acc += w * x: the product rounded, then the sum (no contraction), or
// the wrapping unsigned product and sum
__device__ __forceinline__ void mac(float& acc, float w, float x) {
  acc = __fadd_rn(acc, __fmul_rn(w, x));
}
__device__ __forceinline__ void mac(uint32_t& acc, uint32_t w, uint32_t x) {
  acc += w * x;
}

__device__ __forceinline__ void atomic_to(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_to(uint32_t* p, uint32_t v) {
  atomicAdd(reinterpret_cast<unsigned int*>(p), v);
}

struct Args {
  const int4* units;
  int n_units;
  const int32_t* cols;
  const void* vals;
  int val_code;
  const int32_t* keys;
  const int32_t* inv;  // blocked: the inverse slot map; coo: null
  long long nnz_pad;   // blocked: entries a block
  int rows_pad;        // blocked: slots a block
  const void* x;
  void* out;
  int h;
};

// One entry a lane: its x row, weight and output row.
template <typename Acc>
struct Entry {
  int col;
  Acc val;
  int row;
};

template <typename Acc>
__device__ __forceinline__ Entry<Acc> fetch(const Args& a, int64_t e0,
                                            int n, int q,
                                            const int32_t* inv) {
  Entry<Acc> E;
  E.col = 0;
  E.val = Acc(0);
  E.row = -1;
  if (q < n) {
    const int64_t e = e0 + q;
    E.col = __ldg(a.cols + e);
    E.val = load_val<Acc>(a.vals, a.val_code, e);
    const int key = __ldg(a.keys + e);
    E.row = inv ? __ldg(inv + key) : key;
  }
  return E;
}

// W: elements a lane holds per group (4 for Vec4 loads, 1 for scalars);
// NJ groups a lane; a slab is 32 * NJ * W columns.
template <typename X, typename Acc, int NJ, int W>
__global__ void __launch_bounds__(WARPS * 32)
seg_rows_kernel(Args a) {
  using In = std::conditional_t<W == 4, Vec4<X>, X>;
  using Out = std::conditional_t<W == 4, Vec4<Acc>, Acc>;
  constexpr int SLAB = 32 * NJ * W;
  constexpr int BATCH = W == 4 ? BATCH_VEC : BATCH_SCALAR;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (u >= a.n_units) return;
  const int4 U = __ldg(a.units + u);
  const int64_t e0 = static_cast<uint32_t>(U.x);
  const int n = U.y;
  const int r_lo = U.z;
  const int r_end = r_lo + (U.w & 0x3fffffff);
  const bool atomic = (U.w >> 30) & 1;
  const int h = a.h;
  const int col0 = blockIdx.y * SLAB;
  const int32_t* inv =
      a.inv ? a.inv + (e0 / a.nnz_pad) * static_cast<int64_t>(a.rows_pad)
            : nullptr;
  bool live[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) live[j] = col0 + W * (lane + 32 * j) < h;
  const X* x = static_cast<const X*>(a.x);
  Acc* out = static_cast<Acc*>(a.out);

  Acc acc[NJ][W];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[j][w] = Acc(0);

  auto store_row = [&](int row, bool add) {
    Acc* o = out + static_cast<int64_t>(row) * h + col0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (!live[j]) continue;
      Acc* p = o + W * (lane + 32 * j);
      if (add) {
#pragma unroll
        for (int w = 0; w < W; ++w) atomic_to(p + w, acc[j][w]);
      } else {
        Out v;
        if constexpr (W == 4) {
#pragma unroll
          for (int w = 0; w < 4; ++w) v.v[w] = acc[j][w];
        } else {
          v = acc[j][0];
        }
        *reinterpret_cast<Out*>(p) = v;
      }
    }
  };
  auto zero_row = [&](int row) {
    Acc* o = out + static_cast<int64_t>(row) * h + col0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (!live[j]) continue;
      Out v;
      if constexpr (W == 4) {
#pragma unroll
        for (int w = 0; w < 4; ++w) v.v[w] = Acc(0);
      } else {
        v = Acc(0);
      }
      *reinterpret_cast<Out*>(o + W * (lane + 32 * j)) = v;
    }
  };

  int cur = -1;      // the row the sums belong to
  int next = r_lo;   // the first row of the unit not yet written
  Entry<Acc> E = fetch<Acc>(a, e0, n, lane, inv);
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int m = min(32, n - c0);
    const Entry<Acc> N = fetch<Acc>(a, e0, n, c0 + 32 + lane, inv);
    for (int b = 0; b < m; b += BATCH) {
      In xv[BATCH][NJ];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int col = __shfl_sync(FULL, E.col, b + k);
        const In* xr = reinterpret_cast<const In*>(
            x + static_cast<int64_t>(col) * h + col0);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (b + k < m && live[j]) xv[k][j] = ldg(xr + lane + 32 * j);
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int row = __shfl_sync(FULL, E.row, b + k);
        const Acc wgt = __shfl_sync(FULL, E.val, b + k);
        if (b + k >= m) continue;  // the same for every lane
        if (row != cur) {
          if (cur >= 0) store_row(cur, false);
          if (!atomic)
            for (int r = next; r < row; ++r) zero_row(r);
          next = row + 1;
          cur = row;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int w = 0; w < W; ++w) acc[j][w] = Acc(0);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (!live[j]) continue;
          if constexpr (W == 4) {
#pragma unroll
            for (int w = 0; w < 4; ++w)
              mac(acc[j][w], wgt, widen<Acc>(xv[k][j].v[w]));
          } else {
            mac(acc[j][0], wgt, widen<Acc>(xv[k][j]));
          }
        }
      }
    }
    E = N;
  }
  if (cur >= 0) store_row(cur, atomic);
  if (!atomic)
    for (int r = next; r < r_end; ++r) zero_row(r);
}

// Zero the hub rows (the rows whose pieces add atomically), 4 bytes an
// element whatever the accumulation type.
__global__ void zero_rows_kernel(const int32_t* __restrict__ rows, int n,
                                 uint32_t* __restrict__ out, int h) {
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    uint32_t* o = out + static_cast<int64_t>(__ldg(rows + i)) * h;
    for (int c = threadIdx.x; c < h; c += blockDim.x) o[c] = 0u;
  }
}

template <typename X, typename Acc, int NJ, int W>
int launch_one(const Args& a, cudaStream_t s) {
  constexpr int SLAB = 32 * NJ * W;
  const dim3 grid((a.n_units + WARPS - 1) / WARPS, (a.h + SLAB - 1) / SLAB);
  seg_rows_kernel<X, Acc, NJ, W><<<grid, WARPS * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename Acc>
int launch(const Args& a, int vec, cudaStream_t s) {
  if (vec) return a.h <= 128 ? launch_one<X, Acc, 1, 4>(a, s)
                             : launch_one<X, Acc, 2, 4>(a, s);
  return a.h <= 64 ? launch_one<X, Acc, 2, 1>(a, s)
                   : launch_one<X, Acc, 8, 1>(a, s);
}

}  // namespace

// units: int32 (n_units, 4) on the card; hub: int32 (n_hub,) rows zeroed
// first; cols, keys: int32 and vals (val_code: 0 f32, 1 int32, 2 int16,
// 3 int8) of the flat stream; inv: blocked's inverse slot map (int32,
// n_blocks * rows_pad) or null for coo; x (x_code: 0 f32, 1 bf16, 2 int8,
// 3 int16, 4 int32) and out (f32, or int32 where int_acc) row-major of
// width h. vec: h % 4 == 0 and x, out aligned to four elements (the
// caller checks). Returns 0 or an error code (cudaError_t, or 901:
// arguments refused).
extern "C" int seg_rows(const void* units, int n_units, const void* hub,
                        int n_hub, const void* cols, const void* vals,
                        int val_code, const void* keys, const void* inv,
                        long long nnz_pad, int rows_pad, const void* x,
                        int x_code, int int_acc, void* out, int h, int vec,
                        void* stream) {
  if (h <= 0) return 0;
  if (val_code < 0 || val_code > 3 || (int_acc && val_code == 0) ||
      (int_acc && x_code < 2) || (inv && nnz_pad <= 0))
    return 901;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_hub > 0) {
    zero_rows_kernel<<<n_hub < 1024 ? n_hub : 1024, 256, 0, s>>>(
        static_cast<const int32_t*>(hub), n_hub, static_cast<uint32_t*>(out),
        h);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_units <= 0) return 0;
  const Args a{static_cast<const int4*>(units),
               n_units,
               static_cast<const int32_t*>(cols),
               vals,
               val_code,
               static_cast<const int32_t*>(keys),
               static_cast<const int32_t*>(inv),
               nnz_pad,
               rows_pad,
               x,
               out,
               h};
  if (int_acc) {
    switch (x_code) {
      case 2:
        return launch<int8_t, uint32_t>(a, vec, s);
      case 3:
        return launch<int16_t, uint32_t>(a, vec, s);
      case 4:
        return launch<int32_t, uint32_t>(a, vec, s);
      default:
        return 901;
    }
  }
  switch (x_code) {
    case 0:
      return launch<float, float>(a, vec, s);
    case 1:
      return launch<uint16_t, float>(a, vec, s);
    case 2:
      return launch<int8_t, float>(a, vec, s);
    case 3:
      return launch<int16_t, float>(a, vec, s);
    case 4:
      return launch<int32_t, float>(a, vec, s);
    default:
      return 901;
  }
}
