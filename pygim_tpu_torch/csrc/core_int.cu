// K-int: int8 staircase bands x integer payload, exact int32 product
// (mod 2^32), scatter-added as f32, all bands of one SpMM in one persistent
// launch.
//
// Replaces the XLA bodies of pygim_tpu/ops/spmm.py:_core_matmul's s8 branch
// (dot(int8 band, int8 xc) -> int32, :598-600) and _wide_int_core_dot
// (:520-568, the wrapped int32 product of an int8 band with an int16 or
// int32 payload), with the scatter of _core_scatter
// (out.at[core_nodes[lo:hi]].add(f32(P))). For every band b = (lo, hi, w):
//
//     P[i, :] = sum_{j < w} band_b[i, j] * q[j, :]      (int32, wraps)
//     out[nodes[lo + i], :] += f32(P[i, :])
//
// The payload q (w_max x h) comes as L int8 limbs, q = sum_l 2^(8l) * limb_l
// (mod 2^32; ops/core_int.py:limb_split), stored K-major as xcT
// (L, h_pad, k_pad) int8: limb l of q[j, n] sits at xcT[l, n, j], rows past h
// and columns past w_max are zero. Every step below is a ring homomorphism
// mod 2^32, so P = sum_l (band @ limb_l) << 8l, summed in uint32, is the
// reference's wrapped int32 product bit for bit, also where one limb's own
// int32 sum wraps. The wgmma runs without .satfinite: saturation would
// break that.
//
// Contract (the wrapper checks it): band widths w % 16 == 0 (the TMA row
// stride is w bytes), h_pad % 64 == 0, k_pad % 16 == 0, 16-byte aligned
// bands and xcT, at most MAX_BANDS bands a launch; any h (16-byte stores
// where vec is set: h % 4 == 0 and out 16-byte aligned).
//
// What bounds it on an H100 SXM: per band 2 * r * w * h * L int8 tensor
// operations against r * w band bytes (plus the output rows, read and
// written once): at h = 256 the s8 rate (1,979 TOP/s) puts L = 1 under the
// bytes and L = 3 (the int32 path) over them. Inside the card a tile
// streams its whole contraction through the L2 into shared memory: at
// L >= 3 a 128 x 64-column tile takes 8 KB of band and 64 * L * 64 bytes
// of limbs per 64-deep stage.
//
// What the design does about it:
// - wgmma m64nNk32 .s32.s8.s8, both operands K-major from shared memory
//   (an 8-bit wgmma has no transpose, hence the K-major xcT); the band is
//   read by TMA as stored (row-major (r, w) is K-major already), never
//   widened.
// - The limbs lie along N in blocks of 64 columns: block g * L + l holds
//   limb l of the tile's output columns 64g..64g + 63. One B stage carries
//   every limb of the tile, A is read once for all limbs, and wgmma's
//   accumulator layout (column 8i + 2 * (lane % 4) + {0, 1}) keeps all limbs
//   of an output element in one thread, so the recombination is in
//   registers. N = 256 (L = 1, 2, 4: 256, 128 and 64 output columns a tile)
//   or 192 (L = 3: 64 columns).
// - At four limbs two blocks form a thread block cluster and share the limb
//   stage: they compute row tiles m0 and m0 + 128 of the same column tile
//   of one band, and each loads half of every 64-row limb block, multicast
//   by TMA (.multicast::cluster) into both, so a block's L2 reads of limbs
//   per stage halve (cluster_rows: measured faster at four limbs only,
//   PERF.md; one to three limbs run single blocks).
//   The clusters, not the blocks, walk a host-built, longest-first list of
//   (band, m0, n0) (ops/core_int.py:cluster_schedule), in lockstep over
//   the same (band, contraction) sequence; a block whose rows lie past the
//   band's end still takes part (it consumes every stage and releases it)
//   and stores nothing.
// - The ring is STAGES deep: one producer thread a block issues its band
//   box (K-core's band maps, core_dot.cu:core_encode_band_map: 64 x 128,
//   64-byte swizzle; not loaded where the rows lie wholly past the band)
//   and its share of the limb stage, and arrives on the full barrier of
//   every block of its cluster with the bytes it sends there (remote
//   arrivals through mapa), so each block's stage waits for both writers;
//   a stage is refilled when every consumer warp of every block that reads
//   it has arrived on the issuing block's empty barrier. Together the two
//   keep the blocks of a cluster within one ring of each other. The zero
//   fill takes the ragged row and contraction edges. A wait that does not
//   complete within about 2 s traps, so a deadlock fails the launch
//   instead of hanging the card.
// - Two consumer warpgroups of 64 band rows each; a consumer keeps one
//   stage's wgmmas in flight while it waits for the next stage, and
//   releases a stage when its products have retired. Whole contractions,
//   so the epilogue needs no atomics.
// - The epilogue recombines the limbs, converts to f32 (round to nearest,
//   as XLA's convert), stages each 64-column slice through shared memory
//   and adds it into out[nodes[lo + i], :] along each row, every row's load
//   issued before any store.

#include <string.h>

#include "tma.cuh"

namespace {

constexpr int MAX_BANDS = 16;
constexpr int BM = 128;           // band rows per tile (2 warpgroups x 64)
constexpr int BK = 64;            // contraction per ring stage (bytes = k)
constexpr int THREADS = 384;      // consumer WG 0, 1; producer WG 2
constexpr int CONSUMER_WARPS = 8;
constexpr int STAGES = 6;
constexpr int A_STAGE = BM * BK;  // int8, 64-byte swizzle
constexpr int B_STAGE = 256 * BK; // up to N = 256 rows (n) x BK int8
constexpr int EPI_LD = 72;          // f32 row stride of staging
constexpr int EPI_WG = 64 * EPI_LD * 4;
constexpr int OFF_A = 0;
constexpr int OFF_B = OFF_A + STAGES * A_STAGE;
constexpr int OFF_EPI = OFF_B + STAGES * B_STAGE;
constexpr int OFF_BAR = OFF_EPI + 2 * EPI_WG;
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8 + 1024;  // + alignment

// Row tiles (blocks) of a cluster at `limbs`: two at four limbs, one
// elsewhere (ops/core_int.py:CLUSTER_ROWS holds the same).
__host__ __device__ constexpr int cluster_rows(int limbs) {
  return limbs == 4 ? 2 : 1;
}

struct __align__(64) Params {
  CUtensorMap band[MAX_BANDS];
  CUtensorMap xct;
  int lo[MAX_BANDS], r[MAX_BANDS], w[MAX_BANDS];
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return v;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Wait for phase `parity` of an mbarrier; trap after about 2^32 cycles
// (~2 s), so a stage that never completes fails the launch instead of
// hanging the card. One asm block: no branch of the C++ code around it.
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " .reg .u64 t0, t1;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra.uni DONE;\n"
      " mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra.uni DONE;\n"
      " mov.u64 t1, %%clock64;\n"
      " sub.u64 t1, t1, t0;\n"
      " setp.gt.u64 p, t1, 4294967296;\n"
      " @p trap;\n"
      " bra.uni WAIT;\n"
      "DONE:\n"
      "}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of the mbarrier at this CTA-relative
// address in block `cta` of the cluster.
__device__ __forceinline__ uint32_t in_block(uint32_t bar, uint32_t cta) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra)
               : "r"(bar), "r"(cta));
  return ra;
}

// arrive on a barrier of a block of the cluster (in_block address)
__device__ __forceinline__ void arrive_at(uint32_t ra) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(ra)
               : "memory");
}

// the same, expecting `bytes` more to land on it
__device__ __forceinline__ void expect_at(uint32_t ra, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cluster.b64 _, [%0], %1;" ::"r"(ra),
      "r"(bytes)
      : "memory");
}

// One 2-D TMA box into the same CTA-relative address of every block in
// `mask` (bit = cluster rank), completing on each one's barrier at `bar`.
__device__ __forceinline__ void tma_load_mc(uint32_t dst, const CUtensorMap* map,
                                           int c0, int c1, uint32_t bar,
                                           uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"(mask)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major int8 operand in 64-byte
// rows, 64-byte swizzle: SBO = 8 rows x 64 B between 8-row groups (LBO is
// unused for swizzled K-major layouts); both in 16-byte units. Adding 2
// advances 32 bytes (one k32 step) inside the swizzle atom.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

#define R8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64 x 256] (s32) += A[64 x 32] @ B[32 x 256], both s8 and K-major in
// shared memory (descriptors); integer products wrap mod 2^32
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56), R8(64), R8(72), R8(80), R8(88), R8(96), R8(104), R8(112), R8(120)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 192] (s32) += A[64 x 32] @ B[32 x 192], both s8 and K-major in
// shared memory (descriptors); integer products wrap mod 2^32
__device__ __forceinline__ void wgmma_s8_n192(int* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p;\n"
      "}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56), R8(64), R8(72), R8(80), R8(88)
      : "l"(da), "l"(db), "r"(1));
}
#undef R8

template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  if constexpr (N == 256)
    wgmma_s8_n256(d, da, db);
  else
    wgmma_s8_n192(d, da, db);
}

template <int L>
__global__ void __launch_bounds__(THREADS, 1)
core_int_kernel(const __grid_constant__ Params p, const int4* __restrict__ tiles,
                const int* __restrict__ starts, const int* __restrict__ nodes,
                float* __restrict__ out, int h, int h_pad, int vec) {
  constexpr int N = L == 3 ? 192 : 256;  // wgmma width: L limbs x G blocks
  constexpr int G = N / (64 * L);        // 64-column output blocks a tile
  constexpr int NACC = N / 2;            // s32 accumulators a thread
  constexpr int CM = cluster_rows(L);    // blocks a cluster
  constexpr bool CLUSTER = CM > 1;
  constexpr int B_ROWS = 64 / CM;        // a block's rows of a limb block

  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle patterns are address-based: align the ring to 1024 B
  // (the same offset in every block, as multicast needs)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t full0 = s_base + OFF_BAR;
  const uint32_t empty0 = full0 + STAGES * 8;
  // this block's rank in its cluster: it takes row tile m0 + 128 * rank
  const uint32_t rank = CLUSTER ? cluster_rank() : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // each block's producer arrives on each stage once, with its bytes,
      // and each consumer warp of each block releases it once
      mbar_init(full0 + 8 * s, CM);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS * CM);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  // every block's barriers exist before the other uses them
  if constexpr (CLUSTER)
    cluster_sync();
  else
    __syncthreads();

  const int c = CLUSTER ? cluster_index() : blockIdx.x;
  const int t_begin = starts[c], t_end = starts[c + 1];
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    // ---- producer: one thread issues this block's part of each stage ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    if (threadIdx.x == 256) {
      // every block's full barriers (stage 0), this block's included
      uint32_t full_of[CM];
#pragma unroll
      for (int i = 0; i < CM; ++i)
        full_of[i] = CLUSTER ? in_block(full0, i) : full0;
      int stage = 0;
      uint32_t phase = 0;
      // this block's share of each 64-row limb block: rows rank * B_ROWS..
      // (the xcT map's boxes are B_ROWS high)
      const uint32_t b_dst = s_base + OFF_B + rank * B_ROWS * BK;
      for (int t = t_begin; t < t_end; ++t) {
        const int4 tile = tiles[t * CM + rank];  // band, m0, n0, live
        const int b = tile.x, m0 = tile.y, n0 = tile.z;
        // rows wholly past the band's end are not loaded (never stored)
        const uint32_t a_bytes = m0 < p.r[b] ? A_STAGE : 0;
        const int nq = max(0, min(G, (h - n0 + 63) / 64)) * L;
        const uint32_t b_bytes = nq * B_ROWS * BK;
        // block q = g * L + l of the limb stage: limb l of output columns
        // n0 + 64 g
        int brow[G * L];
#pragma unroll
        for (int q = 0; q < G * L; ++q)
          brow[q] = (q % L) * h_pad + n0 + 64 * (q / L) + rank * B_ROWS;
        const CUtensorMap* amap = &p.band[b];
        const int w = p.w[b];
        for (int k0 = 0; k0 < w; k0 += BK) {
          const uint32_t full = full0 + 8 * stage;
          wait_or_trap(empty0 + 8 * stage, phase ^ 1);
          if constexpr (CLUSTER) {
            // both blocks' stages wait for this producer: its limb share
            // lands in both, its band box in its own
#pragma unroll
            for (int i = 0; i < CM; ++i)
              expect_at(full_of[i] + 8 * stage,
                        (i == rank ? a_bytes : 0) + b_bytes);
          } else {
            mbar_expect_tx(full, a_bytes + b_bytes);
          }
          if (a_bytes)
            tma_load_2d(s_base + OFF_A + stage * A_STAGE, amap, k0, m0, full);
#pragma unroll
          for (int q = 0; q < G * L; ++q) {
            if (q >= nq) break;
            const uint32_t dst = b_dst + stage * B_STAGE + q * 64 * BK;
            if constexpr (CLUSTER)
              tma_load_mc(dst, &p.xct, k0, brow[q], full, (1u << CM) - 1);
            else
              tma_load_2d(dst, &p.xct, k0, brow[q], full);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: wgmma on a 64 x N half of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    float* epi = reinterpret_cast<float*>(smem + OFF_EPI + wg * EPI_WG);
    // lane k < CM of each warp releases a stage in block k
    const bool signals = lane < CM;
    const uint32_t empty_k = CLUSTER && signals ? in_block(empty0, lane) : 0;
    int stage = 0;
    uint32_t phase = 0;

    for (int t = t_begin; t < t_end; ++t) {
      const int4 tile = tiles[t * CM + rank];
      const int b = tile.x, m0 = tile.y, n0 = tile.z;
      const int r = p.r[b], lo = p.lo[b], w = p.w[b];
      int acc[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = 0;

      int held = -1;  // the stage whose wgmmas may still run
      for (int k0 = 0; k0 < w; k0 += BK) {
        wait_or_trap(full0 + 8 * stage, phase);
        const uint64_t da =
            kmajor_desc(s_base + OFF_A + stage * A_STAGE + wg * 64 * BK);
        const uint64_t db = kmajor_desc(s_base + OFF_B + stage * B_STAGE);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        wgmma_s8<N>(acc, da, db);
        wgmma_s8<N>(acc, da + 2, db + 2);  // the second 32 bytes of k
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // the previous stage's group has retired: its stage is free
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (held >= 0 && signals) {
          if constexpr (CLUSTER)
            arrive_at(empty_k + 8 * held);
          else
            mbar_arrive(empty0 + 8 * held);
        }
        held = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (held >= 0 && signals) {
        if constexpr (CLUSTER)
          arrive_at(empty_k + 8 * held);
        else
          mbar_arrive(empty0 + 8 * held);
      }
      if (!tile.w) continue;  // rows past the band

      // ---- epilogue: out[nodes[lo + row], n0 + col] += f32(P) ----
      int ids[8];  // output rows of this thread's epilogue reads
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = m0 + 64 * wg + (tid >> 4) + 8 * k;
        ids[k] = row < r ? nodes[lo + row] : -1;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (n0 + 64 * g >= h) break;
        named_bar_sync(1 + wg);  // the previous slice's readers are done
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t v = 0;
#pragma unroll
            for (int l = 0; l < L; ++l)
              v += static_cast<uint32_t>(acc[32 * (g * L + l) + 4 * j + e])
                   << (8 * l);
            f[e] = __int2float_rn(static_cast<int>(v));
          }
          const int col = 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(epi + (16 * warp + g8) * EPI_LD + col) =
              make_float2(f[0], f[1]);
          *reinterpret_cast<float2*>(epi + (16 * warp + g8 + 8) * EPI_LD + col) =
              make_float2(f[2], f[3]);
        }
        named_bar_sync(1 + wg);
        const int col = n0 + 64 * g + 4 * (tid & 15);
        if (col >= h) continue;
        float4 s[8], v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          s[k] = *reinterpret_cast<const float4*>(
              epi + ((tid >> 4) + 8 * k) * EPI_LD + 4 * (tid & 15));
        if (vec) {  // h % 4 == 0: the whole float4 is inside
          // all eight loads in flight before any store
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (ids[k] >= 0)
              v[k] = *reinterpret_cast<const float4*>(
                  out + static_cast<int64_t>(ids[k]) * h + col);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (ids[k] < 0) continue;
            v[k].x += s[k].x;
            v[k].y += s[k].y;
            v[k].z += s[k].z;
            v[k].w += s[k].w;
            *reinterpret_cast<float4*>(
                out + static_cast<int64_t>(ids[k]) * h + col) = v[k];
          }
        } else {  // ragged or unaligned: element by element
          const int n = h - col;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (ids[k] < 0) continue;
            float* o = out + static_cast<int64_t>(ids[k]) * h + col;
            o[0] += s[k].x;
            if (n > 1) o[1] += s[k].y;
            if (n > 2) o[2] += s[k].z;
            if (n > 3) o[3] += s[k].w;
          }
        }
      }
    }
  }
  // the other block arrives on this block's barriers until its last stage
  if constexpr (CLUSTER) cluster_sync();
}

// The launch configuration of n_clusters clusters of the `L` kernel.
template <int L>
struct Launch {
  cudaLaunchAttribute attr{};
  cudaLaunchConfig_t cfg{};
  Launch(int n_clusters, cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster_rows(L);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(n_clusters * cluster_rows(L));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

template <int L>
int max_clusters(int* n) {
  cudaError_t e = cudaFuncSetAttribute(
      core_int_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch<L> l(1, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(n, core_int_kernel<L>, &l.cfg));
}

template <int L>
int launch(const Params& p, const void* tiles, const void* starts,
           int n_clusters, const void* nodes, void* out, int h, int h_pad,
           int vec, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      core_int_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch<L> l(n_clusters, stream);
  if (cluster_rows(L) == 1) l.cfg.numAttrs = 0;  // single blocks
  e = cudaLaunchKernelEx(&l.cfg, core_int_kernel<L>, p,
                         static_cast<const int4*>(tiles),
                         static_cast<const int*>(starts),
                         static_cast<const int*>(nodes),
                         static_cast<float*>(out), h, h_pad, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most clusters (cluster_rows(limbs) blocks each) of the `limbs`
// kernel the current card runs at once, into *n. Returns 0 or an error
// code.
extern "C" int core_int_max_clusters(int limbs, int* n) {
  switch (limbs) {
    case 1:
      return max_clusters<1>(n);
    case 2:
      return max_clusters<2>(n);
    case 3:
      return max_clusters<3>(n);
    case 4:
      return max_clusters<4>(n);
    default:
      return ERR_ARGS;
  }
}

// One launch over all bands: `band_maps` holds n_bands maps encoded by
// core_dot.cu:core_encode_band_map (host), `band_info` (lo, r, w) per band
// (host); xct is the (limbs, h_pad, k_pad) int8 limb payload; `tiles`
// (int32 (n_tiles, cluster_rows(limbs), 4): each block's band, m0, n0 and
// live flag per cluster tile, in cluster-rank order) and `starts`
// (n_clusters + 1 offsets into the cluster tiles, one segment per
// cluster) are on the device. vec: h % 4 == 0 and out 16-byte aligned.
// Returns 0 or an error code (cudaError_t, or the codes of tma.cuh).
extern "C" int core_int_scatter_add(const void* band_maps, const int* band_info,
                                    int n_bands, const void* xct,
                                    long long k_pad, int h_pad, int limbs,
                                    const void* tiles, const void* starts,
                                    int n_clusters, const void* nodes,
                                    void* out, int h, int vec, void* stream) {
  if (n_bands < 1 || n_bands > MAX_BANDS || n_clusters < 1 || h < 1 ||
      h_pad % 64 || h_pad < h || k_pad % 16 || limbs < 1 || limbs > 4)
    return ERR_ARGS;
  Params p;
  memset(&p, 0, sizeof p);
  memcpy(p.band, band_maps, n_bands * sizeof(CUtensorMap));
  for (int i = 0; i < n_bands; ++i) {
    p.lo[i] = band_info[3 * i];
    p.r[i] = band_info[3 * i + 1];
    p.w[i] = band_info[3 * i + 2];
  }
  int err = encode_2d(&p.xct, CU_TENSOR_MAP_DATA_TYPE_UINT8, xct, k_pad,
                      static_cast<long long>(limbs) * h_pad, k_pad, BK,
                      64 / cluster_rows(limbs), CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 1:
      return launch<1>(p, tiles, starts, n_clusters, nodes, out, h, h_pad,
                       vec, s);
    case 2:
      return launch<2>(p, tiles, starts, n_clusters, nodes, out, h, h_pad,
                       vec, s);
    case 3:
      return launch<3>(p, tiles, starts, n_clusters, nodes, out, h, h_pad,
                       vec, s);
    default:
      return launch<4>(p, tiles, starts, n_clusters, nodes, out, h, h_pad,
                       vec, s);
  }
}
