// K-core: hub-core bands (int8, int4 nibble-packed two cells a byte, or
// bf16) x bf16 payload, f32 accumulate, scatter-add, all bands of one SpMM
// in one persistent launch.
//
// Replaces the TPU kernel pygim_tpu/ops/pallas_core.py:_dequant_core_dot
// (bf16(int8 core) @ bf16(x), f32 accumulation) together with the XLA
// scatter of its product, out.at[core_nodes[lo:hi]].add(...) in
// pygim_tpu/ops/spmm.py:_core_scatter, and in its int4 mode the packed
// branch of _core_matmul (pygim_tpu/ops/spmm.py:586-597: the nibble planes
// of _nibble_halves, dot(lo, x[0::2]) + dot(hi, x[1::2]) in bf16 with f32
// accumulation, which is one product of the unpacked band with x), and in
// its bf16 mode the bf16 branch of _core_matmul (pygim_tpu/ops/spmm.py:630:
// dot(bf16 core, bf16(x)) with f32 accumulation, the reference's default
// core on an integer graph). A square core is the one band (0, k, k). For
// every band b = (lo, hi, w) it computes
//
//     out[nodes[lo + i], :] += sum_{j < w} f32(band_b[i, j]) * f32(xc[j, :])
//
// with band_b int8 (hi - lo, w) row-major (int4 mode: uint8 (hi - lo, w / 2),
// byte j of a row holding cells 2j in its low nibble and 2j + 1 in its high
// one, each two's complement in [-8, 7]; bf16 mode: bf16 (hi - lo, w)),
// xc bf16 (>= w, h) row-major,
// nodes int32 (distinct over all bands: the staircase bands tile disjoint
// row ranges, so every output element belongs to exactly one tile and a
// whole tile needs no atomics), out f32 (N, h) row-major. Contract (the wrapper
// checks it): w % 16 == 0 (the TMA row stride is w bytes; int4: w % 32 == 0,
// the stride w / 2 bytes; bf16: w % 16 == 0, whole k16 steps, the stride
// 2w bytes), h % 8 == 0,
// 16-byte aligned operands, at most MAX_BANDS bands per launch (the wrapper
// launches once per group of MAX_BANDS bands).
//
// What bounds it on an H100 SXM: 2*r*w*h operations against r*w bytes of
// int8 band, i.e. 2*h = 512 operations per band byte at h = 256 (1024 for
// int4, 256 for bf16), above the card's ~295 bf16 operations per HBM byte:
// the bf16 tensor-core rate for int8 and int4; a bf16 band at h = 256 sits
// just under it, so its bytes bound it by a hair.
//
// What the design does about it:
// - wgmma (m64n256k16, bf16 in, f32 accumulate) is the only instruction
//   that reaches Hopper's tensor-core rate. Each block runs two consumer
//   warpgroups on a 128 x 256 output tile, 128 f32 accumulators a thread;
//   setmaxnreg moves registers from the producer warpgroup to them.
// - A comes from registers: each consumer thread reads its fragment's
//   int8 bytes from shared memory and widens them to bf16 with byte
//   permutes and one f32 add per value (exact for |v| <= 128; the band is
//   never widened in memory). In the int4 mode a stage's A box is 32 bytes
//   of 128 rows, unswizzled (a thread reads its two rows whole with two
//   16-byte loads: the eight threads of a load phase read two rows, 32
//   bytes apart, so no bank conflicts); one packed byte is the pair of
//   neighbouring k values that one bf16x2 fragment register holds, so a
//   register is one byte, its nibbles spread to the two halves as
//   136 + v in bf16 (0x4308 ^ nibble) less 136: exact, no table. B (xc)
//   is read by wgmma straight from
//   shared memory in its own row-major (K, N) layout, i.e. MN-major with
//   the transpose bit, 128-byte swizzled by TMA.
// - bf16 mode: the cells are wgmma's own type, so a thread reads its
//   fragment registers whole from the stage (128 rows x 128 bytes,
//   128-byte swizzle: the 16-byte chunk c of row i sits at c ^ (i & 7),
//   which spreads the eight rows of a load phase over all banks) and
//   nothing is widened. The A box doubles to 16 KB a stage, so the ring
//   holds 3 stages (3 x (16 + 32) KB + 36 KB of epilogue staging =
//   185 KB; 4 stages would need 233 KB, past the 227 KB a block may
//   have).
// - One producer thread keeps a 4-stage ring (3 in bf16 mode) of TMA
//   loads in flight (cp.async.bulk.tensor, mbarrier full/empty pairs).
//   TMA's zero fill
//   takes the ragged row and column edges; k16 steps past w are skipped.
// - A consumer reads and widens the next stage's A fragments while the
//   current stage's wgmmas run, then drains them (wait_group 0) and
//   releases the stage. A second group in flight (two A register sets,
//   wait_group 1) was measured slower: it holds each stage one step
//   longer, which leaves the producer two of the four stages.
// - Persistent clusters walk their share of a host-built tile list
//   (ops/core_dot.py:cluster_schedule): longest contraction first, spread
//   by a greedy longest-first assignment, so short bands fill the SMs
//   that the long ones leave idle. One launch covers every band. Where a
//   launch has few row tiles for the SMs (a square core of 180 row tiles
//   on 132 SMs), the host splits every tile's contraction into `split`
//   chunks of whole stages (2 or 4), run by the blocks of one cluster; at
//   split 1 a block is its own cluster and runs whole contractions.
// - The epilogue stages each 64-column slice of the tile through shared
//   memory and adds it into out[nodes[lo + i], n0:n0 + 256] with 16-byte
//   read-modify-writes along each row. In a split tile every block stages
//   its partial slice in its own staging buffer and hands it over on the
//   leader's (rank 0's) `ready` mbarrier; the leader reads the peers'
//   slices through distributed shared memory (mapa, ld.shared::cluster)
//   in chunk order, adds them to its own, frees the peers' buffers on
//   their `free` mbarriers and alone updates out. Every output element is
//   written by one block in a fixed order of f32 sums: no atomics, no
//   global workspace, the same bits from run to run. The hand-over waits
//   trap after about 2 s, so a lost arrival fails the launch instead of
//   hanging the card.

#include <cuda_bf16.h>
#include <string.h>

#include "tma.cuh"

namespace {

constexpr int MAX_BANDS = 16;
constexpr int BM = 128;             // band rows per tile (2 warpgroups x 64)
constexpr int BN = 256;             // output columns per tile
constexpr int BK = 64;              // contraction per ring stage
constexpr int THREADS = 384;        // consumer WG 0, 1; producer WG 2
constexpr int FIELDS = 6;           // a block's tile: band, m0, n0, live, k0, k1
constexpr int B_BOX = 64 * BK * 2;              // 64 columns x BK rows bf16
constexpr int B_STAGE = (BN / 64) * B_BOX;      // 128-byte swizzle
constexpr int EPI_LD = 72;                      // f32 row stride of staging
constexpr int EPI_WG = 64 * EPI_LD * 4;

// cell modes (the host's `mode`)
constexpr int INT8 = 0, PACKED = 1, BF16 = 2;

// The shared-memory layout of one cell mode: the A ring (int8: BM x BK
// bytes a stage, 64-byte swizzle; int4: half of that, unswizzled, in the
// same spacing; bf16: BM x BK x 2 bytes, 128-byte swizzle), the B ring,
// two warpgroups' epilogue staging, and the barriers: ring full / empty,
// then split tiles' ready / free per consumer warpgroup.
template <int MODE>
struct Layout {
  static constexpr int STAGES = MODE == BF16 ? 3 : 4;
  static constexpr int A_STAGE = MODE == BF16 ? 2 * BM * BK : BM * BK;
  static constexpr int A_BYTES = MODE == PACKED ? BM * BK / 2 : A_STAGE;
  static constexpr int OFF_A = 0;
  static constexpr int OFF_B = OFF_A + STAGES * A_STAGE;
  static constexpr int OFF_EPI = OFF_B + STAGES * B_STAGE;
  static constexpr int OFF_BAR = OFF_EPI + 2 * EPI_WG;
  static constexpr int SMEM_BYTES = OFF_BAR + (2 * STAGES + 4) * 8 + 1024;
};
static_assert(Layout<INT8>::SMEM_BYTES <= 232448, "int8 ring too large");
static_assert(Layout<BF16>::SMEM_BYTES <= 232448, "bf16 ring too large");

struct __align__(64) Params {
  CUtensorMap band[MAX_BANDS];
  CUtensorMap xc;
  int lo[MAX_BANDS], r[MAX_BANDS], w[MAX_BANDS];
};

// Shared-memory matrix descriptor of one 64-row (k) x 256-column (n) bf16
// B stage: four 64-column boxes of 64 rows x 128 bytes, 128-byte swizzle.
// MN-major: LBO = stride between 64-column boxes (8192 B), SBO = stride
// between 8-row groups (1024 B); both in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(B_BOX >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Four int8 (bytes of q) -> two bf16x2 (lo: bytes 0, 1; hi: bytes 2, 3),
// the lower byte in the lower half. 2^23 + 128 + v is exact in f32; the
// subtraction leaves v, whose bf16 is the top half of its f32.
__device__ __forceinline__ void s8x4_to_bf16x4(uint32_t q, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t x = q ^ 0x80808080u;
  const uint32_t magic = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(x, magic, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(x, magic, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(x, magic, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(x, magic, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

#define D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] += a[64 x 16] (registers, bf16) @ B[16 x 256] (shared, bf16,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_m64n256k16(float* d, const uint32_t* a,
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64),
        D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
#undef D8

// This thread's m64k16 A fragments for the four k16 steps of one stage:
// a[s] = {row g, cols 2t4..+1}, {row g+8, same}, {row g, cols 2t4+8..+9},
// {row g+8, same}, read as int8 from the 64-byte-swizzled stage and
// widened to bf16x2
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* As,
                                       int a_off0, int a_off1, int swz) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = (s ^ swz) << 4;
    const uint32_t q0 =
        *reinterpret_cast<const uint16_t*>(As + a_off0 + c) |
        (static_cast<uint32_t>(
             *reinterpret_cast<const uint16_t*>(As + a_off0 + c + 8))
         << 16);
    const uint32_t q1 =
        *reinterpret_cast<const uint16_t*>(As + a_off1 + c) |
        (static_cast<uint32_t>(
             *reinterpret_cast<const uint16_t*>(As + a_off1 + c + 8))
         << 16);
    s8x4_to_bf16x4(q0, a[s][0], a[s][2]);
    s8x4_to_bf16x4(q1, a[s][1], a[s][3]);
  }
}

// One packed byte (bits 0-7 of b: cells 2j, 2j + 1) -> bf16x2, the even
// cell in the lower half. Each half becomes 0x4300 | (nibble ^ 8), which
// is 136 + v in bf16 for the nibble's value v in [-8, 7]; one bf16x2 FMA
// takes 136 off, exactly.
__device__ __forceinline__ uint32_t nib2_to_bf16x2(uint32_t b) {
  const uint32_t t = ((b | (b << 12)) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(t), "r"(0x3F803F80u), "r"(0xC308C308u));  // t * 1 - 136
  return d;
}

// load_a for a packed stage (32 bytes a row, unswizzled): a[s] = {row g,
// cells 16s + 2t4..+1}, {row g+8, same}, {row g, cells 16s + 8 + 2t4..+1},
// {row g+8, same}, i.e. byte t4 of the row's 32-bit words 2s and 2s + 1
__device__ __forceinline__ void load_a_packed(uint32_t (&a)[4][4],
                                              const uint8_t* As, int ra,
                                              int sh) {
  const uint4* r0 = reinterpret_cast<const uint4*>(As + ra * (BK / 2));
  const uint4* r1 = reinterpret_cast<const uint4*>(As + (ra + 8) * (BK / 2));
  const uint4 p0 = r0[0], p1 = r0[1], q0 = r1[0], q1 = r1[1];
  const uint32_t w0[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
  const uint32_t w1[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = nib2_to_bf16x2((w0[2 * s] >> sh) & 0xFF);
    a[s][1] = nib2_to_bf16x2((w1[2 * s] >> sh) & 0xFF);
    a[s][2] = nib2_to_bf16x2((w0[2 * s + 1] >> sh) & 0xFF);
    a[s][3] = nib2_to_bf16x2((w1[2 * s + 1] >> sh) & 0xFF);
  }
}

// load_a for a bf16 stage (128 bytes a row, 128-byte swizzle): a[s] =
// {row g, cells 16s + 2t4..+1}, {row g+8, same}, {row g, cells 16s + 8 +
// 2t4..+1}, {row g+8, same}, i.e. bytes 32s + 4t4 and 32s + 16 + 4t4 of
// the row, the chunk index XORed with the row's low three bits (the same
// for rows g and g + 8)
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4][4],
                                            const uint8_t* As, int ra,
                                            int t4) {
  const uint8_t* r0 = As + ra * (2 * BK);
  const uint8_t* r1 = As + (ra + 8) * (2 * BK);
  const int sw = ra & 7;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c0 = (((2 * s) ^ sw) << 4) + 4 * t4;
    const int c1 = (((2 * s + 1) ^ sw) << 4) + 4 * t4;
    a[s][0] = *reinterpret_cast<const uint32_t*>(r0 + c0);
    a[s][1] = *reinterpret_cast<const uint32_t*>(r1 + c0);
    a[s][2] = *reinterpret_cast<const uint32_t*>(r0 + c1);
    a[s][3] = *reinterpret_cast<const uint32_t*>(r1 + c1);
  }
}

// this thread's A fragments of one stage, in the cell mode's way
template <int MODE>
__device__ __forceinline__ void load_stage_a(uint32_t (&a)[4][4],
                                             const uint8_t* As, int ra,
                                             int a_off0, int a_off1, int swz,
                                             int t4) {
  if constexpr (MODE == PACKED)
    load_a_packed(a, As, ra, 8 * t4);
  else if constexpr (MODE == BF16)
    load_a_bf16(a, As, ra, t4);
  else
    load_a(a, As, a_off0, a_off1, swz);
}

template <int MODE, int SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
core_bands_kernel(const __grid_constant__ Params p,
                  const int* __restrict__ tiles,
                  const int* __restrict__ starts,
                  const int* __restrict__ nodes, float* __restrict__ out,
                  int h) {
  using L = Layout<MODE>;
  constexpr int STAGES = L::STAGES, A_STAGE = L::A_STAGE, OFF_A = L::OFF_A,
                OFF_B = L::OFF_B, OFF_EPI = L::OFF_EPI, OFF_BAR = L::OFF_BAR;
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle patterns are address-based: align the ring to 1024 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_base = smem_u32(smem);
  const uint32_t full0 = s_base + OFF_BAR;
  const uint32_t empty0 = full0 + STAGES * 8;
  // split tiles, per consumer warpgroup: the peers' partials are staged
  // (the leader's barrier), the leader has read this block's (a peer's)
  const uint32_t ready0 = empty0 + STAGES * 8;
  const uint32_t free0 = ready0 + 2 * 8;
  // this block's chunk of each tile of its cluster; rank 0 leads
  const uint32_t rank = SPLIT > 1 ? cluster_rank() : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    for (int g = 0; g < 2; ++g) {
      mbar_init(ready0 + 8 * g, SPLIT > 1 ? SPLIT - 1 : 1);  // one a peer
      mbar_init(free0 + 8 * g, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  // every block's barriers exist before another block arrives on them
  if constexpr (SPLIT > 1)
    cluster_sync();
  else
    __syncthreads();

  const int c = SPLIT > 1 ? cluster_index() : blockIdx.x;
  const int t_begin = starts[c], t_end = starts[c + 1];
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        const int* e = tiles + (t * SPLIT + rank) * FIELDS;
        const int b = e[0], m0 = e[1], n0 = e[2], kb = e[4], ke = e[5];
        const int nbox = min(BN / 64, (h - n0 + 63) / 64);
        const CUtensorMap* amap = &p.band[b];
        for (int k0 = kb; k0 < ke; k0 += BK) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, L::A_BYTES + nbox * B_BOX);
          tma_load_2d(s_base + OFF_A + stage * A_STAGE, amap,
                      MODE == PACKED ? k0 / 2 : k0, m0, full);
          for (int j = 0; j < nbox; ++j)
            tma_load_2d(s_base + OFF_B + stage * B_STAGE + j * B_BOX, &p.xc,
                        n0 + 64 * j, k0, full);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: wgmma on a 64 x 256 half of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    // this thread's A rows in the tile: ra and ra + 8 (same swizzle row)
    const int ra = 64 * wg + 16 * warp + g;
    const int swz = (ra >> 1) & 3;  // 64-byte swizzle: chunk ^= bits 7..8
    const int a_off0 = ra * BK + 2 * t4;
    const int a_off1 = a_off0 + 8 * BK;
    float* epi = reinterpret_cast<float*>(smem + OFF_EPI + wg * EPI_WG);
    const uint32_t epi_s = s_base + OFF_EPI + wg * EPI_WG;
    int stage = 0;
    uint32_t phase = 0;
    int uses = 0;  // 64-column slices this warpgroup has staged

    for (int t = t_begin; t < t_end; ++t) {
      const int* e = tiles + (t * SPLIT + rank) * FIELDS;
      const int b = e[0], m0 = e[1], n0 = e[2], kb = e[4], ke = e[5];
      const int r = p.r[b], lo = p.lo[b], w = p.w[b];
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;

      // A from registers: the next stage's fragments are read and widened
      // while this stage's wgmmas run; a wgmma's registers stay untouched
      // until wait_group has retired it
      uint32_t a[4][4], a_next[4][4];
      mbar_wait(full0 + 8 * stage, phase);
      load_stage_a<MODE>(a, smem + OFF_A + stage * A_STAGE, ra, a_off0,
                         a_off1, swz, t4);
      for (int k0 = kb; k0 < ke; k0 += BK) {
        const uint64_t desc = b_desc(s_base + OFF_B + stage * B_STAGE);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        if constexpr (SPLIT == 1) {
          if (w - k0 >= BK) {
#pragma unroll
            for (int s = 0; s < 4; ++s)  // 16 rows of B = 128 desc. units
              wgmma_m64n256k16(acc, a[s], desc + 128ull * s);
          } else {  // the last k16 steps of a width not a BK multiple
            const int ksteps = (w - k0) >> 4;
#pragma unroll
            for (int s = 0; s < 3; ++s)
              if (s < ksteps) wgmma_m64n256k16(acc, a[s], desc + 128ull * s);
          }
        } else {
          // Without a branch around a wgmma, which in a split kernel makes
          // ptxas serialize them: a k16 step past w (the last stage of a
          // width that is not a BK multiple) multiplies its zero-filled A
          // by the stage's first rows, which lie inside w, and adds zeros
          // (a non-finite row there makes every row of the band non-finite
          // in the reference's product too).
          const int ks = min(4, (w - k0) >> 4);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            wgmma_m64n256k16(acc, a[s], desc + 128ull * (s < ks ? s : 0));
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        int next = stage + 1;
        uint32_t next_phase = phase;
        if (next == STAGES) {
          next = 0;
          next_phase ^= 1;
        }
        if (k0 + BK < ke) {
          mbar_wait(full0 + 8 * next, next_phase);
          load_stage_a<MODE>(a_next, smem + OFF_A + next * A_STAGE, ra,
                             a_off0, a_off1, swz, t4);
        }
        // drained at every stage: a second group in flight holds a stage
        // longer and, at 4 stages (3 for bf16), starves the producer
        // (PERF.md)
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        stage = next;
        phase = next_phase;
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2) a[s][e2] = a_next[s][e2];
      }

      // ---- epilogue: out[nodes[lo + row], n0 + col] += acc ----
      // A split tile's blocks each stage their partial; the leader adds the
      // peers' to its own in chunk order and alone updates out.
      auto stage_slice = [&](int c4) {  // acc's 64-column slice c4 -> epi
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t4;
          const int i = 32 * c4 + 4 * j;  // compile-time after unrolling
          *reinterpret_cast<float2*>(epi + (16 * warp + g) * EPI_LD + col) =
              make_float2(acc[i], acc[i + 1]);
          *reinterpret_cast<float2*>(epi + (16 * warp + g + 8) * EPI_LD + col) =
              make_float2(acc[i + 2], acc[i + 3]);
        }
      };
      if constexpr (SPLIT > 1) {
        if (rank != 0) {  // a peer: hand each slice to the leader
#pragma unroll
          for (int c4 = 0; c4 < BN / 64; ++c4) {
            if (n0 + 64 * c4 >= h) break;
            if (uses > 0)  // the leader has read the previous slice
              wait_cluster_or_trap(free0 + 8 * wg, (uses - 1) & 1);
            stage_slice(c4);
            named_bar_sync(1 + wg);
            if (tid == 0) arrive_release_at(in_block(ready0 + 8 * wg, 0));
            ++uses;
          }
          continue;
        }
      }
      int ids[8];  // output rows of this thread's epilogue reads
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = m0 + 64 * wg + (tid >> 4) + 8 * k;
        ids[k] = row < r ? nodes[lo + row] : -1;
      }
      // this thread's 16 bytes of staged row (tid >> 4) + 8k
      const int at = (tid >> 4) * EPI_LD + 4 * (tid & 15);
#pragma unroll
      for (int c4 = 0; c4 < BN / 64; ++c4) {
        if (n0 + 64 * c4 >= h) break;
        named_bar_sync(1 + wg);  // the previous slice's readers are done
        stage_slice(c4);
        named_bar_sync(1 + wg);
        const int col = n0 + 64 * c4 + 4 * (tid & 15);
        if constexpr (SPLIT > 1) {
          // add the peers' slices to this one, in chunk order, in place
          wait_cluster_or_trap(ready0 + 8 * wg, uses & 1);
          ++uses;
          if (col < h) {
#pragma unroll 2
            for (int k = 0; k < 8; ++k) {
              float4* o = reinterpret_cast<float4*>(epi + at + 8 * k * EPI_LD);
              float4 a = *o;
#pragma unroll
              for (int q = 1; q < SPLIT; ++q) {
                const uint4 u = ld_cluster_u4(
                    in_block(epi_s + 4 * (at + 8 * k * EPI_LD), q));
                a.x += __uint_as_float(u.x);
                a.y += __uint_as_float(u.y);
                a.z += __uint_as_float(u.z);
                a.w += __uint_as_float(u.w);
              }
              *o = a;
            }
          }
          named_bar_sync(1 + wg);  // every read of the peers' slices is done
          if (tid == 0)
#pragma unroll
            for (int q = 1; q < SPLIT; ++q)
              arrive_release_at(in_block(free0 + 8 * wg, q));
        }
        if (col < h) {  // h % 8 == 0: the whole float4 is inside
          float4 s[8], v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            s[k] = *reinterpret_cast<const float4*>(epi + at + 8 * k * EPI_LD);
          // all eight rows' loads in flight before any store
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
        }
      }
    }
  }
  // a peer's shared memory and barriers stay until the leader has read its
  // last slice and freed it: every thread of the cluster meets here
  if constexpr (SPLIT > 1) cluster_sync();
}

// The launch of n_clusters clusters of `split` blocks (single blocks,
// without the cluster attribute, at split 1).
struct Launch {
  cudaLaunchAttribute attr{};
  cudaLaunchConfig_t cfg{};
  Launch(int n_clusters, int split, int smem_bytes, cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = split;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(n_clusters * split);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

typedef void (*KernelFn)(Params, const int*, const int*, const int*, float*,
                         int);

template <int MODE>
KernelFn kernel_of_split(int split) {
  switch (split) {
    case 1:
      return core_bands_kernel<MODE, 1>;
    case 2:
      return core_bands_kernel<MODE, 2>;
    case 4:
      return core_bands_kernel<MODE, 4>;
  }
  return nullptr;
}

// Dynamic shared memory of a cell mode's kernels
int smem_of(int mode) {
  return mode == BF16 ? Layout<BF16>::SMEM_BYTES
         : mode == PACKED ? Layout<PACKED>::SMEM_BYTES
                          : Layout<INT8>::SMEM_BYTES;
}

// The kernel of the cell mode and split, with its shared memory granted;
// nullptr for another mode or split (or where the card refuses it).
KernelFn kernel_of(int mode, int split) {
  KernelFn k = mode == INT8     ? kernel_of_split<INT8>(split)
               : mode == PACKED ? kernel_of_split<PACKED>(split)
               : mode == BF16   ? kernel_of_split<BF16>(split)
                                : nullptr;
  if (k != nullptr &&
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_of(mode)) != cudaSuccess)
    k = nullptr;
  return k;
}

}  // namespace

// Encode the TMA map of one band of r rows of `row_bytes` bytes into `map`
// (128 bytes of host memory): int8 cells (mode 0) in boxes of 128 rows x
// 64 bytes, 64-byte swizzle; packed int4 (mode 1) in boxes of 128 rows x
// 32 bytes, unswizzled; bf16 cells (mode 2) in boxes of 128 rows x 64
// cells, 128-byte swizzle. Returns 0 or an error code.
extern "C" int core_encode_band_map(void* map, const void* band, long long r,
                                    long long row_bytes, int mode) {
  CUtensorMap m;
  int err;
  if (mode == BF16)
    err = encode_2d(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, band, row_bytes / 2,
                    r, row_bytes, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  else if (mode == PACKED || mode == INT8)
    err = encode_2d(
        &m, CU_TENSOR_MAP_DATA_TYPE_UINT8, band, row_bytes, r, row_bytes,
        mode == PACKED ? BK / 2 : BK, BM,
        mode == PACKED ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_64B);
  else
    return ERR_ARGS;
  if (err == 0) memcpy(map, &m, sizeof m);
  return err;
}

// The most clusters of `split` blocks of the K-core kernel in cell mode
// `mode` the current card runs at once, into *n. Returns 0 or an error
// code.
extern "C" int core_max_clusters(int split, int mode, int* n) {
  const KernelFn k = kernel_of(mode, split);
  if (k == nullptr) return ERR_ARGS;
  Launch l(1, split, smem_of(mode), nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, k, &l.cfg));
}

// One launch over all bands, all of one cell mode (`mode`: 0 int8, 1
// packed int4, 2 bf16):
// `band_maps` holds n_bands encoded maps (host),
// `band_info` (lo, r, w) per band (host); `tiles` (int32 (n, split, 6):
// each block's band, m0, n0, live, k0, k1 per cluster tile, in cluster-rank
// order) and `starts` (n_clusters + 1 offsets into the cluster tiles, one
// segment per cluster) are on the device; clusters of `split` blocks, one
// contraction chunk each, single blocks at split 1. Returns 0 or an error
// code (cudaError_t, or the codes above).
extern "C" int core_bands_scatter_add(const void* band_maps,
                                      const int* band_info, int n_bands,
                                      const void* xc, long long n_xc,
                                      const void* tiles, const void* starts,
                                      int n_clusters, int split,
                                      const void* nodes, void* out, int h,
                                      int mode, void* stream) {
  const KernelFn k = kernel_of(mode, split);
  if (n_bands < 1 || n_bands > MAX_BANDS || n_clusters < 1 || k == nullptr ||
      h % 8)
    return ERR_ARGS;
  Params p;
  memset(&p, 0, sizeof p);
  memcpy(p.band, band_maps, n_bands * sizeof(CUtensorMap));
  for (int i = 0; i < n_bands; ++i) {
    p.lo[i] = band_info[3 * i];
    p.r[i] = band_info[3 * i + 1];
    p.w[i] = band_info[3 * i + 2];
  }
  int err = encode_2d(&p.xc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xc, h, n_xc,
                      2ll * h, 64, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  Launch l(n_clusters, split, smem_of(mode), static_cast<cudaStream_t>(stream));
  if (split == 1) l.cfg.numAttrs = 0;  // single blocks
  const cudaError_t e = cudaLaunchKernelEx(
      &l.cfg, k, p, static_cast<const int*>(tiles),
      static_cast<const int*>(starts), static_cast<const int*>(nodes),
      static_cast<float*>(out), h);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
