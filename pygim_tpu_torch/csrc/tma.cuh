// Hopper building blocks shared by the band kernels (core_dot.cu,
// core_int.cu): mbarriers, 2-D TMA loads, named barriers, thread block
// clusters (ranks, barriers, distributed shared memory), and the TMA map
// encoder, reached through the CUDA runtime's entry-point lookup so the
// libraries need no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// error codes of the host functions besides cudaError_t
// (ops/_build.py:check reads them)
constexpr int ERR_NO_ENCODE = 900;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ARGS = 901;
constexpr int ERR_ENCODE = 1000;    // + CUresult

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Wait for phase `parity` of an mbarrier; trap after about 2^32 cycles
// (~2 s), so a stage that never completes fails the launch instead of
// hanging the card. One asm block: no branch of the C++ code around it.
// SEM is "" (the default: acquire at CTA scope) or ".acquire.cluster",
// for a phase that threads of other blocks of the cluster complete after
// writing what the waiter then reads.
#define WAIT_OR_TRAP(NAME, SEM)                                             \
  __device__ __forceinline__ void NAME(uint32_t bar, uint32_t parity) {     \
    asm volatile(                                                           \
        "{\n"                                                               \
        " .reg .pred p;\n"                                                  \
        " .reg .u64 t0, t1;\n"                                              \
        " mbarrier.try_wait.parity" SEM ".shared::cta.b64 p, [%0], %1;\n"   \
        " @p bra.uni DONE;\n"                                               \
        " mov.u64 t0, %%clock64;\n"                                         \
        "WAIT:\n"                                                           \
        " mbarrier.try_wait.parity" SEM ".shared::cta.b64 p, [%0], %1;\n"   \
        " @p bra.uni DONE;\n"                                               \
        " mov.u64 t1, %%clock64;\n"                                         \
        " sub.u64 t1, t1, t0;\n"                                            \
        " setp.gt.u64 p, t1, 4294967296;\n"                                 \
        " @p trap;\n"                                                       \
        " bra.uni WAIT;\n"                                                  \
        "DONE:\n"                                                           \
        "}" ::"r"(bar),                                                     \
        "r"(parity)                                                         \
        : "memory");                                                        \
  }
WAIT_OR_TRAP(wait_or_trap, "")
WAIT_OR_TRAP(wait_cluster_or_trap, ".acquire.cluster")
#undef WAIT_OR_TRAP

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// ---- thread block clusters ----

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

// The shared::cluster address of this CTA-relative shared address in
// block `cta` of the cluster.
__device__ __forceinline__ uint32_t in_block(uint32_t addr, uint32_t cta) {
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra)
               : "r"(addr), "r"(cta));
  return ra;
}

// arrive on a barrier of a block of the cluster (in_block address)
__device__ __forceinline__ void arrive_at(uint32_t ra) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(ra)
               : "memory");
}

// the same, releasing at cluster scope what this thread (and, through a
// barrier before it, its block's threads) wrote before it, to the
// threads that wait on the phase with wait_cluster_or_trap
__device__ __forceinline__ void arrive_release_at(uint32_t ra) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(ra)
      : "memory");
}

// 16 bytes of another block's shared memory (in_block address)
__device__ __forceinline__ uint4 ld_cluster_u4(uint32_t ra) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(ra)
               : "memory");
  return v;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the CUDA runtime's entry-point lookup, so the
// library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// 2-D row-major tensor (outer, inner) with a row stride of `stride` bytes,
// loaded in boxes of (box_outer, box_inner); out-of-bounds reads are zero
int encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr,
              long long inner, long long outer, long long stride,
              int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(map, dtype, 2, const_cast<void*>(ptr), dims, strides,
                          box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

}  // namespace
