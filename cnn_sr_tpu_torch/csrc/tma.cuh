// Tensor copies (TMA) of the port's kernels (winograd.cu, rowpair.cu,
// xpack.cu, conv_wgmma.cu) and bulk copies (fused_wgmma.cu): the PTX
// wrappers of the copies between global and shared memory, their bulk
// groups and mbarrier transaction counts, and the host side that encodes a
// tensor map. One copy of each, included where used;
// the other barriers and smem_addr are mma.cuh's.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

// an mbarrier arrival that also raises the phase's transaction count by the
// bytes tensor copies will bring
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// whether the phase of the given parity of the mbarrier has completed (one
// try: the hardware may suspend the thread for a while before it answers)
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_wait that traps after about four seconds: a phase that never
// completes (a copy that never lands, a parity out of step) ends the launch
// with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait_or_trap(unsigned long long* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 4000000000ull) __trap();
  }
}

// make the mbarriers' initialisation visible to the tensor copies
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// tensor copies global -> shared of one box of the tensor map at the given
// coordinates (innermost first), counted off the mbarrier as they land;
// elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
// a bulk copy global -> shared of `bytes` contiguous bytes (a multiple of
// 16, both ends 16-byte aligned), counted off the mbarrier as it lands: no
// tensor map
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}
// tensor copy shared -> global of one box at the given coordinates, in a
// bulk group; elements outside the tensor are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::); }
// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// order shared-memory accesses across the generic and the async proxy: the
// reads a barrier ordered before a tensor copy's writes, or this thread's
// writes before a tensor copy's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, looked up through the runtime (nothing links
// libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A tensor map of `rank` dimensions (innermost first, strides in bytes of
// dims 1 .. rank - 1), each box row of 128 bytes swizzled by 128 bytes
// (16-byte chunk c of box row r at c ^ (r % 8)), or by the swizzle given
bool swizzled_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode && encode(map, type, rank, const_cast<void*>(base), dims, strides, box, ones,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16: box rows of 64 lanes (of 32 lanes under CU_TENSOR_MAP_SWIZZLE_64B)
bool bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  return swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box,
                      swizzle);
}

// f32: box rows of 32 lanes
bool f32_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box) {
  return swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank, dims, strides, box);
}

}  // namespace
