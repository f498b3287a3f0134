// parity_copy: dst = src + add, elementwise over two strided views of one
// shape of up to five dimensions, in f32 or bf16.
//
// Replaces the TPU kernel of tools/strided_store_probe.py (pl.pallas_call
// at :30, body main :22-28): strided ref loads a[p::2, q::2] and strided
// ref stores out[p::2, q::2] = v + 1 for the four parity quadrants of a
// (24, 256, 128) f32 block. On the TPU that probe asked whether Mosaic
// lowers stride-2 ref accesses at all. Here any stride is an address, so
// the same kernel also produces and consumes the parity layouts of the
// Winograd probe (probes/layout.py: pack_rows_cols, split_quadrants,
// merge_quadrants): one launch per parity quadrant for the pack, one for
// the split or the merge.
//
// What bounds it: bytes. It reads each source element once and writes each
// destination element once, with no arithmetic beyond the optional add;
// at the RGB model's L6 input (1070 x 1910 x 128 bf16, 523 MB) the pack
// moves 1.05 GB, 0.31 ms at 3.35 TB/s.
//
// What the design does: one thread per 16 bytes of the innermost
// dimension where that dimension is contiguous on both sides (channels,
// in every layout of the probes) and every other stride and both
// pointers keep 16-byte alignment: 4 floats or 8 bf16 a thread, so a warp
// reads and writes 512 contiguous bytes per row of channels. Otherwise one
// element a thread. Each thread splits its flat index into coordinates by
// 32-bit division (the wrapper keeps views under 2^31 elements) and forms
// the two offsets from 64-bit element strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Map {
  unsigned int ext[5];  // extents, outermost first; ext[4] in vectors
  long long src[5];     // element strides; src[4] and dst[4] per vector
  long long dst[5];
};

template <typename T>
__device__ __forceinline__ T add_to(T v, float add);
template <>
__device__ __forceinline__ float add_to<float>(float v, float add) {
  return v + add;
}
template <>
__device__ __forceinline__ __nv_bfloat16 add_to<__nv_bfloat16>(__nv_bfloat16 v, float add) {
  return __float2bfloat16_rn(__bfloat162float(v) + add);
}

// V = 16 / sizeof(T): one 16-byte vector a thread (contiguous innermost
// dimension); V = 1: one element.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    parity_copy_kernel(const T* __restrict__ src, T* __restrict__ dst, Map m,
                       unsigned int total, float add) {
  const unsigned int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  unsigned int rest = idx;
  long long so = 0, dof = 0;
#pragma unroll
  for (int d = 4; d >= 0; --d) {
    const unsigned int i = rest % m.ext[d];
    rest /= m.ext[d];
    so += i * m.src[d];
    dof += i * m.dst[d];
  }
  if constexpr (V == 1) {
    dst[dof] = add == 0.f ? src[so] : add_to<T>(src[so], add);
  } else {
    uint4 q = *reinterpret_cast<const uint4*>(src + so);
    if (add != 0.f) {
      T* e = reinterpret_cast<T*>(&q);
#pragma unroll
      for (int j = 0; j < V; ++j) e[j] = add_to<T>(e[j], add);
    }
    *reinterpret_cast<uint4*>(dst + dof) = q;
  }
}

template <typename T>
int launch(const T* src, T* dst, const long long* ext, const long long* ss, const long long* ds,
           float add, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  Map m;
  long long total = 1;
  for (int d = 0; d < 5; ++d) {
    if (ext[d] <= 0 || ext[d] >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    m.ext[d] = static_cast<unsigned int>(ext[d]);
    // a dimension of extent 1 adds nothing, whatever stride the view gives it
    m.src[d] = ext[d] == 1 ? 0 : ss[d];
    m.dst[d] = ext[d] == 1 ? 0 : ds[d];
    total *= ext[d];
  }
  bool vec = m.src[4] == 1 && m.dst[4] == 1 && ext[4] % V == 0 &&
             reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  for (int d = 0; d < 4; ++d) vec = vec && m.src[d] % V == 0 && m.dst[d] % V == 0;
  if (vec) {
    m.ext[4] /= V;
    m.src[4] = V;
    m.dst[4] = V;
    total /= V;
  }
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  if (vec)
    parity_copy_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
        src, dst, m, static_cast<unsigned int>(total), add);
  else
    parity_copy_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        src, dst, m, static_cast<unsigned int>(total), add);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dst = src + add (no add when add == 0: a plain copy keeps every bit) over
// the view of extents e0..e4 (outermost first) with element strides
// s0..s4 into src and d0..d4 into dst; bf16 != 0 for __nv_bfloat16, else
// float. The bf16 add is taken in f32 and rounded to nearest even. The
// caller pads a view of fewer dimensions with leading extents of 1 and
// keeps it under 2^31 elements; dst must not overlap src. Returns
// cudaGetLastError() of the launch.
extern "C" int parity_copy(const void* src, void* dst, int bf16, long long e0, long long e1,
                           long long e2, long long e3, long long e4, long long s0, long long s1,
                           long long s2, long long s3, long long s4, long long d0, long long d1,
                           long long d2, long long d3, long long d4, float add, void* stream) {
  const long long ext[5] = {e0, e1, e2, e3, e4};
  const long long ss[5] = {s0, s1, s2, s3, s4};
  const long long ds[5] = {d0, d1, d2, d3, d4};
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst), ext,
                  ss, ds, add, s);
  return launch(static_cast<const float*>(src), static_cast<float*>(dst), ext, ss, ds, add, s);
}
