// rowpair_gemm: y[i][j][:] = bf16(a[i * row_stride + j * L + :]) @ w, f32 sums:
// a GEMM whose A operand is m rows of a (rows, W, L) operand read through a
// leading stride, W x L contiguous elements a row.
//
// Replaces the TPU kernel of tools/rowpair_probe.py (pl.pallas_call at :46,
// body _case :36-44): for each row parity rt, the stride-2 leading-dim read
// a[rt : rt + 2m : 2, 0:W, 0:L] of a (64, 128, L) operand (bf16 or f32, L =
// 128 or 64), rounded to bf16 and multiplied by an (L, L) bf16 matrix into
// (m, W, L) f32, m = 16. On the TPU the probe asked whether Mosaic lowers a
// strided leading-dim ref read at the row-pair exit's lane geometry. Here a
// strided row is an address: the wrapper passes row_stride = 2 W L for the
// stride-2 view, W L for a contiguous copy, and the kernel is the same.
//
// What bounds it: bytes. At the flagship's 1080p exit (a 534 x 954 x L
// operand, both parities) the product is 8.35 G MAC at L = 128 (0.017 ms at
// the bf16 tensor-core rate) against 391 MB (bf16 A) or 522 MB (f32 A) of
// operand read and f32 output written (0.117 / 0.156 ms at 3.35 TB/s).
//
// What the design does: it streams. The operand has no shifted window, so
// wgmma reads A and B straight from the shared memory that tensor copies
// fill, and nothing else touches them:
// * a persistent grid, one block an SM, walks output tiles of 128
//   positions of one A row (row i, columns j0 .. j0 + 127; tile t is row t /
//   tiles_row), blockIdx.x, blockIdx.x + gridDim.x, ...; each block loads
//   W (L x L bf16) once by a tensor copy and keeps it;
// * one producer thread keeps tensor copies of A in flight through a ring
//   of stages of 128 bytes of lanes (64 bf16 or 32 f32) of a tile's 128
//   positions (plan: rowpair_plan.cuh), an mbarrier each for full
//   and empty, from a 3-D tensor map over (L, W, m) whose dim-2 stride is
//   row_stride: that stride is all that differs between the strided and
//   the contiguous read, so the walk and the order of the sums, and the
//   results, are the same. Columns past W arrive as zeros;
// * two consumer warpgroups, 64 positions each, issue wgmma m64nLk16 with
//   f32 sums: B is W, MN-major (N contiguous: the transposed form, no copy
//   of W); a bf16 A is read from the stage, K-major, in the 128-byte
//   swizzle the copies write; an f32 A is read from the stage by the
//   threads, rounded to bf16 (nearest even, as the plain version) and
//   given to wgmma from registers;
// * each consumer warpgroup stages its f32 64 x L tile in its own half of
//   a shared buffer and one thread stores it by a tensor copy (columns
//   past W are not written), which runs on while the next tile's copies
//   and products do; the half is rewritten once that copy has read it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "rowpair_plan.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// two consumer warpgroups and one producer warp
constexpr int kConsumers = 256, kThreads = kConsumers + 32;
constexpr int kWarpgroup = 128;
constexpr int kHalf = kRowpairBM / 2;  // positions a consumer warpgroup
static_assert(kConsumers == 2 * kWarpgroup && kHalf == 64, "a warpgroup's m64 half of a tile");

__device__ __forceinline__ unsigned pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);  // v.x in the lower half
  return *reinterpret_cast<const unsigned*>(&h);
}

// Byte offset of f32 lane c (even) of row r in a block of 128-byte rows of
// 32 lanes, 16-byte chunks swizzled by the row
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + (c & 3) * 4;
}

template <int L>
__device__ __forceinline__ void mma_ss(float (&d)[L / 2], unsigned long long da,
                                       unsigned long long db, int scale_d) {
  if constexpr (L == 128)
    wgmma_m64n128k16_ss(d, da, db, scale_d);
  else
    wgmma_m64n64k16_ss(d, da, db, scale_d);
}
template <int L>
__device__ __forceinline__ void mma_rs(float (&d)[L / 2], const unsigned (&a)[4],
                                       unsigned long long db, int scale_d) {
  if constexpr (L == 128)
    wgmma_m64n128k16_rs(d, a, db, scale_d);
  else
    wgmma_m64n64k16_rs(d, a, db, scale_d);
}

// ta: A as (L, W, m), element strides (1, L, row_stride), box (128 bytes of
// lanes, 128 positions, 1), a ring stage; tw: W as (L, L), box (64, L); ty:
// y as (L, W, m), box (32, 64, 1). Tiles: m x tiles_row, tiles_row =
// ceil(W / 128).
template <typename TA, int L>
__global__ void __launch_bounds__(kThreads, 1)
    rowpair_kernel(RowpairPlan p, int W, int tiles_row, int tiles,
                   const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap ty) {
  constexpr bool kF32 = sizeof(TA) == 4;
  constexpr int kLanes = 128 / sizeof(TA);  // lanes a stage: one 128-byte box row
  constexpr int kChunks = L / kLanes;       // stages a tile
  constexpr int kSteps = kLanes / 16;       // k16 steps a stage
  extern __shared__ uint4 smem4[];
  // [W | ring | Y staging, two halves | mbarriers] from a 1024-aligned base
  unsigned char* wbuf = reinterpret_cast<unsigned char*>(smem4) +
                        ((1024 - smem_addr(smem4) % 1024) % 1024);
  unsigned char* ring = wbuf + p.w;
  unsigned char* ystage = ring + p.stages * p.stage;
  auto* full = reinterpret_cast<unsigned long long*>(ystage + p.ys);
  auto* empty = full + p.stages;
  auto* wbar = empty + p.stages;
  if (threadIdx.x == 0) {
    // a stage is full when the producer's copies have landed, empty when
    // every consumer warp has released it
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init(wbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer: W once, then stage c of each tile in walk order, each
    // into the ring's next stage once the consumers have emptied it
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(wbar, p.w);
      for (int nb = 0; nb < L / 64; ++nb) tma_load_2d(wbuf + nb * L * 128, &tw, nb * 64, 0, wbar);
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int i = t / tiles_row, j0 = t % tiles_row * kRowpairBM;
        for (int c = 0; c < kChunks; ++c, ++it) {
          const int s = it % p.stages;
          mbar_wait_or_trap(empty + s, ((it / p.stages) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, p.stage);
          tma_load_3d(ring + s * p.stage, &ta, c * kLanes, j0, i, full + s);
        }
      }
    }
    return;
  }

  // The consumers: warpgroup g takes positions 64 g .. 64 g + 63 of a tile
  const int g = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int r0 = g * kHalf + warp * 16 + lane / 4;  // this thread's rows r0, r0 + 8 of the tile
  const int q2 = (lane % 4) * 2;
  unsigned char* yb = ystage + g * (p.ys / 2);
  const unsigned wsm = smem_addr(wbuf);
  float acc[L / 2];
#pragma unroll
  for (int e = 0; e < L / 2; ++e) acc[e] = 0.f;
  mbar_wait_or_trap(wbar, 0);
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = t / tiles_row, j0 = t % tiles_row * kRowpairBM;
    for (int c = 0; c < kChunks; ++c, ++it) {
      const int s = it % p.stages;
      unsigned char* st = ring + s * p.stage;
      mbar_wait_or_trap(full + s, (it / p.stages) & 1);
      unsigned a[kSteps][4];
      if constexpr (kF32) {
        // rows r0, r0 + 8 and lanes q2, q2 + 1 (+ 8) of each k16 step,
        // rounded to bf16 pairs
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const int c0 = kk * 16 + q2;
          a[kk][0] = pack_bf16(*reinterpret_cast<const float2*>(st + swz32(r0, c0)));
          a[kk][1] = pack_bf16(*reinterpret_cast<const float2*>(st + swz32(r0 + 8, c0)));
          a[kk][2] = pack_bf16(*reinterpret_cast<const float2*>(st + swz32(r0, c0 + 8)));
          a[kk][3] = pack_bf16(*reinterpret_cast<const float2*>(st + swz32(r0 + 8, c0 + 8)));
        }
      }
#pragma unroll
      for (int e = 0; e < L / 2; ++e) wgmma_fence_operand(acc[e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        // W's K rows c kLanes + kk 16 .. + 15: 8-row groups 1024 bytes
        // apart, 64-lane N blocks L 128 bytes apart
        const unsigned long long db =
            wgmma_desc(wsm + (c * kLanes + kk * 16) * 128, L * 128, 1024);
        const int scale = (c | kk) != 0;  // the tile's first step overwrites
        if constexpr (kF32) {
          mma_rs<L>(acc, a[kk], db, scale);
        } else {
          // this warpgroup's 64 rows of the stage, lanes kk 16 .. + 15: 32
          // bytes into each swizzled row, 8-row groups 1024 bytes apart
          const unsigned long long da =
              wgmma_desc(smem_addr(st) + g * kHalf * 128 + kk * 32, 16, 1024);
          mma_ss<L>(acc, da, db, scale);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < L / 2; ++e) wgmma_fence_operand(acc[e]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    // the epilogue: this warpgroup's 64 x L f32 into its staging half (L /
    // 32 swizzled blocks of 64 rows x 32 lanes) once the last copy out of
    // it has read it, then one tensor copy a block; a half wholly past W
    // is not stored
    if (j0 + g * kHalf < W) {
      if (tid == 0) bulk_wait_read<0>();
      bar_sync(1 + g, kWarpgroup);
      const int rr = warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < L / 8; ++j) {
        unsigned char* blk = yb + (j / 4) * (kHalf * 128);
        const int cb = (j % 4) * 8 + q2;
        *reinterpret_cast<float2*>(blk + swz32(rr, cb)) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(blk + swz32(rr + 8, cb)) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      fence_proxy_async();
      bar_sync(1 + g, kWarpgroup);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < L / 32; ++b)
          tma_store_3d(&ty, yb + b * (kHalf * 128), b * 32, j0 + g * kHalf, i);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // the copies have read the staging half
}

template <typename TA, int L>
int launch(const void* a, const void* w, void* y, long long m, int W, long long row_stride,
           cudaStream_t stream) {
  constexpr int esize = sizeof(TA);
  const RowpairPlan p(L);
  const auto misaligned = [](const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16; };
  if (p.smem > kRowpairSmemLimit || m <= 0 || W <= 0 || misaligned(a) || misaligned(w) || misaligned(y) ||
      row_stride <= 0 || (row_stride * esize) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_row = (W + kRowpairBM - 1) / kRowpairBM, tiles = m * tiles_row;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tw, ty;
  const cuuint64_t adims[3] = {static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(m)};
  const cuuint64_t astrides[2] = {static_cast<cuuint64_t>(L) * esize,
                                  static_cast<cuuint64_t>(row_stride) * esize};
  const cuuint32_t abox[3] = {128 / esize, kRowpairBM, 1};
  const bool amap = esize == 2 ? bf16_map(&ta, a, 3, adims, astrides, abox)
                               : f32_map(&ta, a, 3, adims, astrides, abox);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(L)};
  const cuuint64_t wstrides[1] = {2ull * L};
  const cuuint32_t wbox[2] = {64, static_cast<cuuint32_t>(L)};
  const cuuint64_t ystrides[2] = {4ull * L, 4ull * L * W};
  const cuuint32_t ybox[3] = {32, 64, 1};
  if (!amap || !bf16_map(&tw, w, 2, wdims, wstrides, wbox) ||
      !f32_map(&ty, y, 3, adims, ystrides, ybox))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = rowpair_kernel<TA, L>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);  // one block an SM
  kernel<<<grid, kThreads, p.smem, stream>>>(p, W, static_cast<int>(tiles_row),
                                              static_cast<int>(tiles), ta, tw, ty);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (m, W, L) f32 = A @ w on `stream`, A the m rows a + i * row_stride
// (elements), each W x L contiguous, f32 (a_bf16 == 0) or bf16, rounded to
// bf16 at the read; w (L, L) bf16; L = 64 or 128; a, w and y 16-byte
// aligned, row_stride a multiple of 16 bytes. Returns cudaGetLastError() of
// the launch, or cudaErrorInvalidValue for operands it does not take.
extern "C" int rowpair_gemm(const void* a, const void* w, void* y, int a_bf16, int L, long long m,
                            int W, long long row_stride, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (L == 128)
    return a_bf16 ? launch<bf16, 128>(a, w, y, m, W, row_stride, s)
                  : launch<float, 128>(a, w, y, m, W, row_stride, s);
  if (L == 64)
    return a_bf16 ? launch<bf16, 64>(a, w, y, m, W, row_stride, s)
                  : launch<float, 64>(a, w, y, m, W, row_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
