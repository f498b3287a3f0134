// conv_layer_forward_wgmma: one middle layer of the bf16 stream whose padded
// width is 128 or more, on Hopper's warpgroup products:
//   y[p, 0:n] = bf16_rn(relu(sum over taps t of A[p + off_t, 0:K] @ W[t] + b))
// with bf16 operands and f32 sums; x (N, H, W, K) bf16 NHWC in, y (N, H - f +
// 1, W - f + 1, n) bf16 NHWC out, W the tap-major (taps, K_pad, N_pad) packing
// of ops/fused/entry.py: pack_bf16, b its (N_pad,) f32 bias. Its plain version
// is ops/fused/reference.py: tap_layer. The chain (ops/fused/chain.py) takes it
// for every layer that is neither first nor last at n > 64; the other layers
// stay on tc_stage.cuh (conv_layer.cu).
//
// Replaces, with conv_layer_forward_bf16, the TPU kernel
// cnn_sr_tpu/ops/pallas_fused/kernel.py:_fused_tail_single (pl.pallas_call at
// kernel.py:730) in its bf16-stream mode (entry.py:32 fused_forward with
// dtype=bf16, input_int8=True): for the 7-layer RGB model's L5 (64 -> 128) and
// L6 (128 -> 128) the Winograd branches wino_kernel.py:145-253 (j-paired at k
// = 64, unpaired at k = 128), which the port computes directly.
//
// What bounds it: the multiply-adds at the bf16 tensor-core rate (RGB 1080p:
// L5 0.305 ms, L6 0.608 ms at 989 TFLOP/s), and close behind them the reads
// from L2: every 16x16 tile reads its A boxes (3 dx x 18/16 rows of its
// input at f = 3) and its layer's weights again, 258 KB a tile at L5 and
// 516 KB at L6, 2.07 and 4.15 GB over the 8,040 tiles of a 1080p layer.
//
// What the design does (plan: conv_wgmma_plan.cuh):
// * A by tensor copies, one box per (64-lane chunk of K, dx, group of dy
//   taps): (16 + gy - 1) input rows x 16 columns x 64 lanes at the tile's
//   corner shifted by dx, from a 4-D map over (K, W, H, N) in the 128-byte
//   swizzle. What lies outside the image or past K arrives as zeros: no zero
//   fill and no live masks. A dy shift moves the start of the descriptor by
//   16 rows of 128 bytes, two whole swizzle atoms, so the dy taps of a box
//   read it by address and nothing is copied per tap. This is what
//   tc_stage.cuh could not do: its window is one shifted copy for every tap,
//   which only ldmatrix's per-lane addresses read; here the copy per dx costs
//   L2 reads and no thread instructions;
// * W by tensor copies: a slice is one tap's 64 rows of K x 128 columns,
//   MN-major (the packing as it is), 128-byte swizzled, from a 3-D map over
//   (N_pad, K_pad, taps) so that rows past K_pad arrive as zeros. Slices
//   stream through a ring (L6's 288 KB of weights do not fit), once a tile:
//   the 256-position tile keeps that traffic near the A boxes' (an 8x16 tile
//   would read the weights twice as often);
// * one producer thread issues the copies; two consumer warpgroups, which
//   `setmaxnreg` gives the producer warpgroup's registers, each own two m64
//   slabs of the tile (8 of its 16 rows) x 128 columns, 128 f32 sums a
//   thread, and run wgmma m64n128k16 per k16 of every slice; mbarriers mark
//   the stages full and empty. A slice is released once the products that
//   read it are done (those of the slice after it still in flight). No
//   product sits behind a branch: the warpgroup's index is read from lane 0,
//   and positions past the output and lanes past K multiply the zeros the
//   copies brought;
// * a persistent grid, one block an SM, walks the tiles (and, at N_pad >
//   128, their 128-column chunks) round robin, so one tile's epilogue runs
//   beside the next tile's copies;
// * the epilogue: bias in f32, ReLU, one rounding to bf16 (nearest even, as
//   tc_stage.cuh's tc_store_bf16), staged in shared memory in the swizzle
//   and stored by tensor copies, which do not write past the output's edge
//   or past n.
//
// Measured (chip_smoke.py [layers], RGB 1080p, NVIDIA H100 80GB HBM3, 700 W):
// L5 0.415 ms and L6 0.748 ms, 73% and 81% of their bounds, against cuDNN
// bf16's 1.230 and 1.545 and the mma.sync stage's 1.530 and 2.409 that they
// replace; the RGB bf16 chain 3.44 ms, was 6.13. The L2 reads above then
// run at 5.0 and 5.5 TB/s, the likely home of the rest of the time
// (inferred from those byte counts, not profiled); a cluster that
// multicasts W to two tiles would halve its share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv_wgmma_plan.cuh"
#include "mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// two consumer warpgroups and a producer warpgroup, whose registers go to the
// consumers (setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168)
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2 * kWarpgroup, kThreads = kConsumers + kWarpgroup;
constexpr int kConsumerRegs = 224, kProducerRegs = 56;
static_assert(kConsumers * kConsumerRegs + kWarpgroup * kProducerRegs <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "the registers handed over fit the block's");
constexpr int kWarps = kConsumers / 32;  // arrivals that empty a stage, one a consumer warp
constexpr int kRow = kWgLanes * 2;       // bytes of a swizzled row
constexpr int kSlab = 64;                // positions of an m64 slab
constexpr int kBlock = kWgWSlice / 2;    // a 64-lane block of a W slice: 64 rows
constexpr int kHalf = kWgOut / 2;        // a warpgroup's staging: 2 slabs x 128 columns
static_assert(kWgTileRows * kWgTileCols == 4 * kSlab, "four slabs a tile, two a warpgroup");
static_assert(kWgTileCols * kRow % 1024 == 0, "a dy shift is whole swizzle atoms");

// The tile of item i: 128-column chunk fastest, then the tile column, the
// tile row and the image
struct Tile {
  int img, oy0, ox0, n0;
  __device__ Tile(int i, int chunks, int tiles_x, int tiles_y) {
    n0 = i % chunks * kWgN;
    i /= chunks;
    ox0 = i % tiles_x * kWgTileCols;
    i /= tiles_x;
    oy0 = i % tiles_y * kWgTileRows;
    img = i / tiles_y;
  }
};

// A ring's next stage and the parity of its phase
struct Ring {
  int stage = 0, phase = 0;
  __device__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// byte offset of lane c (even) of row r in a block of 128-byte rows, 16-byte
// chunks swizzled by the row (as the tensor copies read it)
__device__ __forceinline__ int swz(int r, int c) {
  return r * kRow + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ unsigned bias_relu_bf16x2(float a, float b, float ba, float bb) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(a + ba, 0.f), fmaxf(b + bb, 0.f));
  return *reinterpret_cast<const unsigned*>(&h);
}

// ta: x as (K, W, H, N), box (64, 16, box_rows, 1); tw: w as (N_pad, K_pad,
// taps), box (64, 64, 1); to: y as (n, OW, OH, N), box (64, 16, 8, 1)
__global__ void __launch_bounds__(kThreads, 1)
    conv_layer_wgmma_kernel(const __grid_constant__ WgmmaPlan p, const float* __restrict__ b,
                            int items, int tiles_x, int tiles_y,
                            const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tw,
                            const __grid_constant__ CUtensorMap to) {
  extern __shared__ uint4 smem4[];
  // [A ring | W ring | staging | mbarriers] from a 1024-aligned base
  unsigned char* aring = reinterpret_cast<unsigned char*>(smem4) +
                         ((1024 - smem_addr(smem4) % 1024) % 1024);
  unsigned char* wring = aring + p.a_ring * p.a_box;
  unsigned char* obuf = wring + p.w_ring * kWgWSlice;
  auto* a_full = reinterpret_cast<unsigned long long*>(obuf + kWgOut);
  auto* a_empty = a_full + kWgMaxRing;
  auto* w_full = a_empty + kWgMaxRing;
  auto* w_empty = w_full + kWgMaxRing;
  const int chunks = p.npad / kWgN;
  if (threadIdx.x == 0) {
    // full when the producer's copies have landed, empty when every
    // consumer warp is done with the stage
    for (int s = 0; s < p.a_ring; ++s) {
      mbar_init(a_full + s, 1);
      mbar_init(a_empty + s, kWarps);
    }
    for (int s = 0; s < p.w_ring; ++s) {
      mbar_init(w_full + s, 1);
      mbar_init(w_empty + s, kWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer: for each tile, each (chunk, dx, dy group) its A box,
    // then the group's W slices, each into the next stage of its ring once
    // the consumers have emptied it
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      Ring ra, rw;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Tile t(i, chunks, tiles_x, tiles_y);
        for (int c = 0; c < p.chunks; ++c)
          for (int dx = 0; dx < p.f; ++dx)
            for (int g0 = 0; g0 < p.f; g0 += p.gy) {
              mbar_wait_or_trap(a_empty + ra.stage, ra.phase ^ 1);
              mbar_arrive_expect_tx(a_full + ra.stage, p.a_box);
              tma_load_4d(aring + ra.stage * p.a_box, &ta, c * kWgLanes, t.ox0 + dx, t.oy0 + g0,
                          t.img, a_full + ra.stage);
              ra.next(p.a_ring);
              const int g1 = min(p.f, g0 + p.gy);
              for (int dy = g0; dy < g1; ++dy) {
                unsigned char* dst = wring + rw.stage * kWgWSlice;
                mbar_wait_or_trap(w_empty + rw.stage, rw.phase ^ 1);
                mbar_arrive_expect_tx(w_full + rw.stage, kWgWSlice);
                tma_load_3d(dst, &tw, t.n0, c * kWgLanes, dy * p.f + dx, w_full + rw.stage);
                tma_load_3d(dst + kBlock, &tw, t.n0 + kWgLanes, c * kWgLanes, dy * p.f + dx,
                            w_full + rw.stage);
                rw.next(p.w_ring);
              }
            }
      }
    }
    return;
  }

  // The consumers: warpgroup g owns slabs 2 g and 2 g + 1, tile rows 8 g ..
  // 8 g + 7; g is read from lane 0 so that it is warp-uniform
  setmaxnreg_inc<kConsumerRegs>();
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int tid = threadIdx.x % kWarpgroup;
  const int lane = threadIdx.x % 32;
  // this warpgroup's first slab in an A box and its staging
  const unsigned a_base = smem_addr(aring) + 2 * g * kSlab * kRow, w_base = smem_addr(wring);
  unsigned char* ob = obuf + g * kHalf;
  float acc[2][kWgN / 2];
  const auto fence_acc = [&] {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < kWgN / 2; ++e) wgmma_fence_operand(acc[s][e]);
  };
  const auto release = [&](unsigned long long* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  Ring ra, rw;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    int scale = 0;                 // the tile's first product overwrites the sums
    int prev_w = -1, prev_a = -1;  // stages whose last products are in flight
    fence_acc();
    for (int c = 0; c < p.chunks; ++c)
      for (int dx = 0; dx < p.f; ++dx)
        for (int g0 = 0; g0 < p.f; g0 += p.gy) {
          mbar_wait_or_trap(a_full + ra.stage, ra.phase);
          unsigned a_addr = a_base + ra.stage * p.a_box;  // at dy = g0
          const int g1 = min(p.f, g0 + p.gy);
          for (int dy = g0; dy < g1; ++dy, a_addr += kWgTileCols * kRow) {
            mbar_wait_or_trap(w_full + rw.stage, rw.phase);
            const unsigned w_addr = w_base + rw.stage * kWgWSlice;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kWgLanes / 16; ++kk) {
              // lanes kk 16 .. + 15: 32 bytes into each swizzled A row, 8-row
              // groups 1024 bytes apart; W's rows kk 16 .. + 15, its two
              // 64-lane blocks kBlock apart
              const unsigned long long db = wgmma_desc(w_addr + kk * 16 * kRow, kBlock, 1024);
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                const unsigned long long da =
                    wgmma_desc(a_addr + s * kSlab * kRow + kk * 32, 16, 1024);
                wgmma_m64n128k16_ss(acc[s], da, db, scale);
              }
              scale = 1;
            }
            wgmma_commit();
            // the slice before's products are done: its stage, and the box
            // before's once its last slice is done, go back to the producer
            wgmma_wait<1>();
            fence_acc();
            if (prev_w >= 0) release(w_empty + prev_w);
            if (prev_a >= 0) release(a_empty + prev_a);
            prev_w = rw.stage;
            prev_a = -1;
            rw.next(p.w_ring);
          }
          prev_a = ra.stage;
          ra.next(p.a_ring);
        }
    wgmma_wait<0>();
    fence_acc();
    release(w_empty + prev_w);
    release(a_empty + prev_a);

    // the epilogue: bias, ReLU, bf16 into this warpgroup's staging once the
    // previous tile's copies out of it have read it, then one tensor copy a
    // 64-lane block
    const Tile t(i, chunks, tiles_x, tiles_y);
    const int warp = tid / 32;
    const int rr = warp * 16 + lane / 4, q2 = (lane % 4) * 2;  // rows rr, rr + 8; lanes q2, q2 + 1
    if (tid == 0) bulk_wait_read<0>();
    bar_sync(1 + g, kWarpgroup);
#pragma unroll
    for (int c8 = 0; c8 < kWgN / 8; ++c8) {
      const int col = c8 * 8 + q2, c = col % kWgLanes;
      const float b0 = __ldg(b + t.n0 + col), b1 = __ldg(b + t.n0 + col + 1);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        unsigned char* blk = ob + (col / kWgLanes) * (kHalf / 2) + s * kSlab * kRow;
        *reinterpret_cast<unsigned*>(blk + swz(rr, c)) =
            bias_relu_bf16x2(acc[s][4 * c8], acc[s][4 * c8 + 1], b0, b1);
        *reinterpret_cast<unsigned*>(blk + swz(rr + 8, c)) =
            bias_relu_bf16x2(acc[s][4 * c8 + 2], acc[s][4 * c8 + 3], b0, b1);
      }
    }
    fence_proxy_async();
    bar_sync(1 + g, kWarpgroup);
    if (tid == 0) {
#pragma unroll
      for (int lb = 0; lb < 2; ++lb)
        tma_store_4d(&to, ob + lb * (kHalf / 2), t.n0 + lb * kWgLanes, t.ox0,
                     t.oy0 + g * (kWgTileRows / 2), t.img);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // the copies have read the staging
}

}  // namespace

// y (N, H - f + 1, W - f + 1, n) bf16 on `stream` from x (N, H, W, K) bf16,
// w (f * f, kpad(K), npad(n)) bf16 and b (npad(n),) f32 (entry.pack_bf16), all
// contiguous and 16-byte aligned: bias, ReLU, one rounding to bf16. Refused
// (cudaErrorInvalidValue, nothing launched): a shape the plan does not take
// (f even, K or n not a multiple of 8, n <= 64), a misaligned pointer,
// more than 2^31 - 1 tiles, or smem_bytes below the plan's. Returns
// cudaGetLastError() of the launch.
extern "C" int conv_layer_forward_wgmma(const void* x, const void* w, const float* b, void* y,
                                        int N, int H, int W, int K, int f, int n,
                                        int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const auto misaligned = [](const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16; };
  WgmmaPlan p;
  if (N <= 0 || N > 65535 || H < f || W < f || wgmma_plan(p, f, K, n) || smem_bytes < p.smem ||
      misaligned(x) || misaligned(w) || misaligned(b) || misaligned(y))
    return bad;
  const int OH = H - f + 1, OW = W - f + 1;
  const cuuint64_t adims[4] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t astrides[3] = {2ull * K, 2ull * K * W, 2ull * K * W * H};
  const cuuint32_t abox[4] = {kWgLanes, kWgTileCols, static_cast<cuuint32_t>(p.box_rows), 1};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(p.npad), static_cast<cuuint64_t>(p.kp),
                               static_cast<cuuint64_t>(f) * f};
  const cuuint64_t wstrides[2] = {2ull * p.npad, 2ull * p.npad * p.kp};
  const cuuint32_t wbox[3] = {kWgLanes, kWgLanes, 1};
  const cuuint64_t odims[4] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(OW),
                               static_cast<cuuint64_t>(OH), static_cast<cuuint64_t>(N)};
  const cuuint64_t ostrides[3] = {2ull * n, 2ull * n * OW, 2ull * n * OW * OH};
  const cuuint32_t obox[4] = {kWgLanes, kWgTileCols, kWgTileRows / 2, 1};
  CUtensorMap ta, tw, to;
  if (!bf16_map(&ta, x, 4, adims, astrides, abox) || !bf16_map(&tw, w, 3, wdims, wstrides, wbox) ||
      !bf16_map(&to, y, 4, odims, ostrides, obox))
    return bad;
  const int tiles_x = (OW + kWgTileCols - 1) / kWgTileCols;
  const int tiles_y = (OH + kWgTileRows - 1) / kWgTileRows;
  const long long items = static_cast<long long>(N) * tiles_y * tiles_x * (p.npad / kWgN);
  if (items > 0x7fffffffLL) return bad;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv_layer_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM
  conv_layer_wgmma_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p, b, static_cast<int>(items), tiles_x, tiles_y, ta, tw, to);
  return static_cast<int>(cudaGetLastError());
}
