// conv_layer_forward_wgmma: one middle layer of the bf16 stream on Hopper's
// warpgroup products:
//   y[p, 0:n] = bf16_rn(relu(sum over taps t of A[p + off_t, 0:K] @ W[t] + b))
// with bf16 operands and f32 sums; x (N, H, W, K) bf16 NHWC in, y (N, H - f +
// 1, W - f + 1, n) bf16 NHWC out, W the tap-major (taps, K_pad, N_pad) packing
// of ops/fused/entry.py: pack_bf16, b its (N_pad,) f32 bias. Its plain version
// is ops/fused/reference.py: tap_layer. The chain (ops/fused/chain.py) takes it
// for every layer that is neither first nor last; the first is
// conv_first_wgmma.cu's, the last conv_last_wgmma.cu's. Its
// warpgroups, descriptors and products are wgmma_conv.cuh's.
//
// Replaces, with the chain's first and last layers, the TPU kernel
// cnn_sr_tpu/ops/pallas_fused/kernel.py:_fused_tail_single (pl.pallas_call at
// kernel.py:730) in its bf16-stream mode (entry.py:32 fused_forward with
// dtype=bf16, input_int8=True): for the 7-layer RGB model's middles the
// sep branch kernel.py:499-544, the quad Winograd wino_kernel.py:98-143 (k =
// 32: L2, L3), the j-paired wino_kernel.py:145-200 (k = 64: L4, L5) and the
// unpaired wino_kernel.py:202-253 (k = 128: L6), which the port computes
// directly.
//
// What bounds it (RGB 1080p, 3.35 TB/s, 989 TFLOP/s): L2 32->32 and L3 32->64
// by their bytes, input once and output once (0.079 and 0.118 ms; 144 and 192
// operations a byte, below the card's ridge of about 295); L4 64->64 at the
// ridge (0.157 ms by bytes); L5 and L6 by their multiply-adds (0.305, 0.608
// ms), and close behind them the reads from L2 of every tile's A boxes (3 dx
// x (rows + 2) / rows of its input at f = 3) and, where they stream, of its
// layer's weights.
//
// What the design does (plan: conv_wgmma_plan.cuh), one design for every
// width, templated on the block's columns BN (npad up to 64, else 128-column
// chunks), the lanes of a box row (32 or 64) and the slabs S a warpgroup owns
// (4 up to 32 columns, else 2):
// * A by tensor copies, one box per (lane chunk of K, dx, group of dy taps):
//   (8 S + gy - 1) input rows x 16 columns x 32 or 64 lanes at the tile's
//   corner shifted by dx, from a 4-D map over (K, W, H, N), in the 64- or
//   128-byte swizzle. What lies outside the image or past K arrives as zeros:
//   no zero fill and no live masks. A dy shift moves the start of the
//   descriptor by 16 rows of 64 or 128 bytes, two whole swizzle atoms, so
//   the dy taps of a box read it by address and nothing is copied per tap.
//   At K <= 32 the box is 32 lanes wide, so that the byte-bound layers do not
//   multiply or copy 32 lanes of zeros;
// * W by tensor copies: a slice is one tap's 32 or 64 rows of K x BN
//   columns, MN-major (the packing as it is), swizzled by its row's bytes
//   (128, 64 or 32; 16 unswizzled), from a 3-D map over (N_pad, K_pad, taps)
//   so that rows past K_pad arrive as zeros. Where every slice fits beside
//   two A boxes (RGB L2-L4: 18, 37 and 74 KB) one copy per block at launch
//   leaves them resident and the A ring takes the rest of the shared memory;
//   else (L5, L6, 128->64) they stream through a ring, once a tile;
// * one producer thread issues the copies; two consumer warpgroups, which
//   `setmaxnreg` gives the producer warpgroup's registers, each own S m64
//   slabs of the tile (4 S of its 8 S rows) x BN columns, S BN / 2 f32 sums a
//   thread, and run wgmma m64nBNk16 per k16 of every slice, the tile's
//   first products write-only (peeled: a sum read by its first product
//   stays live around the tile loop and spills); mbarriers mark the stages
//   full and empty. A
//   stage is released once the products that read it are done (those of
//   the slice after it still in flight). No product sits behind a branch:
//   the warpgroup's index is read from lane 0, and positions past the
//   output and lanes past K multiply the zeros the copies brought;
// * a persistent grid, one block an SM, walks the tiles (and, at N_pad >
//   128, their 128-column chunks) round robin, so one tile's epilogue runs
//   beside the next tile's copies;
// * the epilogue: bias in f32, ReLU, one rounding to bf16 (nearest even, as
//   the other bf16 kernels), staged in shared memory in the swizzle
//   and stored by tensor copies, which do not write past the output's edge
//   or past n.
//
// Two instances have a SAME twin (kSame; conv_layer_forward_wgmma_same): those
// of the plans Real-ESRGAN x4plus's middle layers reach (ops/fused/rrdb.py:
// 32 and 64 columns over 64-lane boxes; entry.same_instances). The boxes start
// (f - 1) / 2 up and left of the tile, so the copies' zero fill is the
// padding; the input is the first K channels of a wider buffer and the
// output a channel slice of one (the maps' strides); the epilogue is
// wgmma_conv.cuh's SameEpi (LeakyReLU or none, f32 residuals, an f32 copy).
// The VALID instances are as before.
//
// Measured (chip_smoke.py [layers], RGB 1080p, NVIDIA H100 80GB HBM3, 700 W):
// L2 0.117 ms, L3 0.158, L4 0.235, L5 0.412, L6 0.748: 67%, 74%, 67%, 74%
// and 81% of their bounds, against cuDNN bf16's 0.398, 0.615, 0.717, 1.236
// and 1.556, and the mma.sync stage's 0.274, 0.446, 0.721 (L2-L4) that they
// replace; the RGB bf16 chain 2.45 ms, was 3.36. The slabs and the A ring
// (the deepest that fits beside resident W) are the fastest that
// ops/fused/tune.py timed (PERF.md, conv_wgmma_plan.cuh: wg_slabs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv_wgmma_plan.cuh"
#include "mma.cuh"
#include "wgmma_conv.cuh"

namespace {

// The tile of item i: the BN-column chunk fastest, then the tile column, the
// tile row and the image
struct Tile {
  int img, oy0, ox0, n0;
  __device__ Tile(int i, int chunks, int tiles_x, int tiles_y, int bn, int rows) {
    n0 = i % chunks * bn;
    i /= chunks;
    ox0 = i % tiles_x * kWgTileCols;
    i /= tiles_x;
    oy0 = i % tiles_y * rows;
    img = i / tiles_y;
  }
};

// ta: x as (K, W, H, N), box (L, 16, box_rows, 1); tw: w as (N_pad, K_pad,
// taps), box (BN's lanes, L, 1); to: y as (n, OW, OH, N), box (BN's lanes,
// 16, 4 S, 1). kSame: the layer is SAME-padded (the tile's input corner
// (f - 1) / 2 up and left of its output corner; the copies bring zeros
// outside the image) and its epilogue is `e`'s; else VALID, bias and ReLU
// (e unused)
template <int BN, int L, int S, bool kSame>
__global__ void __launch_bounds__(kThreads, 1)
    conv_layer_wgmma_kernel(const __grid_constant__ WgmmaPlan p, const float* __restrict__ b,
                            int items, int tiles_x, int tiles_y,
                            const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tw,
                            const __grid_constant__ CUtensorMap to,
                            const __grid_constant__ SameEpi e) {
  using C = Cols<BN>;
  constexpr int kARow = 2 * L;                    // bytes of an A box row
  constexpr int kRows = 8 * S;                    // the tile's rows
  constexpr int kBlock = L * C::kRow;             // a block of a W slice
  constexpr int kWSlice = L * BN * 2;             // a W slice
  constexpr int kStage = S * kWgSlab * BN * 2;    // a warpgroup's output staging
  constexpr int kOutBlock = S * kWgSlab * C::kRow;  // a block of it
  extern __shared__ uint4 smem4[];
  // [A ring | W | output staging | mbarriers] from a 1024-aligned base
  unsigned char* aring = reinterpret_cast<unsigned char*>(smem4) +
                         ((1024 - smem_addr(smem4) % 1024) % 1024);
  unsigned char* wbuf = aring + p.a_ring * p.a_box;
  unsigned char* obuf = wbuf + p.w_bytes;
  auto* a_full = reinterpret_cast<unsigned long long*>(obuf + p.out_bytes);
  auto* a_empty = a_full + kWgMaxRing;
  auto* w_full = a_empty + kWgMaxRing;
  auto* w_empty = w_full + kWgMaxRing;
  const int chunks = p.npad / BN, taps = p.f * p.f;
  const bool w_res = BN <= 64 && p.w_res;  // at 128 columns W always streams
  if (threadIdx.x == 0) {
    // full when the producer's copies have landed, empty when every
    // consumer warp is done with the stage; resident W has one full
    for (int s = 0; s < p.a_ring; ++s) {
      mbar_init(a_full + s, 1);
      mbar_init(a_empty + s, kWarps);
    }
    for (int s = 0; s < (w_res ? 1 : p.w_ring); ++s) {
      mbar_init(w_full + s, 1);
      mbar_init(w_empty + s, kWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer: resident W once; then for each tile, each (chunk, dx,
    // dy group) its A box and, where W streams, the group's W slices, each
    // into the next stage of its ring once the consumers have emptied it
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      if (w_res) {
        mbar_arrive_expect_tx(w_full, p.chunks * taps * kWSlice);
        for (int c = 0; c < p.chunks; ++c)
          for (int t = 0; t < taps; ++t)
            load_w<BN, L>(wbuf + (c * taps + t) * kWSlice, &tw, 0, c * L, t, w_full);
      }
      Ring ra, rw;
      const int pad = kSame ? p.f / 2 : 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Tile t(i, chunks, tiles_x, tiles_y, BN, kRows);
        for (int c = 0; c < p.chunks; ++c)
          for (int dx = 0; dx < p.f; ++dx)
            for (int g0 = 0; g0 < p.f; g0 += p.gy) {
              mbar_wait_or_trap(a_empty + ra.stage, ra.phase ^ 1);
              mbar_arrive_expect_tx(a_full + ra.stage, p.a_box);
              tma_load_4d(aring + ra.stage * p.a_box, &ta, c * L, t.ox0 + dx - pad,
                          t.oy0 + g0 - pad, t.img, a_full + ra.stage);
              ra.next(p.a_ring);
              if (w_res) continue;
              const int g1 = min(p.f, g0 + p.gy);
              for (int dy = g0; dy < g1; ++dy) {
                mbar_wait_or_trap(w_empty + rw.stage, rw.phase ^ 1);
                mbar_arrive_expect_tx(w_full + rw.stage, kWSlice);
                load_w<BN, L>(wbuf + rw.stage * kWSlice, &tw, t.n0, c * L, dy * p.f + dx,
                              w_full + rw.stage);
                rw.next(p.w_ring);
              }
            }
      }
    }
    return;
  }

  // The consumers: warpgroup g owns slabs g S .. g S + S - 1, tile rows 4 g S
  // .. 4 g S + 4 S - 1; g is read from lane 0 so that it is warp-uniform
  setmaxnreg_inc<kConsumerRegs>();
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int tid = threadIdx.x % kWarpgroup;
  const int lane = threadIdx.x % 32;
  // this warpgroup's first slab in an A box and its staging
  const unsigned a_base = smem_addr(aring) + g * S * kWgSlab * kARow, w_base = smem_addr(wbuf);
  unsigned char* ob = obuf + g * kStage;
  float acc[S][BN / 2];
  const auto fence_acc = [&] {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) wgmma_fence_operand(acc[s][e]);
  };
  const auto release = [&](unsigned long long* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (w_res) mbar_wait_or_trap(w_full, 0);
  Ring ra, rw;
  int prev_w = -1, prev_a = -1;  // stages whose last products are in flight
  // One slice's products (chunk c, tap (dy, dx); its A rows at a_addr) into
  // the sums, then the stages the slice before read go back to the
  // producer: its W stage, and the box before's once its last slice is done
  const auto slice = [&](int c, int dx, int dy, unsigned a_addr, auto first) {
    unsigned w_addr = w_base + ((c * p.f + dy) * p.f + dx) * kWSlice;
    if (!w_res) {
      mbar_wait_or_trap(w_full + rw.stage, rw.phase);
      w_addr = w_base + rw.stage * kWSlice;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      // lanes kk 16 .. + 15: 32 bytes into each swizzled A row, 8-row groups
      // one atom apart; W's rows kk 16 .. + 15
      const unsigned long long db = b_desc<BN>(w_addr, kk, kBlock);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const unsigned long long da = a_desc<L>(a_addr + s * kWgSlab * kARow + kk * 32);
        if (decltype(first)::value && kk == 0)
          mma_first<BN>(acc[s], da, db);
        else
          mma_ss<BN>(acc[s], da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc();
    if (!w_res) {
      if (prev_w >= 0) release(w_empty + prev_w);
      prev_w = rw.stage;
      rw.next(p.w_ring);
    }
    if (prev_a >= 0) release(a_empty + prev_a);
    prev_a = -1;
  };
  // One box's slices (box bx: chunk, dx, dy group), each dy tap 16 rows on
  const auto box = [&](int bx, auto first) {
    const int g0 = bx % p.groups * p.gy, dx = bx / p.groups % p.f, c = bx / p.groups / p.f;
    mbar_wait_or_trap(a_full + ra.stage, ra.phase);
    unsigned a_addr = a_base + ra.stage * p.a_box;  // at dy = g0
    int dy = g0;
    if constexpr (decltype(first)::value) {
      slice(c, dx, dy++, a_addr, std::true_type{});
      a_addr += kWgTileCols * kARow;
    }
    for (const int g1 = min(p.f, g0 + p.gy); dy < g1; ++dy, a_addr += kWgTileCols * kARow)
      slice(c, dx, dy, a_addr, std::false_type{});
    prev_a = ra.stage;
    ra.next(p.a_ring);
  };
  const int boxes = p.chunks * p.f * p.groups;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    // the tile's first box is peeled: its first products overwrite the sums
    // (write-only), so that no path reads a sum before one of them writes
    // it and the sums are not live around the tile loop
    box(0, std::true_type{});
    for (int bx = 1; bx < boxes; ++bx) box(bx, std::false_type{});
    wgmma_wait<0>();
    fence_acc();
    if (!w_res) release(w_empty + prev_w);
    release(a_empty + prev_a);
    prev_w = prev_a = -1;

    // the epilogue: bias, ReLU (kSame: e's), bf16 into this warpgroup's
    // staging once the previous tile's copies out of it have read it, then
    // one tensor copy a block of 64 lanes
    const Tile t(i, chunks, tiles_x, tiles_y, BN, kRows);
    const int warp = tid / 32;
    const int rr = warp * 16 + lane / 4, q2 = (lane % 4) * 2;  // rows rr, rr + 8; lanes q2, q2 + 1
    if (tid == 0) bulk_wait_read<0>();
    bar_sync(1 + g, kWarpgroup);
#pragma unroll
    for (int c8 = 0; c8 < BN / 8; ++c8) {
      const int col = c8 * 8 + q2, c = col % C::kLanes;
      const float b0 = __ldg(b + t.n0 + col), b1 = __ldg(b + t.n0 + col + 1);
      unsigned char* blk = ob + (col / C::kLanes) * kOutBlock;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = s * kWgSlab + rr;
        if constexpr (kSame) {
          // staged position r: output row oy0 + 4 g S + r / 16, column ox0 +
          // r % 16 (0 to 7); position r + 8 is 8 columns on in the same row
          const int oy = t.oy0 + g * (kRows / 2) + r / kWgTileCols, ox = t.ox0 + r % kWgTileCols;
          const long long pix = (static_cast<long long>(t.img) * e.oh + oy) * e.ow + ox;
          const bool in = t.n0 + col < p.n && oy < e.oh;
          *reinterpret_cast<unsigned*>(blk + swz<C::kRow>(r, c)) =
              same_bf16x2(e, acc[s][4 * c8], acc[s][4 * c8 + 1], b0, b1, pix, t.n0 + col,
                          in && ox < e.ow);
          *reinterpret_cast<unsigned*>(blk + swz<C::kRow>(r + 8, c)) =
              same_bf16x2(e, acc[s][4 * c8 + 2], acc[s][4 * c8 + 3], b0, b1, pix + 8,
                          t.n0 + col, in && ox + 8 < e.ow);
        } else {
          *reinterpret_cast<unsigned*>(blk + swz<C::kRow>(r, c)) =
              bias_relu_bf16x2(acc[s][4 * c8], acc[s][4 * c8 + 1], b0, b1);
          *reinterpret_cast<unsigned*>(blk + swz<C::kRow>(r + 8, c)) =
              bias_relu_bf16x2(acc[s][4 * c8 + 2], acc[s][4 * c8 + 3], b0, b1);
        }
      }
    }
    fence_proxy_async();
    bar_sync(1 + g, kWarpgroup);
    if (tid == 0) {
#pragma unroll
      for (int blk = 0; blk < C::kBlocks; ++blk)
        tma_store_4d(&to, ob + blk * kOutBlock, t.n0 + blk * C::kLanes, t.ox0,
                     t.oy0 + g * (kRows / 2), t.img);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // the copies have read the staging
}

template <int BN, int L, int S, bool kSame>
int launch(const WgmmaPlan& p, const void* x, const void* w, const float* b, void* y, int N,
           int H, int W, int K, int f, int n, int xs, int ys, SameEpi e, int smem_bytes,
           cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  using C = Cols<BN>;
  const int OH = kSame ? H : H - f + 1, OW = kSame ? W : W - f + 1;
  const cuuint64_t adims[4] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t astrides[3] = {2ull * xs, 2ull * xs * W, 2ull * xs * W * H};
  const cuuint32_t abox[4] = {L, kWgTileCols, static_cast<cuuint32_t>(p.box_rows), 1};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(p.npad), static_cast<cuuint64_t>(p.kp),
                               static_cast<cuuint64_t>(f) * f};
  const cuuint64_t wstrides[2] = {2ull * p.npad, 2ull * p.npad * p.kp};
  const cuuint32_t wbox[3] = {C::kLanes, L, 1};
  const cuuint64_t odims[4] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(OW),
                               static_cast<cuuint64_t>(OH), static_cast<cuuint64_t>(N)};
  const cuuint64_t ostrides[3] = {2ull * ys, 2ull * ys * OW, 2ull * ys * OW * OH};
  const cuuint32_t obox[4] = {C::kLanes, kWgTileCols, 4 * S, 1};
  CUtensorMap ta, tw, to;
  if (!bf16_map(&ta, x, 4, adims, astrides, abox, swizzle_of(2 * L)) ||
      !bf16_map(&tw, w, 3, wdims, wstrides, wbox, swizzle_of(C::kRow)) ||
      !bf16_map(&to, y, 4, odims, ostrides, obox, swizzle_of(C::kRow)))
    return bad;
  const int tiles_x = (OW + kWgTileCols - 1) / kWgTileCols;
  const int tiles_y = (OH + 8 * S - 1) / (8 * S);
  const long long items = static_cast<long long>(N) * tiles_y * tiles_x * (p.npad / BN);
  if (items > 0x7fffffffLL) return bad;
  e.oh = OH;
  e.ow = OW;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = conv_layer_wgmma_kernel<BN, L, S, kSame>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p, b, static_cast<int>(items), tiles_x, tiles_y,
                                                 ta, tw, to, e);
  return static_cast<int>(cudaGetLastError());
}

// the instance of the plan's box lanes at BN columns (64 at 128), its slabs
// wg_slabs(BN)
template <int BN>
int launch_bn(const WgmmaPlan& p, const void* x, const void* w, const float* b, void* y, int N,
              int H, int W, int K, int f, int n, int smem_bytes, cudaStream_t s) {
  constexpr int S = BN <= 32 ? 4 : 2;
  if constexpr (BN == 128)
    return launch<128, 64, S, false>(p, x, w, b, y, N, H, W, K, f, n, K, n, SameEpi{},
                                     smem_bytes, s);
  else
    return p.lanes == 32 ? launch<BN, 32, S, false>(p, x, w, b, y, N, H, W, K, f, n, K, n,
                                                    SameEpi{}, smem_bytes, s)
                         : launch<BN, 64, S, false>(p, x, w, b, y, N, H, W, K, f, n, K, n,
                                                    SameEpi{}, smem_bytes, s);
}

bool misaligned(const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16; }

}  // namespace

// y (N, H - f + 1, W - f + 1, n) bf16 on `stream` from x (N, H, W, K) bf16,
// w (f * f, kpad(K), npad(n)) bf16 and b (npad(n),) f32 (entry.pack_bf16), all
// contiguous and 16-byte aligned: bias, ReLU, one rounding to bf16; the plan
// at `a_ring` A stages (0: the plan's own choice, conv_wgmma_plan.cuh).
// Refused (cudaErrorInvalidValue, nothing launched): a shape or choice the
// plan does not take (f even, K or n not a multiple of 8, A stages that do
// not fit), a misaligned pointer, more than 2^31 - 1 tiles, or smem_bytes
// below the plan's. Returns cudaGetLastError() of the launch.
extern "C" int conv_layer_forward_wgmma(const void* x, const void* w, const float* b, void* y,
                                        int N, int H, int W, int K, int f, int n, int a_ring,
                                        int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  WgmmaPlan p;
  if (N <= 0 || N > 65535 || H < f || W < f || wgmma_plan(p, f, K, n, a_ring) ||
      smem_bytes < p.smem || misaligned(x) || misaligned(w) || misaligned(b) || misaligned(y))
    return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p.bn) {
    case 8:
      return launch_bn<8>(p, x, w, b, y, N, H, W, K, f, n, smem_bytes, s);
    case 16:
      return launch_bn<16>(p, x, w, b, y, N, H, W, K, f, n, smem_bytes, s);
    case 32:
      return launch_bn<32>(p, x, w, b, y, N, H, W, K, f, n, smem_bytes, s);
    case 64:
      return launch_bn<64>(p, x, w, b, y, N, H, W, K, f, n, smem_bytes, s);
    default:
      return launch_bn<128>(p, x, w, b, y, N, H, W, K, f, n, smem_bytes, s);
  }
}

// The SAME-padded layer of the SAME models (ops/fused/rrdb.py): y (N, H, W,
// n) bf16 from x (N, H, W, K), both NHWC with their own channel strides: x
// the first K channels of a buffer of xs channels a pixel (a channel
// prefix), y n channels of a buffer of ys channels a pixel from the pointer
// y (a channel slice: y points at its first channel). The epilogue is
// SameEpi's (wgmma_conv.cuh): the sum and bias, LeakyReLU(0.2) of it where
// lrelu is 1, then r0 (f32, r0s channels a pixel) + s0 v where r0 is not
// null, then r1 + s1 v where r1 is not null; v to y32 (f32, y32s channels a
// pixel) where y32 is not null; one rounding to bf16 into y. w, b and the
// plan as conv_layer_forward_wgmma's. Refused (cudaErrorInvalidValue,
// nothing launched): as there, and xs below K, ys below n, xs or ys not a
// multiple of 8, lrelu not 0 or 1, an f32 tensor not 8-byte aligned or with
// a stride below n or odd, or a plan with no SAME instance (32 or 64
// columns over 64-lane boxes: entry.same_instances).
extern "C" int conv_layer_forward_wgmma_same(const void* x, int xs, const void* w,
                                             const float* b, void* y, int ys, int N, int H,
                                             int W, int K, int f, int n, int lrelu,
                                             const float* r0, int r0s, float s0, const float* r1,
                                             int r1s, float s1, float* y32, int y32s, int a_ring,
                                             int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const auto bad32 = [n](const float* r, int rs) {
    return r != nullptr && (reinterpret_cast<std::uintptr_t>(r) % 8 || rs < n || rs % 2);
  };
  WgmmaPlan p;
  if (N <= 0 || N > 65535 || H < 1 || W < 1 || wgmma_plan(p, f, K, n, a_ring) ||
      smem_bytes < p.smem || misaligned(x) || misaligned(w) || misaligned(b) || misaligned(y) ||
      xs < K || xs % 8 || ys < n || ys % 8 || lrelu < 0 || lrelu > 1 ||
      bad32(r0, r0s) || bad32(r1, r1s) || bad32(y32, y32s))
    return bad;
  SameEpi e{};
  e.res[0] = r0;
  e.res[1] = r1;
  e.res_stride[0] = r0s;
  e.res_stride[1] = r1s;
  e.scale[0] = s0;
  e.scale[1] = s1;
  e.out32 = y32;
  e.out32_stride = y32s;
  e.lrelu = lrelu;
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.lanes == 64 && p.bn == 32)
    return launch<32, 64, 4, true>(p, x, w, b, y, N, H, W, K, f, n, xs, ys, e, smem_bytes, s);
  if (p.lanes == 64 && p.bn == 64)
    return launch<64, 64, 2, true>(p, x, w, b, y, N, H, W, K, f, n, xs, ys, e, smem_bytes, s);
  return bad;
}
