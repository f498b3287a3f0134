// conv_last_forward_wgmma: the last layer of the bf16 stream on Hopper's
// warpgroup products:
//   y[p, c] = b[c] + sum over taps (dy, dx) of A[p + (dy, dx), 0:K] @ W[dy, dx][:, c]
// with bf16 operands and f32 sums, no ReLU and no rounding; x (N, H, W, K)
// bf16 NHWC in, y (N, H - f + 1, W - f + 1, n) f32 NHWC out, W the dx-in-N
// packing of ops/fused/entry.py: pack_last, b its f32 bias (n values at
// least). Its plain version is ops/fused/reference.py: tap_layer(...,
// last=True). The chain (ops/fused/chain.py) takes it for every last layer
// of the bf16 stream.
//
// Replaces, with the chain's other kernels, the TPU kernel
// cnn_sr_tpu/ops/pallas_fused/kernel.py:_fused_tail_single (pl.pallas_call
// at kernel.py:730) in its bf16-stream mode (entry.py:32 fused_forward with
// dtype=bf16, input_int8=True): its last layer, the masked all-phase
// reduction mm_last (kernel.py:585-606) and the parity exit
// wino_kernel.py:349 wino_mm_exit. Both put one product's f n output lanes
// side by side and align the taps afterwards; so does this kernel, and so
// does fused_wgmma.cu's conv3.
//
// What bounds it (RGB L7 128 -> 3 at 1080p, 3.35 TB/s, 989 TFLOP/s): its
// bytes, the K = 128 bf16 input read once (532 MB) and the f32 output
// written once (25 MB): 0.163 ms. Its operations are 9 x 128 x 3 per
// position, 11 us at the peak. On the mma.sync stage (tc_stage.cuh) the layer
// took 0.454-0.459 ms: one 16x16 tile a block, loads not overlapped with
// the products, every tap's A fragments read again from shared memory for
// an n8 product of 3 real columns (2.3 KB of shared-memory reads a
// position), the halo read 1.27 times and the output stored a scalar at a
// time.
//
// What the design does (plan: conv_last_plan.cuh), templated on the
// packed columns N (8 ... 128), the lanes of a box row (32 or 64) and the
// m64 slabs S a warpgroup owns (2 up to 32 columns, else 1):
// * one product per dy tap: the f dx taps of the n outputs side by side in
//   N, column (dx - d0) n + c (RGB L7: 9 real columns of 16), so that A is
//   read once a (position, dy, chunk of K) and not once a tap: 768 bytes
//   of shared-memory reads a position at RGB L7. Where f n passes 128 the
//   dx taps go in dgroups groups of gdx, one pass of the tile each;
// * A by tensor copies, one box per (chunk of 32 or 64 lanes of K, group of
//   dy taps): (tile_rows + gy - 1) input rows x kLastCols (64) columns at
//   the tile's corner, in the 64- or 128-byte swizzle. A product's 64 rows
//   are one row of the box, and a dy tap moves its descriptor's start 64
//   rows on (whole swizzle atoms). The tile's outputs are its first 64 - f
//   + 1 columns (62 at f = 3), so the halo re-read is 1.03 x (tile_rows +
//   2) / tile_rows; outside the image or past K the copies bring zeros;
// * W by tensor copies: a slice is one (dx group, dy)'s lanes x N, MN-major
//   as packed; resident (one copy a block) where every slice fits beside
//   two A boxes (RGB L7: 12 KB), else through a ring;
// * one producer thread issues the copies; two consumer warpgroups, which
//   `setmaxnreg` gives the producer warpgroup's registers, each own S
//   slabs and run wgmma m64nNk16 per k16 of every slice, the tile's first
//   product write-only (peeled, as conv_wgmma.cu: a sum read by its first
//   product stays live around the tile loop); mbarriers mark the stages
//   full and empty, a stage released once the products that read it are
//   done;
// * a persistent grid, one block an SM, walks the tiles round robin, so
//   one tile's epilogue runs beside the next tile's copies;
// * the epilogue: the f32 sums staged in shared memory (rows of N + 8
//   floats), then out[y][x][c] = b[c] + sum over dx of e[(y, x + dx)][(dx
//   - d0) n + c], as fused_wgmma.cu's conv3_sum, written f32 NHWC by the
//   warpgroup's threads a row segment at a time, neighbouring threads on
//   neighbouring addresses (a tensor copy takes no row of 3 floats). A dx
//   group after the first adds to what the same thread wrote before.
//
// One instance has a SAME twin (kSame; conv_last_forward_wgmma_same): that
// of the plan of Real-ESRGAN x4plus's conv_last (ops/fused/rrdb.py: 16
// packed columns over 64-lane boxes; entry.same_instances). The boxes start
// (f - 1) / 2 up and left of the tile, the copies' zero fill the padding.
//
// Measured (chip_smoke.py [layers], RGB 1080p, NVIDIA H100 80GB HBM3,
// 700 W): L7 0.204 ms, 80% of its byte bound, against cuDNN bf16's 0.687
// and the mma.sync stage's 0.455 that it replaces; the RGB bf16 chain
// 2.11-2.15 ms, was 2.43-2.46. Tiles of 64 input columns ran 0.199-0.202
// ms, of 32 0.205-0.207 and of 16 0.218-0.223, and the A ring's depth moved
// it by under 1.5% (PERF.md): the tile and the deepest ring are fixed.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "conv_last_plan.cuh"
#include "mma.cuh"
#include "wgmma_conv.cuh"

namespace {

// ta: x as (K, W, H, N), box (L, kLastCols, box_rows, 1); tw: w as (N_pad,
// K_pad, dgroups f), box (N's lanes, L, 1). kSame: the layer is SAME-padded,
// the tile's input corner (f - 1) / 2 up and left of its output corner (the
// copies bring zeros outside the image); else VALID
template <int N, int L, int S, bool kSame>
__global__ void __launch_bounds__(kThreads, 1)
    conv_last_wgmma_kernel(const __grid_constant__ LastPlan p, const float* __restrict__ b,
                           float* __restrict__ y, int OH, int OW, int items, int tiles_x,
                           int tiles_y, const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tw) {
  using C = Cols<N>;
  constexpr int kARow = 2 * L;         // bytes of an A box row
  constexpr int kBlock = L * C::kRow;  // a block of a W slice
  constexpr int kWSlice = L * N * 2;   // a W slice
  constexpr int kE = N + kLastPad;     // floats of a staged sum row
  extern __shared__ uint4 smem4[];
  // [A ring | W | staged sums | mbarriers] from a 1024-aligned base
  unsigned char* aring = reinterpret_cast<unsigned char*>(smem4) +
                         ((1024 - smem_addr(smem4) % 1024) % 1024);
  unsigned char* wbuf = aring + p.a_ring * p.a_box;
  float* ebuf = reinterpret_cast<float*>(wbuf + p.w_bytes);
  auto* a_full = reinterpret_cast<unsigned long long*>(wbuf + p.w_bytes + p.e_bytes);
  auto* a_empty = a_full + kWgMaxRing;
  auto* w_full = a_empty + kWgMaxRing;
  auto* w_empty = w_full + kWgMaxRing;
  const int slices = p.dgroups * p.f;  // W slices a chunk of K: (dx group, dy)
  const bool w_res = p.w_res;
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
    // The producer: resident W once; then for each tile and dx group, each
    // (chunk, dy group) its A box and, where W streams, the group's W
    // slices, each into the next stage of its ring once it is empty
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      if (w_res) {
        mbar_arrive_expect_tx(w_full, p.chunks * slices * kWSlice);
        for (int c = 0; c < p.chunks; ++c)
          for (int sl = 0; sl < slices; ++sl)
            load_w<N, L>(wbuf + (c * slices + sl) * kWSlice, &tw, 0, c * L, sl, w_full);
      }
      Ring ra, rw;
      const int pad = kSame ? p.f / 2 : 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int ox0 = i % tiles_x * p.out_cols, oy0 = i / tiles_x % tiles_y * p.tile_rows;
        const int img = i / tiles_x / tiles_y;
        for (int dg = 0; dg < p.dgroups; ++dg)
          for (int c = 0; c < p.chunks; ++c)
            for (int g0 = 0; g0 < p.f; g0 += p.gy) {
              mbar_wait_or_trap(a_empty + ra.stage, ra.phase ^ 1);
              mbar_arrive_expect_tx(a_full + ra.stage, p.a_box);
              tma_load_4d(aring + ra.stage * p.a_box, &ta, c * L, ox0 - pad, oy0 + g0 - pad, img,
                          a_full + ra.stage);
              ra.next(p.a_ring);
              if (w_res) continue;
              const int g1 = min(p.f, g0 + p.gy);
              for (int dy = g0; dy < g1; ++dy) {
                mbar_wait_or_trap(w_empty + rw.stage, rw.phase ^ 1);
                mbar_arrive_expect_tx(w_full + rw.stage, kWSlice);
                load_w<N, L>(wbuf + rw.stage * kWSlice, &tw, 0, c * L, dg * p.f + dy,
                             w_full + rw.stage);
                rw.next(p.w_ring);
              }
            }
      }
    }
    return;
  }

  // The consumers: warpgroup g owns slabs g S .. g S + S - 1, positions 64
  // g S on in a box (tile rows g S on); g is read from lane 0 so that it is
  // warp-uniform
  setmaxnreg_inc<kConsumerRegs>();
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int tid = threadIdx.x % kWarpgroup;
  const int lane = threadIdx.x % 32, warp = tid / 32;
  const unsigned a_base = smem_addr(aring) + g * S * kWgSlab * kARow, w_base = smem_addr(wbuf);
  constexpr int kDyStep = kLastCols * kARow;  // a dy tap: a tile row on
  float* eb = ebuf + g * S * kWgSlab * kE;  // this warpgroup's staged sums
  float acc[S][N / 2];
  const auto fence_acc = [&] {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) wgmma_fence_operand(acc[s][e]);
  };
  const auto release = [&](unsigned long long* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  if (w_res) mbar_wait_or_trap(w_full, 0);
  Ring ra, rw;
  int prev_w = -1, prev_a = -1;  // stages whose last products are in flight
  // One slice's products (chunk c, slice sl = (dx group, dy); its A rows at
  // a_addr) into the sums, then the stages the slice before read go back to
  // the producer: its W stage, and the box before's once its last slice is
  // done
  const auto slice = [&](int c, int sl, unsigned a_addr, auto first) {
    unsigned w_addr = w_base + (c * slices + sl) * kWSlice;
    if (!w_res) {
      mbar_wait_or_trap(w_full + rw.stage, rw.phase);
      w_addr = w_base + rw.stage * kWSlice;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      // lanes kk 16 .. + 15: 32 bytes into each swizzled A row, 8-row groups
      // one atom apart; W's rows kk 16 .. + 15
      const unsigned long long db = b_desc<N>(w_addr, kk, kBlock);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const unsigned long long da = a_desc<L>(a_addr + s * kWgSlab * kARow + kk * 32);
        if (decltype(first)::value && kk == 0)
          mma_first<N>(acc[s], da, db);
        else
          mma_ss<N>(acc[s], da, db, 1);
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
  // One box's slices (box bx of dx group dg: chunk, dy group), each dy tap
  // a tile row on
  const auto box = [&](int dg, int bx, auto first) {
    const int g0 = bx % p.groups * p.gy, c = bx / p.groups;
    mbar_wait_or_trap(a_full + ra.stage, ra.phase);
    unsigned a_addr = a_base + ra.stage * p.a_box;  // at dy = g0
    int dy = g0;
    if constexpr (decltype(first)::value) {
      slice(c, dg * p.f + dy++, a_addr, std::true_type{});
      a_addr += kDyStep;
    }
    for (const int g1 = min(p.f, g0 + p.gy); dy < g1; ++dy, a_addr += kDyStep)
      slice(c, dg * p.f + dy, a_addr, std::false_type{});
    prev_a = ra.stage;
    ra.next(p.a_ring);
  };
  const int boxes = p.chunks * p.groups;
  constexpr int rows = S * kWgSlab / kLastCols;  // this warpgroup's output rows
  const int per_row = p.out_cols * p.n;        // outputs of a row of the tile
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int ox0 = i % tiles_x * p.out_cols;
    const int oy0 = i / tiles_x % tiles_y * p.tile_rows + g * rows;
    const int img = i / tiles_x / tiles_y;
    for (int dg = 0; dg < p.dgroups; ++dg) {
      // the first box is peeled: its first products overwrite the sums
      // (write-only), so that no path reads a sum before one of them writes
      // it and the sums are not live around the tile loop
      box(dg, 0, std::true_type{});
      for (int bx = 1; bx < boxes; ++bx) box(dg, bx, std::false_type{});
      wgmma_wait<0>();
      fence_acc();
      if (!w_res) release(w_empty + prev_w);
      release(a_empty + prev_a);
      prev_w = prev_a = -1;

      // the epilogue: the sums into this warpgroup's staging once its
      // threads are done reading the last tile's, then the dx taps summed
      // a position at a time and written, f32
      bar_sync(1 + g, kWarpgroup);
      // this thread's sum rows rr, rr + 8 and columns q2, q2 + 1 of each n8 block
      const int rr = warp * 16 + lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c8 = 0; c8 < N / 8; ++c8) {
          float* e = eb + (s * kWgSlab + rr) * kE + c8 * 8 + q2;
          *reinterpret_cast<float2*>(e) = make_float2(acc[s][4 * c8], acc[s][4 * c8 + 1]);
          *reinterpret_cast<float2*>(e + 8 * kE) =
              make_float2(acc[s][4 * c8 + 2], acc[s][4 * c8 + 3]);
        }
      bar_sync(1 + g, kWarpgroup);
      const int d0 = dg * p.gdx, taps = min(p.f, d0 + p.gdx) - d0;
      for (int j = tid; j < rows * per_row; j += kWarpgroup) {
        const int r = j / per_row, rem = j - r * per_row;
        const int xo = rem / p.n, c = rem - xo * p.n;
        const int oy = oy0 + r, ox = ox0 + xo;
        if (oy >= OH || ox >= OW) continue;
        // tap dx = d0 + t: the sum row xo + dx, column t n + c
        const float* e = eb + (r * kLastCols + xo + d0) * kE + c;
        float v = 0.f;
        for (int t = 0; t < taps; ++t) v += e[t * (kE + p.n)];
        float* out = y + ((static_cast<size_t>(img) * OH + oy) * OW + ox) * p.n + c;
        *out = (dg == 0 ? __ldg(b + c) : *out) + v;
      }
    }
  }
}

template <int N, int L, int S, bool kSame>
int launch(const LastPlan& p, const void* x, const void* w, const float* b, float* y, int NI,
           int H, int W, int K, int smem_bytes, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  using C = Cols<N>;
  const int OH = kSame ? H : H - p.f + 1, OW = kSame ? W : W - p.f + 1;
  const cuuint64_t adims[4] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(NI)};
  const cuuint64_t astrides[3] = {2ull * K, 2ull * K * W, 2ull * K * W * H};
  const cuuint32_t abox[4] = {L, kLastCols, static_cast<cuuint32_t>(p.box_rows), 1};
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(p.npad), static_cast<cuuint64_t>(p.kp),
                               static_cast<cuuint64_t>(p.dgroups) * p.f};
  const cuuint64_t wstrides[2] = {2ull * p.npad, 2ull * p.npad * p.kp};
  const cuuint32_t wbox[3] = {C::kLanes, L, 1};
  CUtensorMap ta, tw;
  if (!bf16_map(&ta, x, 4, adims, astrides, abox, swizzle_of(2 * L)) ||
      !bf16_map(&tw, w, 3, wdims, wstrides, wbox, swizzle_of(C::kRow)))
    return bad;
  const int tiles_x = (OW + p.out_cols - 1) / p.out_cols;
  const int tiles_y = (OH + p.tile_rows - 1) / p.tile_rows;
  const long long items = static_cast<long long>(NI) * tiles_y * tiles_x;
  if (items > 0x7fffffffLL) return bad;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = conv_last_wgmma_kernel<N, L, S, kSame>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p, b, y, OH, OW, static_cast<int>(items),
                                                 tiles_x, tiles_y, ta, tw);
  return static_cast<int>(cudaGetLastError());
}

// the instance of the plan's columns and box lanes, its slabs last_slabs(N)
template <int N>
int launch_n(const LastPlan& p, const void* x, const void* w, const float* b, float* y, int NI,
             int H, int W, int K, int smem_bytes, cudaStream_t s) {
  constexpr int S = N <= 32 ? 2 : 1;
  return p.lanes == 32 ? launch<N, 32, S, false>(p, x, w, b, y, NI, H, W, K, smem_bytes, s)
                       : launch<N, 64, S, false>(p, x, w, b, y, NI, H, W, K, smem_bytes, s);
}

bool misaligned(const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16; }

}  // namespace

// y (N, H - f + 1, W - f + 1, n) f32 on `stream` from x (N, H, W, K) bf16,
// w (dgroups * f, kpad(K), npad) bf16 and b (n or more,) f32 (entry.pack_last),
// all contiguous and 16-byte aligned: the sums and the bias, no ReLU, at the
// plan of conv_last_plan.cuh. Refused (cudaErrorInvalidValue, nothing
// launched): a shape the plan does not take (f past 63, K not a multiple
// of 8, n past 128), a misaligned pointer, more than 2^31 - 1 tiles, or
// smem_bytes below the plan's. Returns cudaGetLastError() of the launch.
extern "C" int conv_last_forward_wgmma(const void* x, const void* w, const float* b, float* y,
                                       int N, int H, int W, int K, int f, int n, int smem_bytes,
                                       void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  LastPlan p;
  if (N <= 0 || N > 65535 || H < f || W < f || last_plan(p, f, K, n) ||
      smem_bytes < p.smem || misaligned(x) || misaligned(w) || misaligned(b) || misaligned(y))
    return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p.npad) {
    case 8:
      return launch_n<8>(p, x, w, b, y, N, H, W, K, smem_bytes, s);
    case 16:
      return launch_n<16>(p, x, w, b, y, N, H, W, K, smem_bytes, s);
    case 32:
      return launch_n<32>(p, x, w, b, y, N, H, W, K, smem_bytes, s);
    case 64:
      return launch_n<64>(p, x, w, b, y, N, H, W, K, smem_bytes, s);
    default:
      return launch_n<128>(p, x, w, b, y, N, H, W, K, smem_bytes, s);
  }
}

// The last layer of a SAME model (ops/fused/rrdb.py): y (N, H, W, n) f32
// from x (N, H, W, K) bf16, SAME-padded (f odd: an even f is refused);
// otherwise as conv_last_forward_wgmma. A plan with no SAME instance (16
// packed columns over 64-lane boxes: entry.same_instances) is refused.
extern "C" int conv_last_forward_wgmma_same(const void* x, const void* w, const float* b,
                                            float* y, int N, int H, int W, int K, int f, int n,
                                            int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  LastPlan p;
  if (N <= 0 || N > 65535 || H < 1 || W < 1 || f % 2 == 0 || last_plan(p, f, K, n) ||
      p.npad != 16 || p.lanes != 64 || smem_bytes < p.smem ||
      misaligned(x) || misaligned(w) || misaligned(b) || misaligned(y))
    return bad;
  return launch<16, 64, 2, true>(p, x, w, b, y, N, H, W, K, smem_bytes,
                                 static_cast<cudaStream_t>(stream));
}
