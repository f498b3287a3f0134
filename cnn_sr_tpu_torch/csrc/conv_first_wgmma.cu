// conv_first_forward_wgmma: the first layer of the bf16 stream on Hopper's
// warpgroup products:
//   y[p, 0:n] = bf16_rn(relu(sum over dy of A[p + dy row, 0:kx] @ W[dy] + b))
// where A is the f32 centred input x (N, H, W, c) quantised, q = round(clip(x,
// -1, 1) * 127) (ties to even, exact in bf16), and dx-expanded: lane dx c +
// ci of position (y, x) holds q(x[y][x + dx][ci]), zero past f c lanes and
// outside the image, kx = the f c lanes to a multiple of 16. W is the folded
// first-layer packing of ops/fused/entry.py: pack_bf16(first=True), (f, kx,
// npad) bf16 with lane dx c + ci of tap dy holding w1[dy, dx, ci] / 127; b its
// (npad,) f32 bias. Bf16 operands, f32 sums, then the bias, ReLU and one
// rounding to bf16; y (N, H - f + 1, W - f + 1, n) bf16 NHWC. Its plain version
// is ops/fused/reference.py: tap_layer(..., first=True). The chain
// (ops/fused/chain.py) takes it for every first layer of the bf16 stream.
//
// Replaces, with the chain's other kernels, the TPU kernel
// cnn_sr_tpu/ops/pallas_fused/kernel.py:_fused_tail_single (pl.pallas_call
// at kernel.py:730) in its bf16-stream mode (entry.py:32 fused_forward with
// dtype=bf16, input_int8=True): its first layer, plane.py:23
// plane_first_layer over the int8 plane of weights.py:123 _quantize_planes
// and the patches of weights.py:135 _im2col_patches(int8=True), with the
// 1/127 scale folded into w1 (weights.py:283).
//
// What bounds it (RGB L1 3 -> 32 at 1080p, 3.35 TB/s): its bytes, the f32
// input read once (24.9 MB) and the bf16 output written once (132.3 MB):
// 0.0469 ms. Its operations, 3 dy taps x 16 lanes x 32 columns a position,
// take 6 us at the bf16 peak. The mma.sync stage it replaces took 0.257 ms:
// one 16x16 tile a block and no overlap of its phases, a 4-byte load with
// integer divisions per expanded lane (each pixel read f times), and 16-byte
// stores of the output at about 0.5 TB/s.
//
// What the design does (plan: conv_first_plan.cuh), templated on the block's
// columns BN (npad up to 64, else 64-column chunks; fewer where the window of
// a wide f leaves no room) and the m64 slabs S a warpgroup owns (2 up to 32
// columns, 1 at 64 or where the window does not fit otherwise):
// * a persistent grid, one block an SM, walks the tiles round robin: cols
//   output columns (64, or the widest whose tile has f - 1 rows or more) x
//   4 S 64 / cols rows, so that one tile's stores drain while the next is
//   computed;
// * one producer warp lands each tile's raw pixels (its rows and f - 1
//   more, x cols + f - 1 columns x c channels, f32) a row at a time by
//   cp.async counted on an mbarrier, 16 bytes a copy where the input's rows
//   start on 16 bytes (else 4), zeros outside the image, into a ring of raw
//   stages, so that the next tiles' pixels land while this one is computed:
//   no integer division per element. (A tensor copy would need the input's
//   row stride to be a multiple of 16 bytes.) Where W does not stay
//   resident, the same warp's lane 0 streams its slices through a ring;
// * four consumer warpgroups quantise and dx-expand the pixels into the
//   window, a position's 8 lanes a 16-byte store, in planes of 8 lanes,
//   each position one 16-byte row of its plane: the no-swizzle core-matrix
//   layout of a K-major operand, whose start needs only 16-byte alignment.
//   So a dy tap is a start cols positions on, and the x halo is paid only in
//   the raw pixels; the y halo ((rows + f - 1) / rows) is the only position
//   expanded twice. Planes past the f c lanes are zeroed once. Two windows
//   where they fit: the next tile's is expanded while this one's products
//   run;
// * W by tensor copies: a slice is one (chunk of N, dy)'s kx rows x BN
//   columns, MN-major as packed, in boxes of 16 rows; resident (one copy a
//   block; RGB L1: 3 KB) where all of it fits beside two raw stages, else
//   through a ring;
// * each consumer warpgroup, which `setmaxnreg` gives part of the producer
//   warpgroup's registers, owns S m64 slabs (64 raster positions) of the
//   tile and runs wgmma m64nBNk16 per dy tap and k16 step, one group of
//   products where W is resident; the tile's first product is write-only
//   (peeled: a zeroed sum makes ptxas serialise the products, one read
//   before its first write stays live around the loop);
// * the epilogue: bias in f32, ReLU, one rounding to bf16 into this
//   warpgroup's output staging (two buffers where they fit, used in turn) in
//   the swizzle of its rows, then one tensor-copy store through a map over
//   (n, OW, OH, N), which clips the ragged edges and the lanes past n (n % 8
//   == 0 makes every stride a multiple of 16 bytes); a buffer is written
//   again once the store out of it has read it.
// Four consumer warpgroups, not two: on two, each tile half as tall, RGB L1
// takes 0.137 ms against 0.094 (probes/first_wgmma_parts.py, which also
// takes the kernel's parts out one at a time: each is a share of the time,
// none is most of it; PERF.md).
//
// One instance has a SAME twin (kSame; conv_first_forward_wgmma_same): the
// plan of Real-ESRGAN x4plus's conv_first (ops/fused/rrdb.py; 64 columns,
// one slab; entry.same_instances). The raw window starts (f - 1) / 2 up and
// left of the tile, zeros outside the image landed 4 bytes a copy; the RGB
// input in 0..1 is quantised to its 0..255 levels (the 1/255 folded into
// w); the output is a channel slice of a wider buffer; the epilogue is the
// bias alone, no activation (basicsr's conv_first).
//
// Measured: PERF.md (the kernel table, chip_smoke.py [layers]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv_first_plan.cuh"
#include "mma.cuh"
#include "wgmma_conv.cuh"

namespace {

// four consumer warpgroups (kFirstWgs) and a producer warpgroup, whose
// registers go to the consumers (setmaxnreg: 128 x 64 + 512 x 104 = 640 x 96)
constexpr int kFirstConsumers = kFirstWgs * kWarpgroup, kFirstThreads = kFirstConsumers + kWarpgroup;
constexpr int kFirstConsumerRegs = 104, kFirstProducerRegs = 64;
static_assert(kFirstConsumers * kFirstConsumerRegs + kWarpgroup * kFirstProducerRegs <=
                  65536 / kFirstThreads / 8 * 8 * kFirstThreads,
              "the registers handed over fit the block's");
constexpr int kFirstWarps = kFirstConsumers / 32;  // arrivals that empty a stage
constexpr int kWindowBar = 1 + kFirstWgs;  // the consumers' barrier (1 + g is warpgroup g's)

// 16 bytes global -> shared, of which the first `bytes` (0 to 16) are
// copied and the rest zero-filled
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// the int8 plane's integer of x (ties to even, as jnp.round), exact in bf16;
// kLevels (the SAME models' RGB input in 0..1): its 0..255 level, which the
// integer also is, exact in bf16
template <bool kLevels>
__device__ __forceinline__ float quantize(float v) {
  return rintf(fminf(fmaxf(v, -1.f), 1.f) * (kLevels ? 255.f : 127.f));
}

// tw: w as (npad, kx, f), box (BN's lanes, 16, 1); to: y as (n, OW, OH, N),
// box (BN's lanes, cols, S 64 / cols, 1). kSame: the layer of a SAME model,
// SAME-padded (the raw pixels (f - 1) / 2 up and left of the tile's output
// corner, zeros outside the image), its input quantised to 0..255 levels and
// its epilogue the bias alone; else VALID, the int8 plane, bias and ReLU
template <int BN, int S, bool kSame>
__global__ void __launch_bounds__(kFirstThreads, 1)
    conv_first_wgmma_kernel(const __grid_constant__ FirstPlan p, const float* __restrict__ x,
                            const float* __restrict__ b, int H, int W, int items, int tiles_x,
                            int tiles_y, const __grid_constant__ CUtensorMap tw,
                            const __grid_constant__ CUtensorMap to) {
  using C = Cols<BN>;
  constexpr int kStage = S * kWgSlab * BN * 2;       // a warpgroup's output buffer
  constexpr int kOutBlock = S * kWgSlab * C::kRow;  // a 64-lane block of it
  const int kx = p.kx, ks = kx / 16;
  const int w_block = kx * C::kRow;  // a 64-lane block of a W slice
  const int slices = p.nchunks * p.f;  // W slices: (chunk of N, dy)
  const int win_pos = p.win_rows * p.cols;  // positions of the window
  const int row_floats = p.iw * p.k;              // a raw row
  const int row_stride = (row_floats + 3) / 4 * 4;  // its floats in a raw stage
  extern __shared__ uint4 smem4[];
  // [W | output staging | windows | raw ring | mbarriers] from a 1024-aligned base
  unsigned char* wbuf = reinterpret_cast<unsigned char*>(smem4) +
                        ((1024 - smem_addr(smem4) % 1024) % 1024);
  unsigned char* obuf = wbuf + p.w_bytes;
  unsigned char* win = obuf + p.out_bytes;
  unsigned char* raw = win + p.win_bytes;
  auto* raw_full = reinterpret_cast<unsigned long long*>(raw + p.raw_ring * p.raw_bytes);
  auto* raw_empty = raw_full + kFirstMaxRaw;
  auto* w_full = raw_empty + kFirstMaxRaw;
  auto* w_empty = w_full + kWgMaxRing;
  const bool w_res = p.w_res;
  if (threadIdx.x == 0) {
    // raw full when the producer warp's 32 lanes' copies have landed, W full
    // when its tensor copies have; empty when every consumer warp is done
    // with the stage; resident W has one full
    for (int s = 0; s < p.raw_ring; ++s) {
      mbar_init(raw_full + s, 32);
      mbar_init(raw_empty + s, kFirstWarps);
    }
    for (int s = 0; s < (w_res ? 1 : p.w_ring); ++s) {
      mbar_init(w_full + s, 1);
      mbar_init(w_empty + s, kFirstWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFirstConsumers) {
    // The producer warpgroup's first warp: resident W once (lane 0); then
    // for each tile its raw pixels (all lanes) into the next raw stage once
    // the consumers have emptied it and, where W streams, the tile's W
    // slices into theirs (lane 0)
    setmaxnreg_dec<kFirstProducerRegs>();
    if (threadIdx.x >= kFirstConsumers + 32) return;
    const int lane = threadIdx.x % 32;
    // W slice sl = (chunk, dy) into dst: 16-row boxes of each 64-lane block
    const auto load_slice = [&](unsigned char* dst, int sl, unsigned long long* bar) {
      const int nc = sl / p.f, dy = sl - nc * p.f;
      for (int k16 = 0; k16 < ks; ++k16)
#pragma unroll
        for (int blk = 0; blk < C::kBlocks; ++blk)
          tma_load_3d(dst + blk * w_block + k16 * 16 * C::kRow, &tw,
                      nc * BN + blk * C::kLanes, k16 * 16, dy, bar);
    };
    if (lane == 0 && w_res) {
      mbar_arrive_expect_tx(w_full, slices * p.w_slice);
      for (int sl = 0; sl < slices; ++sl) load_slice(wbuf + sl * p.w_slice, sl, w_full);
    }
    Ring rr, rw;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const int ox0 = i % tiles_x * p.cols, oy0 = i / tiles_x % tiles_y * p.tile_rows;
      const int img = i / tiles_x / tiles_y;
      mbar_wait_or_trap(raw_empty + rr.stage, rr.phase ^ 1);
      float* dst = reinterpret_cast<float*>(raw + rr.stage * p.raw_bytes);
      if constexpr (kSame) {
        // the window's corner (f - 1) / 2 up and left of the tile's: the
        // floats of each row from lo to hi lie inside the image, rows above
        // and below it and the rest are zeros; 4 bytes a copy
        const int iy0 = oy0 - p.f / 2, ix0 = ox0 - p.f / 2;
        const int lo = max(0, -ix0) * p.k, hi = (W - ix0) * p.k;
        for (int r = 0; r < p.win_rows; ++r, dst += row_stride) {
          const int iy = iy0 + r;
          const bool row_in = iy >= 0 && iy < H;
          const long long at = ((static_cast<long long>(img) * H + iy) * W + ix0) * p.k;
          for (int j = lane; j < row_floats; j += 32) {
            const bool ok = row_in && j >= lo && j < hi;
            cp_async4(dst + j, ok ? x + at + j : x, ok);
          }
        }
      } else {
        // rows inside the image, then rows past it (zeros); 16 bytes a copy
        // where every row starts on 16 bytes, else 4
        const int in_row = (W - ox0) * p.k;  // floats of a raw row inside the image
        const int rows_in = min(p.win_rows, H - oy0);
        const float* src = x + ((static_cast<size_t>(img) * H + oy0) * W + ox0) * p.k;
        const bool vec = reinterpret_cast<std::uintptr_t>(src) % 16 == 0 && W * p.k % 4 == 0;
        for (int r = 0; r < p.win_rows; ++r, dst += row_stride, src += W * p.k) {
          const int in = r < rows_in ? in_row : 0;  // floats of the row to copy
          if (vec)
            for (int j = 4 * lane; j < row_floats; j += 128) {
              const int bytes = 4 * max(0, min(4, in - j));
              cp_async16_n(dst + j, bytes ? src + j : x, bytes);
            }
          else
            for (int j = lane; j < row_floats; j += 32)
              cp_async4(dst + j, j < in ? src + j : x, j < in);
        }
      }
      cp_async_mbar_arrive(raw_full + rr.stage);
      rr.next(p.raw_ring);
      if (lane == 0 && !w_res)
        for (int sl = 0; sl < slices; ++sl) {
          mbar_wait_or_trap(w_empty + rw.stage, rw.phase ^ 1);
          mbar_arrive_expect_tx(w_full + rw.stage, p.w_slice);
          load_slice(wbuf + rw.stage * p.w_slice, sl, w_full + rw.stage);
          rw.next(p.w_ring);
        }
      __syncwarp();
    }
    return;
  }

  // The consumers: warpgroup g owns slabs g S .. g S + S - 1 of the tile,
  // its positions 64 g S on (rows g S 64 / cols on); all of them expand the
  // window; g is read from lane 0 so that it is warp-uniform
  setmaxnreg_inc<kFirstConsumerRegs>();
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int tid = threadIdx.x % kWarpgroup;
  const int lane = threadIdx.x % 32, warp = tid / 32;
  const unsigned plane = win_pos * 16;  // bytes of a plane of 8 lanes (the LBO)
  const int win_buf = kx / 8 * plane;   // bytes of a window
  const unsigned w_base = smem_addr(wbuf);
  const int rows_wg = S * kWgSlab / p.cols;  // this warpgroup's output rows
  const int fc = p.f * p.k, real = (fc + 7) / 8;  // lanes and planes with input
  const int log_cols = __ffs(p.cols) - 1;
  // the planes past the input lanes are zero in every tile
  for (int wb = 0; wb < p.win_bufs; ++wb)
    for (int i = threadIdx.x; i < (kx / 8 - real) * win_pos; i += kFirstConsumers)
      *reinterpret_cast<uint4*>(win + wb * win_buf + real * plane + i * 16) =
          make_uint4(0, 0, 0, 0);
  // the descriptor of this warpgroup's first 64 positions in the first
  // window, lanes 0 .. 15: K-major in planes of 8 lanes (the LBO one plane),
  // 8-row core matrices 128 bytes apart; an operand further on adds its
  // 16-byte units to the start field
  const unsigned long long a_desc0 =
      wgmma_desc_interleave(smem_addr(win) + g * S * kWgSlab * 16, plane, 128);

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
  Ring rr, rw;
  // The next raw stage into window `buf`, a share of its positions each
  // consumer thread, then the stage goes back to the producer: lane dx c +
  // ci of position (r, col) is raw pixel (r, col + dx)'s channel ci, the raw
  // row's float col c + lane; 8 lanes a store
  const auto expand = [&](int buf) {
    mbar_wait_or_trap(raw_full + rr.stage, rr.phase);
    const float* rs = reinterpret_cast<const float*>(raw + rr.stage * p.raw_bytes);
    unsigned char* dst = win + buf * win_buf;
#pragma unroll 2
    for (int pos = threadIdx.x; pos < win_pos; pos += kFirstConsumers) {
      const float* src = rs + (pos >> log_cols) * row_stride + (pos & (p.cols - 1)) * p.k;
      for (int l0 = 0; l0 < fc; l0 += 8) {
        unsigned v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lo = l0 + 2 * e < fc ? quantize<kSame>(src[l0 + 2 * e]) : 0.f;
          const float hi = l0 + 2 * e + 1 < fc ? quantize<kSame>(src[l0 + 2 * e + 1]) : 0.f;
          const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
          v[e] = *reinterpret_cast<const unsigned*>(&h);
        }
        *reinterpret_cast<uint4*>(dst + (l0 >> 3) * plane + pos * 16) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    release(raw_empty + rr.stage);
    rr.next(p.raw_ring);
    fence_proxy_async();  // the window's generic writes before the products read them
  };
  if (w_res) mbar_wait_or_trap(w_full, 0);
  int prev_w = -1;  // the W stage whose last products are in flight
  // One dy tap's products (chunk nc) over the window whose descriptor is
  // `ad` into the sums. Where W streams, its stage is waited for and,
  // once the tap before's products are done, that tap's stage goes back to
  // the producer; resident, the taps are one group of products
  const auto tap = [&](unsigned long long ad, int nc, int dy, auto first) {
    unsigned w_addr = w_base + (nc * p.f + dy) * p.w_slice;
    if (!w_res) {
      mbar_wait_or_trap(w_full + rw.stage, rw.phase);
      w_addr = w_base + rw.stage * p.w_slice;
    }
    // the A operand of slab s, k16 step kk: 64 positions from s 64 + dy
    // cols on, lanes 16 kk on (two planes)
    const auto da = [&](int s, int kk) {
      return ad + static_cast<unsigned>(2 * kk * (plane >> 4) + s * kWgSlab + dy * p.cols);
    };
    wgmma_fence();
    int kk = 0;
    if constexpr (decltype(first)::value) {  // the chunk's first products, write-only
      const unsigned long long db = b_desc<BN>(w_addr, 0, w_block);
#pragma unroll
      for (int s = 0; s < S; ++s) mma_first<BN>(acc[s], da(s, 0), db);
      kk = 1;
    }
    for (; kk < ks; ++kk) {
      const unsigned long long db = b_desc<BN>(w_addr, kk, w_block);
#pragma unroll
      for (int s = 0; s < S; ++s) mma_ss<BN>(acc[s], da(s, kk), db, 1);
    }
    if (!w_res) {
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc();
      if (prev_w >= 0) release(w_empty + prev_w);
      prev_w = rw.stage;
      rw.next(p.w_ring);
    }
  };
  int step = 0;  // this warpgroup's (tile, chunk) epilogues so far
  if (static_cast<int>(blockIdx.x) < items) expand(0);
  for (int i = blockIdx.x, t = 0; i < items; i += gridDim.x, ++t) {
    const int ox0 = i % tiles_x * p.cols;
    const int oy0 = i / tiles_x % tiles_y * p.tile_rows + g * rows_wg;
    const int img = i / tiles_x / tiles_y;
    const int buf = t % p.win_bufs;
    const bool next = i + static_cast<int>(gridDim.x) < items;
    // the tile's window is whole, and (two windows) every warpgroup is done
    // with the other, which the tile before's products read
    bar_sync(kWindowBar, kFirstConsumers);
    const unsigned long long ad = a_desc0 + static_cast<unsigned>(buf * win_buf >> 4);
    for (int nc = 0; nc < p.nchunks; ++nc) {
      // the chunk's first tap is peeled: its first products overwrite the
      // sums (write-only), so that no path reads a sum before one of them
      // writes it and the sums are not live around the tile loop
      tap(ad, nc, 0, std::true_type{});
      for (int dy = 1; dy < p.f; ++dy) tap(ad, nc, dy, std::false_type{});
      wgmma_commit();
      // with two windows, the next tile's expands while these products run
      if (nc == 0 && next && p.win_bufs == 2) expand(buf ^ 1);
      wgmma_wait<0>();
      fence_acc();
      if (!w_res) {
        release(w_empty + prev_w);
        prev_w = -1;
      }

      // the epilogue: bias, ReLU, bf16 into this warpgroup's next output
      // buffer once the store out of it has read it, then one tensor copy a
      // block of 64 lanes
      const int n0 = nc * BN;
      unsigned char* ob = obuf + ((step % p.out_bufs) * kFirstWgs + g) * kStage;
      ++step;
      if (tid == 0) {
        if (p.out_bufs == 2)
          bulk_wait_read<1>();
        else
          bulk_wait_read<0>();
      }
      bar_sync(1 + g, kWarpgroup);
      const int rr0 = warp * 16 + lane / 4, q2 = (lane % 4) * 2;  // rows rr0, + 8; lanes q2, + 1
#pragma unroll
      for (int c8 = 0; c8 < BN / 8; ++c8) {
        const int col = c8 * 8 + q2, c = col % C::kLanes;
        const float b0 = __ldg(b + n0 + col), b1 = __ldg(b + n0 + col + 1);
        unsigned char* blk = ob + (col / C::kLanes) * kOutBlock;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int r = s * kWgSlab + rr0;
          if constexpr (kSame) {
            *reinterpret_cast<unsigned*>(blk + swz<C::kRow>(r, c)) =
                bias_bf16x2(acc[s][4 * c8], acc[s][4 * c8 + 1], b0, b1);
            *reinterpret_cast<unsigned*>(blk + swz<C::kRow>(r + 8, c)) =
                bias_bf16x2(acc[s][4 * c8 + 2], acc[s][4 * c8 + 3], b0, b1);
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
          tma_store_4d(&to, ob + blk * kOutBlock, n0 + blk * C::kLanes, ox0, oy0, img);
        bulk_commit();
      }
    }
    if (next && p.win_bufs == 1) {
      // one window: every warpgroup's products are done before it is refilled
      bar_sync(kWindowBar, kFirstConsumers);
      expand(0);
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // the stores have read the staging
}

template <int BN, int S, bool kSame>
int launch(const FirstPlan& p, const void* x, const void* w, const float* b, void* y, int N,
           int H, int W, int ys, int smem_bytes, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  using C = Cols<BN>;
  const int OH = kSame ? H : H - p.f + 1, OW = kSame ? W : W - p.f + 1;
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(p.npad), static_cast<cuuint64_t>(p.kx),
                               static_cast<cuuint64_t>(p.f)};
  const cuuint64_t wstrides[2] = {2ull * p.npad, 2ull * p.npad * p.kx};
  const cuuint32_t wbox[3] = {C::kLanes, 16, 1};
  const cuuint64_t odims[4] = {static_cast<cuuint64_t>(p.n), static_cast<cuuint64_t>(OW),
                               static_cast<cuuint64_t>(OH), static_cast<cuuint64_t>(N)};
  const cuuint64_t ostrides[3] = {2ull * ys, 2ull * ys * OW, 2ull * ys * OW * OH};
  const cuuint32_t obox[4] = {C::kLanes, static_cast<cuuint32_t>(p.cols),
                              static_cast<cuuint32_t>(S * kWgSlab / p.cols), 1};
  CUtensorMap tw, to;
  if (!bf16_map(&tw, w, 3, wdims, wstrides, wbox, swizzle_of(C::kRow)) ||
      !bf16_map(&to, y, 4, odims, ostrides, obox, swizzle_of(C::kRow)))
    return bad;
  const int tiles_x = (OW + p.cols - 1) / p.cols;
  const int tiles_y = (OH + p.tile_rows - 1) / p.tile_rows;
  const long long items = static_cast<long long>(N) * tiles_y * tiles_x;
  if (items > 0x7fffffffLL) return bad;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = conv_first_wgmma_kernel<BN, S, kSame>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM
  kernel<<<grid, kFirstThreads, smem_bytes, stream>>>(p, static_cast<const float*>(x), b, H, W,
                                                      static_cast<int>(items), tiles_x, tiles_y,
                                                      tw, to);
  return static_cast<int>(cudaGetLastError());
}

// the instance of the plan's block columns and slabs: first_slabs(BN), or 1
template <int BN>
int launch_bn(const FirstPlan& p, const void* x, const void* w, const float* b, void* y, int N,
              int H, int W, int smem_bytes, cudaStream_t s) {
  constexpr int S = BN <= 32 ? 2 : 1;
  if constexpr (S == 1)
    return launch<BN, 1, false>(p, x, w, b, y, N, H, W, p.n, smem_bytes, s);
  else
    return p.slabs == S ? launch<BN, S, false>(p, x, w, b, y, N, H, W, p.n, smem_bytes, s)
                        : launch<BN, 1, false>(p, x, w, b, y, N, H, W, p.n, smem_bytes, s);
}

bool misaligned(const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16; }

}  // namespace

// y (N, H - f + 1, W - f + 1, n) bf16 on `stream` from x (N, H, W, c) f32,
// w (f, kx, npad(n)) bf16 and b (npad(n),) f32 (entry.pack_bf16, first), all
// contiguous and 16-byte aligned: the quantised, dx-expanded input's products,
// bias, ReLU, one rounding to bf16, on the plan of conv_first_plan.cuh.
// Refused (cudaErrorInvalidValue, nothing launched): a shape the plan does
// not take (n not a multiple of 8, a window that does not fit), a misaligned
// pointer, more than 2^31 - 1 tiles, or smem_bytes below the plan's.
// Returns cudaGetLastError() of the launch.
extern "C" int conv_first_forward_wgmma(const void* x, const void* w, const float* b, void* y,
                                        int N, int H, int W, int c, int f, int n,
                                        int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  FirstPlan p;
  if (N <= 0 || N > 65535 || H < f || W < f || first_plan(p, f, c, n) ||
      smem_bytes < p.smem || misaligned(x) || misaligned(w) || misaligned(b) || misaligned(y))
    return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p.bn) {
    case 8:
      return launch_bn<8>(p, x, w, b, y, N, H, W, smem_bytes, s);
    case 16:
      return launch_bn<16>(p, x, w, b, y, N, H, W, smem_bytes, s);
    case 32:
      return launch_bn<32>(p, x, w, b, y, N, H, W, smem_bytes, s);
    default:
      return launch_bn<64>(p, x, w, b, y, N, H, W, smem_bytes, s);
  }
}

// The first layer of a SAME model (ops/fused/rrdb.py): y (N, H, W, n) bf16,
// n channels of a buffer of ys channels a pixel from the pointer y (a
// channel slice), from x (N, H, W, c) f32 in 0..1, SAME-padded, each value
// taken as its 0..255 level round(clip(x, -1, 1) 255) with the 1/255 folded
// into w (entry.pack_bf16(levels=255)); the sum and bias, no activation, one
// rounding to bf16. Refused as conv_first_forward_wgmma, and for an even f,
// ys below n or not a multiple of 8, or a plan with no SAME instance (64
// columns, one slab: entry.same_instances).
extern "C" int conv_first_forward_wgmma_same(const void* x, const void* w, const float* b,
                                             void* y, int ys, int N, int H, int W, int c, int f,
                                             int n, int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  FirstPlan p;
  if (N <= 0 || N > 65535 || H < 1 || W < 1 || f % 2 == 0 || first_plan(p, f, c, n) ||
      p.bn != 64 || p.slabs != 1 || smem_bytes < p.smem || misaligned(x) || misaligned(w) ||
      misaligned(b) || misaligned(y) || ys < n || ys % 8)
    return bad;
  return launch<64, 1, true>(p, x, w, b, y, N, H, W, ys, smem_bytes,
                             static_cast<cudaStream_t>(stream));
}
