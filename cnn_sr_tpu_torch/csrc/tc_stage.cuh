// tc_stage: one VALID f x f layer of the bf16 stream on the tensor cores, the
// stage the bf16 chain's first layer is built from (conv_layer.cu, one per
// launch) and wino5.cu's quad modes run on (TcAcc). The chain's middle
// layers are conv_wgmma.cu's and its last layer conv_last_wgmma.cu's; the
// bf16 fused kernel is fused_wgmma.cu; the f32 kernels run on
// ffma_stage.cuh.
//
// Replaces, with the chain's kernels, the TPU kernel
// cnn_sr_tpu/ops/pallas_fused/kernel.py:_fused_tail_single (pl.pallas_call
// at kernel.py:730) in its bf16-stream / int8-plane mode (entry.py:32
// fused_forward with dtype=bf16, input_int8=True) and the branches named in
// each kernel's header.
//
// The layer as an implicit GEMM: out[p, :] = sum over taps t of
// A[p + off_t, 0:K] @ W[t] (K x N), bf16 operands, f32 sums (mma.sync
// m16n8k16), then bias in f32, ReLU, and one rounding to bf16.
// * A, the window, lives in shared memory position-major, [y][x][K + 8]
//   bf16: one contraction row per position, padded by 16 bytes so that the
//   8 rows an ldmatrix reads start on distinct banks (the row stride is an
//   odd multiple of 16 bytes). It is loaded once, and every tap reads it
//   from shared memory: no tap re-reads its window from L2.
// * Taps are address offsets: ldmatrix takes one row address per lane, so
//   tap (dy, dx) of output position (y, x) is window row (y + dy, x + dx),
//   an offset and no copy. (A wgmma descriptor takes a start shifted by a
//   position too, in the no-swizzle layout or by the 128-byte swizzle's own
//   address bits, but not this window's rows of K + 8 lanes: fused_wgmma.cu
//   keeps its activations in planes of 8 lanes for that.) The chain's
//   middle layers run on conv_wgmma.cu and its last layer on
//   conv_last_wgmma.cu, where tensor copies land boxes whose dy shifts are
//   whole swizzle atoms. This stage keeps the one layer no tensor copy
//   lands: the first, whose dx-expanded window is quantised by the threads
//   as they load it.
// * B, the weights, are packed on the host as (taps, K_pad, N_pad) bf16
//   (ops/fused/entry.py: pack_bf16). A block streams one or more taps'
//   slabs through two cp.async stages while the current slab's mma.sync
//   run, or keeps the whole layer resident where it is small.
// * The first layer: the block quantises the f32 input while it loads the
//   window (round(clip(x, -1, 1) * 127), ties to even, exact in bf16) and
//   builds it dx-expanded, [y][x][dx * c + ci] zero-padded to a multiple of
//   16 lanes, so that the layer is f taps (one per dy) of K = 16 to 48.
//   The chain's first layer runs load_first_window (conv_layer.cu); the
//   fused kernel quantises its own window (fused_wgmma.cu).
// * K is padded to a multiple of 16 and N to 8, 16, 32, 64 or a multiple
//   of 128 (tc_npad); the padding lanes of weights and biases are zero, so
//   padded output lanes are ReLU(0) = 0.
//
// What bounds it on the H100: the first layer by its bytes (RGB L1 writes
// 1080p x 32 bf16 lanes); the multiply-adds at mma.sync's rate (about 2/3
// of wgmma's 989 TFLOP/s) come close (K = 16 dx-expanded lanes at N = 32).
// At N = 128 the ldmatrix traffic of the fragments nears the shared-memory
// rate first (each B fragment feeds two mma.sync), which held the RGB
// model's L5 and L6 at 1.24x and 1.55x cuDNN bf16's time until they moved
// to conv_wgmma.cu; at n <= 64 the stage ran far below mma.sync's rate,
// unpipelined across tiles (RGB L4 0.719 ms, 21% of the bf16 peak), until
// those middles moved there too; the last layer (RGB L7, 0.454-0.459 ms,
// 36% of its byte bound, its A fragments read again for every tap) until
// it moved to conv_last_wgmma.cu.
//
// Measured (chip_smoke.py [layers], 1080p, NVIDIA H100 80GB HBM3, 700 W):
// RGB L1 0.257 ms on this stage, 18% of its byte bound (cuDNN bf16
// 0.536).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 16;  // output tile of a chain block: 16 x 16 positions

// padded widths, as ops/fused/entry.py computes them
__host__ __device__ constexpr int tc_npad(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : (n + 127) / 128 * 128;
}
__host__ __device__ constexpr int tc_kx(int f, int c) { return (f * c + 15) / 16 * 16; }
// a block's columns: all of N up to 128, else 128-column chunks
__host__ __device__ constexpr int tc_nb(int npad) { return npad < 128 ? npad : 128; }
// a shared row of nb weight columns: 16 bytes of padding where nb / 8 is
// even, so that its row stride is an odd multiple of 16 bytes
__host__ __device__ constexpr int tc_ws(int nb) { return (nb / 8) % 2 ? nb : nb + 8; }

// A block of WARPS warps: WARPS_M x WARPS_N, each warp MT m16 tiles (16
// positions each) by NT n8 tiles; PB positions and NB columns a pass.
template <int NB_, int MT_, int WARPS_>
struct TcCfg {
  static constexpr int NB = NB_, MT = MT_, WARPS = WARPS_, THREADS = 32 * WARPS_;
  static constexpr int WARPS_N = NB >= 64 ? 2 : 1;
  static constexpr int WARPS_M = WARPS / WARPS_N;
  static constexpr int NT = NB / 8 / WARPS_N;
  static constexpr int PB = WARPS_M * MT * 16;
  static constexpr int WS = tc_ws(NB);
};

template <class C>
struct TcAcc {
  float v[C::MT][C::NT][4];
  int row[C::MT];   // this lane's window row of each m16 tile (tap 0)
  bool live[C::MT];  // the m16 tile has a position inside the layer's output
  int wm, wn_col, lane;

  // the pass at positions [pb, pb + PB) of an (oh, ow) output read from a
  // window ww positions wide; zero sums
  __device__ __forceinline__ void begin(int pb, int P, int ow, int ww) {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    wm = warp / C::WARPS_N;
    wn_col = (warp % C::WARPS_N) * C::NT * 8;
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      const int m0 = pb + (i * C::WARPS_M + wm) * 16;
      live[i] = m0 < P;
      // positions past the output repeat its last one (computed, never stored)
      const int p = min(m0 + (lane & 15), P - 1);
      row[i] = (p / ow) * ww + p % ow;
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[i][j][e] = 0.f;
    }
  }

  // the output position of value pair h (0: v[..][0..1], 1: v[..][2..3]) of tile i
  __device__ __forceinline__ int pos(int pb, int i, int h) const {
    return pb + (i * C::WARPS_M + wm) * 16 + (lane >> 2) + 8 * h;
  }
  // the block column of value pair j
  __device__ __forceinline__ int col(int j) const { return wn_col + j * 8 + (lane & 3) * 2; }

  // taps [t0, t1) (tap t = (t / fx, t % fx), its window offset
  // (t / fx) ww + t % fx) over K lanes of the window win (row stride as),
  // with the weights wst [t - t0][K][WS] in shared memory
  __device__ __forceinline__ void taps(const bf16* win, int as, int ww, int fx, const bf16* wst,
                                       int K, int t0, int t1) {
    for (int t = t0; t < t1; ++t) {
      const int off = (t / fx) * ww + t % fx;
      const bf16* wt = wst + (t - t0) * K * C::WS + wn_col;
      for (int k16 = 0; k16 < K; k16 += 16) {
        unsigned af[C::MT][4];
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
          if (live[i]) ldmatrix_x4(af[i], win + (row[i] + off) * as + k16 + (lane >> 4) * 8);
        const bf16* wk = wt + (k16 + (lane & 15)) * C::WS;
#pragma unroll
        for (int nj = 0; nj < C::NT / 2; ++nj) {
          // b[0], b[1]: n8 tile 2 nj (k 0-7, 8-15); b[2], b[3]: tile 2 nj + 1
          unsigned b[4];
          ldmatrix_x4_trans(b, wk + nj * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int i = 0; i < C::MT; ++i)
            if (live[i]) {
              mma_bf16(v[i][2 * nj], af[i], b[0], b[1]);
              mma_bf16(v[i][2 * nj + 1], af[i], b[2], b[3]);
            }
        }
        if constexpr (C::NT % 2) {
          unsigned b[2];
          ldmatrix_x2_trans(b, wk + (C::NT - 1) * 8);
#pragma unroll
          for (int i = 0; i < C::MT; ++i)
            if (live[i]) mma_bf16(v[i][C::NT - 1], af[i], b[0], b[1]);
        }
      }
    }
  }
};

// Taps [t0, t1) of the packed weights wg (taps, kp, npad), all kp rows,
// columns [n0, n0 + nb), into dst [t - t0][kp][ws], by cp.async.
__device__ __forceinline__ void load_weights_async(const bf16* __restrict__ wg, int kp, int npad,
                                                   int n0, int nb, int ws, int t0, int t1,
                                                   bf16* dst) {
  const int pieces = nb / 8, per_tap = kp * pieces, total = (t1 - t0) * per_tap;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int q = i % pieces, r = (i / pieces) % kp, tt = i / per_tap;
    cp_async16(dst + (tt * kp + r) * ws + q * 8,
               wg + (static_cast<size_t>(t0 + tt) * kp + r) * npad + n0 + q * 8, true);
  }
}

// The first layer's window, dx-expanded and quantised: dst[r][x][dx c + ci]
// = q(xi[gy0 + r][gx0 + x + dx][ci]) for dx < f, 0 past f c lanes and
// outside the (H, W, c) image; rows x cols positions of kx lanes, row
// stride as. Plain loads and stores (the quantisation sits between them).
__device__ __forceinline__ void load_first_window(const float* __restrict__ xi, int H, int W,
                                                  int c, int gy0, int gx0, int rows, int cols,
                                                  int f, int kx, int as, bf16* dst) {
  const int total = rows * cols * kx;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int ln = i % kx, pos = i / kx;
    const int dx = ln / c, ci = ln % c;
    const int gy = gy0 + pos / cols, gx = gx0 + pos % cols + dx;
    const float v = (dx < f && gy < H && gx < W) ? __ldg(xi + (static_cast<size_t>(gy) * W + gx) * c + ci) : 0.f;
    // the int8 plane's integers (ties to even, as jnp.round), exact in bf16
    dst[pos * as + ln] = __float2bfloat16_rn(rintf(fminf(fmaxf(v, -1.f), 1.f) * 127.f));
  }
}

// The layer's sums over all kp rows of the packed weights wg (taps, kp,
// npad), columns [n0, n0 + NB), streamed in groups of tps taps through two
// stages at wbuf (one where a single group holds every tap), after
// load_win() fills the window (cp.async or plain stores). Starts and ends
// with a __syncthreads, so the caller may reuse the window and wbuf right
// after.
template <class C, class LoadWin>
__device__ __forceinline__ void tc_stream(TcAcc<C>& acc, LoadWin load_win, const bf16* win,
                                          int as, int ww, int fx, int taps, int tps,
                                          const bf16* __restrict__ wg, int kp, int npad, int n0,
                                          bf16* wbuf) {
  const int groups = (taps + tps - 1) / tps;
  const int stage = tps * kp * C::WS;
  __syncthreads();  // every warp is done with the window and both stages
  load_win();
  load_weights_async(wg, kp, npad, n0, C::NB, C::WS, 0, min(tps, taps), wbuf);
  cp_async_commit();
  for (int g = 0; g < groups; ++g) {
    if (g + 1 < groups)
      load_weights_async(wg, kp, npad, n0, C::NB, C::WS, (g + 1) * tps, min(taps, (g + 2) * tps),
                         wbuf + ((g + 1) & 1) * stage);
    cp_async_commit();  // an empty group after the last keeps the count
    cp_async_wait_1();  // group g's copies (and the window's) have landed
    __syncthreads();
    acc.taps(win, as, ww, fx, wbuf + (g & 1) * stage, kp, g * tps, min(taps, (g + 1) * tps));
    __syncthreads();  // every warp is done with the stage before it is refilled
  }
}

// Epilogue into a shared bf16 tile dst [p][ds] (the next layer's window):
// bias in f32, ReLU, one rounding to bf16 (round to nearest even).
template <class C>
__device__ __forceinline__ void tc_store_smem(const TcAcc<C>& acc, int pb, int P,
                                              const float* __restrict__ b, bf16* dst, int ds) {
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
    if (!acc.live[i]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = acc.pos(pb, i, h);
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int c = acc.col(j);
        *reinterpret_cast<__nv_bfloat162*>(dst + p * ds + c) =
            __floats2bfloat162_rn(fmaxf(acc.v[i][j][2 * h] + __ldg(b + c), 0.f),
                                  fmaxf(acc.v[i][j][2 * h + 1] + __ldg(b + c + 1), 0.f));
      }
    }
  }
}

// Epilogue of a chain layer that feeds another: bias, ReLU, bf16, staged as
// a PB x WS tile at stage (shared memory the caller no longer reads), then
// written to yi (one image of (OH, OW, n) bf16, n % 8 == 0) in 16-byte
// pieces, masking the ragged edge and the columns past n.
template <class C>
__device__ __forceinline__ void tc_store_bf16(const TcAcc<C>& acc, int ow,
                                              const float* __restrict__ b, bf16* stage, bf16* yi,
                                              int gy0, int gx0, int OH, int OW, int n, int n0) {
  tc_store_smem<C>(acc, 0, C::PB, b, stage, C::WS);
  __syncthreads();
  constexpr int pieces = C::NB / 8;
  for (int e = threadIdx.x; e < C::PB * pieces; e += blockDim.x) {
    const int p = e / pieces, q = e % pieces;
    const int gy = gy0 + p / ow, gx = gx0 + p % ow, c = n0 + q * 8;
    if (gy < OH && gx < OW && c < n)
      *reinterpret_cast<uint4*>(yi + (static_cast<size_t>(gy) * OW + gx) * n + c) =
          *reinterpret_cast<const uint4*>(stage + p * C::WS + q * 8);
  }
}

}  // namespace
