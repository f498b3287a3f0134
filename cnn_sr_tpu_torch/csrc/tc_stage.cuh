// tc_stage: the mma.sync m16n8k16 fragment layout that wino5.cu's quad modes
// run on (probes/wino5.py, a port of tools/wino5_probe.py): a block's warps
// (TcCfg) and one warp's sums and window rows (TcAcc), bf16 operands and f32
// sums. The bf16 stream's layers all run on wgmma: the chain's first layer
// on conv_first_wgmma.cu, its middle layers on conv_wgmma.cu, its last on
// conv_last_wgmma.cu, the fused stack on fused_wgmma.cu; the f32 kernels run
// on ffma_stage.cuh.
//
// A, a window, lives in shared memory position-major, [y][x][K + pad] bf16:
// one contraction row per position, and tap (dy, dx) of output position (y,
// x) is window row (y + dy, x + dx), an ldmatrix row address and no copy. B,
// the weights, sit in shared memory as [K][WS] rows, WS = tc_ws(NB): padded by
// 16 bytes where NB / 8 is even, so that ldmatrix rows fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
  int row[C::MT];  // this lane's window row of each m16 tile (tap 0)
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
};

}  // namespace
