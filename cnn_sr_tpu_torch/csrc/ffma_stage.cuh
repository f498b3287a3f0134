// ffma_stage: one VALID f x f convolution layer over a shared tile in f32,
// as a register-tiled FFMA implicit GEMM whose weights stream through
// shared memory in cp.async stages. Both f32 kernels of this directory are
// built from it: fused_srcnn.cu runs three ffma_stage layers a block,
// conv_layer.cu one layer a launch on its parts (FfmaAcc: begin,
// accumulate; ffma_store), with the window streamed beside the weights.
//
// Tiles are channel-major and column-major, [c][x][y], with an odd column
// stride (ffma_col_stride): a column is contiguous, so a thread reads its
// rows at fixed offsets from one address, and the lanes of a warp, on
// neighbouring columns, hit distinct banks. Each thread owns PX output
// rows of one column for NB output channels (PX * NB accumulators). For
// each input channel and each dx it loads the PX + f - 1 activations of
// its input column into registers once and runs all f dy taps over them;
// each weight vector (NB floats, one warp-uniform 16-byte broadcast per 4)
// feeds PX FMAs. With f known at compile time
// (F > 0) the tap loops unroll; F = 0 takes any f in a runtime loop.
//
// Weights come packed by ops/fused/entry.py:pack_f32: (k, f * f, npad)
// f32, npad = n rounded up to NB with zero columns, and a zero-padded
// (npad,) bias, so a chunk of input channels is one contiguous, 16-byte
// aligned copy and no lane tests its channel. In the fused kernel the
// shared buffer wbuf holds the whole layer where it fits, else two stages
// of as many input channels as fit in half of it (chunk c + 1 lands by
// cp.async while chunk c is computed), else one stage (FfmaChunks).
#pragma once

#include <cuda_runtime.h>

#include "ffma_plan.cuh"
#include "mma.cuh"

namespace {

// V consecutive floats at p (16-byte aligned, V a multiple of 4) into v
template <int V>
__device__ __forceinline__ void ffma_load(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + j);
    v[j] = q.x;
    v[j + 1] = q.y;
    v[j + 2] = q.z;
    v[j + 3] = q.w;
  }
}

// cn input channels' packed weights (cn * per_ch floats, from src) into
// dst by 16-byte cp.async copies, every thread of the block taking a share
__device__ __forceinline__ void ffma_fetch(float* dst, const float* __restrict__ src, int floats) {
  for (int i = threadIdx.x; i < floats / 4; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i, true);
  cp_async_commit();
}

// One thread's item of a layer: PX output rows of one column for NB output
// channels, in registers, summed over as many chunks of input channels as
// the caller streams through shared memory.
template <int NB, int PX, int F>
struct FfmaAcc {
  static_assert(NB % 4 == 0, "NB must be a multiple of 4");
  float v[PX][NB];

  // begin: the item's NB biases (b, 16-byte aligned) into every row
  __device__ __forceinline__ void begin(const float* __restrict__ b) {
    float bv[NB];
    ffma_load<NB>(b, bv);
#pragma unroll
    for (int q = 0; q < PX; ++q)
#pragma unroll
      for (int j = 0; j < NB; ++j) v[q][j] = bv[j];
  }

  // accumulate: the FMAs of cn input channels in shared memory. ic: the
  // item's column in the first channel's tile (its first input row), the
  // next channel plane floats on, rows at stride 1 and columns at stride
  // is; wc: the first channel's weights at the item's first column, taps
  // (dy * f + dx) wrow floats apart and channels per_ch apart.
  __device__ __forceinline__ void accumulate(const float* ic, int plane, int is, const float* wc,
                                             int per_ch, int wrow, int f_rt, int cn) {
    const int f = F > 0 ? F : f_rt;
    for (int cc = 0; cc < cn; ++cc) {
      const float* icc = ic + cc * plane;
      const float* wcc = wc + cc * per_ch;
      if constexpr (F > 0) {
        auto column = [&](int dx) {
          float a[PX + F - 1];
          const float* col = icc + dx * is;
#pragma unroll
          for (int r = 0; r < PX + F - 1; ++r) a[r] = col[r];
#pragma unroll
          for (int dy = 0; dy < F; ++dy) {
            float wv[NB];
            ffma_load<NB>(wcc + (dy * F + dx) * wrow, wv);
#pragma unroll
            for (int q = 0; q < PX; ++q)
#pragma unroll
              for (int j = 0; j < NB; ++j) v[q][j] = fmaf(a[q + dy], wv[j], v[q][j]);
          }
        };
        if constexpr (F <= 5) {
#pragma unroll
          for (int dx = 0; dx < F; ++dx) column(dx);
        } else {
#pragma unroll 1
          for (int dx = 0; dx < F; ++dx) column(dx);
        }
      } else {
        for (int dy = 0; dy < f; ++dy) {
          for (int dx = 0; dx < f; ++dx) {
            float wv[NB];
            ffma_load<NB>(wcc + (dy * f + dx) * wrow, wv);
            const float* col = icc + dx * is + dy;
#pragma unroll
            for (int q = 0; q < PX; ++q) {
              const float a = col[q];
#pragma unroll
              for (int j = 0; j < NB; ++j) v[q][j] = fmaf(a, wv[j], v[q][j]);
            }
          }
        }
      }
    }
  }
};

// store: the item's rows row0 + q < oh (ReLU'd if RELU), channels n0 + j < n.
// TO_GLOBAL = false: into shared out[n][ow][os] at column x (gy0 ... gw unused).
// TO_GLOBAL = true: NHWC into out (one image of (gh, gw, n)) at (gy0 + row,
// gx0 + x) where inside it; VEC (n % 4 == 0 and n0 % 4 == 0, out 16-byte
// aligned) in 16-byte stores.
template <int NB, int PX, int F, bool RELU, bool TO_GLOBAL, bool VEC = false>
__device__ __forceinline__ void ffma_store(const FfmaAcc<NB, PX, F>& acc, float* out, int os,
                                           int ow, int n, int n0, int x, int row0, int oh,
                                           int gy0, int gx0, int gh, int gw) {
  auto act = [](float a) { return RELU ? fmaxf(a, 0.f) : a; };
#pragma unroll
  for (int q = 0; q < PX; ++q) {
    const int row = row0 + q;
    if (row >= oh) break;
    if constexpr (TO_GLOBAL) {
      const int gy = gy0 + row, gx = gx0 + x;
      if (gy >= gh || gx >= gw) continue;
      float* dst = out + (static_cast<size_t>(gy) * gw + gx) * n + n0;
      if constexpr (VEC) {
#pragma unroll
        for (int j = 0; j < NB; j += 4)
          if (n0 + j < n)
            *reinterpret_cast<float4*>(dst + j) =
                make_float4(act(acc.v[q][j]), act(acc.v[q][j + 1]), act(acc.v[q][j + 2]),
                            act(acc.v[q][j + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (n0 + j < n) dst[j] = act(acc.v[q][j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (n0 + j < n) out[(n0 + j) * ow * os + x * os + row] = act(acc.v[q][j]);
    }
  }
}

// One layer: VALID cross-correlation of the shared tile in[k][iw][is] (ih
// rows, column stride is = ffma_col_stride(ih, f, PX)) with the packed
// weights w (k, f * f, npad) and bias b (npad), into an (oh, ow, n) result
// with oh = ih - f + 1, ow = iw - f + 1.
// TO_GLOBAL = false: stored into shared out[n][ow][os].
// TO_GLOBAL = true: stored NHWC into out (one image of (gh, gw, n)) at
// offset (gy0, gx0), where inside that image. Only the real n channels
// are stored. npad % NB == 0 and NB % 4 == 0 (16-byte weight reads); wbuf
// 16-byte aligned. Every thread of the block calls it (it synchronises).
template <int NB, int PX, int F, bool RELU, bool TO_GLOBAL>
__device__ void ffma_stage(const float* in, int k, int ih, int iw, int is,
                           const float* __restrict__ w, const float* __restrict__ b, int f_rt,
                           int n, int npad, float* wbuf, int wbuf_floats, float* out, int os,
                           int gy0, int gx0, int gh, int gw) {
  static_assert(NB % 4 == 0, "NB must be a multiple of 4");
  const int f = F > 0 ? F : f_rt;
  const int oh = ih - f + 1, ow = iw - f + 1;
  const int per_ch = f * f * npad;
  const FfmaChunks ch(k, per_ch, wbuf_floats);
  const int nchunks = (k + ch.ck - 1) / ch.ck;
  const int groups = npad / NB;
  const int rblocks = (oh + PX - 1) / PX;
  const int items = groups * rblocks * ow;
  const int plane = iw * is;

  __syncthreads();  // the previous layer is done with wbuf and has stored `in`
  if (nchunks == 1) {  // the whole layer stays resident across passes
    ffma_fetch(wbuf, w, k * per_ch);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int it0 = 0; it0 < items; it0 += blockDim.x) {
    const bool active = it0 + static_cast<int>(threadIdx.x) < items;
    const int it = min(it0 + static_cast<int>(threadIdx.x), items - 1);
    const int x = it % ow;
    const int t = it / ow;
    const int row0 = (t % rblocks) * PX;
    const int n0 = (t / rblocks) * NB;

    // the thread's column from its first input row; rows past the tile's
    // last (a ragged last row block) are read inside the column's stride
    // and their outputs never stored
    const int col0 = x * is + row0;

    FfmaAcc<NB, PX, F> acc;
    acc.begin(b + n0);
    // the FMAs of cn input channels from c0, their weights at ws
    auto compute = [&](const float* ws, int c0, int cn) {
      acc.accumulate(in + c0 * plane + col0, plane, is, ws + n0, per_ch, npad, f, cn);
    };

    if (nchunks == 1) {
      if (active) compute(wbuf, 0, k);
    } else {
      // stage s at wbuf + s * ck * per_ch; chunk c + 1 is in flight while
      // chunk c is computed where there are two stages
      const int stage_floats = ch.ck * per_ch;
      ffma_fetch(wbuf, w, stage_floats);
      for (int c = 0; c < nchunks; ++c) {
        const int c0 = c * ch.ck;
        const int cn = min(ch.ck, k - c0);
        float* cur = wbuf + (ch.stages == 2 ? (c & 1) * stage_floats : 0);
        if (ch.stages == 2 && c + 1 < nchunks) {
          const int c1 = c0 + ch.ck;
          ffma_fetch(wbuf + ((c + 1) & 1) * stage_floats, w + static_cast<size_t>(c1) * per_ch,
                     min(ch.ck, k - c1) * per_ch);
          cp_async_wait_1();
        } else {
          cp_async_wait_all();
        }
        __syncthreads();  // chunk c is visible to every thread
        if (active) compute(cur, c0, cn);
        __syncthreads();  // every thread is done with chunk c's stage
        if (ch.stages == 1 && c + 1 < nchunks)
          ffma_fetch(wbuf, w + static_cast<size_t>(c0 + cn) * per_ch,
                     min(ch.ck, k - c0 - cn) * per_ch);
      }
    }
    if (!active) continue;
    ffma_store<NB, PX, F, RELU, TO_GLOBAL>(acc, out, os, ow, n, n0, x, row0, oh, gy0, gx0, gh,
                                           gw);
  }
}

}  // namespace
