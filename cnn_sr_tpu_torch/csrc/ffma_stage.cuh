// ffma_stage: one VALID f x f convolution layer over a shared tile in f32,
// as a register-tiled FFMA implicit GEMM whose weights stream through
// shared memory in cp.async stages. fused_srcnn.cu runs its three layers
// on it.
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
// aligned copy and no lane tests its channel. The shared buffer wbuf holds
// the whole layer where it fits, else two stages of as many input channels
// as fit in half of it (chunk c + 1 lands by cp.async while chunk c is
// computed), else one stage.
#pragma once

#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

// The column stride of a tile of `rows` rows read by a layer of f taps and
// PX rows a thread: odd (conflict-free across columns), and long enough
// that a thread's last row block reads inside its column.
// ops/fused/entry.py:col_stride computes the same.
__host__ __device__ inline int ffma_col_stride(int rows, int f, int px) {
  const int oh = rows - f + 1;
  const int need = (oh + px - 1) / px * px + f - 1;
  const int s = need > rows ? need : rows;
  return s | 1;
}

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

// How a layer's packed weights pass through wbuf (wbuf_floats, a multiple
// of 4): `ck` input channels a chunk, in `stages` buffers of ck * per_ch
// floats. ops/fused/entry.py:weight_stages computes the same.
struct FfmaChunks {
  int ck, stages;
  __host__ __device__ FfmaChunks(int k, int per_ch, int wbuf_floats) {
    if (k * per_ch <= wbuf_floats) {
      ck = k;
      stages = 1;
    } else if (2 * per_ch <= wbuf_floats) {
      ck = (wbuf_floats / 2) / per_ch;
      stages = 2;
    } else {
      ck = wbuf_floats / per_ch;
      stages = 1;
    }
  }
};

// cn input channels' packed weights (cn * per_ch floats, from src) into
// dst by 16-byte cp.async copies, every thread of the block taking a share
__device__ __forceinline__ void ffma_fetch(float* dst, const float* __restrict__ src, int floats) {
  for (int i = threadIdx.x; i < floats / 4; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i, true);
  cp_async_commit();
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

    float acc[PX][NB];
    {
      float bv[NB];
      ffma_load<NB>(b + n0, bv);
#pragma unroll
      for (int q = 0; q < PX; ++q)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[q][j] = bv[j];
    }

    // the FMAs of cn input channels from c0, their weights at ws
    auto compute = [&](const float* ws, int c0, int cn) {
      for (int cc = 0; cc < cn; ++cc) {
        const float* ic = in + (c0 + cc) * plane + col0;
        const float* wc = ws + cc * per_ch + n0;
        if constexpr (F > 0) {
          auto column = [&](int dx) {
            float a[PX + F - 1];
            const float* col = ic + dx * is;
#pragma unroll
            for (int r = 0; r < PX + F - 1; ++r) a[r] = col[r];
#pragma unroll
            for (int dy = 0; dy < F; ++dy) {
              float wv[NB];
              ffma_load<NB>(wc + (dy * F + dx) * npad, wv);
#pragma unroll
              for (int q = 0; q < PX; ++q)
#pragma unroll
                for (int j = 0; j < NB; ++j) acc[q][j] = fmaf(a[q + dy], wv[j], acc[q][j]);
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
              ffma_load<NB>(wc + (dy * f + dx) * npad, wv);
              const float* col = ic + dx * is + dy;
#pragma unroll
              for (int q = 0; q < PX; ++q) {
                const float a = col[q];
#pragma unroll
                for (int j = 0; j < NB; ++j) acc[q][j] = fmaf(a, wv[j], acc[q][j]);
              }
            }
          }
        }
      }
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

#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const int row = row0 + q;
      if (row >= oh) break;
      if constexpr (TO_GLOBAL) {
        const int gy = gy0 + row, gx = gx0 + x;
        if (gy >= gh || gx >= gw) continue;
        float* dst = out + (static_cast<size_t>(gy) * gw + gx) * n + n0;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (n0 + j < n) dst[j] = RELU ? fmaxf(acc[q][j], 0.f) : acc[q][j];
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (n0 + j < n)
            out[(n0 + j) * ow * os + x * os + row] = RELU ? fmaxf(acc[q][j], 0.f) : acc[q][j];
      }
    }
  }
}

}  // namespace
