// conv_stage: one VALID f x f convolution layer over a channel-major shared
// tile in f32, the FMA stage that both f32 kernels of this directory are
// built from (fused_srcnn.cu runs three of them per block, conv_layer.cu
// one). The bf16 stream runs on the tensor cores (tc_stage.cuh).
#pragma once

#include <cuda_runtime.h>

namespace {

// V consecutive floats at p (16-byte aligned), in float4 reads
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + j);
    v[j] = q.x;
    v[j + 1] = q.y;
    v[j + 2] = q.z;
    v[j + 3] = q.w;
  }
}

// V values (ReLU'd if RELU) stored at p (16-byte aligned) in float4 stores
template <int V, bool RELU>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    float4 q = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    if (RELU) q = make_float4(fmaxf(q.x, 0.f), fmaxf(q.y, 0.f), fmaxf(q.z, 0.f), fmaxf(q.w, 0.f));
    *reinterpret_cast<float4*>(p + j) = q;
  }
}

// One layer: VALID cross-correlation of the channel-major shared tile
// in[k][ih][iw] with HWIO weights w (f, f, k, n) plus f32 bias b, into an
// (oh, ow, n) result with oh = ih - f + 1, ow = iw - f + 1.
// TO_GLOBAL = false: stored channel-major into shared out[n][oh][ow].
// TO_GLOBAL = true: stored NHWC into out (one image of (gh, gw, n)) at
// offset (gy0, gx0), where inside that image.
// The weights pass through the shared buffer wbuf (wbuf_elems, at least
// f * f * n) in chunks of input channels, laid out [c][tap][n].
// VEC (16-byte weight reads, and 16-byte stores with TO_GLOBAL) needs
// n % NB == 0, NB a multiple of 4, a 16-byte aligned wbuf and, with
// TO_GLOBAL, out.
template <int NB, int PX, bool VEC, bool RELU, bool TO_GLOBAL>
__device__ void conv_stage(const float* in, int k, int ih, int iw, const float* __restrict__ w,
                           const float* __restrict__ b, int f, int n, float* wbuf, int wbuf_elems,
                           float* out, int oh, int ow, int gy0, int gx0, int gh, int gw) {
  const int taps = f * f;
  const int ck = min(k, wbuf_elems / (taps * n));
  const int groups = (n + NB - 1) / NB;
  const int rblocks = (oh + PX - 1) / PX;
  const int items = groups * rblocks * ow;
  const int plane = ih * iw;
  for (int it0 = 0; it0 < items; it0 += blockDim.x) {
    const bool active = it0 + static_cast<int>(threadIdx.x) < items;
    const int it = min(it0 + static_cast<int>(threadIdx.x), items - 1);
    const int x = it % ow;
    const int t = it / ow;
    const int rb = t % rblocks;
    const int n0 = (t / rblocks) * NB;
    const int n_left = n - n0;

    // rows past the tile's last one repeat it (computed, never stored),
    // which keeps every shared-memory read inside the tile
    int base[PX];
#pragma unroll
    for (int q = 0; q < PX; ++q) base[q] = min(rb * PX + q, oh - 1) * iw + x;

    float acc[PX][NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float bj = j < n_left ? __ldg(b + n0 + j) : 0.f;
#pragma unroll
      for (int q = 0; q < PX; ++q) acc[q][j] = bj;
    }

    for (int c0 = 0; c0 < k; c0 += ck) {
      const int cn = min(ck, k - c0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = threadIdx.x; i < cn * taps * n; i += blockDim.x) {
        const int tap = (i / n) % taps, cc = i / (n * taps);
        wbuf[i] = __ldg(w + (static_cast<size_t>(tap) * k + c0 + cc) * n + i % n);
      }
      __syncthreads();
      if (!active) continue;
      for (int cc = 0; cc < cn; ++cc) {
        const float* inc = in + (c0 + cc) * plane;
        const float* wc = wbuf + cc * taps * n + n0;
        for (int dy = 0; dy < f; ++dy) {
          for (int dx = 0; dx < f; ++dx) {
            const float* wt = wc + (dy * f + dx) * n;
            float wv[NB];
            if constexpr (VEC) {
              load_vec<NB>(wt, wv);
            } else {
#pragma unroll
              for (int j = 0; j < NB; ++j) wv[j] = j < n_left ? wt[j] : 0.f;
            }
            const int off = dy * iw + dx;
#pragma unroll
            for (int q = 0; q < PX; ++q) {
              const float a = inc[base[q] + off];
#pragma unroll
              for (int j = 0; j < NB; ++j) acc[q][j] = fmaf(a, wv[j], acc[q][j]);
            }
          }
        }
      }
    }
    if (!active) continue;

#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const int row = rb * PX + q;
      if (row >= oh) break;
      if constexpr (TO_GLOBAL) {
        const int gy = gy0 + row, gx = gx0 + x;
        if (gy >= gh || gx >= gw) continue;
        float* dst = out + (static_cast<size_t>(gy) * gw + gx) * n + n0;
        if constexpr (VEC) {
          // n % NB == 0: the NB channels are whole and 16-byte aligned
          store_vec<NB, RELU>(dst, acc[q]);
        } else {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (j < n_left) dst[j] = RELU ? fmaxf(acc[q][j], 0.f) : acc[q][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (j < n_left)
            out[(n0 + j) * oh * ow + row * ow + x] = RELU ? fmaxf(acc[q][j], 0.f) : acc[q][j];
      }
    }
  }
}

}  // namespace
