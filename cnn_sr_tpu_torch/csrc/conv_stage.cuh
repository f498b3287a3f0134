// conv_stage: one VALID f x f convolution layer over a channel-major shared
// tile, the FMA stage that both kernels of this directory are built from
// (fused_srcnn.cu runs three of them per block, conv_layer.cu one), in
// either storage type: float (the f32 kernels) or __nv_bfloat16 (the bf16
// stream). Sums are f32 in both: a bf16 operand is widened to float at
// the read, so each bf16 x bf16 product is exact and only the sums round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// float <-> storage type. The bf16 store rounds to nearest even
// (__float2bfloat16_rn), as XLA's f32 -> bf16 convert does.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// read-only global load through the non-coherent cache
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// V consecutive values at p (16-byte aligned) widened to float: float4
// reads for float, 16-byte reads of 8 values for bf16.
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
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  static_assert(V % 8 == 0, "bf16 vector reads take 8 values");
#pragma unroll
  for (int j = 0; j < V; j += 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + j);
    const unsigned int u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[h]));
      v[j + 2 * h] = f.x;
      v[j + 2 * h + 1] = f.y;
    }
  }
}

// V values (ReLU'd if RELU) stored at p (16-byte aligned) in 16-byte
// stores: 4 floats or 8 bf16 each.
template <int V, bool RELU>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    float4 q = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    if (RELU) q = make_float4(fmaxf(q.x, 0.f), fmaxf(q.y, 0.f), fmaxf(q.z, 0.f), fmaxf(q.w, 0.f));
    *reinterpret_cast<float4*>(p + j) = q;
  }
}
template <int V, bool RELU>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  static_assert(V % 8 == 0, "bf16 vector stores take 8 values");
#pragma unroll
  for (int j = 0; j < V; j += 8) {
    unsigned int u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float a = v[j + 2 * h], b = v[j + 2 * h + 1];
      if (RELU) a = fmaxf(a, 0.f), b = fmaxf(b, 0.f);
      const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
      u[h] = *reinterpret_cast<const unsigned int*>(&r);
    }
    *reinterpret_cast<uint4*>(p + j) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// One layer: VALID cross-correlation of the channel-major shared tile
// in[k][ih][iw] with HWIO weights w (f, f, k, n) plus f32 bias b, into an
// (oh, ow, n) result with oh = ih - f + 1, ow = iw - f + 1.
// T is the storage type of the tile and of the weights (global and
// shared); TO that of the result.
// TO_GLOBAL = false: stored channel-major into shared out[n][oh][ow].
// TO_GLOBAL = true: stored NHWC into out (one image of (gh, gw, n)) at
// offset (gy0, gx0), where inside that image.
// The weights pass through the shared buffer wbuf (wbuf_elems, at least
// f * f * n) in chunks of input channels, laid out [c][tap][n].
// VEC (16-byte weight reads, and 16-byte stores with TO_GLOBAL) needs
// n % NB == 0, NB a multiple of 16 bytes' worth of T (and of TO with
// TO_GLOBAL), a 16-byte aligned wbuf and, with TO_GLOBAL, out.
template <typename T, typename TO, int NB, int PX, bool VEC, bool RELU, bool TO_GLOBAL>
__device__ void conv_stage(const T* in, int k, int ih, int iw, const T* __restrict__ w,
                           const float* __restrict__ b, int f, int n, T* wbuf, int wbuf_elems,
                           TO* out, int oh, int ow, int gy0, int gx0, int gh, int gw) {
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
        wbuf[i] = ldg(w + (static_cast<size_t>(tap) * k + c0 + cc) * n + i % n);
      }
      __syncthreads();
      if (!active) continue;
      for (int cc = 0; cc < cn; ++cc) {
        const T* inc = in + (c0 + cc) * plane;
        const T* wc = wbuf + cc * taps * n + n0;
        for (int dy = 0; dy < f; ++dy) {
          for (int dx = 0; dx < f; ++dx) {
            const T* wt = wc + (dy * f + dx) * n;
            float wv[NB];
            if constexpr (VEC) {
              load_vec<NB>(wt, wv);
            } else {
#pragma unroll
              for (int j = 0; j < NB; ++j) wv[j] = j < n_left ? to_f32(wt[j]) : 0.f;
            }
            const int off = dy * iw + dx;
#pragma unroll
            for (int q = 0; q < PX; ++q) {
              const float a = to_f32(inc[base[q] + off]);
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
        TO* dst = out + (static_cast<size_t>(gy) * gw + gx) * n + n0;
        if constexpr (VEC) {
          // n % NB == 0: the NB channels are whole and 16-byte aligned
          store_vec<NB, RELU>(dst, acc[q]);
        } else {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (j < n_left) dst[j] = from_f32<TO>(RELU ? fmaxf(acc[q][j], 0.f) : acc[q][j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (j < n_left)
            out[(n0 + j) * oh * ow + row * ow + x] =
                from_f32<TO>(RELU ? fmaxf(acc[q][j], 0.f) : acc[q][j]);
      }
    }
  }
}

}  // namespace
