// Winograd F(2x2, 3x3) of one 3x3 ReLU layer, bf16 operands, f32 sums,
// bf16 output in the parity layout (2, 2, TR, TC, n).
//
// Replaces the TPU kernel of tools/winograd_probe.py (pl.pallas_call at
// :291), its three Winograd bodies as one kernel with a compile-time mode:
//   direct   = wino_body (:148): V[a][b] = sum of B^T[a][i] B^T[b][j] d[i][j]
//              over the four nonzero taps, in row-major tap order (:164-177);
//   factored = winoF_body (:187): row combinations R[a][j] of the taps, then
//              V[a][b] = column combinations of R (:199-213);
//   pre      = winoD_body (:133): V is given, (16, TR*TC, k) bf16.
// Each then forms M[pos] = V[pos] U[pos] over the k input channels (U =
// G g G^T, (16k, n) bf16, made on the host as the probe's
// transform_weights does) and Y = A^T M A, ReLU, bf16. As in the probe's
// interpret run, V is rounded to bf16 after every add, in the mode's own
// order; each bf16 x bf16 product is exact in f32, the sums over channels
// are f32, and the four Y accumulators take +-M in position order
// (accum_y, :113-119). The direct and factored modes can also store V
// instead (winograd_input_transform): that is how the pre mode's V is made.
// The probe's fifth body, repack (:224), is the shipped conv_layer.cu
// followed by a parity_copy.cu split (probes/winograd.py: repack).
//
// Input layout (direct and factored): the parity planes of the layer's
// input, x[rp][i][j][cp*k + c] = act[2i + rp][2j + cp][c], (2, RH, CWP, 2k)
// with RH >= TR + 1 and CWP >= TC + 1; tap d[i][j] of tile (tr, tc) is
// x[i % 2][tr + i / 2][tc + j / 2][(j % 2) k + c], so a tile's 16 taps are
// contiguous rows of channels. Only rows <= TR and columns <= TC are read.
//
// What bounds it: f32 FMAs on the CUDA cores (no tensor cores here: this
// kernel answers whether the transform pays for itself on the card, beside
// the direct conv_layer.cu on the same units). 16 k n MACs per 2x2 output
// tile instead of the direct form's 36 k n; at the RGB model's L6 (128 ->
// 128, 1068 x 1908 out) 133.5 G MAC, 4.0 ms at the 67 TFLOP/s f32 peak.
//
// What the design does: a block takes 4 x 16 tiles (8 x 32 output pixels)
// and NB output channels (blockIdx.z picks the group): NB = 128 with 512
// threads where n >= 128, else 64 with 256. It copies its window of the
// parity planes, 2 x 5 x 17 cells of 2k bf16, into shared memory once.
// Then for each of the 16 positions it forms that position's V (64 tiles
// x k, f32, row pitch 65 floats so that the transposed writes miss no
// bank) from the window, or reads it (pre), and stages U[pos] for its NB
// channels as f32, so that the inner loop reads shared memory with no
// conversion: each thread keeps 2 tiles x 8 channels of M (two 4-byte
// reads and two 16-byte broadcast reads feed 16 FMAs per channel) and
// folds them into its 4 x 2 x 8 Y accumulators in registers. The wider
// block forms each V once for 128 channels instead of twice for 64: with
// NB = 64 everywhere, 128 -> 128 took 23.04 ms at 1080p (one 8-warp block
// per SM at 153,088 bytes), against 8.46 ms for 64 -> 128 (NVIDIA H100
// 80GB HBM3, 700 W; probes/winograd.py). Shared memory at k = 128, NB =
// 128: 185,856 bytes, one 16-warp block per SM. The tile-row groups of
// the probe (TRG = 6, a VMEM budget) have no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TBR = 4, TBC = 16, TB = TBR * TBC;  // a block's tiles
constexpr int WR = TBR + 1, WC = TBC + 1;          // its window cells per parity plane
constexpr int NPT = 8;                             // a thread's output channels
constexpr int VS = TB + 1;                         // row pitch of the shared V, in floats
// NB, a block's output channels, is 128 (512 threads) for n >= 128, else
// 64 (256 threads): 32 threads of two tiles each per 8 channels
template <int NB>
__host__ __device__ constexpr int threads_of() {
  return TB / 2 * NB / NPT;
}

enum Mode { kDirect = 0, kFactored = 1, kPre = 2 };

struct Geo {
  int RH, CWP, k, n, TR, TC;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the two nonzero entries of row a of B^T = [[1, 0, -1, 0], [0, 1, 1, 0],
// [0, -1, 1, 0], [0, 1, 0, -1]], in column order
__device__ __forceinline__ void bt_row(int a, int& i1, float& s1, int& i2, float& s2) {
  i1 = a == 0 ? 0 : 1;
  s1 = a == 2 ? -1.f : 1.f;
  i2 = a == 3 ? 3 : 2;
  s2 = (a == 0 || a == 3) ? -1.f : 1.f;
}

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__device__ __forceinline__ float at(int p, int a) {
  if (p == 0) return a == 3 ? 0.f : 1.f;
  return a == 0 ? 0.f : (a == 1 ? 1.f : -1.f);
}

// V[pa][pb] of the block's tile (tr, tc), channel c, from the window win
// [2][WR][WC][2k], rounded to bf16 after every add in the mode's order.
// s * d is exact (s = +-1), and a sum of two bf16 values taken in f32 and
// rounded once to bf16 is the bf16 sum.
template <int MODE>
__device__ __forceinline__ float v_value(const bf16* win, int k, int tr, int tc, int c, int pa,
                                         int pb) {
  auto d = [&](int i, int j) {
    return __bfloat162float(
        win[((((i & 1) * WR + tr + (i >> 1)) * WC) + tc + (j >> 1)) * 2 * k + (j & 1) * k + c]);
  };
  int i1, i2, j1, j2;
  float si1, si2, sj1, sj2;
  bt_row(pa, i1, si1, i2, si2);
  bt_row(pb, j1, sj1, j2, sj2);
  if constexpr (MODE == kFactored) {
    const float r1 = round_bf16(si1 * d(i1, j1) + si2 * d(i2, j1));
    const float r2 = round_bf16(si1 * d(i1, j2) + si2 * d(i2, j2));
    return round_bf16(sj1 * r1 + sj2 * r2);
  } else {
    float v = si1 * sj1 * d(i1, j1);
    v = round_bf16(v + si1 * sj2 * d(i1, j2));
    v = round_bf16(v + si2 * sj1 * d(i2, j1));
    return round_bf16(v + si2 * sj2 * d(i2, j2));
  }
}

// STORE_V: write V (16, TR*TC, k) bf16 to y and stop (direct and
// factored only); else y is the parity output (2, 2, TR, TC, n).
template <int MODE, bool STORE_V, int NB>
__global__ void __launch_bounds__(threads_of<NB>())
    winograd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u, bf16* __restrict__ y,
                    Geo g) {
  constexpr int kThreads = threads_of<NB>();
  extern __shared__ float4 smem4[];
  const int k = g.k;
  // [U of one position, k x NB | V of one position, k x VS | window]
  float* us = reinterpret_cast<float*>(smem4);
  float* vs = us + (STORE_V ? 0 : k * NB);
  bf16* win = reinterpret_cast<bf16*>(vs + (STORE_V ? 0 : k * VS));
  const int tr0 = blockIdx.y * TBR, tc0 = blockIdx.x * TBC;
  const long long T = static_cast<long long>(g.TR) * g.TC;

  if constexpr (MODE != kPre) {
    // the window: parity plane rp, rows tr0 .. tr0 + TBR, columns tc0 ..
    // tc0 + TBC, in 16-byte copies; zero past row TR and column TC
    const int vecs = 2 * k / 8;
    for (int e = threadIdx.x; e < 2 * WR * WC * vecs; e += kThreads) {
      const int cell = e / vecs, v8 = e % vecs;
      const int rp = cell / (WR * WC), r = (cell / WC) % WR, cc = cell % WC;
      const int gr = tr0 + r, gc = tc0 + cc;
      uint4 q = make_uint4(0, 0, 0, 0);
      if (gr <= g.TR && gc <= g.TC)
        q = *reinterpret_cast<const uint4*>(
            x + ((static_cast<long long>(rp) * g.RH + gr) * g.CWP + gc) * 2 * k + v8 * 8);
      *reinterpret_cast<uint4*>(win + cell * 2 * k + v8 * 8) = q;
    }
    __syncthreads();
  }

  if constexpr (STORE_V) {
    for (int pos = 0; pos < 16; ++pos)
      for (int e = threadIdx.x; e < TB * k; e += kThreads) {
        const int c = e % k, t = e / k;
        const int gr = tr0 + t / TBC, gc = tc0 + t % TBC;
        if (gr < g.TR && gc < g.TC)
          y[(pos * T + static_cast<long long>(gr) * g.TC + gc) * k + c] = __float2bfloat16_rn(
              v_value<MODE>(win, k, t / TBC, t % TBC, c, pos >> 2, pos & 3));
      }
    return;
  } else {
    const int n0 = blockIdx.z * NB;
    const int lane = threadIdx.x & 31;
    const int ch = n0 + (threadIdx.x >> 5) * NPT;  // the thread's first channel
    float acc[4][2][NPT];                           // Y[p * 2 + q] of tiles lane, lane + 32
#pragma unroll
    for (int pq = 0; pq < 4; ++pq)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < NPT; ++j) acc[pq][t][j] = 0.f;

    for (int pos = 0; pos < 16; ++pos) {
      const int pa = pos >> 2, pb = pos & 3;
      __syncthreads();  // every thread is done with the previous position's V and U
      for (int e = threadIdx.x; e < TB * k; e += kThreads) {
        const int c = e % k, t = e / k;
        float v;
        if constexpr (MODE == kPre) {
          const int gr = tr0 + t / TBC, gc = tc0 + t % TBC;
          v = (gr < g.TR && gc < g.TC)
                  ? __bfloat162float(x[(pos * T + static_cast<long long>(gr) * g.TC + gc) * k + c])
                  : 0.f;
        } else {
          v = v_value<MODE>(win, k, t / TBC, t % TBC, c, pa, pb);
        }
        vs[c * VS + t] = v;
      }
      // U rows pos * k + c, columns n0 .. n0 + NB (zero past n), widened to f32
      for (int e = threadIdx.x; e < k * (NB / 8); e += kThreads) {
        const int c = e / (NB / 8), j = (e % (NB / 8)) * 8;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (n0 + j < g.n) {
          const uint4 q = *reinterpret_cast<const uint4*>(
              u + (static_cast<long long>(pos) * k + c) * g.n + n0 + j);
          const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[h]));
            f[2 * h] = p.x;
            f[2 * h + 1] = p.y;
          }
        }
        float4* dst = reinterpret_cast<float4*>(us + c * NB + j);
        dst[0] = make_float4(f[0], f[1], f[2], f[3]);
        dst[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
      __syncthreads();

      float m[2][NPT];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < NPT; ++j) m[t][j] = 0.f;
      const float* vt = vs + lane;
      const float* ut = us + (ch - n0);
#pragma unroll 4
      for (int c = 0; c < k; ++c) {
        const float a0 = vt[c * VS], a1 = vt[c * VS + 32];
        const float4 ua = *reinterpret_cast<const float4*>(ut + c * NB);
        const float4 ub = *reinterpret_cast<const float4*>(ut + c * NB + 4);
        const float w[NPT] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          m[0][j] = fmaf(a0, w[j], m[0][j]);
          m[1][j] = fmaf(a1, w[j], m[1][j]);
        }
      }
      // Y[p][q] += A^T[p][pa] A^T[q][pb] M: coefficients 0 or +-1, so each
      // add rounds once, as the probe's ys[pq] + m * c
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        const float cf = at(pq >> 1, pa) * at(pq & 1, pb);
        if (cf != 0.f) {
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int j = 0; j < NPT; ++j) acc[pq][t][j] += cf * m[t][j];
        }
      }
    }

    if (ch >= g.n) return;
    // ReLU, bf16 (nearest even), 16-byte stores into plane (p, q)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = lane + 32 * t;
      const int gr = tr0 + tile / TBC, gc = tc0 + tile % TBC;
      if (gr >= g.TR || gc >= g.TC) continue;
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        unsigned int w[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const __nv_bfloat162 r = __floats2bfloat162_rn(fmaxf(acc[pq][t][2 * h], 0.f),
                                                         fmaxf(acc[pq][t][2 * h + 1], 0.f));
          w[h] = *reinterpret_cast<const unsigned int*>(&r);
        }
        *reinterpret_cast<uint4*>(
            y + ((static_cast<long long>(pq) * g.TR + gr) * g.TC + gc) * g.n + ch) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

template <int MODE, bool STORE_V, int NB>
int launch(const void* x, const void* u, void* y, Geo g, cudaStream_t stream) {
  if (g.k <= 0 || g.k % 8 || g.TR <= 0 || g.TC <= 0 || (!STORE_V && (g.n <= 0 || g.n % 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t win = MODE == kPre ? 0 : sizeof(bf16) * 2 * WR * WC * 2 * g.k;
  const size_t stage = STORE_V ? 0 : sizeof(float) * g.k * (NB + VS);
  const size_t smem = win + stage;
  const dim3 grid((g.TC + TBC - 1) / TBC, (g.TR + TBR - 1) / TBR,
                  STORE_V ? 1 : (g.n + NB - 1) / NB);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = winograd_kernel<MODE, STORE_V, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads_of<NB>(), smem, stream>>>(static_cast<const bf16*>(x),
                                           static_cast<const bf16*>(u), static_cast<bf16*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One layer on `stream`: mode 0 (direct) or 1 (factored) with x the parity
// input (2, RH, CWP, 2k), or mode 2 (pre) with x = V (16, TR*TC, k); u =
// (16k, n); y = (2, 2, TR, TC, n). All bf16, 16-byte aligned, k and n
// multiples of 8. Returns cudaGetLastError() of the launch.
extern "C" int winograd_f2x3_forward(const void* x, const void* u, void* y, int RH, int CWP,
                                     int k, int n, int TR, int TC, int mode, void* stream) {
  const Geo g{RH, CWP, k, n, TR, TC};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool wide = n >= 128;
  if (mode == kDirect)
    return wide ? launch<kDirect, false, 128>(x, u, y, g, s) : launch<kDirect, false, 64>(x, u, y, g, s);
  if (mode == kFactored)
    return wide ? launch<kFactored, false, 128>(x, u, y, g, s)
                : launch<kFactored, false, 64>(x, u, y, g, s);
  if (mode == kPre)
    return wide ? launch<kPre, false, 128>(x, u, y, g, s) : launch<kPre, false, 64>(x, u, y, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The input transform alone: V (16, TR*TC, k) bf16 of the parity input x,
// in mode 0 (direct) or 1 (factored), the same values the layer forms.
extern "C" int winograd_input_transform(const void* x, void* v, int RH, int CWP, int k, int TR,
                                        int TC, int mode, void* stream) {
  const Geo g{RH, CWP, k, 0, TR, TC};
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kDirect) return launch<kDirect, true, 64>(x, nullptr, v, g, s);
  if (mode == kFactored) return launch<kFactored, true, 64>(x, nullptr, v, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
