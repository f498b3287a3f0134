// The flagship's conv2 (f = 5, k -> 32) in the half-resolution quad domain,
// by the dense quad dot or by a 1-D F(2,5) row Winograd; bf16 operands, f32
// sums, bf16 ReLU output in the parity layout (2, 2, TR, TC, 32).
//
// Replaces the TPU kernel of tools/wino5_probe.py (pl.pallas_call at :253),
// its four bodies as one kernel with a compile-time mode:
//   quad, quadp, quad1 = quad_body (:154) with group_k 1, 2, 9: for each of
//     the nine half-res taps (ro, co), out[i][j][(2p+q)*32 + n] +=
//     sum over 4k channels of a[i + ro][j + co][ch] Wq[tap][ch][(2p+q)*32 + n],
//     the quad weights of quad_weights (:97), (5/6)^2 = 69% filled, whose
//     structural zeros are multiplied as the probe does. Each operand is
//     rounded from f32 to bf16 at its read; a group's taps are summed into a
//     partial, and the partials are added to the total in tap order;
//   w55f = w55f_body (:182): for each row combination a of B6 (the 6-point
//     F(2,5) family), V_a[i][j][(cp, c)] = sum over ti of B6[a][ti] *
//     a[i + ti/2][j][(2 (ti%2) + cp) k + c], each product and sum rounded in
//     f32 in the body's order (zero coefficients skipped, no multiply by 1),
//     V rounded once to bf16; then M_a = sum over co of V_a[:, j + co] @
//     Wf[a][co] (w55f_weights, :116, 2k -> (q, n)), and ys[pz][q] +=
//     AT25[pz][a] M_a[q].
// Input: the quad image x[i][j][(2rp + cp) k + c] = act[2i + rp][2j + cp][c],
// (RH, CWP, 4k) f32 with RH >= TR + 2 and CWP >= TC + 2 (probes/layout.py:
// pack_quad); only rows < TR + 2 and columns < TC + 2 are read.
//
// What bounds it: f32 FMAs on the CUDA cores (tensor cores are the
// redesign's work, ROADMAP.md Queue 2 #1). At the flagship's 1080p conv2
// (quad image 536 x 956 x 256, TR = 534, TC = 954) the quad modes do
// 509,436 x 2304 x 128 = 150.2 G MAC, 1.44x the direct form's 104.3 G;
// w55f does 509,436 x 6 x 384 x 64 = 75.1 G (0.72x) plus the row
// combinations, 3.7 products and sums per V element. The bytes, a 524.7 MB
// f32 quad image read and a 130.4 MB bf16 output written, take 0.196 ms at
// 3.35 TB/s.
//
// What the design does: a block takes 4 x 32 output quad pixels, one column
// a lane, four rows a thread, and all output lanes: 128 (p, q, n) lanes in
// 16 warps in the quad modes, 64 (q, n) lanes in 8 warps in w55f, 8 lanes a
// warp. So a warp reads 32 consecutive cells of a shared row per channel
// (no bank conflict) and one weight row as two 16-byte broadcasts, and each
// thread keeps 4 x 8 sums.
//   quad modes: the window, 6 x 34 cells of the quad image, all 4k channels,
//   is rounded to bf16 as it is copied to shared memory, channel-major; the
//   weights stream through shared memory one tap at a time, in chunks of 64
//   input channels widened to f32 (Wq is 589,824 bytes in bf16 at k = 64;
//   window and chunk take 104,448 + 32,768 bytes). Each thread keeps the
//   total and the group's partial, 64 registers.
//   w55f: the input channels split by column parity cp, whose V elements
//   read no other channels: per cp the block copies the f32 window of its 2k
//   channels (rp, c), then for each a forms V_a (4 x 34 cells x k, rounded to
//   bf16, kept as f32) and stages Wf[a] for its (co, cp) rows as f32; each
//   thread keeps 2 x 4 x 8 ys sums and 4 x 8 of M. Shared memory at k = 64:
//   49,152 (W) + 34,816 (V) + 104,448 (window) = 188,416 bytes. The M of
//   the two column parities is added to ys in turn, not summed first: only
//   the order of f32 sums differs from the probe's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TBR = 4, TBC = 32;           // a block's output quad pixels
constexpr int WR = TBR + 2, WC = TBC + 2;  // its window of the quad image
constexpr int WCELLS = WR * WC;
constexpr int VCELLS = TBR * WC;           // w55f: V cells per channel
constexpr int N = 32;                      // output channels
constexpr int NPT = 8;                     // a thread's output lanes
constexpr int QC = 64;                     // input channels of a quad weight chunk

enum Mode { kQuad = 0, kQuadP = 1, kQuad1 = 2, kW55f = 3 };

template <int MODE>
__host__ __device__ constexpr int lanes_of() {
  return MODE == kW55f ? 2 * N : 4 * N;
}
template <int MODE>
__host__ __device__ constexpr int threads_of() {
  return lanes_of<MODE>() / NPT * 32;
}
template <int MODE>
__host__ __device__ constexpr int group_of() {
  return MODE == kQuad ? 1 : (MODE == kQuadP ? 2 : 9);
}

__constant__ float kB6[6][6] = {{4, 0, -5, 0, 1, 0},  {0, -4, -4, 1, 1, 0}, {0, 4, -4, -1, 1, 0},
                                {0, -2, -1, 2, 1, 0}, {0, 2, -1, -2, 1, 0}, {0, 4, 0, -5, 0, 1}};
__constant__ float kAT25[2][6] = {{1, 1, 1, 1, 1, 0}, {0, 1, -1, 2, -2, 1}};

struct Geo {
  int RH, CWP, k, TR, TC;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// nrows x cols bf16 weights at w (row pitch cols) -> f32 dst (row pitch
// cols), 16 bytes a read; cols a multiple of 8
template <int kThreads>
__device__ __forceinline__ void stage_weights(float* dst, const bf16* w, int nrows, int cols) {
  const int vecs = cols / 8;
  for (int e = threadIdx.x; e < nrows * vecs; e += kThreads) {
    const int r = e / vecs, j = (e % vecs) * 8;
    const uint4 q = *reinterpret_cast<const uint4*>(w + static_cast<long long>(r) * cols + j);
    const unsigned int u[4] = {q.x, q.y, q.z, q.w};
    float f[8];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[h]));
      f[2 * h] = p.x;
      f[2 * h + 1] = p.y;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * cols + j);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// m[r][j] += sum over c < nc of act[c * pitch + r * WC] * w[c * lanes + j]:
// act points at the thread's column in the first row, w at its first lane
template <int LANES, typename TA>
__device__ __forceinline__ void dot_rows(float (&m)[TBR][NPT], const TA* act, int pitch,
                                         const float* w, int nc) {
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    float av[TBR];
#pragma unroll
    for (int r = 0; r < TBR; ++r) {
      if constexpr (sizeof(TA) == 2)
        av[r] = __bfloat162float(act[c * pitch + r * WC]);
      else
        av[r] = act[c * pitch + r * WC];
    }
    const float4 wa = *reinterpret_cast<const float4*>(w + c * LANES);
    const float4 wb = *reinterpret_cast<const float4*>(w + c * LANES + 4);
    const float wv[NPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int r = 0; r < TBR; ++r)
#pragma unroll
      for (int j = 0; j < NPT; ++j) m[r][j] = fmaf(av[r], wv[j], m[r][j]);
  }
}

// ReLU, bf16 (nearest even), 16-byte stores of plane pq, channels n0 .. n0 + 7
__device__ __forceinline__ void store_rows(bf16* y, const float (&s)[TBR][NPT], int pq, int n0,
                                           int tr0, int gc, const Geo& g) {
  if (gc >= g.TC) return;
#pragma unroll
  for (int r = 0; r < TBR; ++r) {
    const int gr = tr0 + r;
    if (gr >= g.TR) return;
    unsigned int u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 b =
          __floats2bfloat162_rn(fmaxf(s[r][2 * h], 0.f), fmaxf(s[r][2 * h + 1], 0.f));
      u[h] = *reinterpret_cast<const unsigned int*>(&b);
    }
    *reinterpret_cast<uint4*>(y + ((static_cast<long long>(pq) * g.TR + gr) * g.TC + gc) * N +
                              n0) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(threads_of<MODE>())
    wino5_kernel(const float* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
                 Geo g) {
  constexpr int kThreads = threads_of<MODE>();
  constexpr int LANES = lanes_of<MODE>();
  extern __shared__ float4 smem4[];
  const int k = g.k, K4 = 4 * g.k;
  const int tr0 = blockIdx.y * TBR, tc0 = blockIdx.x * TBC;
  const int col = threadIdx.x & 31;          // the thread's column in the block
  const int l0 = (threadIdx.x >> 5) * NPT;   // its first output lane
  const long long row_pitch = static_cast<long long>(g.CWP) * K4;

  // the window's cell of quad image row tr0 + r, column tc0 + cc, or null
  // past the image (its outputs are masked)
  auto cell_ptr = [&](int cell) -> const float* {
    const int gr = tr0 + cell / WC, gc = tc0 + cell % WC;
    return (gr < g.RH && gc < g.CWP) ? x + gr * row_pitch + static_cast<long long>(gc) * K4
                                     : nullptr;
  };

  if constexpr (MODE != kW55f) {
    // [weight chunk QC x 128 f32 | window 4k x WCELLS bf16, channel-major]
    float* ws = reinterpret_cast<float*>(smem4);
    bf16* win = reinterpret_cast<bf16*>(ws + QC * LANES);
    const int vecs = K4 / 4;
    for (int e = threadIdx.x; e < WCELLS * vecs; e += kThreads) {
      const int cell = e / vecs, c = (e % vecs) * 4;
      const float* src = cell_ptr(cell);
      const float4 q = src ? *reinterpret_cast<const float4*>(src + c) : make_float4(0, 0, 0, 0);
      win[(c + 0) * WCELLS + cell] = __float2bfloat16_rn(q.x);
      win[(c + 1) * WCELLS + cell] = __float2bfloat16_rn(q.y);
      win[(c + 2) * WCELLS + cell] = __float2bfloat16_rn(q.z);
      win[(c + 3) * WCELLS + cell] = __float2bfloat16_rn(q.w);
    }
    float tot[TBR][NPT], part[TBR][NPT];
#pragma unroll
    for (int r = 0; r < TBR; ++r)
#pragma unroll
      for (int j = 0; j < NPT; ++j) tot[r][j] = part[r][j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int ro = tap / 3, co = tap % 3;
      for (int c0 = 0; c0 < K4; c0 += QC) {
        __syncthreads();  // the window is in; every thread is done with the last chunk
        stage_weights<kThreads>(ws, w + (static_cast<long long>(tap) * K4 + c0) * LANES, QC,
                                LANES);
        __syncthreads();
        dot_rows<LANES>(part, win + c0 * WCELLS + ro * WC + col + co, WCELLS, ws + l0, QC);
      }
      if ((tap + 1) % group_of<MODE>() == 0 || tap == 8) {
#pragma unroll
        for (int r = 0; r < TBR; ++r)
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            tot[r][j] += part[r][j];
            part[r][j] = 0.f;
          }
      }
    }
    store_rows(y, tot, l0 / N, l0 % N, tr0, tc0 + col, g);
  } else {
    // [W of (a, cp): 3 x k x 64 f32 | V: k x VCELLS f32 | window: 2k x WCELLS f32]
    float* ws = reinterpret_cast<float*>(smem4);
    float* vs = ws + 3 * k * LANES;
    float* win = vs + k * VCELLS;
    float ys[2][TBR][NPT];
#pragma unroll
    for (int pz = 0; pz < 2; ++pz)
#pragma unroll
      for (int r = 0; r < TBR; ++r)
#pragma unroll
        for (int j = 0; j < NPT; ++j) ys[pz][r][j] = 0.f;
    for (int cp = 0; cp < 2; ++cp) {
      __syncthreads();  // every thread is done with the last window
      // channels (rp, c) of column parity cp: quad channels (2 rp + cp) k + c
      const int vecs = 2 * k / 4;
      for (int e = threadIdx.x; e < WCELLS * vecs; e += kThreads) {
        const int cell = e / vecs, ch = (e % vecs) * 4;
        const int rp = ch / k, c = ch % k;
        const float* src = cell_ptr(cell);
        const float4 q = src ? *reinterpret_cast<const float4*>(src + (2 * rp + cp) * k + c)
                             : make_float4(0, 0, 0, 0);
        win[(ch + 0) * WCELLS + cell] = q.x;
        win[(ch + 1) * WCELLS + cell] = q.y;
        win[(ch + 2) * WCELLS + cell] = q.z;
        win[(ch + 3) * WCELLS + cell] = q.w;
      }
      for (int a = 0; a < 6; ++a) {
        __syncthreads();  // the window is in; every thread is done with the last V and W
        for (int e = threadIdx.x; e < k * VCELLS; e += kThreads) {
          const int c = e / VCELLS, cell = e % VCELLS;
          float v = 0.f;
          bool first = true;
          for (int ti = 0; ti < 6; ++ti) {
            const float cf = kB6[a][ti];
            if (cf == 0.f) continue;
            float t = win[((ti & 1) * k + c) * WCELLS + (ti >> 1) * WC + cell];
            if (cf != 1.f) t = __fmul_rn(t, cf);        // no contraction into an FMA
            v = first ? t : __fadd_rn(v, t);
            first = false;
          }
          vs[c * VCELLS + cell] = round_bf16(v);
        }
        // Wf rows ((a * 3 + co) * 2 + cp) * k + c, c < k, for co = 0, 1, 2
        for (int co = 0; co < 3; ++co)
          stage_weights<kThreads>(
              ws + co * k * LANES,
              w + (static_cast<long long>((a * 3 + co) * 2 + cp) * k) * LANES, k, LANES);
        __syncthreads();
        float m[TBR][NPT];
#pragma unroll
        for (int r = 0; r < TBR; ++r)
#pragma unroll
          for (int j = 0; j < NPT; ++j) m[r][j] = 0.f;
        for (int co = 0; co < 3; ++co)
          dot_rows<LANES>(m, vs + col + co, VCELLS, ws + co * k * LANES + l0, k);
        // AT25 coefficients are 0, +-1 or +-2: cf * m is exact, one rounding
#pragma unroll
        for (int pz = 0; pz < 2; ++pz) {
          const float cf = kAT25[pz][a];
          if (cf == 0.f) continue;
#pragma unroll
          for (int r = 0; r < TBR; ++r)
#pragma unroll
            for (int j = 0; j < NPT; ++j) ys[pz][r][j] += cf * m[r][j];
        }
      }
    }
    // lanes (q, n): plane 2 pz + q
#pragma unroll
    for (int pz = 0; pz < 2; ++pz) store_rows(y, ys[pz], 2 * pz + l0 / N, l0 % N, tr0, tc0 + col, g);
  }
}

template <int MODE>
size_t smem_bytes(int k) {
  if (MODE == kW55f)
    return sizeof(float) * (3 * k * lanes_of<MODE>() + k * VCELLS + 2 * k * WCELLS);
  return sizeof(float) * QC * lanes_of<MODE>() + sizeof(bf16) * 4 * k * WCELLS;
}

template <int MODE>
int launch(const float* x, const bf16* w, bf16* y, Geo g, cudaStream_t stream) {
  if (g.k <= 0 || g.k % 16 || g.TR <= 0 || g.TC <= 0 || g.RH < g.TR + 2 || g.CWP < g.TC + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<MODE>(g.k);
  const dim3 grid((g.TC + TBC - 1) / TBC, (g.TR + TBR - 1) / TBR);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wino5_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads_of<MODE>(), smem, stream>>>(x, w, y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One conv2 on `stream`: x the quad image (RH, CWP, 4k) f32; w the bf16
// weights, (9 * 4k, 128) in modes 0-2 (quad, quadp, quad1) or (6 * 3 * 2k,
// 64) in mode 3 (w55f); y = (2, 2, TR, TC, 32) bf16. k a multiple of 16
// whose shared memory fits (up to 64), RH >= TR + 2, CWP >= TC + 2, all
// 16-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int wino5_forward(const void* x, const void* w, void* y, int RH, int CWP, int k,
                             int TR, int TC, int mode, void* stream) {
  const Geo g{RH, CWP, k, TR, TC};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  auto* yb = static_cast<bf16*>(y);
  switch (mode) {
    case kQuad: return launch<kQuad>(xf, wb, yb, g, s);
    case kQuadP: return launch<kQuadP>(xf, wb, yb, g, s);
    case kQuad1: return launch<kQuad1>(xf, wb, yb, g, s);
    case kW55f: return launch<kW55f>(xf, wb, yb, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
