// The flagship's conv2 (f = 5, k -> 32) in the half-resolution quad domain on
// the tensor cores, by the dense quad dot or by a 1-D F(2,5) row Winograd;
// bf16 operands, f32 sums, bf16 ReLU output in the parity layout (2, 2, TR,
// TC, 32).
//
// Replaces the TPU kernel of tools/wino5_probe.py (pl.pallas_call at :253),
// its four bodies as one entry point with a mode:
//   quad, quadp, quad1 = quad_body (:154) with group_k 1, 2, 9: for each of
//     the nine half-res taps (ro, co), out[i][j][(2p+q)*32 + n] +=
//     sum over 4k channels of a[i + ro][j + co][ch] Wq[tap][ch][(2p+q)*32 + n],
//     the quad weights of quad_weights (:97), (5/6)^2 = 69% filled, whose
//     structural zeros are multiplied as the probe does. Each operand is
//     rounded from f32 to bf16 at its read; a group's taps are summed over
//     all 4k channels into a partial, and the partials are added to the
//     total in tap order;
//   w55f = w55f_body (:182): for each row combination a of B6 (the 6-point
//     F(2,5) family), V_a[i][j][(cp, c)] = sum over ti of B6[a][ti] *
//     a[i + ti/2][j][(2 (ti%2) + cp) k + c], each product and sum rounded in
//     f32 in the body's order (zero coefficients skipped, no multiply by 1),
//     V rounded once to bf16; then M_a = sum over co of V_a[:, j + co] @
//     Wf[a][co] (w55f_weights, :116, 2k -> (q, n)), and ys[pz][q] +=
//     AT25[pz][a] M_a[q].
// Input: the quad image x[i][j][(2rp + cp) k + c] = act[2i + rp][2j + cp][c],
// (RH, CWP, 4k) f32 with RH >= TR + 2 and CWP >= TC + 2 (probes/layout.py:
// pack_quad); cells past row RH or column CWP read as zero.
//
// What bounds it on the H100: at the flagship's 1080p conv2 (quad image 536
// x 956 x 256, TR = 534, TC = 954) the quad modes do 509,436 x 2304 x 128 =
// 150.2 G MAC (1.44x the direct form's 104.3 G): 0.304 ms at the bf16
// tensor-core peak, their operations bound. w55f does 509,436 x 6 x 384 x 64
// = 75.1 G MAC plus the row combinations; its bound, 0.196 ms, is its bytes:
// the 524.7 MB f32 quad image read and the 130.4 MB bf16 output written at
// 3.35 TB/s. Beside both sit the shared-memory traffic of the mma.sync
// fragments and the weights' traffic from L2, since every block reads all of
// them (Wq 590 KB, Wf 295 KB at k = 64).
//
// What the design does: a block takes 4 x 32 output quad pixels (128
// positions, wino5_plan.cuh) and all output lanes, as bf16 mma.sync m16n8k16
// implicit GEMMs on tc_stage.cuh's TcAcc (taps as ldmatrix row offsets into a
// position-major window whose rows are odd multiples of 16 bytes), the next
// k16 step's fragments loaded before this one's products, their shared
// addresses stepped from one step to the next (mma_stage: no division in the
// loop, which cost the quad modes a quarter of their time).
// * quad modes: 8 warps, 4 over the positions by 2 over the 128 (p, q, n)
//   lanes. The window, 6 x 34 cells of the quad image over all 4k channels,
//   is rounded to bf16 as it is loaded (16-byte loads staged in registers,
//   four pieces a thread in flight) and stays resident (107,712 bytes at k
//   = 64); the taps run outermost, each tap's 4k x 128 slab of Wq streaming
//   through three cp.async stages of up to 128 contiguous rows, two in
//   flight. So a tap group's partial over all 4k channels exists: quad and
//   quadp keep it in a second set of sums and add it to the total every
//   group_k taps (64 + 64 f32 a thread); quad1 needs none.
// * w55f: a persistent block, one an SM, walking over the tile blocks, with
//   warps specialised. A producer warpgroup takes the input channels in
//   chunks of 16: it reads the chunk's six window rows of the four (rp, cp)
//   planes straight from the f32 quad image into registers (12 16-byte
//   loads per column, column parity and 4 channels; the next chunk's loads
//   in flight while it streams the weights), forms V_a for all six a from
//   them (__fmul_rn / __fadd_rn in the body's order, so V is bit-equal to
//   the plain version's), rounds it once to bf16 and stores it
//   position-major [a][i][j][(cp, c)] into one of two chunk buffers; and it
//   streams Wf[a]'s rows of the chunk (3 co x 32 rows x 64) into a stage of
//   its own for each a by cp.async. mbarriers say full (the producers'
//   arrivals; for Wf, cp.async.mbarrier.arrive when the copies land), named
//   barriers empty. 8 consumer warps, 4 over the positions by 2 over the 64
//   (q, n) lanes, multiply each (chunk, a): M_a's partial over the chunk is a
//   1x3 implicit GEMM of K = 3 x 32, folded into the two ys sets in registers
//   with AT25's exact coefficients (0, +-1, +-2), as winograd.cu folds M
//   into Y. Adding each chunk's partial M_a into ys changes only the order of
//   the f32 sums. 32 + 64 f32 sums a consumer thread.
// * The store: the four lanes of an mma row exchange their pairs (shuffles)
//   so that each holds 8 channels of one n8 tile; ReLU, one rounding to bf16,
//   16-byte stores into plane 2p + q, the ragged TR x TC edge masked.
// The block plans (tiles, stages, shared bytes, the limit MAX_K) are
// wino5_plan.cuh's, in one place. What sets the pace (PERF.md §6): in
// the quad modes the mma.sync loop itself, then the window load and Wq's
// 2.37 GB from L2 beside it; in w55f shared memory, where the consumers'
// fragments and the producers' V stores meet.
//
// History: on the CUDA cores (f32 FMAs over a bf16 or f32 window, one column
// a thread, the design before this one) this kernel took, at the 1080p
// conv2, quad 9.309 ms, quadp 9.177, quad1 9.435 and w55f 7.665 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py), against cuDNN bf16 conv + ReLU's
// 1.380-1.390.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "tc_stage.cuh"
#include "wino5_plan.cuh"

namespace {

enum Mode { kQuad = 0, kQuadP = 1, kQuad1 = 2, kW55f = 3 };

// quad modes: 8 warps, 4 over the 128 positions by 2 over the 128 lanes;
// w55f: 8 consumer warps, 4 by 2 over the 64 lanes, and a producer warpgroup
using QuadCfg = TcCfg<4 * kW5N, 2, 8>;
using W55fCfg = TcCfg<2 * kW5N, 2, 8>;
constexpr int kQuadThreads = QuadCfg::THREADS;
constexpr int kConsumers = W55fCfg::THREADS, kProducers = 128;
constexpr int kW55fThreads = kConsumers + kProducers;
static_assert(QuadCfg::PB == kW5TB && W55fCfg::PB == kW5TB, "the warps cover the positions");
static_assert(QuadCfg::WS == kW5QuadWS && W55fCfg::WS == kW5WS, "the plan's stage rows");
static_assert(QuadCfg::NT % 4 == 0 && W55fCfg::NT == 4, "a warp's n8 tiles make whole planes");
// w55f's named barriers: a chunk buffer of V free again (two, by parity), the
// stage of Wf[a] free again (six)
constexpr int kVEmpty = 1, kWEmpty = 3;

template <int MODE>
__host__ __device__ constexpr int group_of() {
  return MODE == kQuad ? 1 : (MODE == kQuadP ? 2 : 9);
}

// B6[a][t] (probes/wino5.py), read at compile time only
__host__ __device__ constexpr float b6(int a, int t) {
  constexpr float m[36] = {4, 0, -5, 0, 1, 0,  0, -4, -4, 1, 1, 0,  0, 4, -4, -1, 1, 0,
                           0, -2, -1, 2, 1, 0, 0, 2, -1, -2, 1, 0, 0, 4, 0, -5, 0, 1};
  return m[a * 6 + t];
}
// AT25[pz][a] = [[1, 1, 1, 1, 1, 0], [0, 1, -1, 2, -2, 1]], as selects (a is
// known at run time only)
__host__ __device__ constexpr float at25(int pz, int a) {
  return pz == 0 ? (a < 5 ? 1.f : 0.f)
                 : (a == 0 ? 0.f : a == 5 ? 1.f : (a & 1 ? 1.f : -1.f) * (a < 3 ? 1.f : 2.f));
}

struct Geo {
  int RH, CWP, k, TR, TC;
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&b);
}

// The quad modes' window: rows tr0 .. tr0 + 5 and columns tc0 .. tc0 + 33 of
// the quad image, all 4k channels, rounded to bf16 (nearest even) on the
// way: win[cell][0 : 4k], row stride as, zero past the image. Four 8-channel
// pieces a thread in flight, each two 16-byte loads and one 16-byte store.
__device__ __forceinline__ void load_quad_window(const float* __restrict__ x, const Geo& g,
                                                 int tr0, int tc0, int as, bf16* win) {
  constexpr int kBatch = 4;
  const int pieces = g.k / 2, total = kW5WR * kW5WC * pieces;
  const long long row_pitch = static_cast<long long>(g.CWP) * 4 * g.k;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
    float4 v[kBatch][2];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * blockDim.x, cell = e / pieces, q = e % pieces;
      const int gr = tr0 + cell / kW5WC, gc = tc0 + cell % kW5WC;
      if (e < total && gr < g.RH && gc < g.CWP) {
        const auto* src = reinterpret_cast<const float4*>(
            x + gr * row_pitch + static_cast<long long>(gc) * 4 * g.k + q * 8);
        v[u][0] = __ldg(src);
        v[u][1] = __ldg(src + 1);
      } else {
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total)
        *reinterpret_cast<uint4*>(win + (e / pieces) * as + (e % pieces) * 8) =
            make_uint4(pack_bf16(v[u][0].x, v[u][0].y), pack_bf16(v[u][0].z, v[u][0].w),
                       pack_bf16(v[u][1].x, v[u][1].y), pack_bf16(v[u][1].z, v[u][1].w));
    }
  }
}

// Row h (0: the lane's row, 1: 8 below) of four n8 tiles v[0..3] of an mma
// row, ReLU'd and rounded to bf16: the four lanes of the row exchange their
// column pairs so that lane t returns the 8 columns of tile t, 16 bytes
__device__ __forceinline__ uint4 quad_rows16(const float (*v)[4], int h) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  unsigned w[4], o[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16(fmaxf(v[j][2 * h], 0.f), fmaxf(v[j][2 * h + 1], 0.f));
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // lane s sends its pair of tile (s - r) & 3 and reads lane (t + r) & 3's
    // pair of tile t: columns 2 ((t + r) & 3), + 1
    const int js = (t - r) & 3, src = (t + r) & 3;
    const unsigned send = js == 0 ? w[0] : js == 1 ? w[1] : js == 2 ? w[2] : w[3];
    const unsigned got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (m == src) o[m] = got;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The sums v (C's fragment layout) of a block's 128 positions, ReLU, bf16,
// into the parity planes y (4, TR, TC, 32): the warp's n8 tiles 4 jg .. 4 jg
// + 3 are plane plane0 + (its first column + 32 jg) / 32
template <class C>
__device__ __forceinline__ void store_planes(const float (&v)[C::MT][C::NT][4],
                                             const TcAcc<C>& acc, bf16* __restrict__ y,
                                             int plane0, const Geo& g, int tr0, int tc0) {
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = acc.pos(0, i, h);
      const int gr = tr0 + pos / kW5TBC, gc = tc0 + pos % kW5TBC;
#pragma unroll
      for (int jg = 0; jg < C::NT / 4; ++jg) {
        const uint4 val = quad_rows16(v[i] + 4 * jg, h);  // every lane takes part
        const int plane = plane0 + acc.wn_col / kW5N + jg;
        if (gr < g.TR && gc < g.TC)
          *reinterpret_cast<uint4*>(
              y + ((static_cast<long long>(plane) * g.TR + gr) * g.TC + gc) * kW5N +
              (acc.lane & 3) * 8) = val;
      }
    }
}

// The A (window) and B (weights) fragments of one k16 step of a warp
template <class C>
struct Frags {
  unsigned a[C::MT][4];
  unsigned b[C::NT / 2][4];  // [nj]: n8 tile 2 nj (k 0-7, 8-15), then tile 2 nj + 1

  // A from shared address a0 (m16 tile 0's row of this lane) plus da[i]; B
  // from b0 (this lane's weight row), n8 tile pairs 32 bytes apart
  __device__ __forceinline__ void load(unsigned a0, const unsigned (&da)[C::MT], unsigned b0) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i) ldmatrix_x4(a[i], a0 + da[i]);
#pragma unroll
    for (int nj = 0; nj < C::NT / 2; ++nj) ldmatrix_x4_trans(b[nj], b0 + nj * 32);
  }
  __device__ __forceinline__ void mma(TcAcc<C>& acc) const {
#pragma unroll
    for (int nj = 0; nj < C::NT / 2; ++nj)
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        mma_bf16(acc.v[i][2 * nj], a[i], b[nj][0], b[nj][1]);
        mma_bf16(acc.v[i][2 * nj + 1], a[i], b[nj][2], b[nj][3]);
      }
  }
};

// acc += taps [t0, t1) (tap t at window offset (t / 3) WC + t % 3) over K
// lanes of the window win (row stride as) against the stage wst [t - t0][K]
// [WS], the next k16 step's fragments loaded before this one's mma.sync;
// the sums of each accumulator are taken in tap, then lane order
template <class C>
__device__ __forceinline__ void mma_stage(TcAcc<C>& acc, const bf16* win, int as, const bf16* wst,
                                          int K, int t0, int t1) {
  const unsigned a_lane = smem_addr(win + acc.row[0] * as + (acc.lane >> 4) * 8);
  unsigned da[C::MT];
#pragma unroll
  for (int i = 0; i < C::MT; ++i) da[i] = (acc.row[i] - acc.row[0]) * as * 2;
  unsigned b_addr = smem_addr(wst + (acc.lane & 15) * C::WS + acc.wn_col + (acc.lane >> 4) * 8);
  // the step that the next load reads: tap t, lanes k16 .. k16 + 15
  int t = t0, k16 = 0;
  auto a_addr = [&]() { return a_lane + (((t / 3) * kW5WC + t % 3) * as + k16) * 2; };
  auto advance = [&]() {
    b_addr += 16 * C::WS * 2;  // the stage's rows run on from tap to tap
    k16 += 16;
    if (k16 == K) {
      k16 = 0;
      ++t;
    }
  };
  const int n = (t1 - t0) * (K / 16);
  Frags<C> f0, f1;
  f0.load(a_addr(), da, b_addr);
  advance();
  for (int s = 0; s < n; s += 2) {
    if (s + 1 < n) {
      f1.load(a_addr(), da, b_addr);
      advance();
    }
    f0.mma(acc);
    if (s + 2 < n) {
      f0.load(a_addr(), da, b_addr);
      advance();
    }
    if (s + 1 < n) f1.mma(acc);
  }
}

// One block of the quad modes at tile (blockIdx.y, blockIdx.x): the window
// resident, the nine taps outermost, each tap's rows of Wq in p.steps stages,
// kW5QuadStages of them in flight.
template <int MODE>
__global__ void __launch_bounds__(kQuadThreads, 1)
    wino5_quad_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ y, Geo g, Wino5Plan p) {
  extern __shared__ uint4 smem4[];
  // [window | kW5QuadStages weight stages]
  bf16* win = reinterpret_cast<bf16*>(smem4);
  bf16* wst = win + p.win / 2;
  const int stage = p.stage / 2, K4 = 4 * g.k, steps = 9 * p.steps;
  const int tr0 = blockIdx.y * kW5TBR, tc0 = blockIdx.x * kW5TBC;
  // step s: tap s / p.steps, Wq rows (s % p.steps) kc onwards (contiguous
  // rows of 128 columns), into stage s % kW5QuadStages; a cp.async group
  // each, empty past the last step
  auto load_stage = [&](int s) {
    if (s < steps) {
      const int tap = s / p.steps, c0 = (s - tap * p.steps) * p.kc;
      const bf16* src = w + (static_cast<long long>(tap) * K4 + c0) * (4 * kW5N);
      bf16* dst = wst + (s % kW5QuadStages) * stage;
      for (int i = threadIdx.x; i < min(p.kc, K4 - c0) * 16; i += kQuadThreads)
        cp_async16(dst + (i >> 4) * kW5QuadWS + (i & 15) * 8, src + i * 8, true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kW5QuadStages - 1; ++s) load_stage(s);
  load_quad_window(x, g, tr0, tc0, p.as, win);
  TcAcc<QuadCfg> acc;  // the tap group's partial (quad1: the total)
  acc.begin(0, kW5TB, kW5TBC, kW5WC);
  float tot[QuadCfg::MT][QuadCfg::NT][4];
#pragma unroll
  for (int i = 0; i < QuadCfg::MT; ++i)
#pragma unroll
    for (int j = 0; j < QuadCfg::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kW5QuadStages - 2>();  // step s's stage has landed
    // ... for every thread, as has the window at s = 0; and every warp is
    // done with step s - 1, whose stage step s + kW5QuadStages - 1 refills
    __syncthreads();
    load_stage(s + kW5QuadStages - 1);
    const int tap = s / p.steps, c0 = (s - tap * p.steps) * p.kc;
    mma_stage(acc, win + c0, p.as, wst + (s % kW5QuadStages) * stage, min(p.kc, K4 - c0), tap,
              tap + 1);
    if constexpr (MODE != kQuad1) {
      if (s % p.steps == p.steps - 1 && ((tap + 1) % group_of<MODE>() == 0 || tap == 8)) {
#pragma unroll
        for (int i = 0; i < QuadCfg::MT; ++i)
#pragma unroll
          for (int j = 0; j < QuadCfg::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[i][j][e] += acc.v[i][j][e];
              acc.v[i][j][e] = 0.f;
            }
      }
    }
  }
  if constexpr (MODE == kQuad1)
    store_planes<QuadCfg>(acc.v, acc, y, 0, g, tr0, tc0);
  else
    store_planes<QuadCfg>(tot, acc, y, 0, g, tr0, tc0);
}

// V_A of one row, 4 channels, from its six taps d[t] (row t / 2, input row
// parity t % 2): the nonzero B6[A][t] d[t] in t order, each product and sum
// rounded in f32 (no contraction into an FMA), no multiply by 1
template <int A>
__device__ __forceinline__ float4 v_row(const float4 (&d)[6]) {
  float4 v = d[0];
  bool first = true;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const float cf = b6(A, t);
    if (cf == 0.f) continue;
    float4 p = d[t];
    if (cf != 1.f)
      p = make_float4(__fmul_rn(p.x, cf), __fmul_rn(p.y, cf), __fmul_rn(p.z, cf),
                      __fmul_rn(p.w, cf));
    v = first ? p
              : make_float4(__fadd_rn(v.x, p.x), __fadd_rn(v.y, p.y), __fadd_rn(v.z, p.z),
                            __fadd_rn(v.w, p.w));
    first = false;
  }
  return v;
}

// 4 lanes of V rounded once to bf16, 8 bytes
__device__ __forceinline__ void store_v(bf16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// w55f's producer items: V_a of all six a for input channels c0 .. c0 + 15
// of a block, item e = (column j, column parity cp, 4-channel group); 272 a
// chunk, items tid and tid + 128 for every producer thread, 256 + tid for the
// first 16
constexpr int kW5Groups = kW5Chunk / 4;
constexpr int kW5Items = kW5WC * 2 * kW5Groups;
static_assert(kW5Items > 2 * kProducers && kW5Items <= 3 * kProducers, "items a producer");

// The chunk's input of item e of the block at (tr0, tc0): its six window rows
// r of both row parities rp, d[r][rp], straight from the quad image (zero
// past it); sixteen-byte loads, in flight until d is read
__device__ __forceinline__ void load_item(const float* __restrict__ x, const Geo& g, int tr0,
                                          int tc0, int c0, int e, float4 (&d)[kW5WR][2]) {
  const int grp = e % kW5Groups, cp = (e / kW5Groups) % 2, gc = tc0 + e / (2 * kW5Groups);
  const long long row_pitch = static_cast<long long>(g.CWP) * 4 * g.k;
#pragma unroll
  for (int r = 0; r < kW5WR; ++r)
#pragma unroll
    for (int rp = 0; rp < 2; ++rp) {
      const int gr = tr0 + r;
      const auto* src = reinterpret_cast<const float4*>(
          x + gr * row_pitch + static_cast<long long>(gc) * 4 * g.k + (2 * rp + cp) * g.k + c0 +
          4 * grp);
      d[r][rp] = gr < g.RH && gc < g.CWP ? __ldg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// V_a of all six a of item e from its input d into the chunk buffer vb
// [a][i][j][cp * 16 + c], rounded once to bf16
__device__ __forceinline__ void form_item(const float4 (&d)[kW5WR][2], int e, bf16* vb) {
  const int grp = e % kW5Groups, cp = (e / kW5Groups) % 2, j = e / (2 * kW5Groups);
  bf16* dst = vb + j * kW5VS + cp * kW5Chunk + 4 * grp;
#pragma unroll
  for (int i = 0; i < kW5TBR; ++i) {
    const float4 taps[6] = {d[i][0], d[i][1], d[i + 1][0], d[i + 1][1], d[i + 2][0], d[i + 2][1]};
    bf16* row = dst + i * kW5WC * kW5VS;
    constexpr int kA = kW5VCells * kW5VS;  // one a's V
    store_v(row, v_row<0>(taps));
    store_v(row + kA, v_row<1>(taps));
    store_v(row + 2 * kA, v_row<2>(taps));
    store_v(row + 3 * kA, v_row<3>(taps));
    store_v(row + 4 * kA, v_row<4>(taps));
    store_v(row + 5 * kA, v_row<5>(taps));
  }
}

// w55f's producers: Wf[a]'s rows ((a * 3 + co) * 2 + cp) k + c0 + r, r < 16,
// into the stage dst [co][cp * 16 + r][kW5WS], by cp.async
__device__ __forceinline__ void load_wf(const bf16* __restrict__ w, int k, int a, int c0,
                                        bf16* dst, int tid) {
  constexpr int kPieces = 2 * kW5N / 8;
  for (int e = tid; e < 3 * 2 * kW5Chunk * kPieces; e += kProducers) {
    const int pc = e % kPieces, row = e / kPieces;  // row = (co * 2 + cp) * 16 + r
    const int r = row % kW5Chunk, cpco = row / kW5Chunk;
    cp_async16(dst + row * kW5WS + pc * 8,
               w + (static_cast<long long>(a * 6 + cpco) * k + c0 + r) * (2 * kW5N) + pc * 8,
               true);
  }
}

// w55f: a persistent grid; a block takes the tile blocks blockIdx.x,
// blockIdx.x + gridDim.x, ... of the gx-wide grid of blocks. Warps 0-7
// multiply, warps 8-11 form V and bring Wf.
__global__ void __launch_bounds__(kW55fThreads, 1)
    wino5_w55f_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ y, Geo g, int nch, int gx, int blocks) {
  extern __shared__ uint4 smem4[];
  // [V, two chunk buffers | Wf, a stage for each a | mbarriers: V full x 2, W full x 6]
  bf16* vbuf = reinterpret_cast<bf16*>(smem4);
  bf16* wbuf = vbuf + kW5VBytes;  // two buffers of kW5VBytes bytes
  auto* bars = reinterpret_cast<unsigned long long*>(wbuf + 3 * kW5WStageBytes);
  constexpr int kVLen = kW5VBytes / 2, kWLen = kW5WStageBytes / 2;
  if (threadIdx.x == 0)
    for (int i = 0; i < kW5Bars; ++i) mbar_init(bars + i, kProducers);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // chunk u, the block's u-th (tile blockIdx.x + u / nch gridDim.x,
    // channels u % nch 16 onwards): wait until the consumers are done with
    // chunk u - 2, whose buffer it reuses; form V from the inputs of items
    // tid and tid + 128 already in registers (and of item 256 + tid, loaded
    // meanwhile); start the loads of chunk u + 1's; then for each a, once the
    // consumers are done with chunk u - 1's a, stream Wf[a]'s rows, while
    // those loads are in flight
    const int tid = threadIdx.x - kConsumers;
    const int chunks = (blocks - blockIdx.x + gridDim.x - 1) / gridDim.x * nch;
    auto coords = [&](int u, int& tr0, int& tc0, int& c0) {
      const int b = blockIdx.x + u / nch * gridDim.x;
      tr0 = b / gx * kW5TBR;
      tc0 = b % gx * kW5TBC;
      c0 = u % nch * kW5Chunk;
    };
    float4 d0[kW5WR][2], d1[kW5WR][2];
    auto load_two = [&](int u) {
      int tr0, tc0, c0;
      coords(u, tr0, tc0, c0);
      load_item(x, g, tr0, tc0, c0, tid, d0);
      load_item(x, g, tr0, tc0, c0, tid + kProducers, d1);
    };
    load_two(0);
    int u = 0;
    for (; u < chunks; ++u) {
      int tr0, tc0, c0;
      coords(u, tr0, tc0, c0);
      bf16* vb = vbuf + (u & 1) * kVLen;
      if (u >= 2) bar_sync(kVEmpty + (u & 1), kW55fThreads);
      form_item(d0, tid, vb);
      const bool third = tid + 2 * kProducers < kW5Items;
      if (third) load_item(x, g, tr0, tc0, c0, tid + 2 * kProducers, d0);
      form_item(d1, tid + kProducers, vb);
      if (third) form_item(d0, tid + 2 * kProducers, vb);
      mbar_arrive(bars + (u & 1));
      if (u + 1 < chunks) load_two(u + 1);
      for (int a = 0; a < 6; ++a) {
        if (u >= 1) bar_sync(kWEmpty + a, kW55fThreads);
        load_wf(w, g.k, a, c0, wbuf + a * kWLen, tid);
        cp_async_mbar_arrive(bars + 2 + a);
      }
    }
    // the consumers' releases that no later chunk waited for
    if (u >= 1) {
      for (int a = 0; a < 6; ++a) bar_sync(kWEmpty + a, kW55fThreads);
      bar_sync(kVEmpty + ((u - 1) & 1), kW55fThreads);
    }
    if (u >= 2) bar_sync(kVEmpty + (u & 1), kW55fThreads);
  } else {
    TcAcc<W55fCfg> acc;  // M_a's partial over a chunk
    acc.begin(0, kW5TB, kW5TBC, kW5WC);
    float ys[2][W55fCfg::MT][W55fCfg::NT][4];
    int u = 0;
    for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
      const int tc0 = b % gx * kW5TBC, tr0 = b / gx * kW5TBR;
#pragma unroll
      for (int pz = 0; pz < 2; ++pz)
#pragma unroll
        for (int i = 0; i < W55fCfg::MT; ++i)
#pragma unroll
          for (int j = 0; j < W55fCfg::NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ys[pz][i][j][e] = 0.f;
      for (int q = 0; q < nch; ++q, ++u) {
        const bf16* vb = vbuf + (u & 1) * kVLen;
        mbar_wait(bars + (u & 1), (u >> 1) & 1);
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int i = 0; i < W55fCfg::MT; ++i)
#pragma unroll
            for (int j = 0; j < W55fCfg::NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
          mbar_wait(bars + 2 + a, u & 1);
          mma_stage(acc, vb + a * kW5VCells * kW5VS, kW5VS, wbuf + a * kWLen, 2 * kW5Chunk, 0, 3);
          bar_arrive(kWEmpty + a, kW55fThreads);
          // AT25's coefficients are 0, +-1 or +-2: cf * m is exact, one rounding
#pragma unroll
          for (int pz = 0; pz < 2; ++pz) {
            const float cf = at25(pz, a);
            if (cf == 0.f) continue;
#pragma unroll
            for (int i = 0; i < W55fCfg::MT; ++i)
#pragma unroll
              for (int j = 0; j < W55fCfg::NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) ys[pz][i][j][e] += cf * acc.v[i][j][e];
          }
        }
        bar_arrive(kVEmpty + (u & 1), kW55fThreads);
      }
      // lanes (q, n): plane 2 pz + q
      store_planes<W55fCfg>(ys[0], acc, y, 0, g, tr0, tc0);
      store_planes<W55fCfg>(ys[1], acc, y, 2, g, tr0, tc0);
    }
  }
}

bool geometry_ok(const Geo& g) {
  return g.TR > 0 && g.TC > 0 && g.RH >= g.TR + 2 && g.CWP >= g.TC + 2;
}

template <int MODE>
int launch_quad(const float* x, const bf16* w, bf16* y, const Geo& g, cudaStream_t stream) {
  const Wino5Plan p(g.k, false);
  if (!p.ok || !geometry_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.TC + kW5TBC - 1) / kW5TBC, (g.TR + kW5TBR - 1) / kW5TBR);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = wino5_quad_kernel<MODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kQuadThreads, p.smem, stream>>>(x, w, y, g, p);
  return static_cast<int>(cudaGetLastError());
}

int launch_w55f(const float* x, const bf16* w, bf16* y, const Geo& g, cudaStream_t stream) {
  const Wino5Plan p(g.k, true);
  if (!p.ok || !geometry_ok(g)) return static_cast<int>(cudaErrorInvalidValue);
  const int gx = (g.TC + kW5TBC - 1) / kW5TBC, gy = (g.TR + kW5TBR - 1) / kW5TBR;
  const long long blocks = static_cast<long long>(gx) * gy;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wino5_w55f_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(blocks < sms ? blocks : sms);  // one block an SM
  wino5_w55f_kernel<<<grid, kW55fThreads, p.smem, stream>>>(x, w, y, g, p.nch, gx,
                                                            static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One conv2 on `stream`: x the quad image (RH, CWP, 4k) f32; w the bf16
// weights, (9 * 4k, 128) in modes 0-2 (quad, quadp, quad1) or (6 * 3 * 2k,
// 64) in mode 3 (w55f); y = (2, 2, TR, TC, 32) bf16. k a multiple of 16 up to
// kWino5MaxK, RH >= TR + 2, CWP >= TC + 2, all 16-byte aligned. Returns
// cudaGetLastError() of the launch.
extern "C" int wino5_forward(const void* x, const void* w, void* y, int RH, int CWP, int k,
                             int TR, int TC, int mode, void* stream) {
  const Geo g{RH, CWP, k, TR, TC};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  auto* yb = static_cast<bf16*>(y);
  switch (mode) {
    case kQuad: return launch_quad<kQuad>(xf, wb, yb, g, s);
    case kQuadP: return launch_quad<kQuadP>(xf, wb, yb, g, s);
    case kQuad1: return launch_quad<kQuad1>(xf, wb, yb, g, s);
    case kW55f: return launch_w55f(xf, wb, yb, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
