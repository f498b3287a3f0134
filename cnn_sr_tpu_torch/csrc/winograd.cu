// Winograd F(2x2, 3x3) of one 3x3 ReLU layer on the tensor cores: bf16
// operands, f32 sums, bf16 output in the parity layout (2, 2, TR, TC, n).
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
// (accum_y, :113-119). winograd_input_transform stores the direct or
// factored V instead: that is how the pre mode's V is made. The probe's
// fifth body, repack (:224), is the shipped conv_layer.cu followed by a
// parity_copy.cu split (probes/winograd.py: repack).
//
// Input layout (direct and factored): the parity planes of the layer's
// input, x[rp][i][j][cp*k + c] = act[2i + rp][2j + cp][c], (2, RH, CWP, 2k)
// with RH >= TR + 1 and CWP >= TC + 1; tap d[i][j] of tile (tr, tc) is
// x[i % 2][tr + i / 2][tc + j / 2][(j % 2) k + c], so a tile's 16 taps are
// contiguous rows of channels. Only rows <= TR and columns <= TC are read.
//
// What bounds it on the H100: the 16 position GEMMs are 16 k n
// multiply-adds per 2x2 output tile (the direct form's 36 k n), 133.5 G
// MAC at the RGB model's L6 (128 -> 128, 1068 x 1908 out): 0.27 ms at the
// bf16 tensor-core peak, under the 0.31 ms that its input, U and output
// take at 3.35 TB/s, so the layer is bound by bytes. Three costs sit beside
// both, all in a block's shared memory or on its way there: forming V
// (four taps read and three bf16 adds per value, per position), the
// mma.sync fragments (each V fragment read by the 4 warps that share its
// tiles, each U fragment by 2) and U's traffic from L2, since every block
// reads all of U, 16 k n bf16 (512 KB at 128 -> 128, 4.1 GB a 1080p L6
// launch). At L6 they come to about 250 KB of shared-memory traffic per
// position and block: the pace setter.
//
// What the design does: a block takes 4 x 16 tiles (8 x 32 output pixels)
// and NB output channels (NB = 128 for n >= 128, else 64), persistent, one
// block an SM walking over the tile blocks, with warps specialised:
// * a producer warpgroup (its registers handed to the consumers by
//   setmaxnreg) copies the block's window of the parity planes, 2 x 5 x 17
//   cells of 2k bf16, into shared memory by cp.async (zero past row TR and
//   column TC), and for each position in order forms V[pos] as bf16 from
//   it, 8 channels a thread with add.bf16x2 (a bf16 add rounds once: V is
//   bit-equal to the plain version's); in mode pre a tensor copy brings
//   V[pos] instead. One thread starts U[pos]'s tensor copy (kc input
//   channels x NB; past k = 128 U[pos] does not fit beside the window and
//   streams in nch stages a position). V and U are double-buffered: the
//   producers fill step s + 1 while the consumers multiply step s, an
//   mbarrier says full (the copies' bytes landed and every producer
//   arrived) and a named barrier empty. The next block's window loads
//   plane by plane as the positions stop reading it (plane 0 after V[11],
//   plane 1 after V[15]), so no block waits for its window.
// * 8 consumer warps, 2 over the tiles by 4 over the channels, each a
//   32-tile x NB / 4-channel tile of mma.sync m16n8k16 (f32 sums), with
//   the next k16 step's fragments loaded (ldmatrix, .trans for the
//   row-major U) before this one's products. V, U and the output staging
//   are 128-byte rows whose 16-byte chunks are swizzled by the row (the
//   tensor copies' 128-byte swizzle), so that ldmatrix and the producers'
//   stores touch every bank once. The M fragments fold into the thread's
//   four Y fragments in registers with A^T's +-1 coefficients: the m16n8
//   fragments of M and Y share one layout, so the fold is register adds.
//   32 + 128 f32 sums a thread at NB = 128.
// * The epilogue stages each ReLU'd bf16 Y plane in shared memory and one
//   thread stores it by a tensor copy, which drops the tiles past the
//   ragged grid and the channels past n and runs on while the next block
//   computes.
// The block plan (tiles, stages, shared bytes, the limit MAX_K) is
// winograd_plan.cuh's, in one place.
//
// History: on the CUDA cores (f32 FMAs over V and U staged as f32 in shared
// memory, the design before this one) this kernel took, at 1080p, L6 wino
// 13.79 ms, winoF 13.58, winoD 13.50 and L5 7.56, 7.48, 7.13 (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py), against cuDNN bf16 conv + ReLU's 1.916
// and 1.593.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "tma.cuh"
#include "winograd_plan.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A layer block: 8 consumer warps (2 over the tiles by kWarpsN over the
// channels, kMT m16 tiles each) and a producer warpgroup, its registers
// handed to the consumers (setmaxnreg: 128 x 72 + 256 x 216 = 384 x 168)
constexpr int kConsumers = 256, kProducers = 128, kThreads = kConsumers + kProducers;
constexpr int kConsumerRegs = 216, kProducerRegs = 72;
constexpr int kWarpsN = 4;
constexpr int kMT = 2;
constexpr int kTransformThreads = 256;
// named barriers: a step's buffers free again (two, by step parity), the
// producers' own and the consumers' own; a step's buffers full are the two
// mbarriers
constexpr int kEmpty = 1, kProducerBar = 3, kConsumerBar = 4;
static_assert(kConsumers / 32 / kWarpsN * kMT * 16 == kWinoTB, "the warps cover the tiles");
static_assert(kConsumers * kConsumerRegs + kProducers * kProducerRegs <= 65536 / kThreads * kThreads,
              "the register file of one block an SM");

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Element offset of lane c of row r in a swizzled block of 128-byte rows:
// 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int c) {
  return r * kWinoLanes + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}
// lane c of tile t in a V buffer (kblk blocks of 64 tiles x 64 lanes)
__device__ __forceinline__ int v_at(int t, int c) {
  return (c / kWinoLanes) * (kWinoTB * kWinoLanes) + swz(t, c % kWinoLanes);
}

enum Mode { kDirect = 0, kFactored = 1, kPre = 2 };

struct Geo {
  int RH, CWP, k, n, TR, TC;
};

// row a of B^T = [[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]]:
// its two nonzero entries, in column order, and whether each is -1
__host__ __device__ constexpr int bt_i1(int a) { return a == 0 ? 0 : 1; }
__host__ __device__ constexpr int bt_i2(int a) { return a == 3 ? 3 : 2; }
__host__ __device__ constexpr bool bt_neg1(int a) { return a == 2; }
__host__ __device__ constexpr bool bt_neg2(int a) { return a == 0 || a == 3; }

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__device__ __forceinline__ float at(int p, int a) {
  if (p == 0) return a == 3 ? 0.f : 1.f;
  return a == 0 ? 0.f : (a == 1 ? 1.f : -1.f);
}

// 8 bf16 lanes: negated (exact), and a +- b rounded once to bf16
// (add.bf16x2 / sub.bf16x2, round to nearest even)
template <bool NEG>
__device__ __forceinline__ uint4 neg8(uint4 a) {
  constexpr unsigned m = NEG ? 0x80008000u : 0u;
  return NEG ? make_uint4(a.x ^ m, a.y ^ m, a.z ^ m, a.w ^ m) : a;
}
template <bool SUB>
__device__ __forceinline__ unsigned addsub2(unsigned a, unsigned b) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162 r = SUB ? __hsub2(x, y) : __hadd2(x, y);
  return *reinterpret_cast<const unsigned*>(&r);
}
template <bool SUB>
__device__ __forceinline__ uint4 addsub8(uint4 a, uint4 b) {
  return make_uint4(addsub2<SUB>(a.x, b.x), addsub2<SUB>(a.y, b.y), addsub2<SUB>(a.z, b.z),
                    addsub2<SUB>(a.w, b.w));
}

// V[POS] of one tile, 8 channels, from w = the window at the tile's cell
// (0, 0) of parity plane 0 and its first channel; rounded to bf16 after
// every add, in the mode's order (the sign of a term is exact)
template <int MODE, int POS>
__device__ __forceinline__ uint4 v8(const bf16* w, int k) {
  constexpr int pa = POS >> 2, pb = POS & 3;
  constexpr int i1 = bt_i1(pa), i2 = bt_i2(pa), j1 = bt_i1(pb), j2 = bt_i2(pb);
  constexpr bool ni1 = bt_neg1(pa), ni2 = bt_neg2(pa), nj1 = bt_neg1(pb), nj2 = bt_neg2(pb);
  // tap d[i][j]: parity plane i % 2, cell (i / 2, j / 2), lanes (j % 2) k
  auto d = [&](int i, int j) {
    return *reinterpret_cast<const uint4*>(
        w + (((i & 1) * kWinoWR + (i >> 1)) * kWinoWC + (j >> 1)) * 2 * k + (j & 1) * k);
  };
  if constexpr (MODE == kFactored) {
    const uint4 r1 = addsub8<ni2>(neg8<ni1>(d(i1, j1)), d(i2, j1));
    const uint4 r2 = addsub8<ni2>(neg8<ni1>(d(i1, j2)), d(i2, j2));
    return addsub8<nj2>(neg8<nj1>(r1), r2);
  } else {
    uint4 v = neg8<ni1 != nj1>(d(i1, j1));
    v = addsub8<ni1 != nj2>(v, d(i1, j2));
    v = addsub8<ni2 != nj1>(v, d(i2, j1));
    return addsub8<ni2 != nj2>(v, d(i2, j2));
  }
}

// V[POS] of the block's 64 tiles from the window, 8 channels an item,
// items tid, tid + nthr, ...: store(t, c, v) takes tile t, channel c
template <int MODE, int POS, class Store>
__device__ __forceinline__ void form_pos(const bf16* win, int k, int tid, int nthr, Store store) {
  const int groups = k / 8;
  const unsigned magic = 0xffffffffu / groups + 1;  // e / groups = umulhi(e, magic) here, groups > 1
#pragma unroll 1  // (unrolled, the transform kernel spills and neither runs faster)
  for (int e = tid; e < kWinoTB * groups; e += nthr) {
    const int t = groups > 1 ? __umulhi(static_cast<unsigned>(e), magic) : e;
    const int c = (e - t * groups) * 8;
    store(t, c, v8<MODE, POS>(win + ((t / kWinoTBC) * kWinoWC + t % kWinoTBC) * 2 * k + c, k));
  }
}

// form_pos at a position known at run time
template <int MODE, int P = 0, class Store>
__device__ __forceinline__ void form_at(int pos, const bf16* win, int k, int tid, int nthr,
                                        Store store) {
  if constexpr (P < 16) {
    if (pos == P)
      form_pos<MODE, P>(win, k, tid, nthr, store);
    else
      form_at<MODE, P + 1>(pos, win, k, tid, nthr, store);
  }
}

// The block's window, parity planes rp0 .. rp1: rows tr0 .. tr0 + TBR,
// columns tc0 .. tc0 + TBC, in 16-byte cp.async pieces, zero past row TR
// and column TC; threads tid of nthr take part
__device__ __forceinline__ void load_window(const bf16* __restrict__ x, const Geo& g, int tr0,
                                            int tc0, bf16* win, int tid, int nthr, int rp0 = 0,
                                            int rp1 = 2) {
  const int pieces = g.k / 4;  // of a cell's 2k lanes
  for (int e = tid + rp0 * kWinoWR * kWinoWC * pieces; e < rp1 * kWinoWR * kWinoWC * pieces;
       e += nthr) {
    const int cell = e / pieces, q = e % pieces;
    const int rp = cell / (kWinoWR * kWinoWC), r = (cell / kWinoWC) % kWinoWR;
    const int gr = tr0 + r, gc = tc0 + cell % kWinoWC;
    const bool valid = gr <= g.TR && gc <= g.TC;
    cp_async16(win + cell * 2 * g.k + q * 8,
               valid ? x + ((static_cast<long long>(rp) * g.RH + gr) * g.CWP + gc) * 2 * g.k +
                           q * 8
                     : x,
               valid);
  }
}

// The A (V, kMT m16 tiles) and B (U, NT n8 tiles) fragments of one k16 step
template <int NT>
struct Frags {
  unsigned a[kMT][4];
  unsigned b[NT / 2][4];  // [nj]: n8 tile 2 nj (k 0-7, 8-15), then tile 2 nj + 1

  // A rows from va (a V buffer at this lane's tile row, 16 tiles an m16
  // tile) at lane chunk cc (of 8 lanes, swizzled by the tile row's % 8 =
  // sw); B from ub[nj] (this lane's U rows for n8 tiles 2 nj, 2 nj + 1)
  __device__ __forceinline__ void load(const bf16* va, int cc, int sw, const bf16* const* ub,
                                       int krow) {
    const int off = (cc >> 3) * (kWinoTB * kWinoLanes) + (((cc ^ sw) & 7) << 3);
#pragma unroll
    for (int i = 0; i < kMT; ++i) ldmatrix_x4(a[i], va + i * 16 * kWinoLanes + off);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) ldmatrix_x4_trans(b[nj], ub[nj] + krow * kWinoLanes);
  }
  __device__ __forceinline__ void mma(float (&m)[kMT][NT][4]) const {
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj)
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        mma_bf16(m[i][2 * nj], a[i], b[nj][0], b[nj][1]);
        mma_bf16(m[i][2 * nj + 1], a[i], b[nj][2], b[nj][3]);
      }
  }
};

// One layer: p is the launch's plan; tu the tensor map of U as (16, k, n),
// box (1, kc, 64); tv (mode pre) of V as (16, TR, TC, k), box (1, 4, 16,
// 64); ty of the parity output as (4, TR, TC, n), box (1, 4, 16, 64), the
// same box as V's. A persistent grid: a
// block takes the tile blocks blockIdx.x, blockIdx.x + gridDim.x, ... of
// the gx x gy x (n / NB) grid of blocks, column block fastest. Warps 0-7
// compute, warps 8-11 feed them.
template <int MODE, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    winograd_kernel(const bf16* __restrict__ x, Geo g, WinoPlan p, int gx, int gy, int blocks,
                    const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap ty) {
  extern __shared__ uint4 smem4[];
  // [V, two buffers | U, two stages | Y, two planes | window | two
  // mbarriers] from a 1024-aligned base
  const unsigned base = smem_addr(smem4);
  bf16* vbuf = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem4) + ((1024 - base % 1024) % 1024));
  bf16* ubuf = vbuf + p.v;  // two V buffers of p.v bytes = p.v bf16
  bf16* ystage = ubuf + p.u;  // two U stages of p.u bytes
  bf16* win = ystage + p.y;
  auto* full = reinterpret_cast<unsigned long long*>(win + p.win / 2);
  const int vlen = p.v / 2, ulen = p.u / 2, steps = 16 * p.nch;
  if (threadIdx.x == 0) {
    // a step's buffers are full when every producer thread has arrived
    // (its V formed) and the elected one's tensor copies have landed
    mbar_init(full, kProducers + 1);
    mbar_init(full + 1, kProducers + 1);
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup. For step s (position s / nch of a tile
    // block, U rows (s % nch) kc onwards) it waits until the consumers
    // are done with step s - 2, whose V buffer and U stage step s reuses;
    // one thread starts the tensor copies of U (and in mode pre of V), the
    // others form V[pos] from the window meanwhile, and all arrive on the
    // step's mbarrier. The window's parity plane 0 (tap rows 0 and 2) is
    // last read by V[11] and plane 1 (rows 1 and 3) first by V[4], so the
    // next block's planes load as soon as V[11] and V[15] are formed.
    setmaxnreg_dec<kProducerRegs>();
    const int tid = threadIdx.x - kConsumers;
    if constexpr (MODE != kPre)
      if (p.kp > g.k)  // V's lanes k .. kp (8 of them) in both buffers stay zero
        for (int t = tid; t < 2 * kWinoTB; t += kProducers)
          *reinterpret_cast<uint4*>(vbuf + (t / kWinoTB) * vlen + v_at(t % kWinoTB, g.k)) =
              make_uint4(0, 0, 0, 0);
    // plane rp of the window of tile block b, a cp.async group
    auto load_plane = [&](int b, int rp) {
      load_window(x, g, b / gx % gy * kWinoTBR, b % gx * kWinoTBC, win, tid, kProducers, rp,
                  rp + 1);
      cp_async_commit();
    };
    if constexpr (MODE != kPre) {
      load_plane(blockIdx.x, 0);
      load_plane(blockIdx.x, 1);
    }
    int s = 0;
    for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
      const int tc0 = b % gx * kWinoTBC, tr0 = b / gx % gy * kWinoTBR, n0 = b / (gx * gy) * NB;
      for (int t = 0; t < steps; ++t, ++s) {
        const int pos = t / p.nch, ch = t % p.nch;
        bf16* vb = vbuf + (pos & 1) * vlen;
        if (s >= 2) bar_sync(kEmpty + (s & 1), kThreads);
        if (tid == 0) {
          fence_proxy_async();
          const bool with_v = MODE == kPre && ch == 0;
          mbar_arrive_expect_tx(full + (s & 1), p.u + (with_v ? p.v : 0));
          bf16* ub = ubuf + (s & 1) * ulen;
#pragma unroll
          for (int sb = 0; sb < NB / kWinoLanes; ++sb)
            tma_load_3d(ub + sb * p.kc * kWinoLanes, &tu, n0 + sb * kWinoLanes, ch * p.kc, pos,
                        full + (s & 1));
          if (with_v)
            for (int kb = 0; kb < p.kblk; ++kb)
              tma_load_4d(vb + kb * kWinoTB * kWinoLanes, &tv, kb * kWinoLanes, tc0, tr0, pos,
                          full + (s & 1));
        }
        if constexpr (MODE != kPre) {
          if (t == 0 || t == 4 * p.nch) {  // plane 0 (then 1) has landed, for every producer
            if (t == 0)
              cp_async_wait_1();
            else
              cp_async_wait_all();
            bar_sync(kProducerBar, kProducers);
          }
          if (ch == 0)
            form_at<MODE>(pos, win, g.k, tid, kProducers, [&](int tile, int c, uint4 v) {
              *reinterpret_cast<uint4*>(vb + v_at(tile, c)) = v;
            });
        }
        mbar_arrive(full + (s & 1));
        if constexpr (MODE != kPre)
          if (ch == 0 && (pos == 11 || pos == 15) && b + gridDim.x < blocks) {
            bar_sync(kProducerBar, kProducers);  // every producer is done with the plane
            load_plane(b + gridDim.x, pos == 15);
          }
      }
    }
    // the consumers' releases of the last two steps
    bar_sync(kEmpty + (s & 1), kThreads);
    bar_sync(kEmpty + ((s + 1) & 1), kThreads);
  } else {
    // The consumer warpgroups: 2 warps over the 64 tiles by 4 over the NB
    // channels, each a 32-tile x NB / 4-channel tile of mma.sync m16n8k16,
    // the fragments of the next k16 step loaded before this one's products
    setmaxnreg_inc<kConsumerRegs>();
    constexpr int NT = NB / 8 / kWarpsN;  // n8 tiles a warp
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp / kWarpsN, wn = warp % kWarpsN;
    const int sw = lane & 7;  // the swizzle of this lane's A and B rows
    // this lane's B rows (k16 + lane % 16 of a stage) for n8 tiles 2 nj, 2 nj + 1
    int uoff[NT / 2];
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      const int cc = wn * NT + nj * 2 + (lane >> 4);  // 8-column chunk of the stage
      uoff[nj] = (cc >> 3) * p.kc * kWinoLanes + (lane & 15) * kWinoLanes + (((cc ^ sw) & 7) << 3);
    }
    float m[kMT][NT][4];
    float acc[4][kMT][NT][4];  // Y[pq], pq = p * 2 + q, in M's fragment layout
    Frags<NT> f0, f1;
    int s = 0;
    for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
      const int tc0 = b % gx * kWinoTBC, tr0 = b / gx % gy * kWinoTBR, n0 = b / (gx * gy) * NB;
#pragma unroll
      for (int pq = 0; pq < 4; ++pq)
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[pq][i][j][e] = 0.f;
      for (int t = 0; t < steps; ++t, ++s) {
        const int pos = t / p.nch, ch = t % p.nch;
        if (ch == 0) {
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) m[i][j][e] = 0.f;
        }
        const bf16* va = vbuf + (pos & 1) * vlen + (wm * kMT * 16 + (lane & 15)) * kWinoLanes;
        const bf16* ub[NT / 2];
#pragma unroll
        for (int nj = 0; nj < NT / 2; ++nj) ub[nj] = ubuf + (s & 1) * ulen + uoff[nj];
        const int cc0 = ch * p.kc / 8 + (lane >> 4);  // this lane's first A chunk
        const int kc = min(p.kc, p.kp - ch * p.kc);
        mbar_wait(full + (s & 1), (s >> 1) & 1);
        f0.load(va, cc0, sw, ub, 0);
        for (int k16 = 0; k16 < kc; k16 += 32) {
          if (k16 + 16 < kc) f1.load(va, cc0 + (k16 + 16) / 8, sw, ub, k16 + 16);
          f0.mma(m);
          if (k16 + 32 < kc) f0.load(va, cc0 + (k16 + 32) / 8, sw, ub, k16 + 32);
          if (k16 + 16 < kc) f1.mma(m);
        }
        bar_arrive(kEmpty + (s & 1), kThreads);
        if (ch == p.nch - 1) {
          // Y[p][q] += A^T[p][pa] A^T[q][pb] M: coefficients 0 or +-1, so
          // each add rounds once, as the probe's ys[pq] + m * c
          const int pa = pos >> 2, pb = pos & 3;
#pragma unroll
          for (int pq = 0; pq < 4; ++pq) {
            const float cf = at(pq >> 1, pa) * at(pq & 1, pb);
            if (cf != 0.f) {
#pragma unroll
              for (int i = 0; i < kMT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[pq][i][j][e] += cf * m[i][j][e];
            }
          }
        }
      }
      // ReLU, bf16 (nearest even), each Y plane staged in shared memory in
      // V's layout and stored by one tensor copy (tiles past the grid and
      // channels past n fall outside the tensor), in flight while the next
      // block computes; a staging buffer is rewritten once its copy has
      // read it
#pragma unroll
      for (int pq = 0; pq < 4; ++pq) {
        bf16* yb = ystage + (pq & 1) * (NB * kWinoTB);
        if (threadIdx.x == 0) bulk_wait_read<1>();
        bar_sync(kConsumerBar, kConsumers);
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tile = wm * kMT * 16 + i * 16 + (lane >> 2) + 8 * h;
#pragma unroll
            for (int j = 0; j < NT; ++j)
              *reinterpret_cast<__nv_bfloat162*>(
                  yb + v_at(tile, wn * NT * 8 + j * 8 + (lane & 3) * 2)) =
                  __floats2bfloat162_rn(fmaxf(acc[pq][i][j][2 * h], 0.f),
                                        fmaxf(acc[pq][i][j][2 * h + 1], 0.f));
          }
        fence_proxy_async();
        bar_sync(kConsumerBar, kConsumers);
        if (threadIdx.x == 0) {
#pragma unroll
          for (int sb = 0; sb < NB / kWinoLanes; ++sb)
            tma_store_4d(&ty, yb + sb * kWinoTB * kWinoLanes, n0 + sb * kWinoLanes, tc0, tr0, pq);
          bulk_commit();
        }
      }
    }
    if (threadIdx.x == 0) bulk_wait_read<0>();  // the copies have read the staging buffers
  }
}

// The input transform alone: V (16, TR*TC, k) bf16 into v, the values the
// layer kernel forms (v8)
template <int MODE>
__global__ void __launch_bounds__(kTransformThreads)
    winograd_transform_kernel(const bf16* __restrict__ x, bf16* __restrict__ v, Geo g) {
  extern __shared__ uint4 smem4[];
  bf16* win = reinterpret_cast<bf16*>(smem4);
  const int k = g.k, tr0 = blockIdx.y * kWinoTBR, tc0 = blockIdx.x * kWinoTBC;
  load_window(x, g, tr0, tc0, win, threadIdx.x, kTransformThreads);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const long long T = static_cast<long long>(g.TR) * g.TC;
  for (int pos = 0; pos < 16; ++pos)
    form_at<MODE>(pos, win, k, threadIdx.x, kTransformThreads, [&](int t, int c, uint4 val) {
      const int gr = tr0 + t / kWinoTBC, gc = tc0 + t % kWinoTBC;
      if (gr < g.TR && gc < g.TC)
        *reinterpret_cast<uint4*>(v + (pos * T + static_cast<long long>(gr) * g.TC + gc) * k +
                                  c) = val;
    });
}

bool shape_ok(const Geo& g, bool window) {
  return g.k > 0 && g.k % 8 == 0 && g.k <= kWinoMaxK && g.TR > 0 && g.TC > 0 &&
         (!window || (g.RH >= g.TR + 1 && g.CWP >= g.TC + 1)) &&
         (g.TR + kWinoTBR - 1) / kWinoTBR <= 65535;
}

template <int MODE, int NB>
int launch_layer(const void* x, const void* u, void* y, const Geo& g, cudaStream_t stream) {
  const WinoPlan p(g.k, NB, MODE != kPre);
  if (!p.ok || !shape_ok(g, MODE != kPre) || g.n <= 0 || g.n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gx = (g.TC + kWinoTBC - 1) / kWinoTBC, gy = (g.TR + kWinoTBR - 1) / kWinoTBR;
  const long long blocks = static_cast<long long>(gx) * gy * ((g.n + NB - 1) / NB);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // U as (16, k, n), a box of kc rows x 64 columns; V (mode pre) as (16,
  // TR, TC, k), a box of the block's 4 x 16 tiles x 64 lanes
  CUtensorMap tu, tv, ty;
  const cuuint64_t udims[3] = {static_cast<cuuint64_t>(g.n), static_cast<cuuint64_t>(g.k), 16};
  const cuuint64_t ustrides[2] = {2ull * g.n, 2ull * g.n * g.k};
  const cuuint32_t ubox[3] = {kWinoLanes, static_cast<cuuint32_t>(p.kc), 1};
  if (!bf16_map(&tu, u, 3, udims, ustrides, ubox)) return static_cast<int>(cudaErrorInvalidValue);
  // the parity output as (4, TR, TC, n), V's box
  const cuuint64_t ydims[4] = {static_cast<cuuint64_t>(g.n), static_cast<cuuint64_t>(g.TC),
                               static_cast<cuuint64_t>(g.TR), 4};
  const cuuint64_t ystrides[3] = {2ull * g.n, 2ull * g.n * g.TC, 2ull * g.n * g.TC * g.TR};
  const cuuint32_t box[4] = {kWinoLanes, kWinoTBC, kWinoTBR, 1};
  if (!bf16_map(&ty, y, 4, ydims, ystrides, box)) return static_cast<int>(cudaErrorInvalidValue);
  tv = tu;
  if (MODE == kPre) {
    const cuuint64_t vdims[4] = {static_cast<cuuint64_t>(g.k), static_cast<cuuint64_t>(g.TC),
                                 static_cast<cuuint64_t>(g.TR), 16};
    const cuuint64_t vstrides[3] = {2ull * g.k, 2ull * g.k * g.TC, 2ull * g.k * g.TC * g.TR};
    if (!bf16_map(&tv, x, 4, vdims, vstrides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = winograd_kernel<MODE, NB>;
  // setmaxnreg moves registers within the block's allocation: refuse a
  // build whose allocation could not hold the consumers' (it would wait
  // for them for ever)
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kThreads < kConsumers * kConsumerRegs + kProducers * kProducerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(blocks < sms ? blocks : sms);  // one block an SM
  kernel<<<grid, kThreads, p.smem, stream>>>(static_cast<const bf16*>(x), g, p, gx, gy,
                                             static_cast<int>(blocks), tu, tv, ty);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_transform(const void* x, void* v, const Geo& g, cudaStream_t stream) {
  if (!shape_ok(g, true)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = wino_window_bytes(g.k);
  const dim3 grid((g.TC + kWinoTBC - 1) / kWinoTBC, (g.TR + kWinoTBR - 1) / kWinoTBR);
  auto kernel = winograd_transform_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kTransformThreads, smem, stream>>>(static_cast<const bf16*>(x),
                                                    static_cast<bf16*>(v), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One layer on `stream`: mode 0 (direct) or 1 (factored) with x the parity
// input (2, RH, CWP, 2k), or mode 2 (pre) with x = V (16, TR*TC, k); u =
// (16k, n); y = (2, 2, TR, TC, n). All bf16, 16-byte aligned, k and n
// multiples of 8, k at most kWinoMaxK. Returns cudaGetLastError() of the
// launch.
extern "C" int winograd_f2x3_forward(const void* x, const void* u, void* y, int RH, int CWP,
                                     int k, int n, int TR, int TC, int mode, void* stream) {
  const Geo g{RH, CWP, k, n, TR, TC};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool wide = n >= 128;
  if (mode == kDirect)
    return wide ? launch_layer<kDirect, 128>(x, u, y, g, s) : launch_layer<kDirect, 64>(x, u, y, g, s);
  if (mode == kFactored)
    return wide ? launch_layer<kFactored, 128>(x, u, y, g, s)
                : launch_layer<kFactored, 64>(x, u, y, g, s);
  if (mode == kPre)
    return wide ? launch_layer<kPre, 128>(x, u, y, g, s) : launch_layer<kPre, 64>(x, u, y, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The input transform alone: V (16, TR*TC, k) bf16 of the parity input x,
// in mode 0 (direct) or 1 (factored), the same values the layer forms.
extern "C" int winograd_input_transform(const void* x, void* v, int RH, int CWP, int k, int TR,
                                        int TC, int mode, void* stream) {
  const Geo g{RH, CWP, k, 0, TR, TC};
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == kDirect) return launch_transform<kDirect>(x, v, g, s);
  if (mode == kFactored) return launch_transform<kFactored>(x, v, g, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
