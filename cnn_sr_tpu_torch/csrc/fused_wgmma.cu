// fused_srcnn_forward_bf16: the 3-layer SRCNN stack of the bf16 stream with
// the int8 first layer in one launch, on Hopper's warpgroup products:
//   y = conv3(relu(conv2(relu(conv1(q(x)) + b1)) + b2)) + b3
// over the f32 centred plane x (N, H, W, c), q(x) = round(clip(x, -1, 1) *
// 127) (ties to even) taken at the window load, w1 carrying the 1/127 fold,
// bf16 operands and f32 sums, each activation rounded once to bf16 (nearest
// even) between layers; y f32 (N, H - s, W - s, n3), s = (f1 - 1) + (f2 - 1)
// + (f3 - 1). Its plain version is ops/fused/reference.py: fused_forward(...,
// "bf16").
//
// Replaces the TPU kernel cnn_sr_tpu/ops/pallas_fused/kernel.py:
// _fused_tail_single (pl.pallas_call at kernel.py:730) as
// cnn_sr_tpu/ops/pallas_fused/entry.py:32 fused_forward runs it with
// dtype=bf16, input_int8=True (the JAX package's default under use_pallas):
// its branches plane.py:23 plane_first_layer (conv1 from the int8 plane),
// wino_kernel.py:25 wino_layer (conv2, the quad branch) and
// wino_kernel.py:349 wino_mm_exit (conv3). It computes what they compute;
// the TPU's parity planes and lane rolls have no purpose here.
//
// What bounds it: the multiply-adds at the bf16 tensor-core rate, and with
// them the shared-memory reads that feed them. The flagship 9-5-5 (n1 = 64,
// n2 = 32) needs 57,184 MACs an output pixel, 51,200 in conv2: 116.6 G MAC a
// 1080p frame, 0.236 ms at 989 TFLOP/s; its bytes (the f32 plane in and
// out) take 0.005 ms. At the flagship's 20 x 20 output tile the halo (conv2
// over 24 x 24, 1.44x; conv1 over 13 chunks of 64 for 28 x 28 positions at K
// = 16 a dy tap; conv3's 5 x 1 dx columns padded to N = 8) brings the
// executed work to about 200 G MAC. conv2's products are m64n32k16: at N =
// 32 a wgmma reaches about half the tensor rate (the xpack probe's N = 32
// forms, PERF.md), and conv2 takes half the time.
//
// What the design does (plan: fused_wgmma_plan.cuh):
// * Every activation is kept in shared memory as planes of 8 lanes, each
//   position one 16-byte row of its plane, position-major. That is the
//   no-swizzle (interleave) core-matrix layout of a K-major wgmma operand:
//   a core matrix is 8 consecutive positions of one plane, 128 contiguous
//   bytes, the next 8 lanes one plane on (LBO), the next 8 rows SBO on. Its
//   start needs only 16-byte alignment, so each tap (dy, dx) is a start
//   address dy * width + dx positions into the tile and nothing is copied
//   per tap. (The 128-byte swizzle reads a shifted start right too, by the
//   address's own bits, with the matrix-base offset 0; its rows would hold
//   64 lanes where conv1's window has 16. The card test of both forms is
//   tests/test_torch_fused_wgmma.py.)
// * conv2 (f2^2 taps, K = kpad(n1), N = npad(n2)): an M = 64 operand is an
//   8 x 8 patch of the a2 tile, SBO one a1 row; the a2 x a2 tile's patches
//   are shared round robin by three consumer warpgroups, each holding all
//   of its patches' sums (at most 96 floats a thread) while w2 streams by:
//   one tap slice (K x N, 4 KB at the flagship) a ring slot, brought by one
//   bulk copy. A slot goes back to the producer once the products after it
//   are issued and its own have completed (wgmma wait 1).
// * conv1 (f1 taps of the dx-expanded, quantised window, K = 16 a dy tap at
//   c f1 <= 16, N = npad(n1)): M = 64 raster positions of the a1 tile, SBO
//   128; the window is a1 positions wide, so tap dy is a start dy * a1
//   positions on.
// * conv3 (K = kpad(n2)): M = 64 raster positions of the output rows taken
//   a2 wide, its f3 dy taps start offsets and its f3 dx taps side by side
//   in N (npad(f3 n3) columns: 8 for the flagship, 5 taps x 1 channel),
//   so that A is read once a dy tap, not once a tap; the f32 sums go to
//   a1's bytes and each output adds its f3 dx columns, shifted, with the
//   bias. m64n8k16 over all 25 taps read A five times as often.
// * A persistent grid, one block an SM, walks the tiles (column fastest).
//   Four warpgroups: three consumers (setmaxnreg gives them the fourth's
//   registers) and a producer of which one warp works: w1 and w3 once, then
//   for each tile its input pixels (f32, 4-byte cp.async with zero fill
//   outside the image, counted on an mbarrier) and its w2 slices, so that a
//   tile's pixels land while the tile before is computed. The consumers
//   quantise and expand the pixels into the window.
// * Each sum's first product is a write-only wgmma (wgmma_kk_first), peeled
//   out of its loop, and nothing else writes the sums' registers. Zeroing
//   them first made ptxas serialise every product (a WARPGROUP.DEPBAR after
//   each HGMMA; probes/fused_wgmma_parts.py times that copy); reading them
//   before any write kept every instance's sums live around the tile loop
//   (spills).
// * Raster chunks run past the tile's last row: the window and a2 carry
//   the positions they reach (zeros in the window); what those rows compute
//   is never stored. Ragged right and bottom edges read zeros and store
//   only inside the output. No product sits behind a branch: a warpgroup
//   with fewer patches or chunks than the others repeats its last one and
//   does not store it.
// * The weights are tiled on the host into the shared-memory image of the
//   K-major operand (ops/fused/entry.py: fused_weights): each tap a block of
//   [K / 8][N / 8] core matrices of 8 N rows x 8 K lanes, so every copy is
//   contiguous.
// * Shared memory, flagship: the window (1,056 positions x 32 bytes) in
//   the bytes that a2 (608 positions x 64 bytes, 38,912) later takes, w1
//   18,432, a1 100,352 (later conv3's sums), w3 2,560, the pixels 5,184,
//   eight w2 slots of 4,096 and the mbarriers: 198,360 bytes.
//
// Measured: PERF.md (the kernel table, chip_smoke.py [time]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "fused_wgmma_plan.cuh"
#include "mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// three consumer warpgroups and a producer warpgroup of which one warp
// works, whose registers go to the consumers (setmaxnreg: 128 x 56 + 384 x
// 152 = 512 x 128)
constexpr int kWarpgroup = 128;
constexpr int kConsumerThreads = kFwConsumers * kWarpgroup;
constexpr int kThreads = kConsumerThreads + kWarpgroup;
constexpr int kConsumerRegs = 152, kProducerRegs = 56;
static_assert(kConsumerThreads * kConsumerRegs + kWarpgroup * kProducerRegs <= 65536,
              "the registers handed over fit the block's");
constexpr int kConsumerWarps = kConsumerThreads / 32;  // arrivals that empty a ring slot
constexpr int kConsumerBar = 1;  // the consumers' named barrier

// A ring's next slot and the parity of its phase
struct Ring {
  int slot = 0, phase = 0;
  __device__ void next(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void consumers_sync() { bar_sync(kConsumerBar, kConsumerThreads); }

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) wgmma_fence_operand(acc[e]);
}

__device__ __forceinline__ unsigned relu_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  return *reinterpret_cast<const unsigned*>(&h);
}

// zero lanes [g0 * 8, g1 * 8) of `positions` positions of a plane set
__device__ __forceinline__ void zero_planes(unsigned char* t, int positions, int g0, int g1) {
  const int total = positions * (g1 - g0);
  for (int i = threadIdx.x; i < total; i += kConsumerThreads)
    *reinterpret_cast<uint4*>(t + (g0 + i / positions) * positions * 16 + i % positions * 16) =
        make_uint4(0, 0, 0, 0);
}

// The tile's ih x (a1 + f1 - 1) input pixels, f32, into `raw` by 4-byte
// copies of the producer warp's 32 lanes (zeros outside the image), each
// lane's arrival on `full` counted when its copies have landed
__device__ __forceinline__ void load_pixels(const FusedWgmmaPlan& p, const float* __restrict__ xi,
                                            int H, int W, int oy0, int ox0, float* raw,
                                            unsigned long long* full) {
  const int iw = p.a1 + p.f1 - 1, lane = threadIdx.x % 32;
  for (int i = lane; i < p.ih * iw * p.c; i += 32) {
    const int pix = i / p.c, gy = oy0 + pix / iw, gx = ox0 + pix % iw;
    const bool in = gy < H && gx < W;
    cp_async4(raw + i, in ? xi + (static_cast<size_t>(gy) * W + gx) * p.c + i % p.c : xi, in);
  }
  cp_async_mbar_arrive(full);
}

// The dx-expanded, quantised window from the pixels: lane dx * c + ci of
// position (r, col) is q(x[oy0 + r][ox0 + col + dx][ci]), zero past f1 * c
// lanes and at the positions past ih x a1; 8 lanes a 16-byte store
__device__ __forceinline__ void expand_window(const FusedWgmmaPlan& p, const float* raw,
                                              unsigned char* win) {
  const int iw = p.a1 + p.f1 - 1, planes = p.kx / 8, real = p.ih * p.a1;
  for (int i = threadIdx.x; i < p.win_pos * planes; i += kConsumerThreads) {
    const int pos = i % p.win_pos, g = i / p.win_pos;
    const float* src = raw + (pos / p.a1 * iw + pos % p.a1) * p.c;
    unsigned v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float q[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ln = g * 8 + 2 * e + u;  // lane dx c + ci: pixel offset ln
        const float val = pos < real && ln < p.f1 * p.c ? src[ln] : 0.f;
        // the int8 plane's integers (ties to even, as jnp.round), exact in bf16
        q[u] = rintf(fminf(fmaxf(val, -1.f), 1.f) * 127.f);
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(q[0], q[1]);
      v[e] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(win + g * p.win_pos * 16 + pos * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// conv1 over the a1 tile: warpgroup wg's raster chunks wg, wg + 3, ... one at
// a time (as many for every warpgroup; a chunk past the last repeats it and
// is not stored): bias, ReLU, bf16 into a1's planes. (Two chunks in flight
// made ptxas serialise the products again, and ran slower.)
template <int N>
__device__ __forceinline__ void conv1(const FusedWgmmaPlan& p, int wg, int warp, int lane,
                                      const unsigned char* win, const unsigned char* w1s,
                                      const float* __restrict__ b1, unsigned char* a1) {
  const unsigned win_a = smem_addr(win), w_a = smem_addr(w1s);
  const unsigned plane = p.win_pos * 16, wk = N / 8 * 128;  // LBO of A and of B
  const int P1 = p.a1 * p.a1, ks = p.kx / 16, q = lane % 4;
  const int rounds = (p.chunks1 + kFwConsumers - 1) / kFwConsumers;
  float bias[N / 4];  // this thread's columns 8 j + 2 q, + 1
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    bias[2 * j] = __ldg(b1 + 8 * j + 2 * q);
    bias[2 * j + 1] = __ldg(b1 + 8 * j + 2 * q + 1);
  }
  for (int r = 0; r < rounds; ++r) {
    const int ch = min(wg + kFwConsumers * r, p.chunks1 - 1);
    // product j: tap dy = j / ks, lanes 16 (j % ks) on
    const auto da = [&](int j) {
      return wgmma_desc_interleave(
          win_a + 2 * (j % ks) * plane + (ch * 64 + j / ks * p.a1) * 16, plane, 128);
    };
    const auto db = [&](int j) { return wgmma_desc_interleave(w_a + 2 * j * wk, wk, 128); };
    float acc[N / 2];
    wgmma_fence();
    wgmma_kk_first<N>(acc, da(0), db(0));
    for (int j = 1; j < p.f1 * ks; ++j) wgmma_kk<N>(acc, da(j), db(j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (wg + kFwConsumers * r >= p.chunks1) continue;
    const int row = ch * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = row + 8 * h;
        if (pos < P1)
          *reinterpret_cast<unsigned*>(a1 + j * P1 * 16 + pos * 16 + q * 4) = relu_bf16x2(
              acc[4 * j + 2 * h] + bias[2 * j], acc[4 * j + 2 * h + 1] + bias[2 * j + 1]);
      }
  }
}

// conv2 over the a2 tile: warpgroup wg's patches wg, wg + 3, ... (P of them:
// a patch past the last repeats it and is not stored, so that no product
// sits behind a branch), all taps through the ring; bias, ReLU, bf16 into
// a2's planes
template <int N, int P>
__device__ __forceinline__ void conv2(const FusedWgmmaPlan& p, int wg, int warp, int lane,
                      const unsigned char* a1, const unsigned char* ring,
                      unsigned long long* full, unsigned long long* empty, Ring& r,
                      const float* __restrict__ b2, unsigned char* a2) {
  const int side = p.a2 / 8;
  const unsigned plane = p.a1 * p.a1 * 16, row = p.a1 * 16, wk = N / 8 * 128;
  const unsigned ring_a = smem_addr(ring);
  unsigned base[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int q = min(wg + kFwConsumers * i, p.patches - 1);
    base[i] = smem_addr(a1) + ((q / side) * 8 * p.a1 + q % side * 8) * 16;
  }
  float acc[P][N / 2];
  int prev = -1;
  const auto release = [&](int slot) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  };
  // tap t's products into the sums (tap 0's first ones overwrite them), then
  // one slot back to the producer once the tap before's products are done.
  // The first products are peeled, so that no path reads a sum before one
  // of them writes it: the sums are not live around the tile loop
  const auto tap = [&](int t, auto first) {
    const unsigned off = ((t / p.f2) * p.a1 + t % p.f2) * 16;
    const unsigned w_a = ring_a + r.slot * p.slice;
    const auto da = [&](int i, int k) {
      return wgmma_desc_interleave(base[i] + off + 2 * k * plane, plane, row);
    };
    const auto db = [&](int k) { return wgmma_desc_interleave(w_a + 2 * k * wk, wk, 128); };
    mbar_wait_or_trap(full + r.slot, r.phase);
    wgmma_fence();
    int k0 = 0;
    if constexpr (decltype(first)::value) {  // lanes 0-15 of tap 0, peeled
#pragma unroll
      for (int i = 0; i < P; ++i) wgmma_kk_first<N>(acc[i], da(i, 0), db(0));
      k0 = 1;
    }
    for (int k = k0; k < p.k2 / 16; ++k)
#pragma unroll
      for (int i = 0; i < P; ++i) wgmma_kk<N>(acc[i], da(i, k), db(k), 1);
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < P; ++i) fence_acc(acc[i]);
    if (prev >= 0) release(prev);
    prev = r.slot;
    r.next(p.ring);
  };
  tap(0, std::true_type{});
  for (int t = 1; t < p.f2 * p.f2; ++t) tap(t, std::false_type{});
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < P; ++i) fence_acc(acc[i]);
  release(prev);

  // D row m of a patch is its position (m / 8, m % 8): this thread's rows
  // 16 warp + lane / 4 (+ 8) are patch rows 2 warp (+ 1), column lane / 4
  const int q4 = lane % 4;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int q = wg + kFwConsumers * i;
    if (q >= p.patches) continue;
    const int pos0 = ((q / side) * 8 + 2 * warp) * p.a2 + q % side * 8 + lane / 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float c0 = __ldg(b2 + 8 * j + 2 * q4), c1 = __ldg(b2 + 8 * j + 2 * q4 + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(a2 + j * p.a2_pos * 16 + (pos0 + h * p.a2) * 16 + q4 * 4) =
            relu_bf16x2(acc[i][4 * j + 2 * h] + c0, acc[i][4 * j + 2 * h + 1] + c1);
    }
  }
}

// conv3's products over the output tile's rows taken a2 wide: warpgroup
// wg's raster chunks wg, wg + 3, ... two at a time (a chunk past the last
// repeats it and is not stored), the f3 dy taps as start offsets, the f3 dx
// taps side by side in N (column dx n3 + c): e[r][dx n3 + c] = sum over dy
// of a2[r + dy a2] . w3[dy][dx][:, c], f32
template <int N>
__device__ __forceinline__ void conv3(const FusedWgmmaPlan& p, int wg, int warp, int lane,
                                      const unsigned char* a2, const unsigned char* w3s,
                                      float* e) {
  constexpr int kAtOnce = 2;
  const unsigned plane = p.a2_pos * 16, w_a = smem_addr(w3s), wk = N / 8 * 128;
  const int ks = p.k3 / 16;
  const int rounds = (p.chunks3 + kFwConsumers - 1) / kFwConsumers;
  for (int r0 = 0; r0 < rounds; r0 += kAtOnce) {
    unsigned base[kAtOnce];
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u)
      base[u] = smem_addr(a2) + min(wg + kFwConsumers * (r0 + u), p.chunks3 - 1) * 64 * 16;
    // product j: tap dy = j / ks, lanes 16 (j % ks) on
    const auto da = [&](int u, int j) {
      return wgmma_desc_interleave(base[u] + (j / ks * p.a2 * 16) + 2 * (j % ks) * plane,
                                   plane, 128);
    };
    const auto db = [&](int j) { return wgmma_desc_interleave(w_a + 2 * j * wk, wk, 128); };
    float acc[kAtOnce][N / 2];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) wgmma_kk_first<N>(acc[u], da(u, 0), db(0));
    for (int j = 1; j < p.f3 * ks; ++j)
#pragma unroll
      for (int u = 0; u < kAtOnce; ++u) wgmma_kk<N>(acc[u], da(u, j), db(j), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      fence_acc(acc[u]);
      const int ch = wg + kFwConsumers * (r0 + u);
      if (r0 + u >= rounds || ch >= p.chunks3) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = e + (ch * 64 + warp * 16 + lane / 4 + 8 * h) * N + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(acc[u][4 * j + 2 * h], acc[u][4 * j + 2 * h + 1]);
      }
    }
  }
}

// conv3's output: y[oy0 + ty][ox0 + tx][c] = b3[c] + sum over dx of
// e[(ty a2 + tx + dx)][dx n3 + c], inside the tile and the image
__device__ __forceinline__ void conv3_sum(const FusedWgmmaPlan& p, const float* e,
                                          const float* __restrict__ b3, float* yi, int oy0,
                                          int ox0, int OH, int OW) {
  const int total = p.tile * p.tile * p.n3;
  for (int i = threadIdx.x; i < total; i += kConsumerThreads) {
    const int c = i % p.n3, o = i / p.n3, ty = o / p.tile, tx = o % p.tile;
    const int gy = oy0 + ty, gx = ox0 + tx;
    if (gy >= OH || gx >= OW) continue;
    const float* er = e + (ty * p.a2 + tx) * p.n3p + c;
    float sum = __ldg(b3 + c);
    for (int dx = 0; dx < p.f3; ++dx) sum += er[dx * (p.n3p + p.n3)];
    yi[(static_cast<size_t>(gy) * OW + gx) * p.n3 + c] = sum;
  }
}

// The tile of item i: column fastest, then row, then image
struct Tile {
  int img, oy0, ox0;
  __device__ Tile(int i, int tile, int tiles_x, int tiles_y) {
    ox0 = i % tiles_x * tile;
    i /= tiles_x;
    oy0 = i % tiles_y * tile;
    img = i / tiles_y;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    fused_wgmma_kernel(const __grid_constant__ FusedWgmmaPlan p, const float* __restrict__ x,
                       const bf16* __restrict__ w1, const float* __restrict__ b1,
                       const bf16* __restrict__ w2, const float* __restrict__ b2,
                       const bf16* __restrict__ w3, const float* __restrict__ b3,
                       float* __restrict__ y, int H, int W, int items, int tiles_x, int tiles_y) {
  extern __shared__ uint4 smem4[];
  unsigned char* const sm = reinterpret_cast<unsigned char*>(smem4);
  // window, later a2 | w1 | a1, later conv3's sums | w3 | pixels | ring | mbarriers
  unsigned char* const win = sm;
  unsigned char* const a2 = sm;
  unsigned char* const w1s = sm + p.r0;
  unsigned char* const a1 = w1s + p.w1_bytes;
  unsigned char* const w3s = a1 + p.r1;
  float* const raw = reinterpret_cast<float*>(w3s + p.w3_bytes);
  unsigned char* const ring = w3s + p.w3_bytes + p.raw_bytes;
  auto* const wbar = reinterpret_cast<unsigned long long*>(ring + p.ring * p.slice);
  auto* const raw_full = wbar + 1;
  auto* const raw_empty = wbar + 2;
  auto* const full = wbar + 3;
  auto* const empty = full + kFwMaxRing;
  const int OH = H - (p.f1 - 1) - (p.f2 - 1) - (p.f3 - 1);
  const int OW = W - (p.f1 - 1) - (p.f2 - 1) - (p.f3 - 1);
  if (threadIdx.x == 0) {
    // full when the copies have landed, empty when every consumer warp is
    // done with the pixels or the slot
    mbar_init(wbar, 1);
    mbar_init(raw_full, 32);
    mbar_init(raw_empty, kConsumerWarps);
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // The producer warpgroup's first warp: w1 and w3 once; then for each of
    // the block's tiles its pixels (all lanes) and its w2 tap slices, a
    // slot each (lane 0), so that a tile's pixels land while the tile
    // before is computed. (Issuing the next tile's pixels as soon as the
    // consumers have expanded a tile's, between two slices, hid their wait
    // but slowed conv2 more: its copies then run beside conv2's products.)
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumerThreads + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(wbar, p.w1_bytes + p.w3_bytes);
      bulk_load(w1s, w1, p.w1_bytes, wbar);
      bulk_load(w3s, w3, p.w3_bytes, wbar);
    }
    Ring r;
    for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
      const Tile t(i, p.tile, tiles_x, tiles_y);
      mbar_wait_or_trap(raw_empty, (n & 1) ^ 1);
      load_pixels(p, x + static_cast<size_t>(t.img) * H * W * p.c, H, W, t.oy0, t.ox0, raw,
                  raw_full);
      if (lane == 0)
        for (int tap = 0; tap < p.f2 * p.f2; ++tap) {
          mbar_wait_or_trap(empty + r.slot, r.phase ^ 1);
          mbar_arrive_expect_tx(full + r.slot, p.slice);
          bulk_load(ring + r.slot * p.slice, reinterpret_cast<const unsigned char*>(w2) +
                    static_cast<size_t>(tap) * p.slice, p.slice, full + r.slot);
          r.next(p.ring);
        }
      __syncwarp();
    }
    return;
  }

  // The consumers, tile after tile; the warpgroup's index is read from lane
  // 0 so that the compiler sees it warp-uniform
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int warp = threadIdx.x % kWarpgroup / 32, lane = threadIdx.x % 32;
  Ring r;
  for (int i = blockIdx.x, n = 0; i < items; i += gridDim.x, ++n) {
    const Tile t(i, p.tile, tiles_x, tiles_y);
    mbar_wait_or_trap(raw_full, n & 1);
    expand_window(p, raw, win);
    __syncwarp();
    if (lane == 0) mbar_arrive(raw_empty);  // the pixels may be refilled
    fence_proxy_async();  // the generic writes before the products read them
    consumers_sync();     // (and the tile before's conv3 sums are read)
    if (n == 0) mbar_wait_or_trap(wbar, 0);
    // lanes past a layer's padded N are the next layer's zero K padding
    if (p.n1p < p.k2) zero_planes(a1, p.a1 * p.a1, p.n1p / 8, p.k2 / 8);
    switch (p.n1p) {  // block-uniform
      case 8: conv1<8>(p, wg, warp, lane, win, w1s, b1, a1); break;
      case 16: conv1<16>(p, wg, warp, lane, win, w1s, b1, a1); break;
      case 32: conv1<32>(p, wg, warp, lane, win, w1s, b1, a1); break;
      case 64: conv1<64>(p, wg, warp, lane, win, w1s, b1, a1); break;
      default: conv1<128>(p, wg, warp, lane, win, w1s, b1, a1); break;
    }
    fence_proxy_async();
    consumers_sync();  // a1 is whole; the window is free for a2
    if (p.n2p < p.k3) zero_planes(a2, p.a2_pos, p.n2p / 8, p.k3 / 8);
    // conv2: N at most 64 (three patches of 32 sums a warpgroup at a2 =
    // 24), three patches a warpgroup at a2 = 24, six at a2 = 32
    const bool six = p.per_wg == 6;
#define FW_CONV2(N, P) conv2<N, P>(p, wg, warp, lane, a1, ring, full, empty, r, b2, a2)
    switch (p.n2p) {  // block-uniform
      case 8: six ? FW_CONV2(8, 6) : FW_CONV2(8, 3); break;
      case 16: six ? FW_CONV2(16, 6) : FW_CONV2(16, 3); break;
      case 32: six ? FW_CONV2(32, 6) : FW_CONV2(32, 3); break;
      default: FW_CONV2(64, 3); break;
    }
#undef FW_CONV2
    fence_proxy_async();
    consumers_sync();  // a2 is whole; a1 is free for conv3's sums
    // conv3: N at most 32 (f3 n3 <= 32)
    float* const e = reinterpret_cast<float*>(a1);
    switch (p.n3p) {
      case 8: conv3<8>(p, wg, warp, lane, a2, w3s, e); break;
      case 16: conv3<16>(p, wg, warp, lane, a2, w3s, e); break;
      default: conv3<32>(p, wg, warp, lane, a2, w3s, e); break;
    }
    consumers_sync();
    conv3_sum(p, e, b3, y + static_cast<size_t>(t.img) * OH * OW * p.n3, t.oy0, t.ox0, OH,
              OW);
  }
}

// One wgmma m64n32k16 of a probe: A and B images copied verbatim into
// shared memory (A at a 1024-aligned base, B 1024-aligned after it), the
// descriptors' address fields relative to those bases, d (64 x 32 f32,
// row-major) from the accumulator fragment. B MN-major (wgmma_m64n32k16_ss)
// or K-major (wgmma_kk<32>).
__global__ void __launch_bounds__(kWarpgroup)
    wgmma_desc_probe_kernel(const uint4* __restrict__ a_img, int a_vecs,
                            const uint4* __restrict__ b_img, int b_vecs,
                            unsigned long long desc_a, unsigned long long desc_b, int b_kmajor,
                            float* __restrict__ d) {
  extern __shared__ uint4 smem4[];
  uint4* const a = smem4 + (1024 - smem_addr(smem4) % 1024) % 1024 / 16;
  uint4* const b = a + (a_vecs + 63) / 64 * 64;
  for (int i = threadIdx.x; i < a_vecs; i += blockDim.x) a[i] = a_img[i];
  for (int i = threadIdx.x; i < b_vecs; i += blockDim.x) b[i] = b_img[i];
  fence_proxy_async();
  __syncthreads();
  float acc[16];
  wgmma_fence();
  const unsigned long long da = desc_a + (smem_addr(a) >> 4), db = desc_b + (smem_addr(b) >> 4);
  if (b_kmajor)
    wgmma_kk<32>(acc, da, db, 0);
  else
    wgmma_m64n32k16_ss(acc, da, db, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[(warp * 16 + lane / 4 + 8 * h) * 32 + 8 * j + 2 * (lane % 4) + e] =
            acc[4 * j + 2 * h + e];
}

}  // namespace

// x: the f32 centred plane (N, H, W, C), quantised at the window load. w1,
// w2, w3: the shared-memory images of the packed weights (entry.pack_bf16
// tiled by entry.fused_images): per tap [K / 8][N / 8][8][8] bf16, w1 with
// the 1/127 fold (f1 taps of K = kx, lane dx C + ci of tap dy holding w1[dy,
// dx, ci]), w2 f2 * f2 taps of kpad(n1) x npad(n2), w3 f3 * f3 taps of
// kpad(n2) x 8; all 16-byte aligned. Biases f32, zero-padded to npad. y: f32
// (N, H - s, W - s, n3). Refused (cudaErrorInvalidValue, nothing launched):
// a stack the plan does not take (fused_wgmma_plan.cuh), more than 65535
// images, an empty output, a misaligned weight image, or smem_bytes below
// the plan's. Returns cudaGetLastError() of the launch.
extern "C" int fused_srcnn_forward_bf16(const float* x, const void* w1, const float* b1,
                                        const void* w2, const float* b2, const void* w3,
                                        const float* b3, float* y, int N, int H, int W, int C,
                                        int f1, int n1, int f2, int n2, int f3, int n3,
                                        int smem_bytes, void* stream) {
  const auto misaligned = [](const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16; };
  const int s = (f1 - 1) + (f2 - 1) + (f3 - 1);
  const int OH = H - s, OW = W - s;
  FusedWgmmaPlan p;
  if (N <= 0 || N > 65535 || OH <= 0 || OW <= 0 ||
      fused_wgmma_plan(p, C, f1, n1, f2, n2, f3, n3) || smem_bytes < p.smem || misaligned(w1) ||
      misaligned(w2) || misaligned(w3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (OW + p.tile - 1) / p.tile, tiles_y = (OH + p.tile - 1) / p.tile;
  const long long items = static_cast<long long>(N) * tiles_y * tiles_x;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM
  fused_wgmma_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      p, x, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
      static_cast<const bf16*>(w3), b3, y, H, W, static_cast<int>(items), tiles_x, tiles_y);
  return static_cast<int>(cudaGetLastError());
}

// d (64 x 32 f32) = A (64 x 16) @ B (16 x 32) by one wgmma, A and B read by
// the descriptors desc_a and desc_b from images of a_bytes and b_bytes
// (multiples of 16) copied into shared memory: each descriptor's address
// field (bits 0-13) counts 16-byte units from its image's 1024-aligned
// base; every other field is used as given. b_kmajor: B K-major
// (wgmma_kk<32>), else MN-major (wgmma_m64n32k16_ss). For the card test of
// shifted and swizzled operand starts. Returns cudaGetLastError().
extern "C" int wgmma_desc_probe(const void* a_img, int a_bytes, const void* b_img, int b_bytes,
                                unsigned long long desc_a, unsigned long long desc_b,
                                int b_kmajor, float* d, void* stream) {
  if (a_bytes <= 0 || b_bytes <= 0 || a_bytes % 16 || b_bytes % 16 ||
      a_bytes + b_bytes > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + (a_bytes + 1023) / 1024 * 1024 + b_bytes;
  cudaError_t err = cudaFuncSetAttribute(wgmma_desc_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_desc_probe_kernel<<<1, kWarpgroup, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a_img), a_bytes / 16, static_cast<const uint4*>(b_img),
      b_bytes / 16, desc_a, desc_b, b_kmajor, d);
  return static_cast<int>(cudaGetLastError());
}
