// One SRCNN layer per launch: y = act(conv(x, w) + b), act = ReLU or none.
//
// Replaces, for stacks the 3-layer fused kernel does not take (more or
// fewer than 3 layers, c_in > 4, n_out > 4, or tiles too large for one
// block), the TPU kernel cnn_sr_tpu/ops/pallas_fused/kernel.py:
// _fused_tail_single (pl.pallas_call at kernel.py:730) and the branches it
// runs for the 7-layer RGB model (3->32->32->64->64->128->128->3, f = 3):
// the plane first layer (plane.py:plane_first_layer), the f=3 middles as
// per-dy dots (sep, kernel.py:499-544) or Winograd F(2x2,3x3) in the
// quad-parity domain (wino_kernel.py:wino_layer, quad / j-paired /
// unpaired branches), the parity-split producer store
// (wino_kernel.py:parity_entry_store), and the last layer as a masked
// all-phase reduction (mm_last, kernel.py:585-606) or the parity exit
// (wino_kernel.py:wino_mm_exit). Each of those computes a VALID f x f
// layer; this kernel computes it directly, NHWC in and NHWC out, with no
// parity layout and no Winograd transform (Winograd at k >= 64 is a later
// measurement).
//
// Two entry points: conv_layer_forward (f32, on ffma_stage.cuh) and the
// bf16 stream's conv_layer_forward_bf16 on the tensor cores (tc_stage.cuh;
// the first layer alone, its note is with its kernel below; the bf16 middle
// layers are conv_wgmma.cu's and the last conv_last_wgmma.cu's).
//
// What bounds the f32 one, by width class (ffma_plan.cuh: ChainPlan): f32
// FMAs on the CUDA cores in the middle layers (RGB L2-L6: 17.42 ms of the
// stack's 17.68 ms bound at 67 TFLOP/s, half of it in the 128 -> 128
// layer); bytes in the first and last layers (L1 3 -> 32 writes 265 MB,
// 0.086 ms; L7 128 -> 3 reads 1.06 GB, 0.32 ms), where a layer's input and
// output through device memory cost more than its FMAs.
//
// What the design does about it. A block owns a tile of output positions
// and nblk output channels; each of its threads one item (an FfmaAcc: PX
// rows of one column for NB channels, the column fastest, then the NB
// group, then the row block), so that every thread works and a warp's
// activation reads, 32 columns or 16 columns of two groups, hit distinct
// banks or one address. The plan picks the class from n (ffma_plan.cuh):
// NB = 16, PX = 4, 512 threads at n > 64 (a 16x16 tile at n = 128, 64
// sums a thread, one block an SM); NB = 8, PX = 4, 256 threads at n <= 64
// (16x16 at n = 32, 8x16 at n = 64, two blocks an SM, so that one block's
// barriers and window waits overlap the other's FMAs); NB = 4, PX = 2, 512
// threads at n <= 4 (a 32x32 tile, 512 items: the byte-bound last layer
// keeps every thread busy; one block an SM, stages of up to 32 channels).
// The input streams through shared memory kc input channels a stage: the
// chunk's window [c][x][y] (column stride ffma_col_stride, an odd channel
// stride), copied from NHWC by 4-byte cp.async with zero fill outside the
// image, channels fastest so that a warp reads whole 32-byte sectors, and
// its packed weights (entry.pack_f32 at the class's NB, 16-byte cp.async).
// Two stages alternate: chunk c + 1 lands while chunk c is computed, one
// barrier a chunk, and the accumulators stay in registers across chunks.
// So no layer is refused for its window: a stage needs one channel's
// window and weights, and a layer of a wide f takes fewer NB groups a
// block (N over more blocks) until it has them. Stores: NHWC, 16 bytes a store where n % 4 == 0.
//
// Measured (chip_smoke.py [time], [layers]; NVIDIA H100 80GB HBM3, 700 W):
// the RGB stack at 1080p in 31.67 ms, against 63.28 on the per-tap stage
// this replaces, cuDNN f32's 44.1 and the 17.68 ms bound; per layer L1-L7
// 0.232, 1.149, 2.159, 4.012, 7.744, 15.112, 1.261 ms (L2-L6 at 49-59% of
// the FMA peak, L7 at 4x its byte bound). The flagship as three launches
// takes 6.62 ms, against the fused kernel's 9.69. ops/fused/tune.py times
// other shapes a class: two blocks an SM at n <= 4, one at n <= 64, NB =
// 16 at n <= 64, 256 threads at n > 64 and NB = 8 at n = 128 ran 0.5-5%
// slower over each class's RGB layers summed (NB = 16 was ahead at L1
// and L3 alone). A window read 16 bytes (4 channels) at a time and staged
// in registers across the previous chunk's FMAs ran 1-11% slower than
// the 4-byte cp.async, in every class, and is not kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ffma_stage.cuh"
#include "tc_stage.cuh"

namespace {

// One f32 layer: x (N, H, W, K) NHWC, w packed (K, f * f, npad), b (npad),
// y (N, H - f + 1, W - f + 1, n). blockIdx.x = tile column x N split, .y =
// tile row, .z = image; blockDim.x = the plan's items; p: the layer's
// ChainPlan (ffma_plan.cuh), passed by value.
template <int NB, int PX, int F, int THREADS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    conv_layer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ y, int H, int W, int K,
                      int f_rt, int n, int relu, ChainPlan p) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int f = F > 0 ? F : f_rt;
  const int taps = f * f;
  const int OH = H - f + 1, OW = W - f + 1;
  const int nbase = (blockIdx.x % p.nsplit) * p.nblk;
  const int oy0 = blockIdx.y * p.tile_h, ox0 = (blockIdx.x / p.nsplit) * p.tile_w;
  const size_t img = blockIdx.z;
  const float* const xi = x + img * H * W * K;
  const int t = threadIdx.x;
  const int xc = t % p.tile_w;
  const int n0 = (t / p.tile_w) % p.gb * NB;
  const int row0 = t / (p.tile_w * p.gb) * PX;
  const int per_ch = taps * p.nblk;
  const int wfloats = p.kc * per_ch;  // a stage: [weights | window]

  // chunk c's packed weights into the stage at st: cn * taps rows of the
  // block's nblk columns, 16 bytes a cp.async (not committed)
  auto load_weights = [&](int c, float* st) {
    const int c0 = c * p.kc, cn = min(p.kc, K - c0);
    const int q = p.nblk / 4, pieces = cn * taps * q;
    const float* ws = w + static_cast<size_t>(c0) * taps * p.npad + nbase;
    if (p.nblk == p.npad) {
      for (int i = t; i < pieces; i += blockDim.x) cp_async16(st + 4 * i, ws + 4 * i, true);
    } else {
      for (int i = t; i < pieces; i += blockDim.x) {
        const int r = i / q, j = i - r * q;
        cp_async16(st + r * p.nblk + 4 * j, ws + static_cast<size_t>(r) * p.npad + 4 * j, true);
      }
    }
  };
  // chunk c into the stage at st, weights and window by cp.async, the
  // window an element (cc, wx, wy) a copy, channel fastest, stepped by
  // blockDim.x without a division per element
  auto load = [&](int c, float* st) {
    load_weights(c, st);
    const int c0 = c * p.kc, cn = min(p.kc, K - c0);
    float* const win = st + wfloats;
    const int T = blockDim.x;
    int cc = t % cn, pos = t / cn;
    const int dcc = T % cn, dpos = T / cn;
    int wy = pos / p.iw, wx = pos - wy * p.iw;
    const int dwy = dpos / p.iw, dwx = dpos - dwy * p.iw;
    while (wy < p.ih) {
      const int gy = oy0 + wy, gx = ox0 + wx;
      const bool valid = gy < H && gx < W;
      cp_async4(win + cc * p.plane + wx * p.cs + wy,
                valid ? xi + (static_cast<size_t>(gy) * W + gx) * K + c0 + cc : xi, valid);
      cc += dcc;
      wx += dwx;
      wy += dwy;
      if (cc >= cn) {
        cc -= cn;
        ++wx;
      }
      if (wx >= p.iw) {
        wx -= p.iw;
        ++wy;
      }
    }
    cp_async_commit();
  };

  FfmaAcc<NB, PX, F> acc;
  acc.begin(b + nbase + n0);
  const int chunks = (K + p.kc - 1) / p.kc;
  const int col0 = xc * p.cs + row0;
  auto compute = [&](int c, const float* st) {
    acc.accumulate(st + wfloats + col0, p.plane, p.cs, st + n0, per_ch, p.nblk, f,
                   min(p.kc, K - c * p.kc));
  };
  load(0, smem);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed, and every thread is done with chunk c - 1
    if (c + 1 < chunks) load(c + 1, smem + ((c + 1) & 1) * p.stage_floats);
    compute(c, smem + (c & 1) * p.stage_floats);
  }

  float* const yi = y + img * OH * OW * n;
  const int nc = nbase + n0;
#define CHAIN_STORE(RELU, VEC)                                                                 \
  ffma_store<NB, PX, F, RELU, true, VEC>(acc, yi, 0, 0, n, nc, xc, row0, p.tile_h, oy0, ox0, OH, \
                                         OW)
  if (n % 4 == 0) {
    if (relu) CHAIN_STORE(true, true);
    else CHAIN_STORE(false, true);
  } else {
    if (relu) CHAIN_STORE(true, false);
    else CHAIN_STORE(false, false);
  }
#undef CHAIN_STORE
}

template <int NB, int PX, int THREADS, int BLOCKS, int F>
int launch_f32(const float* x, const float* w, const float* b, float* y, int N, int H, int W,
               int K, int f, int n, int relu, const ChainPlan& pl, int smem_bytes,
               cudaStream_t s) {
  auto kernel = conv_layer_kernel<NB, PX, F, THREADS, BLOCKS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = H - f + 1, OW = W - f + 1;
  const dim3 grid((OW + pl.tile_w - 1) / pl.tile_w * pl.nsplit, (OH + pl.tile_h - 1) / pl.tile_h,
                  N);
  kernel<<<grid, pl.items, smem_bytes, s>>>(x, w, b, y, H, W, K, f, n, relu, pl);
  return static_cast<int>(cudaGetLastError());
}

// one width class: f unrolled where it is one of the shipped configs' (1,
// 3, 5, 9), else in a runtime loop
template <int NB, int PX, int THREADS, int BLOCKS>
int launch_class(const float* x, const float* w, const float* b, float* y, int N, int H, int W,
                 int K, int f, int n, int relu, const ChainPlan& pl, int smem_bytes,
                 cudaStream_t s) {
#define LAUNCH_F(F) \
  launch_f32<NB, PX, THREADS, BLOCKS, F>(x, w, b, y, N, H, W, K, f, n, relu, pl, smem_bytes, s)
  switch (f) {
    case 1: return LAUNCH_F(1);
    case 3: return LAUNCH_F(3);
    case 5: return LAUNCH_F(5);
    case 9: return LAUNCH_F(9);
    default: return LAUNCH_F(0);
  }
#undef LAUNCH_F
}

}  // namespace

// Launches one f32 layer on `stream` and returns cudaGetLastError(). w and
// b: packed by ops/fused/entry.py:pack_f32 at the layer's class NB (w (K, f
// * f, npad), b (npad,), zero-padded); y: (N, H - f + 1, W - f + 1, n),
// 16-byte aligned; ReLU where relu != 0. tile_h, tile_w and kc: the
// layer's ChainPlan (ffma_plan.cuh, as entry.layer_plan computes it); kc
// may be any count of input channels a stage from 1 to K. Refused
// (cudaErrorInvalidValue, nothing launched): a malformed shape, a layer
// the plan finds no stage for, a tile the plan does not describe, or
// smem_bytes below what kc needs.
extern "C" int conv_layer_forward(const float* x, const float* w, const float* b, float* y,
                                  int N, int H, int W, int K, int f, int n, int relu,
                                  int tile_h, int tile_w, int kc, int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || N > 65535 || f <= 0 || H < f || W < f || K <= 0 || n <= 0) return bad;
  ChainPlan pl(f, K, n);
  if (pl.kc == 0 || tile_h != pl.tile_h || tile_w != pl.tile_w || kc < 1 || kc > K ||
      (H - f + pl.tile_h) / pl.tile_h > 65535)
    return bad;
  pl.set_kc(f, K, kc);
  if (smem_bytes < pl.smem) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
#define LAUNCH_CLASS(C)                                                                        \
  launch_class<C[0], C[1], C[2], C[3]>(x, w, b, y, N, H, W, K, f, n, relu, pl, smem_bytes, s)
  if (n <= 4) return LAUNCH_CLASS(kChainNarrow);
  if (n <= 64) return LAUNCH_CLASS(kChainMid);
  return LAUNCH_CLASS(kChainWide);
#undef LAUNCH_CLASS
}


// The first layer of the bf16 stream on the tensor cores: replaces the same
// TPU kernel as run by cnn_sr_tpu/ops/pallas_fused/entry.py:32 fused_forward
// with dtype=bf16, input_int8=True (the JAX default under use_pallas) for
// the stacks the fused kernel does not take, the 7-layer RGB model first:
// the int8 plane of weights.py:123 _quantize_planes with the 1/127 scale
// folded into w1 (weights.py:283, entry.py:326), bf16 operands, f32 sums.
// Every middle layer is conv_wgmma.cu's (conv_layer_forward_wgmma) and the
// last conv_last_wgmma.cu's (conv_last_forward_wgmma).
//
// What bounds it: its bytes (RGB L1, K = 16 dx-expanded lanes), the f32
// input read and quantised by the threads as they load it, and the bf16
// output written.
//
// What the design does: one block per 16x16 output tile and 128-column
// chunk of N (blockIdx.x = tile column x N chunks, .y = tile row, .z =
// image), one tc_stage (tc_stage.cuh): the window with its (f - 1) halo
// rows, dx-expanded and quantised from the f32 input by the threads; the
// packed weights streamed tps taps (dy rows) at a time through two cp.async
// stages; mma.sync m16n8k16 with every tap an address offset into the
// window. Warps (ChainCfg): 8 x 2 at N = 128 (each 2 m16 by 8 n8 tiles), 4
// x 2 at N = 64 (4 m16 by 4 n8), 8 x 1 below (2 m16 by N / 8). Epilogue:
// bias, ReLU and one bf16 rounding staged in shared memory and written in
// 16-byte pieces.
// Why not wgmma: the window is quantised by the threads that load it, so no
// tensor copy lands it (ROADMAP Queue 2 #1s).
//
// Measured (chip_smoke.py [layers], 1080p, NVIDIA H100 80GB HBM3, 700 W):
// RGB L1 0.257 ms (cuDNN bf16 0.536), of the bf16 chain's 2.11-2.15 ms.
namespace {

// a 16x16 tile a block: 16 warps of 2 m16 by 8 n8 tiles at N = 128 (one
// block an SM: its window and weights take most of the shared memory), 8
// warps of 4 m16 at N = 64 and of 2 m16 below (two or more blocks an SM)
template <int NB>
using ChainCfg = TcCfg<NB, NB == 128 ? 2 : NB == 64 ? 4 : 2, NB == 128 ? 16 : 8>;

template <int NB>
__global__ void __launch_bounds__(ChainCfg<NB>::THREADS)
    conv_layer_tc_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                         const float* __restrict__ b, bf16* __restrict__ y, int H, int W, int K,
                         int f, int n, int kp, int npad, int tps) {
  using C = ChainCfg<NB>;
  static_assert(C::PB == kTile * kTile, "a pass covers the 16x16 tile");
  extern __shared__ float4 smem4[];
  bf16* const sm = reinterpret_cast<bf16*>(smem4);
  const int OH = H - f + 1, OW = W - f + 1;
  const int chunks = npad / NB;
  const int n0 = (blockIdx.x % chunks) * NB;
  const int oy0 = blockIdx.y * kTile, ox0 = (blockIdx.x / chunks) * kTile;
  const size_t img = blockIdx.z;
  const int rows = kTile + f - 1;
  const int as = kp + 8;
  bf16* const win = sm;
  bf16* const wbuf = sm + rows * kTile * as;

  TcAcc<C> acc;
  acc.begin(0, C::PB, kTile, kTile);
  auto load_win = [&] {
    load_first_window(x + img * H * W * K, H, W, K, oy0, ox0, rows, kTile, f, kp, as, win);
  };
  tc_stream<C>(acc, load_win, win, as, kTile, 1, f, tps, w, kp, npad, n0, wbuf);
  tc_store_bf16<C>(acc, kTile, b + n0, sm, y + img * OH * OW * n, oy0, ox0, OH, OW, n, n0);
}

// shared bytes of the layer, as ops/fused/entry.py: tc_layer_plan computes them
int tc_layer_smem(int f, int kp, int nb, int tps) {
  const int rows = kTile + f - 1;
  const int stages = (f + tps - 1) / tps > 1 ? 2 : 1;
  const int pipe = rows * kTile * (kp + 8) + stages * tps * kp * tc_ws(nb);
  const int out = kTile * kTile * tc_ws(nb);
  return 2 * (pipe > out ? pipe : out);
}

template <int NB>
int launch_tc(const float* x, const bf16* w, const float* b, bf16* y, int N, int H, int W, int K,
              int f, int n, int kp, int npad, int tps, int smem_bytes, cudaStream_t s) {
  auto kernel = conv_layer_tc_kernel<NB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = H - f + 1, OW = W - f + 1;
  const dim3 grid((OW + kTile - 1) / kTile * (npad / NB), (OH + kTile - 1) / kTile, N);
  kernel<<<grid, ChainCfg<NB>::THREADS, smem_bytes, s>>>(x, w, b, y, H, W, K, f, n, kp, npad,
                                                          tps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x is the f32 centred input (N, H, W, K), quantised at the window load,
// and w the folded first-layer weights packed (f, kx, npad) with lane dx K
// + ci of tap dy holding w1[dy, dx, ci] / 127 (entry.pack_bf16, first);
// b: f32, npad values, zero past n; y: bf16 (N, H - f + 1, W - f + 1, n)
// after ReLU (n % 8 == 0). tps: taps (dy rows) a weight stage. Refused
// (cudaErrorInvalidValue, nothing launched): a shape the packing or the
// plan does not describe, or smem_bytes below what the plan needs. Returns
// cudaGetLastError() of the launch.
extern "C" int conv_layer_forward_bf16(const void* x, const void* w, const float* b, void* y,
                                       int N, int H, int W, int K, int f, int n, int tps,
                                       int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || N > 65535 || f <= 0 || H < f || W < f || K <= 0 || n <= 0 || n % 8) return bad;
  const int kp = tc_kx(f, K);
  const int npad = tc_npad(n);
  if (tps < 1 || tps > f || smem_bytes < tc_layer_smem(f, kp, tc_nb(npad), tps)) return bad;
  const auto xs = static_cast<const float*>(x);
  const auto ws = static_cast<const bf16*>(w);
  const auto ys = static_cast<bf16*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
#define LAUNCH_TC(NB) launch_tc<NB>(xs, ws, b, ys, N, H, W, K, f, n, kp, npad, tps, smem_bytes, s)
  switch (tc_nb(npad)) {
    case 8:
      return LAUNCH_TC(8);
    case 16:
      return LAUNCH_TC(16);
    case 32:
      return LAUNCH_TC(32);
    case 64:
      return LAUNCH_TC(64);
    default:
      return LAUNCH_TC(128);
  }
#undef LAUNCH_TC
}
