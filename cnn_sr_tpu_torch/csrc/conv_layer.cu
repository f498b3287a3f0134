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
// parity layout and no Winograd transform (whether Winograd pays on this
// card is a later measurement).
//
// Two entry points: conv_layer_forward (f32, this header) and the bf16
// stream's conv_layer_forward_bf16 on the tensor cores (tc_stage.cuh; its
// note is with its kernel below).
//
// What bounds the f32 one: f32 FMAs on the CUDA cores. The RGB model does 290,016
// MACs per output pixel, half of them in the 128 -> 128 layer; moving every
// layer's input and output through device memory costs far less than the
// FMAs (about 7.4 GB against 1.19 TFLOP per 1080p frame).
//
// Why one layer per launch and not the whole stack, as on the TPU: the TPU
// kernel keeps all seven layers' tiles in VMEM; a block here has 227 KB of
// shared memory, and a 16x16 output tile of a k=128 layer needs 165,888
// bytes for its input window alone, while the stack's halo is 7 px per
// side. A fused 7-layer tile would not fit, or would spend most of its
// FMAs on halo recompute. Fusing pairs of layers is later work.
//
// What the design does: one block per output tile of one image
// (blockIdx.x/y = tile column/row, blockIdx.z = image) loads the tile's
// input window, tile + (f - 1), for all k channels into shared memory,
// channel-major, zero outside the image; conv_stage (conv_stage.cuh) then
// streams the weights through the rest of shared memory a chunk of input
// channels at a time, so that the FMA loop reads only shared memory, and
// stores the ragged-masked result NHWC. The wrapper
// (ops/fused/chain.py) plans the window and the chunk per layer and
// launches once per layer on the current stream.
// Each thread computes 4 output rows of one column for NB output channels.
// NB = 16 where the layer still has an item for each of the 512 threads
// (n >= 128 at a 16x16 tile): every activation read then feeds 16 FMAs,
// and the weights stream through shared memory once per block instead of
// once per round of items. With NB = 8 there, the 128 -> 128 layer took
// 38.9 ms at 1080p, with NB = 16 29.7 ms, and the RGB stack 84.9 against
// 70.9 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_stage.cuh"
#include "tc_stage.cuh"

namespace {

constexpr int kThreads = 512;

template <int NB, int PX, bool VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    conv_layer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ y, int H, int W, int K,
                      int f, int n, int tile_h, int tile_w, int wbuf_elems) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int OH = H - f + 1, OW = W - f + 1;
  const int oy0 = blockIdx.y * tile_h;
  const int ox0 = blockIdx.x * tile_w;
  const size_t img = blockIdx.z;
  const int ih = tile_h + f - 1, iw = tile_w + f - 1;
  // [weight chunk | input window]; the chunk comes first so that its
  // 16-byte reads are aligned
  float* wbuf = smem;
  float* s_in = wbuf + wbuf_elems;

  // input window, NHWC global -> channel-major shared; zero outside the image
  const float* xi = x + img * H * W * K;
  const int total = ih * iw * K;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % K;
    const int p = i / K;
    const int gy = oy0 + p / iw, gx = ox0 + p % iw;
    s_in[c * ih * iw + p] =
        (gy < H && gx < W) ? __ldg(xi + (static_cast<size_t>(gy) * W + gx) * K + c) : 0.f;
  }
  // (the first chunk load in conv_stage synchronises before any read)
  conv_stage<NB, PX, VEC, RELU, true>(s_in, K, ih, iw, w, b, f, n, wbuf, wbuf_elems,
                                      y + img * OH * OW * n, tile_h, tile_w, oy0, ox0, OH, OW);
}

template <int NB, int PX, bool VEC, bool RELU>
int launch(const float* x, const float* w, const float* b, float* y, int N, int H, int W, int K,
           int f, int n, int tile_h, int tile_w, int wbuf_elems, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = conv_layer_kernel<NB, PX, VEC, RELU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = H - f + 1, OW = W - f + 1;
  const dim3 grid((OW + tile_w - 1) / tile_w, (OH + tile_h - 1) / tile_h, N);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(x, w, b, y, H, W, K, f, n, tile_h, tile_w,
                                                 wbuf_elems);
  return static_cast<int>(cudaGetLastError());
}

// 16 channels x 4 rows per thread where that still gives every thread an
// item (n >= 128 at a 16x16 tile), 8 x 4 where the width is a multiple of
// 8, both with 16-byte weight reads and stores; 4 channels x 1 row
// otherwise (narrow last layers)
template <bool RELU>
int launch_by_width(const float* x, const float* w, const float* b, float* y, int N, int H,
                    int W, int K, int f, int n, int tile_h, int tile_w, int wbuf_elems,
                    int smem_bytes, cudaStream_t s) {
  if (n % 16 == 0 && (n / 16) * ((tile_h + 3) / 4) * tile_w >= kThreads)
    return launch<16, 4, true, RELU>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w, wbuf_elems,
                                     smem_bytes, s);
  if (n % 8 == 0)
    return launch<8, 4, true, RELU>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w, wbuf_elems,
                                    smem_bytes, s);
  return launch<4, 1, false, RELU>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w, wbuf_elems,
                                   smem_bytes, s);
}

}  // namespace

// Launches one f32 layer on `stream` and returns cudaGetLastError(). The
// caller checks the shapes, plans the shared memory (input window plus a
// weight chunk of wbuf_floats, smem_bytes in all, within the per-block
// limit) and allocates y (N, H - f + 1, W - f + 1, n).
extern "C" int conv_layer_forward(const float* x, const float* w, const float* b, float* y,
                                  int N, int H, int W, int K, int f, int n, int relu,
                                  int tile_h, int tile_w, int wbuf_floats, int smem_bytes,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return relu ? launch_by_width<true>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w, wbuf_floats,
                                      smem_bytes, s)
              : launch_by_width<false>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w, wbuf_floats,
                                       smem_bytes, s);
}


// One layer of the bf16 stream on the tensor cores: replaces the same TPU
// kernel as run by cnn_sr_tpu/ops/pallas_fused/entry.py:32 fused_forward
// with dtype=bf16, input_int8=True (the JAX default under use_pallas) for
// the stacks the fused kernel does not take, the 7-layer RGB model first:
// the int8 plane of weights.py:123 _quantize_planes with the 1/127 scale
// folded into w1 (weights.py:283, entry.py:326), bf16 operands, f32 sums.
//
// What bounds it: the multiply-adds (592.4 G MAC per RGB 1080p frame, half
// of them in the 128 -> 128 layer) at mma.sync's rate; the 128 -> 3 last
// layer by its bytes. Each block reads every weight of its layer once from
// L2, so the 16x16 tile (256 positions) keeps that traffic below the
// window's.
//
// What the design does: one block per 16x16 output tile and
// 128-column chunk of N (blockIdx.x = tile column x N chunks, .y = tile
// row, .z = image), one tc_stage (tc_stage.cuh): the window with its
// (f - 1) halo, position-major, for a chunk of kc input lanes (all of K
// where it fits), filled by cp.async (the first layer: dx-expanded and
// quantised from the f32 input); the packed weights streamed tps taps at a
// time through two cp.async stages; mma.sync m16n8k16 with every tap an
// address offset into the window. Warps (ChainCfg): 8 x 2 at N = 128
// (each 2 m16 by 8 n8 tiles), 4 x 2 at N = 64 (4 m16 by 4 n8), 8 x 1 below
// (2 m16 by N / 8). Epilogue: bias,
// ReLU and one bf16 rounding staged in shared memory and written in
// 16-byte pieces; the last layer writes f32 and no ReLU.
// Why mma.sync over a shifted window and not wgmma: every tap is a row
// offset into one window, which ldmatrix's per-lane row addresses take as
// is; a wgmma shared-memory descriptor needs the canonical 8x8 core-matrix
// layout, which a shift by one position breaks, so wgmma would need a copy
// of the window per dx.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the RGB stack at
// 1080p in 6.12 ms, against 64.23 on the CUDA cores and cuDNN bf16's 6.98
// (bound 1.198); per layer L1-L7 0.32, 0.27, 0.45, 0.72, 1.55, 2.43, 0.45
// ms. L5 and L6 (N = 128) trail cuDNN (1.24, 1.56 ms): one block an SM,
// and with 2 m16 tiles a warp every B fragment feeds only two mma.sync,
// so the ldmatrix traffic nears the shared-memory rate (ROADMAP Queue 2
// #1: wgmma reads B from shared memory without it).
namespace {

// a 16x16 tile a block: 16 warps of 2 m16 by 8 n8 tiles at N = 128 (one
// block an SM: its window and weights take most of the shared memory), 8
// warps of 4 m16 at N = 64 and of 2 m16 below (two or more blocks an SM)
template <int NB>
using ChainCfg = TcCfg<NB, NB == 128 ? 2 : NB == 64 ? 4 : 2, NB == 128 ? 16 : 8>;

template <int NB, int MODE>  // MODE 0: first layer, 1: middle, 2: last
__global__ void __launch_bounds__(ChainCfg<NB>::THREADS)
    conv_layer_tc_kernel(const void* __restrict__ xv, const bf16* __restrict__ w,
                         const float* __restrict__ b, void* __restrict__ yv, int H, int W, int K,
                         int f, int n, int kp, int npad, int kc, int tps) {
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
  const int ww = MODE == 0 ? kTile : rows;  // the window's positions a row
  const int as = kc + 8;
  bf16* const win = sm;
  bf16* const wbuf = sm + rows * ww * as;

  TcAcc<C> acc;
  acc.begin(0, C::PB, kTile, ww);
  auto load_win = [&](int c0, int kcc) {
    if constexpr (MODE == 0)
      load_first_window(static_cast<const float*>(xv) + img * H * W * K, H, W, K, oy0, ox0, rows,
                        kTile, f, kp, as, win);
    else
      load_window_async(static_cast<const bf16*>(xv) + img * H * W * K, H, W, K, oy0, ox0, rows,
                        ww, c0, kcc, as, win);
  };
  tc_stream<C>(acc, load_win, kp, kc, win, as, ww, MODE == 0 ? 1 : f, MODE == 0 ? f : f * f, tps,
               w, npad, n0, wbuf);
  if constexpr (MODE == 2)
    tc_store_f32<C>(acc, 0, C::PB, kTile, b, static_cast<float*>(yv) + img * OH * OW * n, oy0,
                    ox0, OH, OW, n);
  else
    tc_store_bf16<C>(acc, kTile, b + n0, sm, static_cast<bf16*>(yv) + img * OH * OW * n, oy0,
                     ox0, OH, OW, n, n0);
}

// shared bytes of the layer, as ops/fused/entry.py: tc_layer_plan computes them
int tc_layer_smem(int f, int kp, int nb, int first, int last, int kc, int tps) {
  const int rows = kTile + f - 1, ww = first ? kTile : rows;
  const int taps = first ? f : f * f;
  const int stages = (taps + tps - 1) / tps > 1 ? 2 : 1;
  const int pipe = rows * ww * (kc + 8) + stages * tps * kc * tc_ws(nb);
  const int out = last ? 0 : kTile * kTile * tc_ws(nb);
  return 2 * (pipe > out ? pipe : out);
}

template <int NB, int MODE>
int launch_tc(const void* x, const void* w, const float* b, void* y, int N, int H, int W, int K,
              int f, int n, int kp, int npad, int kc, int tps, int smem_bytes, cudaStream_t s) {
  auto kernel = conv_layer_tc_kernel<NB, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = H - f + 1, OW = W - f + 1;
  const dim3 grid((OW + kTile - 1) / kTile * (npad / NB), (OH + kTile - 1) / kTile, N);
  kernel<<<grid, ChainCfg<NB>::THREADS, smem_bytes, s>>>(x, static_cast<const bf16*>(w), b, y, H, W, K, f, n,
                                              kp, npad, kc, tps);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_tc_by_width(const void* x, const void* w, const float* b, void* y, int N, int H, int W,
                       int K, int f, int n, int kp, int npad, int kc, int tps, int smem_bytes,
                       cudaStream_t s) {
  switch (tc_nb(npad)) {
    case 8:
      return launch_tc<8, MODE>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
    case 16:
      return launch_tc<16, MODE>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
    case 32:
      return launch_tc<32, MODE>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
    case 64:
      return launch_tc<64, MODE>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
    default:
      return launch_tc<128, MODE>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
  }
}

}  // namespace

// first != 0: x is the f32 centred input (N, H, W, K), quantised at the
// window load, and w the folded first-layer weights packed (f, kx, npad)
// with lane dx K + ci of tap dy holding w1[dy, dx, ci] / 127; else x is the
// previous layer's bf16 output and w packed (f * f, kpad(K), npad). b: f32,
// npad values, zero past n. last != 0: y is f32 (N, H - f + 1, W - f + 1, n)
// and no ReLU; else y is bf16 after ReLU (n % 8 == 0). kc: window lanes a
// chunk (a multiple of 16; all of them for the first layer); tps: taps a
// weight stage. Refused (cudaErrorInvalidValue, nothing launched): a shape
// the packing or the plan does not describe, or smem_bytes below what the
// plan needs. Returns cudaGetLastError() of the launch.
extern "C" int conv_layer_forward_bf16(const void* x, const void* w, const float* b, void* y,
                                       int N, int H, int W, int K, int f, int n, int first,
                                       int last, int kc, int tps, int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || N > 65535 || f <= 0 || H < f || W < f || K <= 0 || n <= 0 || (first && last))
    return bad;  // the stream has at least 3 layers, so no layer is both
  const int kp = first ? tc_kx(f, K) : tc_kpad(K);
  const int npad = tc_npad(n);
  const int taps = first ? f : f * f;
  if ((!first && K % 8) || (!last && n % 8) || (last && npad != 8) || kc < 16 || kc % 16 ||
      kc > kp || (first && kc != kp) || tps < 1 || tps > taps ||
      smem_bytes < tc_layer_smem(f, kp, tc_nb(npad), first, last, kc, tps))
    return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  if (first)
    return launch_tc_by_width<0>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
  if (last)
    return launch_tc<8, 2>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
  return launch_tc_by_width<1>(x, w, b, y, N, H, W, K, f, n, kp, npad, kc, tps, smem_bytes, s);
}
