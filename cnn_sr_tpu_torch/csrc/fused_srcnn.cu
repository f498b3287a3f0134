// Fused 3-layer SRCNN forward: y = conv3(relu(conv2(relu(conv1(x) + b1)) + b2)) + b3
//
// Replaces the TPU kernel cnn_sr_tpu/ops/pallas_fused/kernel.py:_fused_tail_single
// (the one pl.pallas_call, kernel.py:730) and the branches it runs for a
// 3-layer luma stack: conv1 from the raw plane (plane.py:plane_first_layer)
// or as a 1x1 matmul over im2col patches (kernel.py:463-497, also the f==1
// middle of 9-1-5); conv2 as the quad-parity direct conv
// (wino_kernel.py:wino_layer, quad branch) or the all-phase Z middle
// (kernel.py:546-667); conv3 as the parity exit (wino_kernel.py:wino_mm_exit
// with _xt_extract and the parity recombine) or the packed-dx FMA loop
// (kernel.py:672-718). On this card those TPU layouts (parity planes, lane
// rolls, identity-dot transposes) have no purpose: what is kept is the
// math and what the TPU kernel keeps out of device memory.
//
// All three convolutions are VALID stride-1 cross-correlations over NHWC
// activations with HWIO (f, f, k, n) weights; the output is
// (N, H - s, W - s, n_out) with s = (f1 - 1) + (f2 - 1) + (f3 - 1).
//
// What bounds the f32 version (fused_srcnn_forward; the bf16 stream's
// fused_srcnn_forward_bf16 on the tensor cores is described with its entry
// point below): f32 FMAs on the CUDA cores. The flagship 9-5-5 (n1 = 64,
// n2 = 32) needs 57,184 MACs per output pixel, 51,200 of them in conv2:
// 116.6 G MAC a 1080p frame, 3.48 ms at the 67 TFLOP/s f32 peak. A 16x16
// output tile recomputes its halo (conv1 over 24x24 positions, 2.25x;
// conv2 over 20x20, 1.5625x), so the kernel executes about 92,500 MACs per
// output pixel: 188.7 G MAC over a 1080p frame's 7,973 tiles, a 5.6 ms
// floor at this tile (5.8 with conv3's n3 = 1 padded to NB = 4). Its bytes
// (the f32 plane in and out) take 0.005 ms.
//
// What the design does about it:
// * One thread block owns one 16x16 output tile of one image (blockIdx.x/y
//   = tile column/row, blockIdx.z = image). Dynamic shared memory holds the
//   input window with its s-pixel halo, the conv1 tile and the conv2 tile,
//   each [c][x][y] with an odd column stride, so only the output is
//   written to device memory; the flagship's tiles take 4,224 + 153,600 +
//   53,760 = 211,584 bytes, one block per SM. The rest (20,864 bytes)
//   carries the weights.
// * Each layer is an ffma_stage (ffma_stage.cuh): a thread owns PX rows of
//   one column for NB output channels, keeps its input column (PX + f - 1
//   values, read at fixed offsets from one address) in registers across
//   the f dy taps, and reads each weight vector once, as a warp-uniform
//   16-byte broadcast, for PX FMAs; the taps unroll for f in {1, 3, 5, 9}.
//   640 threads (20 warps, 5 on each SM sub-partition). conv2 at the
//   flagship's 20x20x32 tile: PX = 5, NB = 4, so 8 channel groups x 4 row
//   blocks x 20 columns = 640 items, one a thread, none idle; 100 FFMAs per
//   14 shared loads (9 activations, 5 weight float4s) per input channel and
//   dx, against 32 per 6 in the per-tap loop it replaced.
//   conv1 (24x24x64: PX = 4, NB = 8) takes 1,152 items in two passes (90%
//   of the slots); conv3 (16x16, n3 <= 4: PX = 2, NB = 4) 128. Shapes with
//   more FFMAs a load but fewer warps measured slower
//   (ops/fused/tune.py; PERF.md).
// * Weights are packed once per parameter set (ops/fused/entry.py:
//   pack_f32): channel-major (k, f * f, npad) with npad = n rounded up to NB
//   and zero bias lanes, so a chunk of input channels is one contiguous
//   16-byte-aligned copy. conv2's weights (204,800 bytes) stream through two
//   cp.async stages of 3 input channels: chunk c + 1 lands while chunk c is
//   computed. conv1's and conv3's stay resident.
// * Ragged right and bottom edges: input outside the image reads as 0,
//   and only in-image outputs are stored.
//
// Measured (chip_smoke.py [time], NVIDIA H100 80GB HBM3, 700 W): the
// flagship at 1080p in 9.65 ms, against 20.28 for the per-tap stage it
// replaced, cuDNN f32's 13.42 and the 3.48 ms bound: 58% of
// the FMA peak on the MACs executed at this tile. 9-1-5 in 2.12 ms (was
// 4.93; cuDNN f32 7.19). The same flagship stack as the chain's three f32
// launches (conv_layer.cu on the same stage, no halo recompute) takes 6.62
// ms, so in f32 too the chain now beats fusion (ROADMAP Queue 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ffma_stage.cuh"
#include "tc_stage.cuh"

namespace {

constexpr int kThreads = 640;
// (NB, PX) of each layer, as ops/fused/entry.py:FUSED_SHAPE (which pads
// the weights to the same NBs and sizes the tiles for the same PXs)
constexpr int kNB1 = 8, kPX1 = 4;
constexpr int kNB2 = 4, kPX2 = 5;
constexpr int kNB3 = 4, kPX3 = 2;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// one layer on ffma_stage, its f unrolled where it is one of the shipped
// configs' (1, 3, 5, 9), else in a runtime loop
template <int NB, int PX, bool RELU, bool TO_GLOBAL>
__device__ __forceinline__ void ffma_layer(const float* in, int k, int ih, int is,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int f, int n,
                                           float* wbuf, int wbuf_floats, float* out, int os,
                                           int gy0, int gx0, int gh, int gw) {
  const int npad = round_up(n, NB);
#define FFMA_STAGE(F)                                                                        \
  ffma_stage<NB, PX, F, RELU, TO_GLOBAL>(in, k, ih, ih, is, w, b, f, n, npad, wbuf,          \
                                         wbuf_floats, out, os, gy0, gx0, gh, gw)
  switch (f) {  // block-uniform
    case 1: FFMA_STAGE(1); break;
    case 3: FFMA_STAGE(3); break;
    case 5: FFMA_STAGE(5); break;
    case 9: FFMA_STAGE(9); break;
    default: FFMA_STAGE(0); break;
  }
#undef FFMA_STAGE
}

// the block's shared memory in floats: [weights | input window | conv1
// tile | conv2 tile], each tile [c][x][y] with the column stride its
// reader needs, as ops/fused/entry.py:tile_bytes and smem_plan
struct F32Layout {
  int a2, a1, ih, s_in, s1, s2, in_floats, a1_floats, a2_floats;
  __host__ __device__ F32Layout(int C, int f1, int n1, int f2, int n2, int f3) {
    a2 = kTile + f3 - 1;
    a1 = a2 + f2 - 1;
    ih = a1 + f1 - 1;
    s_in = ffma_col_stride(ih, f1, kPX1);
    s1 = ffma_col_stride(a1, f2, kPX2);
    s2 = ffma_col_stride(a2, f3, kPX3);
    in_floats = C * ih * s_in;
    a1_floats = n1 * a1 * s1;
    a2_floats = n2 * a2 * s2;
  }
  __host__ __device__ int bytes(int wbuf_floats) const {
    return 4 * (wbuf_floats + in_floats + a1_floats + a2_floats);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    fused_srcnn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ y, int H, int W,
                       int C, int f1, int n1, int f2, int n2, int f3, int n3, int wbuf_floats) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const F32Layout L(C, f1, n1, f2, n2, f3);
  const int OH = H - (f1 - 1) - (f2 - 1) - (f3 - 1);
  const int OW = W - (f1 - 1) - (f2 - 1) - (f3 - 1);
  const int oy0 = blockIdx.y * kTile;
  const int ox0 = blockIdx.x * kTile;
  const size_t img = blockIdx.z;
  // the weights come first so that their 16-byte reads are aligned
  float* wbuf = smem;
  float* s_in = wbuf + wbuf_floats;
  float* s_a1 = s_in + L.in_floats;
  float* s_a2 = s_a1 + L.a1_floats;

  // input window, NHWC global -> [c][x][y] shared; zero outside the image
  const float* xi = x + img * H * W * C;
  const int total = L.ih * L.ih * C;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % C;
    const int p = i / C;
    const int wy = p / L.ih, wx = p % L.ih;
    const int gy = oy0 + wy, gx = ox0 + wx;
    s_in[(c * L.ih + wx) * L.s_in + wy] =
        (gy < H && gx < W) ? __ldg(xi + (static_cast<size_t>(gy) * W + gx) * C + c) : 0.f;
  }
  // (each stage synchronises before its first read)
  ffma_layer<kNB1, kPX1, true, false>(s_in, C, L.ih, L.s_in, w1, b1, f1, n1, wbuf, wbuf_floats,
                                      s_a1, L.s1, 0, 0, 0, 0);
  ffma_layer<kNB2, kPX2, true, false>(s_a1, n1, L.a1, L.s1, w2, b2, f2, n2, wbuf, wbuf_floats,
                                      s_a2, L.s2, 0, 0, 0, 0);
  ffma_layer<kNB3, kPX3, false, true>(s_a2, n2, L.a2, L.s2, w3, b3, f3, n3, wbuf, wbuf_floats,
                                      y + img * OH * OW * n3, 0, oy0, ox0, OH, OW);
}

}  // namespace

// x: the f32 plane (N, H, W, C). w1, w2, w3: packed by
// ops/fused/entry.py:pack_f32, (k, f * f, npad) f32 with npad = n rounded
// up to kNB1, kNB2, kNB3 and zero padding columns; b1, b2, b3: (npad,) f32,
// zero-padded. y: f32 (N, H - s, W - s, n3). The weights pass through
// wbuf_floats of shared memory (a multiple of 4, at least one input
// channel's padded weights of every layer) beside the tiles. Refused
// (cudaErrorInvalidValue, nothing launched): an empty output, more than
// 65535 images, or a wbuf_floats or smem_bytes below what the layout needs.
// Returns cudaGetLastError() of the launch.
extern "C" int fused_srcnn_forward(const float* x, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const float* w3,
                                   const float* b3, float* y, int N, int H, int W, int C,
                                   int f1, int n1, int f2, int n2, int f3, int n3,
                                   int wbuf_floats, int smem_bytes, void* stream) {
  const int s = (f1 - 1) + (f2 - 1) + (f3 - 1);
  const int OH = H - s, OW = W - s;
  const int need = max(f1 * f1 * round_up(n1, kNB1),
                       max(f2 * f2 * round_up(n2, kNB2), f3 * f3 * round_up(n3, kNB3)));
  if (N <= 0 || N > 65535 || OH <= 0 || OW <= 0 || C <= 0 || f1 <= 0 || f2 <= 0 || f3 <= 0 ||
      n1 <= 0 || n2 <= 0 || n3 <= 0 || wbuf_floats % 4 || wbuf_floats < need ||
      smem_bytes < F32Layout(C, f1, n1, f2, n2, f3).bytes(wbuf_floats))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_srcnn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((OW + kTile - 1) / kTile, (OH + kTile - 1) / kTile, N);
  fused_srcnn_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, y, H, W, C, f1, n1, f2, n2, f3, n3, wbuf_floats);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 stream with the int8 first layer, on the tensor cores: replaces
// the same TPU kernel as run by cnn_sr_tpu/ops/pallas_fused/entry.py:32
// fused_forward with dtype=bf16, input_int8=True (the JAX package's default
// under use_pallas), whose input is quantised by weights.py:123
// _quantize_planes and whose w1 carries the 1/127 scale (weights.py:283,
// entry.py:326).
//
// What bounds it: the multiply-adds at mma.sync's rate. At a 16x16 output
// tile the halo recompute and the padded K bring the flagship's 116.6 G MAC
// per 1080p frame to about 218 G (conv1 over 24x24 positions at K = 16,
// conv2 over 20x20); its bytes (the f32 plane in, the f32 plane out) take
// 0.005 ms.
//
// What the design does: one block of 16 warps per 16x16 output tile, three
// tc_stage layers (tc_stage.cuh) whose activations stay in shared memory,
// position-major bf16 with rows padded by 16 bytes:
// * conv1: the dx-expanded, quantised input window (f1 taps of K = kx),
//   N = n1, over the 24x24 a1 tile in passes of 256 positions; w1 and w3
//   are copied in whole (cp.async) while the window is built;
// * conv2: f2^2 taps over a1, N = n2, w2 streamed one kernel row (f2 taps)
//   at a time through two stages that reuse the window's and w1's bytes;
//   one pass over the 20x20 a2 tile where N <= 64 (16 warps of 2 or 4 m16
//   tiles);
// * conv3: f3^2 taps over a2, N = n3 in one n8 tile, f32 to device memory.
// Why mma.sync over a shifted window and not wgmma: every tap is a row
// offset into one window, which ldmatrix's per-lane row addresses take as
// is; a wgmma shared-memory descriptor needs the canonical 8x8 core-matrix
// layout, which a shift by one position breaks, so wgmma would need a copy
// of the window per dx.
// The flagship's shared memory: 57,600 bytes for the window and w1 (then
// w2's stages), 82,944 for a1, 32,000 for a2, 12,800 for w3: 185,344, one
// block per SM.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the flagship at
// 1080p in 3.26 ms, against 24.49 on the CUDA cores and cuDNN bf16's 4.11
// (bound 0.236); 8 warps a block took 3.83. The same stack as the chain's
// three launches takes 2.11 ms: at the same rate per multiply-add, the
// halo recompute (218 against 138 G MAC) costs more than the 0.8 GB of
// intermediates the fusion saves, so fusion does not pay at a 16x16 tile
// (ROADMAP Queue 2 #1).
namespace {

// 16 warps a block (one block an SM): conv1 and conv3 in passes of 256
// positions, conv2 in one pass over a 20x20 tile (512 positions) where N
// <= 64, so that w2 streams through the block once
constexpr int kFusedWarps = 16;
template <int NB>
using Conv1Cfg = TcCfg<NB, NB >= 64 ? 2 : 1, kFusedWarps>;
template <int NB>
using Conv2Cfg = TcCfg<NB, NB == 64 ? 4 : 2, kFusedWarps>;
using Conv3Cfg = TcCfg<8, 1, kFusedWarps>;

// the block's shared memory in bf16 elements, as ops/fused/entry.py:
// tc_fused_plan computes it (a 16x16 output tile)
struct FusedLayout {
  int a2, a1, ih, kx, l1, l2, nb1, nb2;
  int x_elems, r0, a1_elems, a2_elems, w3_elems;
  __host__ __device__ FusedLayout(int C, int f1, int n1, int f2, int n2, int f3) {
    a2 = kTile + f3 - 1;
    a1 = a2 + f2 - 1;
    ih = a1 + f1 - 1;
    kx = tc_kx(f1, C);
    l1 = tc_kpad(n1);
    l2 = tc_kpad(n2);
    nb1 = tc_npad(n1);
    nb2 = tc_npad(n2);
    x_elems = ih * a1 * (kx + 8);
    const int head = x_elems + f1 * kx * tc_ws(nb1);
    const int w2_stages = (f2 > 1 ? 2 : 1) * f2 * l1 * tc_ws(nb2);
    r0 = head > w2_stages ? head : w2_stages;
    a1_elems = a1 * a1 * (l1 + 8);
    a2_elems = a2 * a2 * (l2 + 8);
    w3_elems = f3 * f3 * l2 * 8;
  }
  __host__ __device__ int bytes() const { return 2 * (r0 + a1_elems + a2_elems + w3_elems); }
};

__device__ __forceinline__ void zero_smem(bf16* p, int elems) {
  for (int i = threadIdx.x; i < elems / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
}

// conv1 over the whole a1 tile, weights resident, in passes of C::PB positions
template <class C>
__device__ void conv1_tc(const FusedLayout& L, const bf16* xw, int f1, const bf16* w1s,
                         const float* __restrict__ b1, bf16* a1) {
  const int P = L.a1 * L.a1;
  for (int pb = 0; pb < P; pb += C::PB) {
    TcAcc<C> acc;
    acc.begin(pb, P, L.a1, L.a1);
    acc.taps(xw, L.kx + 8, L.a1, 1, w1s, L.kx, 0, f1);
    tc_store_smem<C>(acc, pb, P, b1, a1, L.l1 + 8);
  }
}

// conv2 over the whole a2 tile, w2 streamed a kernel row a stage through wbuf
template <class C>
__device__ void conv2_tc(const FusedLayout& L, const bf16* a1, int f2, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, bf16* wbuf, bf16* a2) {
  const int P = L.a2 * L.a2;
  for (int pb = 0; pb < P; pb += C::PB) {
    TcAcc<C> acc;
    acc.begin(pb, P, L.a2, L.a1);
    tc_stream<C>(acc, [](int, int) {}, L.l1, L.l1, a1, L.l1 + 8, L.a1, f2, f2 * f2, f2, w2, L.nb2,
                 0, wbuf);
    tc_store_smem<C>(acc, pb, P, b2, a2, L.l2 + 8);
  }
}

__global__ void __launch_bounds__(32 * kFusedWarps)
    fused_srcnn_tc_kernel(const float* __restrict__ x, const bf16* __restrict__ w1,
                          const float* __restrict__ b1, const bf16* __restrict__ w2,
                          const float* __restrict__ b2, const bf16* __restrict__ w3,
                          const float* __restrict__ b3, float* __restrict__ y, int H, int W,
                          int C, int f1, int n1, int f2, int n2, int f3, int n3) {
  extern __shared__ float4 smem4[];
  bf16* const sm = reinterpret_cast<bf16*>(smem4);
  const FusedLayout L(C, f1, n1, f2, n2, f3);
  const int OH = H - (f1 - 1) - (f2 - 1) - (f3 - 1);
  const int OW = W - (f1 - 1) - (f2 - 1) - (f3 - 1);
  const int oy0 = blockIdx.y * kTile, ox0 = blockIdx.x * kTile;
  const size_t img = blockIdx.z;
  // [window | w1], later w2's stages | a1 | a2 | w3
  bf16* const xw = sm;
  bf16* const w1s = sm + L.x_elems;
  bf16* const a1 = sm + L.r0;
  bf16* const a2 = a1 + L.a1_elems;
  bf16* const w3s = a2 + L.a2_elems;

  // lanes past a layer's padded N are the next layer's zero K padding
  if (L.nb1 < L.l1) zero_smem(a1, L.a1_elems);
  if (L.nb2 < L.l2) zero_smem(a2, L.a2_elems);
  load_weights_async(w1, L.kx, L.nb1, 0, L.nb1, tc_ws(L.nb1), 0, f1, 0, L.kx, w1s);
  load_weights_async(w3, L.l2, 8, 0, 8, 8, 0, f3 * f3, 0, L.l2, w3s);
  cp_async_commit();
  load_first_window(x + img * H * W * C, H, W, C, oy0, ox0, L.ih, L.a1, f1, L.kx, L.kx + 8, xw);
  cp_async_wait_all();
  __syncthreads();

  switch (L.nb1) {  // block-uniform
    case 8: conv1_tc<Conv1Cfg<8>>(L, xw, f1, w1s, b1, a1); break;
    case 16: conv1_tc<Conv1Cfg<16>>(L, xw, f1, w1s, b1, a1); break;
    case 32: conv1_tc<Conv1Cfg<32>>(L, xw, f1, w1s, b1, a1); break;
    case 64: conv1_tc<Conv1Cfg<64>>(L, xw, f1, w1s, b1, a1); break;
    default: conv1_tc<Conv1Cfg<128>>(L, xw, f1, w1s, b1, a1); break;
  }
  // (conv2's stream synchronises before it overwrites the window and w1)
  switch (L.nb2) {
    case 8: conv2_tc<Conv2Cfg<8>>(L, a1, f2, w2, b2, sm, a2); break;
    case 16: conv2_tc<Conv2Cfg<16>>(L, a1, f2, w2, b2, sm, a2); break;
    case 32: conv2_tc<Conv2Cfg<32>>(L, a1, f2, w2, b2, sm, a2); break;
    case 64: conv2_tc<Conv2Cfg<64>>(L, a1, f2, w2, b2, sm, a2); break;
    default: conv2_tc<Conv2Cfg<128>>(L, a1, f2, w2, b2, sm, a2); break;
  }
  __syncthreads();
  using C3 = Conv3Cfg;
  TcAcc<C3> acc;
  acc.begin(0, C3::PB, kTile, L.a2);
  acc.taps(a2, L.l2 + 8, L.a2, f3, w3s, L.l2, 0, f3 * f3);
  tc_store_f32<C3>(acc, 0, C3::PB, kTile, b3, y + img * OH * OW * n3, oy0, ox0, OH, OW, n3);
}

}  // namespace

// x: the f32 centred plane (N, H, W, C), quantised at the window load. w1:
// packed (f1, kx, npad(n1)) with the 1/127 fold, lane dx C + ci of tap dy
// holding w1[dy, dx, ci]; w2: (f2 * f2, kpad(n1), npad(n2)); w3: (f3 * f3,
// kpad(n2), 8); all bf16. Biases f32, zero-padded to npad. y: f32 (N, H -
// s, W - s, n3). Activations between layers are rounded to bf16 (round to
// nearest even). Refused (cudaErrorInvalidValue, nothing launched): n1 or
// n2 above 128, n3 above 8, an empty output, or smem_bytes below the
// layout's. Returns cudaGetLastError() of the launch.
extern "C" int fused_srcnn_forward_bf16(const float* x, const void* w1, const float* b1,
                                        const void* w2, const float* b2, const void* w3,
                                        const float* b3, float* y, int N, int H, int W, int C,
                                        int f1, int n1, int f2, int n2, int f3, int n3,
                                        int smem_bytes, void* stream) {
  const int s = (f1 - 1) + (f2 - 1) + (f3 - 1);
  const int OH = H - s, OW = W - s;
  if (N <= 0 || N > 65535 || OH <= 0 || OW <= 0 || C <= 0 || f1 <= 0 || f2 <= 0 || f3 <= 0 ||
      n1 <= 0 || n2 <= 0 || n3 <= 0 || tc_npad(n1) > 128 || tc_npad(n2) > 128 || n3 > 8 ||
      smem_bytes < FusedLayout(C, f1, n1, f2, n2, f3).bytes())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_srcnn_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((OW + kTile - 1) / kTile, (OH + kTile - 1) / kTile, N);
  fused_srcnn_tc_kernel<<<grid, 32 * kFusedWarps, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
      static_cast<const bf16*>(w3), b3, y, H, W, C, f1, n1, f2, n2, f3, n3);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cnn_sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
