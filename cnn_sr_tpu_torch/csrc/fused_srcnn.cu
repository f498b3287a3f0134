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
// What bounds it (fused_srcnn_forward, f32; the bf16 stream's fused
// kernel, fused_srcnn_forward_bf16, is fused_wgmma.cu): f32 FMAs on the
// CUDA cores. The flagship 9-5-5 (n1 = 64, n2 = 32) needs 57,184 MACs per
// output pixel, 51,200 of them in conv2: 116.6 G MAC a 1080p frame, 3.48 ms
// at the 67 TFLOP/s f32 peak. A 16x16 output tile recomputes its halo
// (conv1 over 24x24 positions, 2.25x; conv2 over 20x20, 1.5625x), so the
// kernel executes about 92,500 MACs per output pixel: 188.7 G MAC over a
// 1080p frame's 7,973 tiles, a 5.6 ms floor at this tile (5.8 with conv3's
// n3 = 1 padded to NB = 4). Its bytes (the f32 plane in and out) take
// 0.005 ms.
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

#include <cuda_runtime.h>

#include "ffma_stage.cuh"

namespace {

constexpr int kTile = 16;  // output tile of a block: 16 x 16 positions
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

extern "C" const char* cnn_sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
