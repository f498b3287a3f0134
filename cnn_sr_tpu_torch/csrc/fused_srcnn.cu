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
// point below): f32 FMAs on the CUDA cores, shared-memory capacity, and the latency of the memory that
// feeds the FMAs. The flagship 9-5-5 (n1 = 64, n2 = 32) spends 51,200 of
// its 57,184 MACs per output pixel in conv2, whose weights (204,800 bytes)
// do not fit in what L1 keeps beside the tiles.
//
// What the design does about it:
// * One thread block owns one output tile of one image (blockIdx.x/y =
//   tile column/row, blockIdx.z = image). Dynamic shared memory holds the
//   input window with its s-pixel halo, the conv1 tile and the conv2 tile,
//   all channel-major, so only the output is written to device memory. At
//   a 16x16 output tile the flagship's tiles take 4,096 + 147,456 + 51,200
//   = 202,752 bytes: one block per SM. The halo is recomputed per tile
//   (2.25x on conv1, 1.56x on conv2 at 16x16).
// * The rest of the block's shared memory (29,696 bytes for the flagship)
//   carries each layer's weights, read from global memory once per chunk
//   of input channels and then read by every thread from shared memory.
//   Read from global memory inside the FMA loop, they came from L2: 43.5
//   against 22.4 ms per flagship 1080p frame (NVIDIA H100 80GB HBM3, 700 W).
// * Each thread computes PX output rows of one column for NB output
//   channels at once, so every activation read feeds NB FMAs and every
//   weight read feeds PX FMAs. Neighbouring threads take neighbouring
//   columns: their activation reads hit consecutive banks, and their
//   weight reads are one warp-uniform address (a broadcast). 512 threads
//   of NB = 8 give 16 warps per SM to hide shared-memory latency: 20.1 ms
//   against 22.4 ms for 256 threads of NB = 16 (same card and limit).
// * Ragged right and bottom edges: input outside the image reads as 0,
//   and only in-image outputs are stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv_stage.cuh"
#include "tc_stage.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    fused_srcnn_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ y, int H, int W,
                       int C, int f1, int n1, int f2, int n2, int f3, int n3, int tile_h,
                       int tile_w, int wbuf_elems) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int OH = H - (f1 - 1) - (f2 - 1) - (f3 - 1);
  const int OW = W - (f1 - 1) - (f2 - 1) - (f3 - 1);
  const int oy0 = blockIdx.y * tile_h;
  const int ox0 = blockIdx.x * tile_w;
  const size_t img = blockIdx.z;

  const int a2h = tile_h + f3 - 1, a2w = tile_w + f3 - 1;
  const int a1h = a2h + f2 - 1, a1w = a2w + f2 - 1;
  const int ih = a1h + f1 - 1, iw = a1w + f1 - 1;
  // [weight chunk | input window | conv1 tile | conv2 tile]; the chunk
  // comes first so that its 16-byte reads are aligned
  float* wbuf = smem;
  float* s_in = wbuf + wbuf_elems;
  float* s_a1 = s_in + C * ih * iw;
  float* s_a2 = s_a1 + n1 * a1h * a1w;

  // input window, NHWC global -> channel-major shared; zero outside the image
  const float* xi = x + img * H * W * C;
  const int total = ih * iw * C;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % C;
    const int p = i / C;
    const int gy = oy0 + p / iw, gx = ox0 + p % iw;
    s_in[c * ih * iw + p] =
        (gy < H && gx < W) ? __ldg(xi + (static_cast<size_t>(gy) * W + gx) * C + c) : 0.f;
  }
  // (the first chunk load in conv_stage synchronises before any read)
  // vector weight reads where the width allows them (block-uniform branch)
  if (n1 % 8 == 0)
    conv_stage<8, 4, true, true, false>(s_in, C, ih, iw, w1, b1, f1, n1, wbuf, wbuf_elems, s_a1,
                                        a1h, a1w, 0, 0, 0, 0);
  else
    conv_stage<8, 4, false, true, false>(s_in, C, ih, iw, w1, b1, f1, n1, wbuf, wbuf_elems, s_a1,
                                         a1h, a1w, 0, 0, 0, 0);
  if (n2 % 8 == 0)
    conv_stage<8, 4, true, true, false>(s_a1, n1, a1h, a1w, w2, b2, f2, n2, wbuf, wbuf_elems,
                                        s_a2, a2h, a2w, 0, 0, 0, 0);
  else
    conv_stage<8, 4, false, true, false>(s_a1, n1, a1h, a1w, w2, b2, f2, n2, wbuf, wbuf_elems,
                                         s_a2, a2h, a2w, 0, 0, 0, 0);
  conv_stage<4, 1, false, false, true>(s_a2, n2, a2h, a2w, w3, b3, f3, n3, wbuf, wbuf_elems,
                                       y + img * OH * OW * n3, tile_h, tile_w, oy0, ox0, OH, OW);
}

}  // namespace

// Launches the f32 kernel on `stream` and returns cudaGetLastError(). The
// caller checks the envelope (3 layers, C <= 4, n3 <= 4, shared bytes
// within the per-block limit) and allocates y.
extern "C" int fused_srcnn_forward(const float* x, const float* w1, const float* b1,
                                   const float* w2, const float* b2, const float* w3,
                                   const float* b3, float* y, int N, int H, int W, int C,
                                   int f1, int n1, int f2, int n2, int f3, int n3,
                                   int tile_h, int tile_w, int wbuf_floats, int smem_bytes,
                                   void* stream) {
  const int s = (f1 - 1) + (f2 - 1) + (f3 - 1);
  const int OH = H - s, OW = W - s;
  cudaError_t err = cudaFuncSetAttribute(fused_srcnn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((OW + tile_w - 1) / tile_w, (OH + tile_h - 1) / tile_h, N);
  fused_srcnn_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, w3, b3, y, H, W, C, f1, n1, f2, n2, f3, n3, tile_h, tile_w, wbuf_floats);
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
