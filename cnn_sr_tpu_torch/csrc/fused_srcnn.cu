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
// What bounds it: f32 FMAs on the CUDA cores (no tensor cores in this f32
// version), shared-memory capacity, and the latency of the memory that
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

#include <type_traits>

#include "conv_stage.cuh"

namespace {

constexpr int kThreads = 512;

// T = float: the f32 kernel. T = __nv_bfloat16: the bf16 stream, whose
// window load quantises the f32 input to the int8 plane's integers
// (exact in bf16) and whose w1 comes with the 1/127 scale folded in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_srcnn_kernel(const float* __restrict__ x, const T* __restrict__ w1,
                       const float* __restrict__ b1, const T* __restrict__ w2,
                       const float* __restrict__ b2, const T* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ y, int H, int W,
                       int C, int f1, int n1, int f2, int n2, int f3, int n3, int tile_h,
                       int tile_w, int wbuf_elems) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
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
  T* wbuf = smem;
  T* s_in = wbuf + wbuf_elems;
  T* s_a1 = s_in + C * ih * iw;
  T* s_a2 = s_a1 + n1 * a1h * a1w;

  // input window, NHWC global -> channel-major shared; zero outside the image
  const float* xi = x + img * H * W * C;
  const int total = ih * iw * C;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % C;
    const int p = i / C;
    const int gy = oy0 + p / iw, gx = ox0 + p % iw;
    float v = (gy < H && gx < W) ? __ldg(xi + (static_cast<size_t>(gy) * W + gx) * C + c) : 0.f;
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      v = rintf(fminf(fmaxf(v, -1.f), 1.f) * 127.f);  // ties to even, as jnp.round
    s_in[c * ih * iw + p] = from_f32<T>(v);
  }
  // (the first chunk load in conv_stage synchronises before any read)
  // vector weight reads where the width allows them (block-uniform branch)
  if (n1 % 8 == 0)
    conv_stage<T, T, 8, 4, true, true, false>(s_in, C, ih, iw, w1, b1, f1, n1, wbuf, wbuf_elems,
                                              s_a1, a1h, a1w, 0, 0, 0, 0);
  else
    conv_stage<T, T, 8, 4, false, true, false>(s_in, C, ih, iw, w1, b1, f1, n1, wbuf,
                                               wbuf_elems, s_a1, a1h, a1w, 0, 0, 0, 0);
  if (n2 % 8 == 0)
    conv_stage<T, T, 8, 4, true, true, false>(s_a1, n1, a1h, a1w, w2, b2, f2, n2, wbuf,
                                              wbuf_elems, s_a2, a2h, a2w, 0, 0, 0, 0);
  else
    conv_stage<T, T, 8, 4, false, true, false>(s_a1, n1, a1h, a1w, w2, b2, f2, n2, wbuf,
                                               wbuf_elems, s_a2, a2h, a2w, 0, 0, 0, 0);
  conv_stage<T, float, 4, 1, false, false, true>(s_a2, n2, a2h, a2w, w3, b3, f3, n3, wbuf,
                                                 wbuf_elems, y + img * OH * OW * n3, tile_h,
                                                 tile_w, oy0, ox0, OH, OW);
}

template <typename T>
int launch(const float* x, const T* w1, const float* b1, const T* w2, const float* b2,
           const T* w3, const float* b3, float* y, int N, int H, int W, int C, int f1, int n1,
           int f2, int n2, int f3, int n3, int tile_h, int tile_w, int wbuf_elems,
           int smem_bytes, cudaStream_t stream) {
  const int s = (f1 - 1) + (f2 - 1) + (f3 - 1);
  const int OH = H - s, OW = W - s;
  auto kernel = fused_srcnn_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((OW + tile_w - 1) / tile_w, (OH + tile_h - 1) / tile_h, N);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(x, w1, b1, w2, b2, w3, b3, y, H, W, C, f1, n1,
                                                 f2, n2, f3, n3, tile_h, tile_w, wbuf_elems);
  return static_cast<int>(cudaGetLastError());
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
  return launch<float>(x, w1, b1, w2, b2, w3, b3, y, N, H, W, C, f1, n1, f2, n2, f3, n3, tile_h,
                       tile_w, wbuf_floats, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The bf16 stream with the int8 first layer: replaces the same TPU kernel
// as run by cnn_sr_tpu/ops/pallas_fused/entry.py:32 fused_forward with
// dtype=bf16, input_int8=True (the JAX package's default under
// use_pallas), whose input is quantised by weights.py:123
// _quantize_planes and whose w1 carries the 1/127 scale (weights.py:283,
// entry.py:326).
//
// What bounds it: the same FMAs as the f32 kernel (116.6 G MAC per
// flagship 1080p frame), still on the CUDA cores in f32: a bf16 x bf16
// product is exact in f32, so widening each operand at its shared-memory
// read gives the stream's numbers exactly, up to the order of the sums.
// What bf16 buys this design is shared memory: the flagship's tiles take
// 101,376 bytes instead of 202,752, so the weight buffer beside them
// holds conv2's whole 102,400 bytes and each layer's weights are read
// from device memory once per block, in one chunk (the f32 kernel
// streams conv2's in 8 chunks of 9 input channels). The tensor cores are
// the redesign of ROADMAP.md Queue 2 #1.
//
// x: the f32 centred plane (N, H, W, C), quantised at the window load
// (round(clip(x, -1, 1) * 127), ties to even, held exactly in bf16), so no
// int8 array goes through device memory. w1 (folded), w2, w3: bf16 HWIO;
// biases f32; y: f32 (N, H - s, W - s, n3). Activations between layers
// are rounded to bf16 (round to nearest even).
extern "C" int fused_srcnn_forward_bf16(const float* x, const void* w1, const float* b1,
                                        const void* w2, const float* b2, const void* w3,
                                        const float* b3, float* y, int N, int H, int W, int C,
                                        int f1, int n1, int f2, int n2, int f3, int n3,
                                        int tile_h, int tile_w, int wbuf_elems, int smem_bytes,
                                        void* stream) {
  using bf = __nv_bfloat16;
  return launch<bf>(x, static_cast<const bf*>(w1), b1, static_cast<const bf*>(w2), b2,
                    static_cast<const bf*>(w3), b3, y, N, H, W, C, f1, n1, f2, n2, f3, n3,
                    tile_h, tile_w, wbuf_elems, smem_bytes, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cnn_sr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
