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
// What bounds it: f32 FMAs on the CUDA cores. The RGB model does 290,016
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

#include <cuda_runtime.h>

#include "conv_stage.cuh"

namespace {

constexpr int kThreads = 512;

template <int NB, int PX, bool VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    conv_layer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ y, int H, int W, int K,
                      int f, int n, int tile_h, int tile_w, int wbuf_floats) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int OH = H - f + 1, OW = W - f + 1;
  const int oy0 = blockIdx.y * tile_h;
  const int ox0 = blockIdx.x * tile_w;
  const size_t img = blockIdx.z;
  const int ih = tile_h + f - 1, iw = tile_w + f - 1;
  // [weight chunk | input window]; the chunk comes first so that its
  // float4 reads are 16-byte aligned
  float* wbuf = smem;
  float* s_in = wbuf + wbuf_floats;

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
  conv_stage<NB, PX, VEC, RELU, true>(s_in, K, ih, iw, w, b, f, n, wbuf, wbuf_floats,
                                      y + img * OH * OW * n, tile_h, tile_w, oy0, ox0, OH,
                                      OW);
}

template <int NB, int PX, bool VEC, bool RELU>
int launch(const float* x, const float* w, const float* b, float* y, int N, int H, int W,
           int K, int f, int n, int tile_h, int tile_w, int wbuf_floats, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = conv_layer_kernel<NB, PX, VEC, RELU>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int OH = H - f + 1, OW = W - f + 1;
  const dim3 grid((OW + tile_w - 1) / tile_w, (OH + tile_h - 1) / tile_h, N);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(x, w, b, y, H, W, K, f, n, tile_h, tile_w,
                                                 wbuf_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one layer on `stream` and returns cudaGetLastError(). The caller
// checks the shapes, plans the shared memory (input window plus a weight
// chunk of wbuf_floats, smem_bytes in all, within the per-block limit) and
// allocates y (N, H - f + 1, W - f + 1, n).
extern "C" int conv_layer_forward(const float* x, const float* w, const float* b, float* y,
                                  int N, int H, int W, int K, int f, int n, int relu,
                                  int tile_h, int tile_w, int wbuf_floats, int smem_bytes,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  // float4 weight reads and 16 channels x 4 rows per thread where that
  // still gives every thread an item (n >= 128 at a 16x16 tile), 8 x 4
  // where the width is a multiple of 8; 4 channels x 1 row otherwise
  // (narrow last layers)
  if (n % 16 == 0 && (n / 16) * ((tile_h + 3) / 4) * tile_w >= kThreads)
    return relu ? launch<16, 4, true, true>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                            wbuf_floats, smem_bytes, s)
                : launch<16, 4, true, false>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                             wbuf_floats, smem_bytes, s);
  if (n % 8 == 0)
    return relu ? launch<8, 4, true, true>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                           wbuf_floats, smem_bytes, s)
                : launch<8, 4, true, false>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                            wbuf_floats, smem_bytes, s);
  return relu ? launch<4, 1, false, true>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                          wbuf_floats, smem_bytes, s)
              : launch<4, 1, false, false>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                           wbuf_floats, smem_bytes, s);
}
