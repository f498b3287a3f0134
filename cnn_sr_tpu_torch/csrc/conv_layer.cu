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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "conv_stage.cuh"

namespace {

constexpr int kThreads = 512;

// TI: the input's type in device memory; T: the shared window's and the
// weights'; TO: the output's. f32 layers are <float, float, float>; the
// bf16 stream's first layer is <float, bf16, bf16> and quantises at the
// window load, its middle layers <bf16, bf16, bf16>, its last
// <bf16, bf16, float>.
template <typename TI, typename T, typename TO, int NB, int PX, bool VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    conv_layer_kernel(const TI* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ b, TO* __restrict__ y, int H, int W, int K,
                      int f, int n, int tile_h, int tile_w, int wbuf_elems) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int OH = H - f + 1, OW = W - f + 1;
  const int oy0 = blockIdx.y * tile_h;
  const int ox0 = blockIdx.x * tile_w;
  const size_t img = blockIdx.z;
  const int ih = tile_h + f - 1, iw = tile_w + f - 1;
  // [weight chunk | input window]; the chunk comes first so that its
  // 16-byte reads are aligned
  T* wbuf = smem;
  T* s_in = wbuf + wbuf_elems;

  // input window, NHWC global -> channel-major shared; zero outside the image
  const TI* xi = x + img * H * W * K;
  const int total = ih * iw * K;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % K;
    const int p = i / K;
    const int gy = oy0 + p / iw, gx = ox0 + p % iw;
    if constexpr (std::is_same_v<TI, T>) {
      s_in[c * ih * iw + p] =
          (gy < H && gx < W) ? ldg(xi + (static_cast<size_t>(gy) * W + gx) * K + c) : from_f32<T>(0.f);
    } else {
      // the bf16 stream's first layer: the int8 plane's integers, exact in
      // bf16 (round(clip(x, -1, 1) * 127), ties to even, as jnp.round)
      const float v = (gy < H && gx < W) ? __ldg(xi + (static_cast<size_t>(gy) * W + gx) * K + c) : 0.f;
      s_in[c * ih * iw + p] = from_f32<T>(rintf(fminf(fmaxf(v, -1.f), 1.f) * 127.f));
    }
  }
  // (the first chunk load in conv_stage synchronises before any read)
  conv_stage<T, TO, NB, PX, VEC, RELU, true>(s_in, K, ih, iw, w, b, f, n, wbuf, wbuf_elems,
                                             y + img * OH * OW * n, tile_h, tile_w, oy0, ox0,
                                             OH, OW);
}

template <typename TI, typename T, typename TO, int NB, int PX, bool VEC, bool RELU>
int launch(const TI* x, const T* w, const float* b, TO* y, int N, int H, int W, int K, int f,
           int n, int tile_h, int tile_w, int wbuf_elems, int smem_bytes, cudaStream_t stream) {
  auto kernel = conv_layer_kernel<TI, T, TO, NB, PX, VEC, RELU>;
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
template <typename TI, typename T, typename TO, bool RELU>
int launch_by_width(const TI* x, const T* w, const float* b, TO* y, int N, int H, int W, int K,
                    int f, int n, int tile_h, int tile_w, int wbuf_elems, int smem_bytes,
                    cudaStream_t s) {
  if (n % 16 == 0 && (n / 16) * ((tile_h + 3) / 4) * tile_w >= kThreads)
    return launch<TI, T, TO, 16, 4, true, RELU>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                                wbuf_elems, smem_bytes, s);
  if (n % 8 == 0)
    return launch<TI, T, TO, 8, 4, true, RELU>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                               wbuf_elems, smem_bytes, s);
  return launch<TI, T, TO, 4, 1, false, RELU>(x, w, b, y, N, H, W, K, f, n, tile_h, tile_w,
                                              wbuf_elems, smem_bytes, s);
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
  return relu ? launch_by_width<float, float, float, true>(x, w, b, y, N, H, W, K, f, n, tile_h,
                                                           tile_w, wbuf_floats, smem_bytes, s)
              : launch_by_width<float, float, float, false>(x, w, b, y, N, H, W, K, f, n,
                                                            tile_h, tile_w, wbuf_floats,
                                                            smem_bytes, s);
}

// One layer of the bf16 stream: replaces the same TPU kernel as run by
// cnn_sr_tpu/ops/pallas_fused/entry.py:32 fused_forward with dtype=bf16,
// input_int8=True (the JAX default under use_pallas) for the stacks the
// fused kernel does not take, the 7-layer RGB model first: the int8 plane
// of weights.py:123 _quantize_planes with the 1/127 scale folded into w1
// (weights.py:283, entry.py:326), bf16 operands, f32 sums.
//
// What bounds it: the same FMAs as the f32 chain (592.4 G MAC per RGB
// 1080p frame), on the CUDA cores in f32 (a bf16 x bf16 product is exact
// there, so only the order of the sums differs from the stream). What
// bf16 changes: each intermediate is half the bytes in device memory
// (the RGB stack's two ping-pong buffers about 0.52 GB each instead of
// 1.05 GB) and the window half the shared memory, so the k = 128 layer's
// 82,944-byte window leaves room for 64 input channels of weights per
// chunk (14 in f32), and a layer f32 refuses (f = 9 over 128 channels,
// a 147,456-byte window in bf16) fits. The tensor cores are the redesign
// of ROADMAP.md Queue 2 #1.
//
// first != 0: x is the f32 centred input, quantised at the window load,
// and w the folded first-layer weights; else x is the previous layer's
// bf16 output. last != 0: y is f32 and no ReLU; else y is bf16 (rounded
// to nearest even) after ReLU. The stream has at least 3 layers, so no
// layer is both. w is bf16 HWIO, b f32. Stores are 16 bytes a thread
// where n % 8 == 0.
extern "C" int conv_layer_forward_bf16(const void* x, const void* w, const float* b, void* y,
                                       int N, int H, int W, int K, int f, int n, int first,
                                       int last, int tile_h, int tile_w, int wbuf_elems,
                                       int smem_bytes, void* stream) {
  using bf = __nv_bfloat16;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wb = static_cast<const bf*>(w);
  if (first && last) return static_cast<int>(cudaErrorInvalidValue);  // a 1-layer stream
  if (first)
    return launch_by_width<float, bf, bf, true>(static_cast<const float*>(x), wb, b,
                                                static_cast<bf*>(y), N, H, W, K, f, n, tile_h,
                                                tile_w, wbuf_elems, smem_bytes, s);
  if (last)
    return launch_by_width<bf, bf, float, false>(static_cast<const bf*>(x), wb, b,
                                                 static_cast<float*>(y), N, H, W, K, f, n,
                                                 tile_h, tile_w, wbuf_elems, smem_bytes, s);
  return launch_by_width<bf, bf, bf, true>(static_cast<const bf*>(x), wb, b, static_cast<bf*>(y),
                                           N, H, W, K, f, n, tile_h, tile_w, wbuf_elems,
                                           smem_bytes, s);
}
