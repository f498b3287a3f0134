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
// The f32 chain: conv_layer_forward, on ffma_stage.cuh. The bf16 chain's
// layers are conv_first_wgmma.cu's (the first), conv_wgmma.cu's (the
// middles) and conv_last_wgmma.cu's (the last).
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

#include <cuda_runtime.h>

#include "ffma_stage.cuh"

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

