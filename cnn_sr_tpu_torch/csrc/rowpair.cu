// rowpair_gemm: y[i][j][:] = bf16(a[i * row_stride + j * L + :]) @ w, f32 sums:
// a GEMM whose A operand is m rows of a (rows, W, L) operand read through a
// leading stride, W x L contiguous elements a row.
//
// Replaces the TPU kernel of tools/rowpair_probe.py (pl.pallas_call at :46,
// body _case :36-44): for each row parity rt, the stride-2 leading-dim read
// a[rt : rt + 2m : 2, 0:W, 0:L] of a (64, 128, L) operand (bf16 or f32, L =
// 128 or 64), rounded to bf16 and multiplied by an (L, L) bf16 matrix into
// (m, W, L) f32, m = 16. On the TPU the probe asked whether Mosaic lowers a
// strided leading-dim ref read at the row-pair exit's lane geometry. Here a
// strided row is an address: the wrapper passes row_stride = 2 W L for the
// stride-2 view, W L for a contiguous copy, and the kernel is the same.
//
// What bounds it: bytes. At the flagship's 1080p exit (a 534 x 954 x L
// operand, both parities) the product is 8.35 G MAC at L = 128 (0.017 ms at
// the bf16 tensor-core rate) against 391 MB (bf16 A) or 522 MB (f32 A) of
// operand read and f32 output written (0.117 / 0.156 ms at 3.35 TB/s). On the
// CUDA cores in f32 the MACs take 0.25 ms at the 67 TFLOP/s peak, so this
// kernel, right and simple, is bound by its FMAs instead.
//
// What the design does: a block takes 128 rows of the flattened (m W) x L
// A and all L output columns; A and w go through shared memory in chunks of
// 32 input channels, A transposed (channel-major) and both widened to f32.
// A thread loads 16 channels of one row (64 or 32 contiguous bytes; a warp
// covers 32 rows), so the transposed shared writes miss no bank, and keeps
// an 8 x L/16 tile of sums: two 16-byte reads of A and L/64 of w feed
// 8 L/16 FMAs per channel. Each row's address is formed once from its
// (i, j): rows i and i + 1 of A are row_stride apart, which is all that
// differs between the strided and the contiguous read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int BM = 128;  // rows of A a block
constexpr int KC = 32;   // input channels a chunk

__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 q = reinterpret_cast<const float4*>(p)[h];
    v[4 * h] = __bfloat162float(__float2bfloat16_rn(q.x));
    v[4 * h + 1] = __bfloat162float(__float2bfloat16_rn(q.y));
    v[4 * h + 2] = __bfloat162float(__float2bfloat16_rn(q.z));
    v[4 * h + 3] = __bfloat162float(__float2bfloat16_rn(q.w));
  }
}

// 8 bf16 at p (16-byte aligned) widened to f32
__device__ __forceinline__ void widen8(const bf16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned int u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[t]));
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const bf16* p, float (&v)[16]) {
  widen8(p, v);
  widen8(p + 8, v + 8);
}

template <typename TA, int L>
__global__ void __launch_bounds__(kThreads)
    rowpair_kernel(const TA* __restrict__ a, const bf16* __restrict__ w, float* __restrict__ y,
                   long long row_stride, int W, long long M) {
  constexpr int TN = L / 16;  // a thread's columns: tx * 4 + 64 h + u
  __shared__ float4 as4[KC * BM / 4];
  __shared__ float4 bs4[KC * L / 4];
  float* as = reinterpret_cast<float*>(as4);
  float* bs = reinterpret_cast<float*>(bs4);
  const long long r0 = static_cast<long long>(blockIdx.x) * BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // the row this thread loads, and which 16 channels of each chunk
  const int lr = threadIdx.x % BM, kh = threadIdx.x / BM;
  const TA* arow = nullptr;
  if (r0 + lr < M) {
    const long long i = (r0 + lr) / W, j = (r0 + lr) % W;
    arow = a + i * row_stride + j * L;
  }

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += KC) {
    __syncthreads();  // every thread is done with the last chunk
    float v[16];
    if (arow) {
      load16(arow + k0 + kh * 16, v);
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) as[(kh * 16 + u) * BM + lr] = v[u];
    for (int e = threadIdx.x; e < KC * L / 8; e += kThreads) {
      const int kk = e / (L / 8), jj = (e % (L / 8)) * 8;
      float f[8];
      widen8(w + (k0 + kk) * L + jj, f);
      float4* d = reinterpret_cast<float4*>(bs + kk * L + jj);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = as4[(kk * BM + ty * 4) / 4];
      const float4 a1 = as4[(kk * BM + 64 + ty * 4) / 4];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 b = bs4[(kk * L + 64 * h + tx * 4) / 4];
        bv[4 * h] = b.x;
        bv[4 * h + 1] = b.y;
        bv[4 * h + 2] = b.z;
        bv[4 * h + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = r0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      *reinterpret_cast<float4*>(y + r * L + 64 * h + tx * 4) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

template <typename TA, int L>
int launch(const void* a, const void* w, void* y, long long m, int W, long long row_stride,
           cudaStream_t stream) {
  const long long M = m * W;
  const long long blocks = (M + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rowpair_kernel<TA, L><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const bf16*>(w), static_cast<float*>(y), row_stride,
      W, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (m, W, L) f32 = A @ w on `stream`, A the m rows a + i * row_stride
// (elements), each W x L contiguous, f32 (a_bf16 == 0) or bf16, rounded to
// bf16 at the read; w (L, L) bf16; L = 64 or 128; a, w, y and row_stride
// 16-byte aligned. Returns cudaGetLastError() of the launch.
extern "C" int rowpair_gemm(const void* a, const void* w, void* y, int a_bf16, int L, long long m,
                            int W, long long row_stride, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 128)
    return a_bf16 ? launch<bf16, 128>(a, w, y, m, W, row_stride, s)
                  : launch<float, 128>(a, w, y, m, W, row_stride, s);
  if (L == 64)
    return a_bf16 ? launch<bf16, 64>(a, w, y, m, W, row_stride, s)
                  : launch<float, 64>(a, w, y, m, W, row_stride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
