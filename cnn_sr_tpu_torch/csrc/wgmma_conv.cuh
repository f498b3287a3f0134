// The warpgroup layout, operand descriptors, products and output staging that
// the wgmma convolutions of the bf16 chain share: conv_first_wgmma.cu (its
// first layer), conv_wgmma.cu (its middle layers) and conv_last_wgmma.cu (its
// last layer). A block is two consumer warpgroups and a producer warpgroup;
// A is an input box of 32 or 64 lanes a row (64- or 128-byte swizzle,
// K-major; the first layer's is its own window in planes of 8 lanes), W a
// slice of K rows x BN columns (MN-major, swizzled by its row's bytes),
// landed by tensor copies through rings of stages. One copy of each,
// included where used.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

// two consumer warpgroups and a producer warpgroup, whose registers go to the
// consumers (setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168)
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2 * kWarpgroup, kThreads = kConsumers + kWarpgroup;
constexpr int kConsumerRegs = 224, kProducerRegs = 56;
static_assert(kConsumers * kConsumerRegs + kWarpgroup * kProducerRegs <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "the registers handed over fit the block's");
constexpr int kWarps = kConsumers / 32;  // arrivals that empty a stage, one a consumer warp

// BN columns of bf16 in shared memory: rows of up to 64 lanes (kRow bytes,
// swizzled by kRow bytes; 16-byte rows unswizzled), kBlocks of them a row of
// BN
template <int BN>
struct Cols {
  static constexpr int kLanes = BN < 64 ? BN : 64;
  static constexpr int kRow = 2 * kLanes;
  static constexpr int kBlocks = BN / kLanes;
};

// the tensor copies' swizzle of rows of `row` bytes
inline CUtensorMapSwizzle swizzle_of(int row) {
  return row == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : row == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                     : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// the descriptor of the A rows at addr: K-major, L lanes a row
template <int L>
__device__ __forceinline__ unsigned long long a_desc(unsigned addr) {
  if constexpr (L == 64)
    return wgmma_desc(addr, 16, 1024);
  else
    return wgmma_desc_sw64(addr, 16, 512);
}

// the descriptor of W's rows kk 16 .. + 15 of a slice at addr: MN-major,
// BN columns in rows of Cols<BN>::kRow bytes; at 128 columns two 64-lane
// blocks `block` bytes apart; 8-row K groups one swizzle atom (8 rows) apart
template <int BN>
__device__ __forceinline__ unsigned long long b_desc(unsigned addr, int kk, unsigned block) {
  constexpr int kRow = Cols<BN>::kRow;
  const unsigned at = addr + kk * 16 * kRow;
  if constexpr (BN >= 64)
    return wgmma_desc(at, block, 1024);
  else if constexpr (BN == 32)
    return wgmma_desc_sw64(at, block, 512);
  else if constexpr (BN == 16)
    return wgmma_desc_sw32(at, block, 256);
  else  // 8 columns, unswizzled: 8 x 8 core matrices, the K groups 128 bytes apart
    return wgmma_desc_interleave(at, 128, 128);
}

// the tile's first product, written and not read
template <int BN>
__device__ __forceinline__ void mma_first(float (&d)[BN / 2], unsigned long long da,
                                          unsigned long long db) {
  wgmma_mn_first<BN>(d, da, db);
}

template <int BN>
__device__ __forceinline__ void mma_ss(float (&d)[BN / 2], unsigned long long da,
                                       unsigned long long db, int scale_d) {
  if constexpr (BN == 128)
    wgmma_m64n128k16_ss(d, da, db, scale_d);
  else if constexpr (BN == 64)
    wgmma_m64n64k16_ss(d, da, db, scale_d);
  else if constexpr (BN == 32)
    wgmma_m64n32k16_ss(d, da, db, scale_d);
  else if constexpr (BN == 16)
    wgmma_m64n16k16_ss(d, da, db, scale_d);
  else
    wgmma_m64n8k16_ss(d, da, db, scale_d);
}

// byte offset of lane c (even) of row r in a block of R-byte rows swizzled
// by R bytes (16-byte chunk j of row r at j ^ (r R / 128 % (R / 16)), as the
// tensor copies write them from a 1024-aligned base)
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = R / 16;
  return r * R + ((((c >> 3) ^ (r * kChunks / 8)) & (kChunks - 1)) << 4) + (c & 7) * 2;
}

// bias, ReLU and one rounding to bf16 (nearest even) of two sums, packed
__device__ __forceinline__ unsigned bias_relu_bf16x2(float a, float b, float ba, float bb) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(a + ba, 0.f), fmaxf(b + bb, 0.f));
  return *reinterpret_cast<const unsigned*>(&h);
}

// bias and one rounding to bf16 (nearest even) of two sums, packed: no
// activation (the SAME first layer, basicsr's conv_first)
__device__ __forceinline__ unsigned bias_bf16x2(float a, float b, float ba, float bb) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a + ba, b + bb);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The epilogue of the SAME-padded middle instances (the RRDBNet schedule of
// ops/fused/rrdb.py): v = sum + bias, LeakyReLU(0.2) of it where `lrelu`,
// then for each residual k in turn v = res[k] + scale[k] v, all in f32 with
// no fused multiply-add (the plain version, ops/fused/reference.py:
// same_layer, rounds each product and sum as this does), then one rounding
// to bf16. A residual is f32 NHWC of the
// output's height and width, res_stride[k] channels a pixel, read at the
// output's own position and channel; null where the launch has none.
// out32, where not null, takes v in f32 as well (out32_stride channels a
// pixel): the model's residual stream, which a later launch reads as its
// residual. out32 may be one of the launch's residuals (in place): each
// position is read before the same thread writes it.
struct SameEpi {
  const float* res[2];
  long long res_stride[2];
  float scale[2];
  float* out32;
  long long out32_stride;
  int lrelu;
  int oh, ow;  // the output's rows and columns
};

__device__ __forceinline__ float lrelu_of(int lrelu, float v) {
  return lrelu && v < 0.f ? __fmul_rn(v, 0.2f) : v;
}

// two neighbouring channels c, c + 1 of pixel `pix` (the output's raster
// index, image included): the epilogue above, packed; `inside` is false
// past the output's edge, where no residual is read and nothing is written
// (the store clips it)
__device__ __forceinline__ unsigned same_bf16x2(const SameEpi& e, float a, float b, float ba,
                                                float bb, long long pix, int c, bool inside) {
  float v0 = lrelu_of(e.lrelu, __fadd_rn(a, ba)), v1 = lrelu_of(e.lrelu, __fadd_rn(b, bb));
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (e.res[k] != nullptr && inside) {
      // a plain load, not __ldg: a residual may be this launch's out32
      const float2 r = *reinterpret_cast<const float2*>(e.res[k] + pix * e.res_stride[k] + c);
      v0 = __fadd_rn(r.x, __fmul_rn(e.scale[k], v0));
      v1 = __fadd_rn(r.y, __fmul_rn(e.scale[k], v1));
    }
  if (e.out32 != nullptr && inside)
    *reinterpret_cast<float2*>(e.out32 + pix * e.out32_stride + c) = make_float2(v0, v1);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const unsigned*>(&h);
}

// A ring's next stage and the parity of its phase
struct Ring {
  int stage = 0, phase = 0;
  __device__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// W's slice of tap `tap`, K rows from `row`, columns from n0 into dst, block
// by block
template <int BN, int L>
__device__ __forceinline__ void load_w(unsigned char* dst, const CUtensorMap* tw, int n0, int row,
                                       int tap, unsigned long long* bar) {
#pragma unroll
  for (int blk = 0; blk < Cols<BN>::kBlocks; ++blk)
    tma_load_3d(dst + blk * L * Cols<BN>::kRow, tw, n0 + blk * Cols<BN>::kLanes, row, tap, bar);
}

}  // namespace
