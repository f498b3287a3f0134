// conv_wgmma_plan: the tile, box and ring plan of conv_wgmma.cu, plain C++
// so that the launch and a host compiler run the same arithmetic.
// ops/fused/entry.py mirrors it as wgmma_layer_plan(), and
// tests/test_torch_wgmma_chain.py compiles this header with g++ to hold the
// two equal.
#pragma once

namespace {

// the output tile of a block: 16 rows x 16 columns, four m64 slabs of four
// rows each; 16 columns keep a dy shift (16 box rows of 128 bytes) a whole
// number of 1024-byte swizzle atoms
constexpr int kWgTileRows = 16, kWgTileCols = 16;
constexpr int kWgLanes = 64;  // lanes of a box row: 128 bytes, the swizzle's span
constexpr int kWgN = 128;     // output columns a block: one n128 chunk of N
constexpr int kWgMaxRing = 16;
constexpr int kWgSmemLimit = 232448;  // dynamic shared bytes a block may opt into (sm_90)
// a W slice: 64 rows of K x 128 columns, two 64-lane blocks
constexpr int kWgWSlice = kWgLanes * kWgN * 2;
// the output staging: the tile's 256 positions x 128 columns in bf16
constexpr int kWgOut = kWgTileRows * kWgTileCols * kWgN * 2;
// bytes past the buffers: room to align them to 1024 (the swizzle's period)
// and the mbarriers (full and empty a stage of each ring)
constexpr int kWgSlack = 1024 + 8 * 4 * kWgMaxRing;

// One launch's plan for an f x f layer from k to n channels (f odd, k % 8
// == 0, n > 64, n % 8 == 0), packed as (f * f, kp, npad) (entry.pack_bf16:
// kp = kpad(k), npad = n to a multiple of 128): k in `chunks` chunks of 64
// lanes; the f dy taps of a dx in `groups` boxes of gy taps each (the last
// may hold fewer), a box (A) being box_rows = tile rows + gy - 1 input rows
// x 16 columns x 64 lanes, a_box bytes. Shared memory, from a 1024-aligned base: [A ring
// of a_ring boxes | W ring of w_ring slices | output staging | mbarriers].
struct WgmmaPlan {
  int f, k, n, kp, npad, chunks, gy, groups, box_rows, a_box, a_ring, w_ring, smem;
};

// Fill p. Returns 0, or 1 for a layer the kernel does not take: f even or
// below 1, k or n not a multiple of 8, n <= 64 (tc_stage.cuh's), or not
// two A boxes of one dy tap and two W slices beside the staging.
inline int wgmma_plan(WgmmaPlan& p, int f, int k, int n) {
  if (f < 1 || f % 2 == 0 || k <= 0 || k % 8 || n <= 64 || n % 8) return 1;
  p.f = f;
  p.k = k;
  p.n = n;
  p.kp = k <= 16 ? 16 : k <= 32 ? 32 : k <= 64 ? 64 : (k + 127) / 128 * 128;
  p.npad = (n + kWgN - 1) / kWgN * kWgN;
  p.chunks = (k + kWgLanes - 1) / kWgLanes;
  const int budget = kWgSmemLimit - kWgSlack - kWgOut;
  const int row = kWgTileCols * kWgLanes * 2;  // bytes of a box row of the tile
  // the most dy taps a box whose two stages fit beside two W slices, then
  // evened out over the boxes a dx needs
  int gy = f;
  while (gy > 0 && 2 * (kWgTileRows + gy - 1) * row + 2 * kWgWSlice > budget) --gy;
  if (gy == 0) return 1;
  p.gy = (f + (f + gy - 1) / gy - 1) / ((f + gy - 1) / gy);
  p.groups = (f + p.gy - 1) / p.gy;
  p.box_rows = kWgTileRows + p.gy - 1;
  p.a_box = p.box_rows * row;
  p.a_ring = 2;
  p.w_ring = (budget - p.a_ring * p.a_box) / kWgWSlice;
  if (p.w_ring > kWgMaxRing) p.w_ring = kWgMaxRing;
  p.smem = kWgSlack + p.a_ring * p.a_box + p.w_ring * kWgWSlice + kWgOut;
  return 0;
}

}  // namespace
