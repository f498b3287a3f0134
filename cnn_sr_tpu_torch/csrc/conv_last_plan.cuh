// conv_last_plan: the tile, box and ring plan of conv_last_wgmma.cu, plain
// C++ so that the launch and a host compiler run the same arithmetic.
// ops/fused/entry.py mirrors it as last_layer_plan(), and
// tests/test_torch_last_wgmma.py compiles this header with g++ to hold the
// two equal.
#pragma once

#include "conv_wgmma_plan.cuh"

namespace {

// f32 lanes of a staged sum row past its columns: rows 8 floats (32 bytes)
// apart in the banks, so that a half-warp's four rows of 8-byte stores fall
// on distinct banks
constexpr int kLastPad = 8;

// input columns of a tile: 64, so that a product's 64 rows are one tile row.
// At RGB L7 tiles of 64 ran 0.199-0.202 ms, of 32 0.205-0.207 and of 16
// 0.218-0.223 (PERF.md)
constexpr int kLastCols = 64;

// One launch's plan for the last f x f layer from k channels to n outputs (k
// a multiple of 8), packed as (dgroups * f, kp, npad) (entry.pack_last): the
// f dx taps of the n outputs side by side in N, column (dx - d0) n + c of dx
// group d0 / gdx, in dgroups groups of gdx taps (one where f n <= 128), npad
// = wg_npad(gdx n) columns. A product's 64 rows are 64 input positions, one
// row of a tile kLastCols input columns wide, of which out_cols = kLastCols
// - f + 1 are outputs. A warpgroup owns `slabs` such m64 slabs (2 up to 32
// columns, else 1), the tile_rows = 2 slabs output rows of the two. K in
// `chunks` chunks of `lanes` lanes (32 where kp <= 32, in the 64-byte
// swizzle, else 64 in the 128-byte one). The f dy taps in `groups` boxes of
// gy taps each (the last may hold fewer), a box (A) being box_rows =
// tile_rows + gy - 1 input rows x kLastCols columns x `lanes` lanes, a_box
// bytes; a dy tap is a start kLastCols rows on. A W slice is one (dx group,
// dy)'s `lanes` rows of K x npad columns, w_slice bytes: all of them
// resident (w_res) where they fit beside two A boxes, else a ring of w_ring;
// w_bytes of them, to a multiple of 1024. The A ring takes a_ring boxes: all
// that fit beside resident W (at most kWgMaxRing), two where W streams (its
// ring then takes the rest). The sums of a warpgroup's slabs are staged as
// f32 rows of npad + kLastPad, e_bytes for both. Shared memory, from a
// 1024-aligned base: [A ring of a_ring boxes | W, w_bytes | sums, e_bytes |
// mbarriers].
struct LastPlan {
  int f, k, n, kp, lanes, chunks, dgroups, gdx, npad, out_cols, slabs, tile_rows, gy, groups,
      box_rows, a_box, a_ring, w_slice, w_res, w_ring, w_bytes, e_bytes, smem;
};

// the m64 slabs a warpgroup owns at npad columns: 2 up to 32 (at most 32
// sums a thread), 1 at 64 and 128
inline int last_slabs(int npad) { return npad <= 32 ? 2 : 1; }

// Fill p. Returns 0, or 1 for a layer the kernel does not take: f below 1 or
// past 63 (no output column in a tile), k not a multiple of 8, n below 1 or
// past 128, or not two A boxes of one dy tap and two W slices beside the
// staged sums.
inline int last_plan(LastPlan& p, int f, int k, int n) {
  if (f < 1 || f >= kLastCols || k <= 0 || k % 8 || n < 1 || n > 128) return 1;
  p.f = f;
  p.k = k;
  p.n = n;
  p.kp = wg_kpad(k);
  p.lanes = p.kp <= 32 ? 32 : 64;
  p.chunks = (k + p.lanes - 1) / p.lanes;
  // the fewest dx groups of at most 128 columns, their taps evened out
  const int most_dx = 128 / n;
  p.dgroups = (f + most_dx - 1) / most_dx;
  p.gdx = (f + p.dgroups - 1) / p.dgroups;
  p.npad = wg_npad(p.gdx * n);
  p.out_cols = kLastCols - f + 1;
  p.slabs = last_slabs(p.npad);
  p.tile_rows = 2 * p.slabs * kWgSlab / kLastCols;
  const int row = kLastCols * p.lanes * 2;  // bytes of a box row of the tile
  p.w_slice = p.lanes * p.npad * 2;
  p.e_bytes = 2 * p.slabs * kWgSlab * (p.npad + kLastPad) * 4;
  const int budget = kWgSmemLimit - kWgSlack - p.e_bytes;
  // the most dy taps a box whose two stages fit beside two W slices, then
  // evened out over the boxes
  int gy = f;
  while (gy > 0 && 2 * (p.tile_rows + gy - 1) * row + 2 * p.w_slice > budget) --gy;
  if (gy == 0) return 1;
  p.gy = (f + (f + gy - 1) / gy - 1) / ((f + gy - 1) / gy);
  p.groups = (f + p.gy - 1) / p.gy;
  p.box_rows = p.tile_rows + p.gy - 1;
  p.a_box = p.box_rows * row;
  const int w_all = (p.chunks * p.dgroups * f * p.w_slice + 1023) / 1024 * 1024;
  p.w_res = w_all + 2 * p.a_box <= budget;
  if (p.w_res) {
    p.a_ring = (budget - w_all) / p.a_box;
    if (p.a_ring > kWgMaxRing) p.a_ring = kWgMaxRing;
    p.w_ring = 0;
    p.w_bytes = w_all;
  } else {
    p.a_ring = 2;
    p.w_ring = (budget - p.a_ring * p.a_box) / p.w_slice;
    if (p.w_ring > kWgMaxRing) p.w_ring = kWgMaxRing;
    while (p.w_ring > 0 && (p.w_ring * p.w_slice + 1023) / 1024 * 1024 >
                               budget - p.a_ring * p.a_box)
      --p.w_ring;
    if (p.w_ring < 2) return 1;
    p.w_bytes = (p.w_ring * p.w_slice + 1023) / 1024 * 1024;
  }
  p.smem = kWgSlack + p.a_ring * p.a_box + p.w_bytes + p.e_bytes;
  return 0;
}

}  // namespace
