// conv_first_plan: the tile, buffer and ring plan of conv_first_wgmma.cu,
// plain C++ so that the launch and a host compiler run the same arithmetic.
// ops/fused/entry.py mirrors it as first_layer_plan(), and
// tests/test_torch_first_wgmma.py compiles this header with g++ to hold the
// two equal.
#pragma once

#include "conv_wgmma_plan.cuh"

namespace {

constexpr int kFirstMaxRaw = 4;  // the most stages of raw input pixels
// bytes past the buffers: room to align them to 1024 (the swizzle's period)
// and the mbarriers (full and empty a stage of the raw and the W ring)
constexpr int kFirstSlack = 1024 + 8 * 2 * (kFirstMaxRaw + kWgMaxRing);
// the consumer warpgroups of a block: four. On two, each tile half as tall,
// RGB L1 took 0.137 ms against 0.094 and the 9 -> 64 conv1 0.342 against
// 0.216-0.220 (probes/first_wgmma_parts.py, PERF.md)
constexpr int kFirstWgs = 4;
// the tile's columns the plan chooses from, widest first; 8 and 4 take the
// widest f, whose windows fit only a few columns wide
constexpr int kFirstCols[] = {64, 32, 16, 8, 4};

// the m64 slabs a warpgroup owns at bn columns where the window fits: 2 up
// to 32 columns, 1 at 64 (at most 32 sums a thread)
inline int first_slabs(int bn) { return bn <= 32 ? 2 : 1; }

// One launch's plan for the first f x f layer over k = c input channels into
// n outputs (n a multiple of 8), its weights packed as (f, kx, npad)
// (entry.pack_bf16, first): kx = the f c dx-expanded lanes to a multiple of
// 16, a block's bn = min(npad, 64) columns (fewer where the window of a
// wide f leaves no room), N in nchunks such chunks. The
// tile is `cols` output columns x tile_rows = kFirstWgs slabs 64 / cols rows,
// kFirstWgs consumer warpgroups of `slabs` m64 slabs (64 raster positions
// each). Its window holds win_rows = tile_rows + f - 1 rows x cols
// positions of kx lanes, bf16, as kx / 8 planes of 8 lanes; win_bufs of them
// (two where they fit: the next tile's is expanded while this one's
// products run), win_bytes for all; a dy tap is a start cols positions on.
// Its raw pixels are win_rows rows x iw = cols + f - 1 columns x c channels,
// f32, raw_bytes a stage (each row to 4 floats), raw_ring stages (at most
// kFirstMaxRaw). A W slice is one (chunk, dy)'s kx rows x bn columns,
// w_slice bytes: all nchunks f of them resident (w_res) where they fit
// beside two raw stages, else a ring of w_ring; w_bytes of them, to a
// multiple of 1024. The output is staged in out_bufs buffers a warpgroup
// (two where they fit, else one) of slabs 64 positions x bn columns, bf16,
// out_bytes for all. Shared memory, from a 1024-aligned base: [W, w_bytes |
// output staging, out_bytes | windows, win_bytes | raw ring | mbarriers].
struct FirstPlan {
  int f, k, n, kx, npad, bn, nchunks, slabs, cols, tile_rows, win_rows, win_bufs, win_bytes, iw,
      raw_bytes, raw_ring, w_slice, w_res, w_ring, w_bytes, out_bufs, out_bytes, smem;
};

// Fill p's tile at `slabs` slabs, `cols` columns, `wins` windows and `bufs`
// output buffers a warpgroup (p's layer fields set). Returns 0, or 1 where
// two raw stages and two W slices (or all of W) do not fit beside the
// windows and the output buffers.
inline int first_fit(FirstPlan& p, int slabs, int cols, int wins, int bufs) {
  const int w_all = (p.nchunks * p.f * p.w_slice + 1023) / 1024 * 1024;
  const int w_two = (2 * p.w_slice + 1023) / 1024 * 1024;
  p.slabs = slabs;
  p.cols = cols;
  p.tile_rows = kFirstWgs * slabs * kWgSlab / cols;
  p.win_rows = p.tile_rows + p.f - 1;
  p.win_bufs = wins;
  p.win_bytes = wins * p.win_rows * cols * p.kx * 2;
  p.iw = cols + p.f - 1;
  p.raw_bytes = p.win_rows * ((p.iw * p.k + 3) / 4 * 4) * 4;
  p.out_bufs = bufs;
  p.out_bytes = bufs * kFirstWgs * slabs * kWgSlab * p.bn * 2;
  const int budget = kWgSmemLimit - kFirstSlack - p.out_bytes - p.win_bytes;
  if (budget < 2 * p.raw_bytes + (w_all < w_two ? w_all : w_two)) return 1;
  p.w_res = w_all + 2 * p.raw_bytes <= budget;
  if (p.w_res) {
    p.raw_ring = (budget - w_all) / p.raw_bytes;
    if (p.raw_ring > kFirstMaxRaw) p.raw_ring = kFirstMaxRaw;
    p.w_ring = 0;
    p.w_bytes = w_all;
  } else {
    p.raw_ring = 2;
    p.w_ring = (budget - 2 * p.raw_bytes) / p.w_slice;
    if (p.w_ring > kWgMaxRing) p.w_ring = kWgMaxRing;
    while (p.w_ring > 0 &&
           (p.w_ring * p.w_slice + 1023) / 1024 * 1024 > budget - 2 * p.raw_bytes)
      --p.w_ring;
    if (p.w_ring < 2) return 1;
    p.w_bytes = (p.w_ring * p.w_slice + 1023) / 1024 * 1024;
  }
  p.smem = kFirstSlack + p.w_bytes + p.out_bytes + p.win_bytes + p.raw_ring * p.raw_bytes;
  return 0;
}

// Fill p. The block's columns min(npad, 64), else halved down to 8 (N in
// more chunks); at each the slabs first_slabs(bn), then 1; at the first that
// fits, of the columns of kFirstCols the widest whose rows are at least f - 1
// (the window then expands each input row at most twice), else the narrowest
// that fits; at two windows and two output buffers a warpgroup where they
// fit, else one window, else one of each. Returns 0, or 1 for a layer the
// kernel does not take: f, c or n below 1, n not a multiple of 8, or no fit.
inline int first_plan(FirstPlan& p, int f, int c, int n) {
  if (f < 1 || c < 1 || n < 1 || n % 8) return 1;
  p.f = f;
  p.k = c;
  p.n = n;
  p.kx = (f * c + 15) / 16 * 16;
  p.npad = wg_npad(n);
  for (int bn = p.npad < 64 ? p.npad : 64; bn >= 8; bn /= 2) {
    p.bn = bn;
    p.nchunks = p.npad / bn;
    p.w_slice = p.kx * bn * 2;
    for (int slabs = first_slabs(bn); slabs >= 1; slabs = slabs > 1 ? 1 : 0) {
      FirstPlan best = p;
      bool found = false;
      for (int cc : kFirstCols) {
        FirstPlan q = p;
        if (first_fit(q, slabs, cc, 2, 2) && first_fit(q, slabs, cc, 1, 2) &&
            first_fit(q, slabs, cc, 1, 1))
          continue;
        best = q;
        found = true;
        if (q.tile_rows >= f - 1) break;
      }
      if (found) {
        p = best;
        return 0;
      }
    }
  }
  return 1;
}

}  // namespace
