// xpack_plan: the tap tables, tile shape and shared-memory plan of xpack.cu,
// plain C++ so that the launch and a host compiler run the same arithmetic.
// probes/xpack.py mirrors it as plan(), and tests/test_torch_xpack_probe.py
// compiles this header with g++ to hold the two equal.
#pragma once

namespace {

constexpr int kXpackRows = 64;        // output positions a tile: one m64 wgmma
// a consumer warpgroup computes kXpackLanes / N steps at once: 128 f32 sums
// a thread at every N
constexpr int kXpackLanes = 256;
constexpr int kXpackMaxChunks = 8;
constexpr int kXpackMaxKSteps = 128;  // k-steps of 32 lanes a launch, over all chunks
constexpr int kXpackKStep = 32;
constexpr int kXpackMaxRing = 16;     // ring stages, at most
constexpr int kXpackTapInts = 6;      // dr, dc, l0, K, w0, chunk
constexpr int kXpackSmemLimit = 232448;  // dynamic shared bytes a block may opt into (sm_90)
// an A box: 64 positions x 64 lanes (128 bytes) of the operand
constexpr int kXpackBox = kXpackRows * 128;
// bytes past the buffers: room to align them to 1024 (the swizzles'
// period) and the mbarriers (full and empty a ring stage, A's and W's)
constexpr int kXpackSlack = 1024 + 8 * (2 * kXpackMaxRing + 4);

// A box: the operand at rows r0 + dr.., columns x0 + dc.., lanes lane ..
// lane + 63 for the tile at (r0, x0)
struct XpackBox {
  int dr, dc, lane;
};
// A slice: 32 lanes of a box (its first or second half) over k16 = 1 or 2
// steps of 16, against weight rows w_row ..
struct XpackSlice {
  int box, half, w_row, k16;
};

// One launch's plan. Chunk j's slices are [slice_begin[j], slice_begin[j +
// 1]), its boxes (the distinct ones its slices read) [box_begin[j], ..).
// A tile is tr rows x tc columns of the output, 64 positions; tiles_c tiles
// make a row of them, tiles the output. Shared memory,
// from a 1024-aligned base: [A | W | ring | output staging | zeros |
// mbarriers], the zeros 16 rows of weights that a slice's missing second
// k16 step multiplies (so that every slice issues the same products). A
// (a_res) holds a tile's boxes of one chunk, W (w_res) a chunk's slices of
// weights; what is not resident streams through the ring, a stage a slice
// (its box, its weights, or both). The staging holds out_stages outputs of
// each consumer warpgroup, kXpackLanes / N steps each.
struct XpackPlan {
  int n, tc, tr, tiles_c, tiles, chunks, boxes, slices;  // boxes, slices: a chunk's most
  int a_res, w_res, ring, out_stages;
  int wslice, stage;  // bytes: a slice's weights (32 rows x N), a ring stage
  int a_bytes, w_bytes, ring_bytes, out_bytes, zero_bytes, smem;
  int box_begin[kXpackMaxChunks + 1], slice_begin[kXpackMaxChunks + 1];
  XpackBox box[kXpackMaxKSteps];
  XpackSlice slice[kXpackMaxKSteps];
};

// Fill p for a launch of N = n over an (R, C, L) operand and w_rows weight
// rows into out_rows x out_cols positions and `chunks` chunks, from ntaps taps
// of kXpackTapInts ints. Each chunk's taps in their order, each tap's lanes in
// boxes of 64 and slices of 32. Returns 0, or 1 for taps the kernel does not take: a lane
// offset or K not a multiple of 8 and 16, a tap that reads outside the
// operand or w, a chunk without taps, more than kXpackMaxKSteps k-steps
// (and more than 2^31 - 1 tiles).
inline int xpack_plan(XpackPlan& p, int n, int R, int C, int L, int w_rows, int out_rows,
                      int out_cols, int chunks, const int* taps, int ntaps) {
  if (chunks <= 0 || chunks > kXpackMaxChunks) return 1;
  p.n = n;
  p.chunks = chunks;
  p.tc = 1;
  while (p.tc < out_cols && p.tc < kXpackRows) p.tc *= 2;
  p.tr = kXpackRows / p.tc;
  p.tiles_c = (out_cols + p.tc - 1) / p.tc;
  const long long tiles = static_cast<long long>(p.tiles_c) * ((out_rows + p.tr - 1) / p.tr);
  if (tiles > 0x7fffffffLL) return 1;
  p.tiles = static_cast<int>(tiles);
  int ksteps = 0, nb = 0, ns = 0;
  p.boxes = p.slices = 0;
  for (int j = 0; j < chunks; ++j) {
    p.box_begin[j] = nb;
    p.slice_begin[j] = ns;
    for (int t = 0; t < ntaps; ++t) {
      const int* tp = taps + kXpackTapInts * t;
      const int dr = tp[0], dc = tp[1], l0 = tp[2], K = tp[3], w0 = tp[4], cj = tp[5];
      if (cj < 0 || cj >= chunks) return 1;
      if (cj != j) continue;
      if (dr < 0 || dc < 0 || l0 < 0 || w0 < 0 || K <= 0 || K % 16 || l0 % 8 ||
          dr + out_rows > R || dc + out_cols > C || l0 + K > L || w0 + K > w_rows)
        return 1;
      ksteps += (K + kXpackKStep - 1) / kXpackKStep;
      if (ksteps > kXpackMaxKSteps) return 1;
      for (int k = 0; k < K; k += kXpackKStep) {
        const int lane = l0 + k / 64 * 64;
        int b = p.box_begin[j];
        while (b < nb && !(p.box[b].dr == dr && p.box[b].dc == dc && p.box[b].lane == lane)) ++b;
        if (b == nb) p.box[nb++] = XpackBox{dr, dc, lane};
        p.slice[ns++] =
            XpackSlice{b - p.box_begin[j], k / 32 % 2, w0 + k, (K - k < 32 ? K - k : 32) / 16};
      }
    }
    if (ns == p.slice_begin[j]) return 1;
    if (nb - p.box_begin[j] > p.boxes) p.boxes = nb - p.box_begin[j];
    if (ns - p.slice_begin[j] > p.slices) p.slices = ns - p.slice_begin[j];
  }
  p.box_begin[chunks] = nb;
  p.slice_begin[chunks] = ns;

  // residency: A and W both, with two output stages or one; else A with W
  // through the ring; else both through it
  p.wslice = kXpackKStep * n * 2;
  const int a = p.boxes * kXpackBox, w = p.slices * p.wslice;
  const int out = 2 * kXpackLanes * kXpackRows * 2;  // an output stage, both warpgroups
  p.zero_bytes = 16 * n * 2 < 1024 ? 1024 : 16 * n * 2;
  const int budget = kXpackSmemLimit - kXpackSlack - p.zero_bytes;
  p.a_res = p.w_res = 1;
  p.ring = 0;
  p.stage = 0;
  if (a + w + 2 * out <= budget) {
    p.out_stages = 2;
  } else if (a + w + out <= budget) {
    p.out_stages = 1;
  } else {
    p.out_stages = 1;
    p.w_res = 0;
    if (a + out + 2 * p.wslice > budget) p.a_res = 0;
    p.stage = (p.a_res ? 0 : kXpackBox) + p.wslice;
    p.ring = (budget - (p.a_res ? a : 0) - out) / p.stage;
    if (p.ring > kXpackMaxRing) p.ring = kXpackMaxRing;
  }
  p.a_bytes = p.a_res ? a : 0;
  p.w_bytes = p.w_res ? w : 0;
  p.ring_bytes = p.ring * p.stage;
  p.out_bytes = p.out_stages * out;
  p.smem = kXpackSlack + p.a_bytes + p.w_bytes + p.ring_bytes + p.out_bytes + p.zero_bytes;
  return 0;
}

}  // namespace
