// fused_wgmma_plan: the tile and shared-memory plan of fused_wgmma.cu, plain
// C++ so that the launch and a host compiler run the same arithmetic.
// ops/fused/entry.py mirrors it as fused_wgmma_plan(), and
// tests/test_torch_fused_wgmma.py compiles this header with g++ to hold the
// two equal.
#pragma once

namespace {

constexpr int kFwConsumers = 3;  // consumer warpgroups: they share a tile's patches and chunks
constexpr int kFwMaxA2 = 32;     // the conv2 tile's side at most: 16 patches of 8 x 8
// and at least: below 24 x 24 the halo recompute outweighs what fusion
// saves, and such a stack takes the chain
constexpr int kFwMinA2 = 24;
// conv2 sums a thread holds at most (a warpgroup's patches x N / 2)
constexpr int kFwAccFloats = 96;
constexpr int kFwMaxRing = 8;  // w2 tap slices in flight at most
constexpr int kFwSmemLimit = 232448;  // dynamic shared bytes a block may opt into (sm_90)
// the mbarriers: the resident weights', the pixel stage's full and empty,
// and a full and an empty per ring slot
constexpr int kFwBarBytes = 8 * (3 + 2 * kFwMaxRing);

// padded widths, as ops/fused/entry.py computes them: N to 8, 16, 32, 64 or
// a multiple of 128; K to that and at least 16; the first layer's K to the
// dx-expanded window's f * c lanes rounded up to 16
inline int fw_npad(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : (n + 127) / 128 * 128;
}
inline int fw_kpad(int k) { return fw_npad(k) < 16 ? 16 : fw_npad(k); }
inline int fw_max(int a, int b) { return a > b ? a : b; }

// the conv2 patches a warpgroup may hold at N2 columns (its sums' registers)
inline int fw_max_patches(int n2p) {
  const int p = kFwAccFloats / (n2p / 2);
  return p < 6 ? p : 6;
}

// One launch's plan for the stack (f1, c -> n1), (f2, n1 -> n2), (f3, n2 ->
// n3). Output tiles of `tile` x `tile` positions; conv2 computes the a2 x a2
// tile around it (a2 a multiple of 8: patches = (a2 / 8)^2 patches of 8 x 8
// positions, per_wg a warpgroup at most), conv1 the a1 x a1 tile around that
// in chunks1 raster chunks of 64 positions, from the dx-expanded window of
// ih rows x a1 columns; conv3 the output rows in chunks3 raster chunks of 64
// positions a2 wide, its f3 dx taps side by side in N (n3p = npad(f3 n3)
// columns, column dx n3 + c) and its f3 dy taps start offsets, the sums of
// the dx taps' columns, e_bytes of f32, shifted and added afterwards.
// Activations are planes of 8 lanes, a 16-byte row a position: the window
// win_pos positions (the chunks read past its ih x a1), a1 its a1 x a1, a2
// a2_pos (conv3's chunks read past its a2 x a2). The tile's ih x (a1 + f1
// - 1) input pixels arrive as f32 (raw_bytes) while the tile before is
// computed. Shared memory, in bytes from the base: window (later a2, r0
// bytes) | w1 | a1 (later conv3's sums, r1 bytes) | w3 | pixels | ring of
// `ring` w2 tap slices of `slice` bytes | mbarriers.
struct FusedWgmmaPlan {
  int c, f1, n1, f2, n2, f3, n3;
  int kx, n1p, k2, n2p, k3, n3p;  // K a tap and N of conv1, conv2, conv3
  int tile, a2, a1, ih;
  int chunks1, patches, per_wg, chunks3;
  int win_pos, a2_pos;
  int win_bytes, w1_bytes, a2_bytes, r0, a1_bytes, e_bytes, r1, w3_bytes, raw_bytes, slice;
  int ring, smem;
};

// Fill p. Returns 0, or 1 for a stack the kernel does not take: c outside 1
// .. 4, an f or n below 1, n1 padded past 128, f3 n3 past 32, or no a2 of
// kFwMinA2 .. kFwMaxA2 whose patches fit a warpgroup's sums and whose buffers, with
// two ring slots (one where f2 = 1), fit the shared memory. The largest a2
// that fits is taken.
inline int fused_wgmma_plan(FusedWgmmaPlan& p, int c, int f1, int n1, int f2, int n2, int f3,
                            int n3) {
  if (c < 1 || c > 4 || f1 < 1 || f2 < 1 || f3 < 1 || n1 < 1 || n2 < 1 || n3 < 1 ||
      f3 * n3 > 32)
    return 1;
  p.c = c;
  p.f1 = f1;
  p.n1 = n1;
  p.f2 = f2;
  p.n2 = n2;
  p.f3 = f3;
  p.n3 = n3;
  p.kx = (f1 * c + 15) / 16 * 16;
  p.n1p = fw_npad(n1);
  p.k2 = fw_kpad(n1);
  p.n2p = fw_npad(n2);
  p.k3 = fw_kpad(n2);
  p.n3p = fw_npad(f3 * n3);
  if (p.n1p > 128) return 1;
  const int taps2 = f2 * f2;
  for (int a2 = kFwMaxA2; a2 >= kFwMinA2; a2 -= 8) {
    const int tile = a2 - f3 + 1;
    const int patches = (a2 / 8) * (a2 / 8);
    const int per_wg = (patches + kFwConsumers - 1) / kFwConsumers;
    if (tile < 1 || per_wg > fw_max_patches(p.n2p)) continue;
    const int a1 = a2 + f2 - 1, ih = a1 + f1 - 1;
    const int chunks1 = (a1 * a1 + 63) / 64;
    const int chunks3 = (tile * a2 + 63) / 64;
    const int win_reach = chunks1 * 64 + (f1 - 1) * a1;
    const int a2_reach = chunks3 * 64 + (f3 - 1) * a2;
    const int win_pos = fw_max(ih * a1, win_reach);
    const int a2_pos = fw_max(a2 * a2, a2_reach);
    const int win_bytes = win_pos * p.kx * 2, w1_bytes = f1 * p.kx * p.n1p * 2;
    const int a2_bytes = a2_pos * p.k3 * 2;
    const int r0 = fw_max(win_bytes, a2_bytes);
    const int a1_bytes = a1 * a1 * p.k2 * 2, e_bytes = chunks3 * 64 * p.n3p * 4;
    const int r1 = fw_max(a1_bytes, e_bytes);
    const int raw_bytes = (ih * (a1 + f1 - 1) * c * 4 + 15) / 16 * 16;
    const int w3_bytes = f3 * p.k3 * p.n3p * 2;
    const int slice = p.k2 * p.n2p * 2;
    const int fixed = r0 + w1_bytes + r1 + w3_bytes + raw_bytes + kFwBarBytes;
    int ring = (kFwSmemLimit - fixed) / slice;
    if (ring > kFwMaxRing) ring = kFwMaxRing;
    if (ring > taps2) ring = taps2;
    if (ring < (taps2 < 2 ? taps2 : 2)) continue;
    p.tile = tile;
    p.a2 = a2;
    p.a1 = a1;
    p.ih = ih;
    p.chunks1 = chunks1;
    p.patches = patches;
    p.per_wg = per_wg;
    p.chunks3 = chunks3;
    p.win_pos = win_pos;
    p.a2_pos = a2_pos;
    p.win_bytes = win_bytes;
    p.w1_bytes = w1_bytes;
    p.a2_bytes = a2_bytes;
    p.r0 = r0;
    p.a1_bytes = a1_bytes;
    p.e_bytes = e_bytes;
    p.r1 = r1;
    p.w3_bytes = w3_bytes;
    p.raw_bytes = raw_bytes;
    p.slice = slice;
    p.ring = ring;
    p.smem = fixed + ring * slice;
    return 0;
  }
  return 1;
}

}  // namespace
