// winograd_plan: the block shape and shared-memory plan of winograd.cu, plain
// C++ so that the launch and a host compiler run the same arithmetic.
// probes/winograd.py mirrors only the limit, kWinoMaxK (its MAX_K), and
// tests/test_torch_winograd_probe.py compiles this header with g++ to hold
// the two equal.
#pragma once

namespace {

constexpr int kWinoTBR = 4, kWinoTBC = 16;     // a block's tiles: 4 rows x 16 columns
constexpr int kWinoTB = kWinoTBR * kWinoTBC;   // 64, 2 warps of 32 tiles
constexpr int kWinoWR = kWinoTBR + 1, kWinoWC = kWinoTBC + 1;  // window cells a parity plane
constexpr int kWinoSmemLimit = 232448;  // dynamic shared bytes a block may opt into (sm_90)
constexpr int kWinoMaxK = 160;          // the most input channels a layer (MAX_K)
constexpr int kWinoLanes = 64;          // bf16 lanes a 128-byte swizzled row holds
// bytes past the buffers: room to align them to 1024 (the 128-byte
// swizzle's period) and the two mbarriers
constexpr int kWinoSlack = 1024 + 16;

// The window of a block's tiles: 2 parity planes x WR x WC cells of 2k bf16.
constexpr int wino_window_bytes(int k) { return 2 * kWinoWR * kWinoWC * 2 * k * 2; }

// One layer launch of k input channels and nb (64 or 128) output channels a
// block, with the window (modes direct and factored) or without it (pre).
// Shared memory, from a 1024-aligned base: [V, two buffers | U, two stages
// | Y, two staging buffers | window | two mbarriers]. V[pos] is kblk blocks
// of 64 tiles x 64 lanes, a U stage nb / 64 blocks of kc rows x 64 columns
// and a Y plane nb / 64 blocks of 64 tiles x 64 channels, each row 128
// bytes whose 16-byte chunks are swizzled (chunk j of row r at j ^ (r %
// 8)), as the tensor copies read and write them.
struct WinoPlan {
  int kp;     // k padded to 16, the mma depth; V's lanes past k are zero
  int kblk;   // 64-lane blocks of V
  int kc;     // rows of U a stage: kp, or kp split evenly into nch multiples of 16
  int nch;    // stages a position
  int win, v, u, y, smem;  // bytes: the window, a V buffer, a U stage, a Y plane, the block
  bool ok;    // k is a positive multiple of 8 up to kWinoMaxK and the plan fits

  WinoPlan(int k, int nb, bool window) {
    kp = (k + 15) / 16 * 16;
    kblk = (kp + kWinoLanes - 1) / kWinoLanes;
    win = window ? wino_window_bytes(k) : 0;
    v = kblk * kWinoTB * 128;
    y = nb * kWinoTB * 2;
    const int row = nb / kWinoLanes * 128;  // bytes of one U row in a stage
    const int room = kWinoSmemLimit - kWinoSlack - win - 2 * v - 2 * y;
    const int kc_max = room > 0 ? room / (2 * row) / 16 * 16 : 0;
    nch = kc_max >= kp ? 1 : (kc_max > 0 ? (kp + kc_max - 1) / kc_max : 0);
    kc = nch > 0 ? ((kp + nch - 1) / nch + 15) / 16 * 16 : 0;
    if (kc > 0) nch = (kp + kc - 1) / kc;  // so that the last stage holds rows
    u = kc * row;
    smem = kWinoSlack + 2 * v + 2 * u + 2 * y + win;
    ok = k > 0 && k % 8 == 0 && k <= kWinoMaxK && (nb == 64 || nb == 128) && kc >= 16 &&
         kc <= 256 && smem <= kWinoSmemLimit;
  }
};

}  // namespace
