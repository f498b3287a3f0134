// wino5_plan: the block shapes and shared-memory plans of wino5.cu, plain C++
// so that the launch and a host compiler run the same arithmetic.
// probes/wino5.py mirrors only the limit, kWino5MaxK (its MAX_K), and
// tests/test_torch_wino5_probe.py compiles this header with g++ to hold the
// two equal.
#pragma once

namespace {

constexpr int kW5TBR = 4, kW5TBC = 32;                 // a block's output quad pixels
constexpr int kW5TB = kW5TBR * kW5TBC;                 // 128 positions, m16 tiles of 16
constexpr int kW5WR = kW5TBR + 2, kW5WC = kW5TBC + 2;  // the window of the quad image: 6 x 34
constexpr int kW5N = 32;                               // output channels
constexpr int kW5SmemLimit = 232448;  // dynamic shared bytes a block may opt into (sm_90)
constexpr int kWino5MaxK = 64;        // the most input channels (MAX_K)

// quad modes: Wq's rows a weight stage, at most, and the stages in flight;
// its columns, 4n = 128, padded by 8 to an odd multiple of 16 bytes
constexpr int kW5QuadStageRows = 128;
constexpr int kW5QuadStages = 3;
constexpr int kW5QuadWS = 4 * kW5N + 8;

// w55f: input channels a chunk; a V_a cell holds its (cp, c) lanes, 2 x 16,
// padded by 8; Wf's columns, (q, n) = 64, padded by 8
constexpr int kW5Chunk = 16;
constexpr int kW5VS = 2 * kW5Chunk + 8;
constexpr int kW5VCells = kW5TBR * kW5WC;                // 4 x 34 cells of V_a
constexpr int kW5VBytes = 6 * kW5VCells * kW5VS * 2;     // V_a of the six a, one chunk
constexpr int kW5WS = 2 * kW5N + 8;
constexpr int kW5WStageBytes = 3 * 2 * kW5Chunk * kW5WS * 2;  // Wf[a] of one chunk, co < 3
constexpr int kW5Bars = 8;                                // mbarriers: V full x 2, W full x 6

// One launch of k input channels. Quad modes, shared memory: [window: 6 x 34
// cells of 4k + 8 bf16 | kW5QuadStages weight stages of kc rows x
// kW5QuadWS]; the tap's 4k rows stream in `steps` stages of kc rows (the
// last may hold fewer).
// w55f: [V: two chunk buffers | W: six stages, one per a | mbarriers].
struct Wino5Plan {
  int as;     // quad: bf16 lanes of a window cell, 4k + 8 (an odd multiple of 16 bytes)
  int kc;     // quad: Wq rows a stage, a multiple of 16
  int steps;  // quad: stages a tap
  int nch;    // w55f: chunks of kW5Chunk input channels
  int win, stage, smem;  // bytes: the quad window, a weight stage, the block
  bool ok;    // k is a positive multiple of 16 up to kWino5MaxK and the plan fits

  Wino5Plan(int k, bool w55f) {
    const int k4 = 4 * k;
    as = k4 + 8;
    steps = (k4 + kW5QuadStageRows - 1) / kW5QuadStageRows;
    kc = steps > 0 ? ((k4 + steps - 1) / steps + 15) / 16 * 16 : 0;
    nch = k / kW5Chunk;
    if (w55f) {
      win = 0;
      stage = kW5WStageBytes;
      smem = 2 * kW5VBytes + 6 * kW5WStageBytes + 8 * kW5Bars;
    } else {
      win = kW5WR * kW5WC * as * 2;
      stage = kc * kW5QuadWS * 2;
      smem = win + kW5QuadStages * stage;
    }
    ok = k > 0 && k % 16 == 0 && k <= kWino5MaxK && smem <= kW5SmemLimit;
  }
};

}  // namespace
