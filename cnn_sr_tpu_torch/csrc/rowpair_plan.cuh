// rowpair_plan: the tile and shared-memory plan of rowpair.cu, plain C++ so
// that the launch and a host compiler run the same arithmetic.
// probes/rowpair.py mirrors it as plan(), and tests/test_torch_rowpair_probe.py
// compiles this header with g++ to hold the two equal.
#pragma once

namespace {

constexpr int kRowpairBM = 128;         // positions (A rows) a tile: two warpgroups of 64
// bytes a ring stage: 128 bytes of lanes of each of a tile's positions
constexpr int kRowpairStage = kRowpairBM * 128;
// ring stages: two of 16 KB in flight a block stream fastest (3, 4 and 8
// were slower at the flagship's 1080p exit; probes/rowpair_parts.py)
constexpr int kRowpairStages = 2;
constexpr int kRowpairSmemLimit = 232448;  // dynamic shared bytes a block may opt into (sm_90)
// bytes past the buffers: room to align them to 1024 (the 128-byte
// swizzle's period) and the mbarriers (full and empty a stage, W's)
constexpr int kRowpairSlack = 1024 + 8 * (2 * kRowpairStages + 1);

// One launch over lanes L (64 or 128); A's element type changes only how
// many stages a tile takes (L esize / 128). Shared memory, from a
// 1024-aligned base: [W | ring | Y staging | mbarriers]. W is L x L bf16 as
// L / 64 blocks of L K-rows x 64 N-lanes; a ring stage 128 bytes of lanes (64 bf16, 32 f32) of
// a tile's 128 positions, one block of 128 rows x 128 bytes; the staging two
// halves, one a consumer warpgroup, each L / 32 blocks of 64 positions x 32
// f32. Every block is rows of 128 bytes whose 16-byte chunks are swizzled by
// the row (the tensor copies' 128-byte swizzle).
struct RowpairPlan {
  int stage;   // bytes of a ring stage
  int stages;  // ring stages
  int w, ys, smem;  // bytes: W, the staging (both halves), the block

  explicit RowpairPlan(int L) {
    stage = kRowpairStage;
    stages = kRowpairStages;
    w = L * L * 2;
    ys = kRowpairBM * L * 4;
    smem = kRowpairSlack + w + stages * stage + ys;
  }
};

}  // namespace
