// ffma_plan: the shared-memory arithmetic of the f32 kernels on ffma_stage.cuh
// (tile strides, weight stages, the chain's plan of a layer), plain C++ so
// that the host side of each launch and a host compiler can run it.
// ops/fused/entry.py computes the same numbers: col_stride, weight_stages,
// CHAIN_SHAPE and layer_plan.
#pragma once

#ifdef __CUDACC__
#define FFMA_HD __host__ __device__
#else
#define FFMA_HD
#endif

namespace {

constexpr int kSmemLimit = 232448;  // dynamic shared bytes a block may opt into (sm_90)
constexpr int kSmSmem = 233472;     // shared bytes of an SM
constexpr int kSmReserve = 1024;    // bytes the runtime keeps for each resident block

// The column stride of a tile of `rows` rows read by a layer of f taps and
// PX rows a thread: odd (conflict-free across columns), and long enough
// that a thread's last row block reads inside its column.
FFMA_HD inline int ffma_col_stride(int rows, int f, int px) {
  const int oh = rows - f + 1;
  const int need = (oh + px - 1) / px * px + f - 1;
  const int s = need > rows ? need : rows;
  return s | 1;
}

// How a layer's packed weights pass through wbuf (wbuf_floats, a multiple
// of 4) in the fused kernel: `ck` input channels a chunk, in `stages`
// buffers of ck * per_ch floats.
struct FfmaChunks {
  int ck, stages;
  FFMA_HD FfmaChunks(int k, int per_ch, int wbuf_floats) {
    if (k * per_ch <= wbuf_floats) {
      ck = k;
      stages = 1;
    } else if (2 * per_ch <= wbuf_floats) {
      ck = (wbuf_floats / 2) / per_ch;
      stages = 2;
    } else {
      ck = wbuf_floats / per_ch;
      stages = 1;
    }
  }
};

// The f32 chain's width classes, picked by a layer's n: {NB output
// channels and PX output rows a thread, the most threads a block, the
// blocks an SM its registers and shared memory are sized for, the most
// input channels a stage}. ops/fused/tune.py times other values side by
// side.
constexpr int kChainNarrow[5] = {4, 2, 512, 1, 32};  // n <= 4
constexpr int kChainMid[5] = {8, 4, 256, 2, 16};     // 4 < n <= 64
constexpr int kChainWide[5] = {16, 4, 512, 1, 16};   // n > 64
constexpr int kChainGroups = 8;  // the most NB-column groups a block

// One chain launch of an f x f layer from K to n channels. A block owns a
// tile_h x tile_w output tile and nblk of the npad (n padded to NB)
// columns; each of its `items` threads one item: PX rows of one column for
// NB columns, with the column fastest, then the group, then the row block,
// so that every thread has exactly one item. The input streams through
// shared memory kc input channels a stage, each stage [weights kc x f*f x
// nblk | window kc x plane], the window [c][x][y] with column stride cs
// and an odd channel stride plane; two stages alternate where kc < K. A
// block takes gb groups, the largest divisor of the group count up to
// kChainGroups whose stage of one channel fits, so that a wide f splits N
// over more blocks before it is refused. kc == 0: not even one channel
// fits at gb = 1 (refused). The launch computes it on the host and passes
// it to the kernel by value.
struct ChainPlan {
  int nb, px, threads, blocks, kcmax;
  int npad, gb, nsplit, nblk;
  int tile_h, tile_w, items;
  int ih, iw, cs, plane;
  int kc, stages, stage_floats, smem;

  ChainPlan(int f, int K, int n) {
    const int* c = n <= 4 ? kChainNarrow : n <= 64 ? kChainMid : kChainWide;
    nb = c[0];
    px = c[1];
    threads = c[2];
    blocks = c[3];
    kcmax = c[4];
    npad = (n + nb - 1) / nb * nb;
    const int groups = npad / nb;
    const int share = kSmSmem / blocks - kSmReserve;
    const int budget = share < kSmemLimit ? share : kSmemLimit;
    for (int d = groups < kChainGroups ? groups : kChainGroups; d >= 1; --d) {
      if (groups % d) continue;
      set_groups(f, d, groups);
      kc = fit(f, K, budget);
      if (kc == 0) kc = fit(f, K, kSmemLimit);  // a block alone on its SM
      if (kc > 0) break;
    }
    if (kc > 0) {
      const int chunks = (K + kc - 1) / kc;
      kc = (K + chunks - 1) / chunks;  // even chunks
    }
    set_kc(f, K, kc);
  }

  // the block's tile for gb groups: a warp spans 32 columns of one group,
  // or 16 columns of two groups
  void set_groups(int f, int gb_, int groups) {
    gb = gb_;
    nsplit = groups / gb;
    nblk = gb * nb;
    tile_w = gb == 1 ? 32 : 16;
    const int rb_max = (32 + px - 1) / px;
    int rb = threads / (gb * tile_w);
    rb = rb < rb_max ? rb : rb_max;
    tile_h = rb * px;
    items = gb * rb * tile_w;
    ih = tile_h + f - 1;
    iw = tile_w + f - 1;
    cs = ffma_col_stride(ih, f, px);
    plane = (iw * cs) | 1;
  }

  // shared floats of one stage of kc channels (16-byte aligned)
  int stage_of(int f, int kc_) const {
    return (kc_ * (f * f * nblk + plane) + 3) / 4 * 4;
  }
  int bytes_of(int f, int K, int kc_) const {
    return 4 * (kc_ < K ? 2 : 1) * stage_of(f, kc_);
  }
  // the most channels a stage (up to kcmax and K) whose stages fit budget
  int fit(int f, int K, int budget) const {
    int k = K < kcmax ? K : kcmax;
    while (k > 0 && bytes_of(f, K, k) > budget) --k;
    return k;
  }
  void set_kc(int f, int K, int kc_) {
    kc = kc_;
    stages = kc < K ? 2 : 1;
    stage_floats = stage_of(f, kc);
    smem = kc > 0 ? bytes_of(f, K, kc) : 0;
  }
};

}  // namespace
