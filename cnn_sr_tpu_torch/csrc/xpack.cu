// tap_gemm_bf16: for each output chunk j and each step s,
//   out[s, m, j N : (j + 1) N] = bf16_rn(relu(sum over the taps t of chunk j of
//       a[r + dr_t, x + dc_t, l0_t : l0_t + K_t] @ w[w0_t : w0_t + K_t, 0 : N]))
// with m = r out_cols + x, bf16 operands and f32 sums: a GEMM whose A operand is
// a list of shifted windows ("taps") of one (R, C, L) bf16 operand.
//
// Replaces the TPU kernels of tools/xpack_probe.py (pl.pallas_call at :114,
// bodies sep_body :60 and xpack_body :74) and tools/xpack_probe2.py
// (pl.pallas_call at :172, bodies sep_body :74, xpk_body :93 and
// xpk32t32s_body :147). Both probes time a pattern of dots at the RGB model's
// L2-L4 widths (32->32, 32->64, 64->64): the separated form (three row-shifted
// dots of K = 3k into N = n output lanes) against forms that pack P = 128/n
// positions or G = 4 rows into 128 lanes (more multiply-adds, full MXU lanes).
// Every variant is a tap list: probe 1 has C = 1 and every offset 0, its sep
// forms' taps differ only in the weight rows; probe 2's sep taps are row
// offsets dy, its packed taps column offsets dx with lane windows per 128-lane
// output chunk (xpk32t64o reads lanes 64:192). Each grid step of the probe
// recomputes the same block from operands resident in VMEM; here each step
// is computed again into its own slab of a (steps, *out) output.
//
// What bounds it: at one 1080p layer's worth of steps the multiply-adds take
// 0.04-0.21 ms at the bf16 tensor-core peak and the bf16 output 0.04-0.08 ms
// at 3.35 TB/s: the sep forms into 32 or 64 lanes at K = 96 are bound by the
// store, the rest by operations. Reading the operand and weights again for
// every step, from L2, binds before either (1.3-3.5 GB a launch at about 4
// TB/s): so they stay in shared memory across steps.
//
// What the design does (plan: xpack_plan.cuh):
// * a persistent grid, one block an SM, each block a run of about items /
//   SMs of the items (chunk, tile, step), steps fastest, so that it holds a
//   (chunk, tile) pair for a run of steps. A tile is 64 output positions, tr
//   rows x tc columns (tc the power of two >= out_cols, at most 64);
// * a tap's A operand for a tile is a tensor copy of one box of 64 lanes per
//   64 of its K, at its row, column and lane offsets from the tile's corner
//   (a 3-D map over (L, C, R); what lies outside the operand arrives as
//   zeros), in the 128-byte swizzle wgmma reads K-major: a shift by a column
//   or by 8 lanes is a coordinate of the copy, not an address in shared
//   memory, and wgmma reads every A by descriptor (A fed from registers by
//   ldmatrix, which a shifted window in one buffer would need, is timed
//   against it by probes/xpack_parts.py). Taps reading the same box share it
//   (probe 1's sep taps all read one). The chunk's weights are slices of
//   32 rows x N, MN-major (the row-major w as it is), 128-byte swizzled, or
//   64-byte at N = 32;
// * one producer thread loads the tile's boxes (A) once a pair and the
//   chunk's slices (W) once a chunk; what does not fit beside the rest
//   (W at 144-192 KB a chunk, or also A) streams through a ring, a stage a
//   slice, once a pass. A streams only so that tap lists of up to the
//   contract's 128 k-steps, whose boxes do not fit beside an output stage,
//   are still taken: no variant of the probes and not the ragged case
//   streams A; xpack.streamed() is the case that exercises it;
// * two consumer warpgroups take the pair's steps in turns, 256 / N a pass
//   each (128 f32 sums a thread; the pass's last steps past the pair's are
//   computed and not stored): for every step its own wgmma m64nNk16 per
//   k16 of every slice, f32 sums in registers, one set a step;
// * each warpgroup rounds its steps' ReLU'd tiles to bf16 into its staging
//   (64-position rows in the weights' swizzle) and one thread stores them by
//   tensor copies (positions past the output are not written) while the
//   next pass's products run; out_stages stagings a warpgroup where they fit.
//   The output is the only stream to device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"
#include "xpack_plan.cuh"

namespace {

// two consumer warpgroups and a producer warpgroup, whose registers go to
// the consumers (setmaxnreg: 128 x 56 + 256 x 224 = 384 x 168)
constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2 * kWarpgroup, kThreads = kConsumers + kWarpgroup;
constexpr int kConsumerRegs = 224, kProducerRegs = 56;
static_assert(kConsumers * kConsumerRegs + kWarpgroup * kProducerRegs <=
                  65536 / kThreads / 8 * 8 * kThreads,
              "the registers handed over fit the block's");
constexpr int kWarps = kConsumers / 32;  // arrivals that empty a buffer, one a consumer warp

// N's swizzled rows: 128 bytes (64 lanes) at N >= 64, 64 bytes (32 lanes) at
// N = 32, in kBlocks blocks a row of N: a slice of weights is kBlocks
// blocks of 32 such rows, a step's staged output kBlocks of 64
template <int N>
struct Width {
  static constexpr int kRow = N < 64 ? 2 * N : 128;
  static constexpr int kLanes = kRow / 2;
  static constexpr int kBlocks = N / kLanes;
  static constexpr int kWBlock = kXpackKStep * kRow;
  static constexpr int kOutBlock = kXpackRows * kRow;
  static constexpr int kOut = kBlocks * kOutBlock;  // a step's output tile
  static constexpr int kGroup = kXpackLanes / N;      // steps a warpgroup computes at once
};

// the descriptor of 16 weight rows at addr: MN-major, blocks of N's lanes
// `lbo` bytes apart
template <int N>
__device__ __forceinline__ unsigned long long b_desc(unsigned addr, unsigned lbo) {
  if constexpr (N == 32)
    return wgmma_desc_sw64(addr, lbo, 512);
  else
    return wgmma_desc(addr, lbo, 1024);
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], unsigned long long da,
                                       unsigned long long db, int scale_d) {
  if constexpr (N == 128)
    wgmma_m64n128k16_ss(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_m64n64k16_ss(d, da, db, scale_d);
  else
    wgmma_m64n32k16_ss(d, da, db, scale_d);
}

// byte offset of lane c (even) of row r in a block of N's swizzled rows
template <int N>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (N == 32)
    return r * 64 + ((((c >> 3) ^ (r >> 1)) & 3) << 4) + (c & 7) * 2;
  else
    return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ unsigned relu_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  return *reinterpret_cast<const unsigned*>(&h);
}

// A block's items [i, hi) of chunks x tiles x steps (steps fastest), walked a
// (chunk, tile) pair's run of steps [s0, s1) at a time
struct Walk {
  long long i, hi;
  int steps, tiles;
  int chunk, tile, s0, s1;

  __device__ bool next() {
    if (i >= hi) return false;
    const long long pair = i / steps;
    s0 = static_cast<int>(i % steps);
    s1 = hi - i < steps - s0 ? s0 + static_cast<int>(hi - i) : steps;
    i += s1 - s0;
    chunk = static_cast<int>(pair / tiles);
    tile = static_cast<int>(pair % tiles);
    return true;
  }
  // whether the pair just walked is its chunk's last in this block
  __device__ bool chunk_ends() const { return i >= hi || i / steps / tiles != chunk; }
};

// passes over a pair's n steps: the two warpgroups take G = 256 / N each
template <int N>
__device__ __forceinline__ int passes(int n) {
  constexpr int G = Width<N>::kGroup;
  return (n + 2 * G - 1) / (2 * G);
}

// W's slice at weight row `row` into dst, block by block
template <int N>
__device__ __forceinline__ void load_w(unsigned char* dst, const CUtensorMap* tw, int row,
                                       unsigned long long* bar) {
#pragma unroll
  for (int b = 0; b < Width<N>::kBlocks; ++b)
    tma_load_2d(dst + b * Width<N>::kWBlock, tw, b * Width<N>::kLanes, row, bar);
}

// ta: the operand as (L, C, R), box (64, tc, tr); tw: w as (N, w_rows), box
// (N's lanes, 32); to: out as (chunks N, out_cols, out_rows, steps), box (N's
// lanes, tc, tr, 1). kRing: something streams through the ring (p.ring > 0).
template <int N, bool kRing>
__global__ void __launch_bounds__(kThreads, 1)
    tap_gemm_kernel(const __grid_constant__ XpackPlan p, long long items, int steps,
                    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap to) {
  using Wd = Width<N>;
  constexpr int G = Wd::kGroup;
  extern __shared__ uint4 smem4[];
  // [A | W | ring | staging | mbarriers] from a 1024-aligned base
  unsigned char* abuf = reinterpret_cast<unsigned char*>(smem4) +
                        ((1024 - smem_addr(smem4) % 1024) % 1024);
  unsigned char* wbuf = abuf + p.a_bytes;
  unsigned char* ring = wbuf + p.w_bytes;
  unsigned char* obuf = ring + p.ring_bytes;
  unsigned char* zeros = obuf + p.out_bytes;
  auto* full = reinterpret_cast<unsigned long long*>(zeros + p.zero_bytes);
  auto* empty = full + kXpackMaxRing;
  auto* a_full = empty + kXpackMaxRing;
  auto* a_empty = a_full + 1;
  auto* w_full = a_full + 2;
  auto* w_empty = a_full + 3;
  if (threadIdx.x == 0) {
    // full when the producer's copies have landed, empty when every
    // consumer warp is done with it
    for (int s = 0; s < p.ring; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, kWarps);
    mbar_init(w_full, 1);
    mbar_init(w_empty, kWarps);
    fence_mbar_init();
  }
  for (int i = threadIdx.x; i < p.zero_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(zeros)[i] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();  // the zeros, before wgmma reads them
  __syncthreads();
  const long long lo = items * blockIdx.x / gridDim.x, hi = items * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x >= kConsumers) {
    // The producer: a chunk's W once, a pair's A once, then every pass's
    // streamed slices into the ring's next stage once the consumers have
    // emptied it
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      Walk wk{lo, hi, steps, p.tiles};
      int it = 0, na = 0, nw = 0, loaded = -1;
      while (wk.next()) {
        const int r0 = wk.tile / p.tiles_c * p.tr, x0 = wk.tile % p.tiles_c * p.tc;
        const int sb = p.slice_begin[wk.chunk], se = p.slice_begin[wk.chunk + 1];
        const int bb = p.box_begin[wk.chunk], be = p.box_begin[wk.chunk + 1];
        if (p.w_res && wk.chunk != loaded) {
          mbar_wait_or_trap(w_empty, (nw & 1) ^ 1);
          mbar_arrive_expect_tx(w_full, (se - sb) * p.wslice);
          for (int j = sb; j < se; ++j)
            load_w<N>(wbuf + (j - sb) * p.wslice, &tw, p.slice[j].w_row, w_full);
          ++nw;
          loaded = wk.chunk;
        }
        if (p.a_res) {
          mbar_wait_or_trap(a_empty, (na & 1) ^ 1);
          mbar_arrive_expect_tx(a_full, (be - bb) * kXpackBox);
          for (int b = bb; b < be; ++b)
            tma_load_3d(abuf + (b - bb) * kXpackBox, &ta, p.box[b].lane, x0 + p.box[b].dc,
                        r0 + p.box[b].dr, a_full);
          ++na;
        }
        if (kRing) {
          for (int q = passes<N>(wk.s1 - wk.s0); q > 0; --q)
            for (int j = sb; j < se; ++j, ++it) {
              const int s = it % p.ring;
              unsigned char* st = ring + s * p.stage;
              mbar_wait_or_trap(empty + s, ((it / p.ring) & 1) ^ 1);
              mbar_arrive_expect_tx(full + s, p.stage);
              if (!p.a_res) {
                const XpackBox bx = p.box[bb + p.slice[j].box];
                tma_load_3d(st, &ta, bx.lane, x0 + bx.dc, r0 + bx.dr, full + s);
                st += kXpackBox;
              }
              load_w<N>(st, &tw, p.slice[j].w_row, full + s);
            }
        }
      }
    }
    return;
  }

  // The consumers: in pass q of a pair, warpgroup g computes its steps s0 +
  // (2 q + g) G .. + G - 1 (those past s1 are computed, not stored), each
  // into its own sums. The products of a slice issue without a branch
  // (a missing k16 step multiplies the zeros), so that the compiler keeps
  // them in flight; g is read from lane 0 so that it is warp-uniform.
  setmaxnreg_inc<kConsumerRegs>();
  const int g = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroup, 0);
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = threadIdx.x % 32;
  const int rr = warp * 16 + lane / 4, q2 = (lane % 4) * 2;  // rows rr, rr + 8; lanes q2, q2 + 1
  const unsigned long long zero_desc = b_desc<N>(smem_addr(zeros), 16 * Wd::kRow);
  float acc[G][N / 2];
#pragma unroll
  for (int t = 0; t < G; ++t)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[t][e] = 0.f;
  const auto fence_acc = [&] {
#pragma unroll
    for (int t = 0; t < G; ++t)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) wgmma_fence_operand(acc[t][e]);
  };
  const auto release = [&](unsigned long long* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  Walk wk{lo, hi, steps, p.tiles};
  int it = 0, na = 0, nw = 0, loaded = -1, op = 0;
  while (wk.next()) {
    const int r0 = wk.tile / p.tiles_c * p.tr, x0 = wk.tile % p.tiles_c * p.tc;
    const int sb = p.slice_begin[wk.chunk], se = p.slice_begin[wk.chunk + 1];
    if (p.w_res && wk.chunk != loaded) {
      mbar_wait_or_trap(w_full, nw & 1);
      ++nw;
      loaded = wk.chunk;
    }
    if (p.a_res) mbar_wait_or_trap(a_full, na++ & 1);
    const int groups = (wk.s1 - wk.s0 + G - 1) / G;  // of G steps, taken in turns
    const int mine = (groups - g + 1) / 2;
    for (int q = 0; q < mine; ++q) {
      const int first = wk.s0 + (2 * q + g) * G;
      int prev = 0;  // the ring stage of the slice before
      fence_acc();
      for (int j = sb; j < se; ++j) {
        const int s = kRing ? it % p.ring : 0;
        unsigned char* st = ring + s * p.stage;
        if (kRing) mbar_wait_or_trap(full + s, (it / p.ring) & 1);
        const XpackSlice sl = p.slice[j];
        const unsigned a_addr =
            smem_addr(p.a_res ? abuf + sl.box * kXpackBox : st) + sl.half * 64;
        const unsigned w_addr = smem_addr(p.w_res ? wbuf + (j - sb) * p.wslice
                                                  : st + (p.a_res ? 0 : kXpackBox));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          // lanes kk 16 .. + 15 of the slice: 32 bytes into each swizzled A
          // row, 8-row groups 1024 bytes apart; W's rows kk 16 .. + 15
          const unsigned long long da = wgmma_desc(a_addr + kk * 32, 16, 1024);
          const unsigned long long db =
              kk < sl.k16 ? b_desc<N>(w_addr + kk * 16 * Wd::kRow, Wd::kWBlock) : zero_desc;
          const int scale = j != sb || kk != 0;  // the pass's first product overwrites
#pragma unroll
          for (int t = 0; t < G; ++t) mma_ss<N>(acc[t], da, db, scale);
        }
        wgmma_commit();
        if constexpr (kRing) {
          // a stage is released once the products that read it are done:
          // the slice before's, keeping this one's in flight
          wgmma_wait<1>();
          fence_acc();
          if (j > sb) release(empty + prev);
          prev = s;
          ++it;
        }
      }
      wgmma_wait<0>();
      fence_acc();
      if (kRing) release(empty + prev);

      // the epilogue: ReLU, bf16, into this warpgroup's next staging once
      // the copies out of it have read it, then one tensor copy a block
      const int count = wk.s1 - first < G ? wk.s1 - first : G;
      unsigned char* ob = obuf + ((g * p.out_stages + op % p.out_stages) * G) * Wd::kOut;
      ++op;
      if (tid == 0) {
        if (p.out_stages == 2)
          bulk_wait_read<1>();
        else
          bulk_wait_read<0>();
      }
      bar_sync(1 + g, kWarpgroup);
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (t < count) {
#pragma unroll
          for (int c8 = 0; c8 < N / 8; ++c8) {
            unsigned char* blk = ob + t * Wd::kOut + (c8 * 8 / Wd::kLanes) * Wd::kOutBlock;
            const int c = c8 * 8 % Wd::kLanes + q2;
            *reinterpret_cast<unsigned*>(blk + swz<N>(rr, c)) =
                relu_bf16x2(acc[t][4 * c8], acc[t][4 * c8 + 1]);
            *reinterpret_cast<unsigned*>(blk + swz<N>(rr + 8, c)) =
                relu_bf16x2(acc[t][4 * c8 + 2], acc[t][4 * c8 + 3]);
          }
        }
      }
      fence_proxy_async();
      bar_sync(1 + g, kWarpgroup);
      if (tid == 0) {
        for (int t = 0; t < count; ++t)
#pragma unroll
          for (int b = 0; b < Wd::kBlocks; ++b)
            tma_store_4d(&to, ob + t * Wd::kOut + b * Wd::kOutBlock,
                         wk.chunk * N + b * Wd::kLanes, x0, r0, first + t);
        bulk_commit();
      }
    }
    // a pass without steps of this warpgroup (the pair's last, at most)
    // still empties the ring stages it walks
    if (kRing) {
      for (int q = mine; q < passes<N>(wk.s1 - wk.s0); ++q)
        for (int j = sb; j < se; ++j, ++it) {
          const int s = it % p.ring;
          mbar_wait_or_trap(full + s, (it / p.ring) & 1);
          release(empty + s);
        }
    }
    // A is released after every pair, W after its chunk's last
    if (p.a_res) release(a_empty);
    if (p.w_res && wk.chunk_ends()) release(w_empty);
  }
  if (tid == 0) bulk_wait_read<0>();  // the copies have read the staging
}

template <int N>
int launch(const void* a, const void* w, void* out, int R, int C, int L, int w_rows,
           int out_rows, int out_cols, int steps, const XpackPlan& p, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const auto misaligned = [](const void* q) { return reinterpret_cast<std::uintptr_t>(q) % 16; };
  if (p.smem > kXpackSmemLimit || misaligned(a) || misaligned(w) || misaligned(out)) return bad;
  const CUtensorMapSwizzle sw = N == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t lanes = static_cast<cuuint64_t>(p.chunks) * N;
  const cuuint64_t adims[3] = {static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(C),
                               static_cast<cuuint64_t>(R)};
  const cuuint64_t astrides[2] = {2ull * L, 2ull * L * C};
  const cuuint32_t abox[3] = {64, static_cast<cuuint32_t>(p.tc), static_cast<cuuint32_t>(p.tr)};
  const cuuint64_t wdims[2] = {N, static_cast<cuuint64_t>(w_rows)};
  const cuuint64_t wstrides[1] = {2ull * N};
  const cuuint32_t wbox[2] = {Width<N>::kLanes, kXpackKStep};
  const cuuint64_t odims[4] = {lanes, static_cast<cuuint64_t>(out_cols),
                               static_cast<cuuint64_t>(out_rows), static_cast<cuuint64_t>(steps)};
  const cuuint64_t ostrides[3] = {2 * lanes, 2 * lanes * out_cols, 2 * lanes * out_cols * out_rows};
  const cuuint32_t obox[4] = {Width<N>::kLanes, static_cast<cuuint32_t>(p.tc),
                              static_cast<cuuint32_t>(p.tr), 1};
  CUtensorMap ta, tw, to;
  if (!bf16_map(&ta, a, 3, adims, astrides, abox) ||
      !bf16_map(&tw, w, 2, wdims, wstrides, wbox, sw) ||
      !bf16_map(&to, out, 4, odims, ostrides, obox, sw))
    return bad;
  const long long items = static_cast<long long>(p.chunks) * p.tiles * steps;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = p.ring ? tap_gemm_kernel<N, true> : tap_gemm_kernel<N, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sms ? items : sms);  // one block an SM
  kernel<<<grid, kThreads, p.smem, stream>>>(p, items, steps, ta, tw, to);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (steps, out_rows, out_cols, chunks N) bf16 on `stream` from a (R, C, L)
// and w (w_rows, N), both bf16, contiguous and 16-byte aligned. taps holds
// ntaps rows of (dr, dc, l0, K, w0, chunk); each chunk's taps are summed in the
// order given. Refused (cudaErrorInvalidValue, nothing launched): N not 32, 64
// or 128; L, a lane offset l0 or a K not a multiple of 8, 8 and 16; a tap that
// reads outside a or w; a chunk without taps; more than 8 chunks, 65535 steps
// or 128 k-steps of 32 lanes. Returns cudaGetLastError() of the launch.
extern "C" int tap_gemm_bf16(const void* a, const void* w, void* out, int R, int C, int L,
                             int w_rows, int n, int out_rows, int out_cols, int chunks,
                             const int* taps, int ntaps, int steps, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n != 32 && n != 64 && n != 128) return bad;
  if (R <= 0 || C <= 0 || L <= 0 || L % 8 || out_rows <= 0 || out_cols <= 0 || ntaps <= 0 ||
      chunks <= 0 || chunks > kXpackMaxChunks || steps <= 0 || steps > 65535)
    return bad;
  XpackPlan p;
  if (xpack_plan(p, n, R, C, L, w_rows, out_rows, out_cols, chunks, taps, ntaps)) return bad;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 32) return launch<32>(a, w, out, R, C, L, w_rows, out_rows, out_cols, steps, p, s);
  if (n == 64) return launch<64>(a, w, out, R, C, L, w_rows, out_rows, out_cols, steps, p, s);
  return launch<128>(a, w, out, R, C, L, w_rows, out_rows, out_cols, steps, p, s);
}
