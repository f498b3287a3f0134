// tap_gemm_bf16: for each output chunk j and each step s,
//   out[s, m, j N : (j + 1) N] = bf16_rn(relu(sum over the taps t of chunk j of
//       a[r + dr_t, x + dc_t, l0_t : l0_t + K_t] @ w[w0_t : w0_t + K_t, 0 : N]))
// with m = r out_cols + x, bf16 operands and f32 sums: a GEMM whose A operand is
// a list of shifted windows ("taps") of one (R, C, L) bf16 operand. The port's
// first kernel on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out).
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
// output chunk (xpk32t64o reads lanes 64:192, a 128-byte offset). Each grid
// step of the probe recomputes the same block from VMEM-resident operands;
// here `steps` blocks do, each into its own slab of a (steps, *out) output, so
// that no two blocks write the same bytes and the operand stays shared.
//
// What bounds it: at one 1080p layer's worth of steps the multiply-adds take
// 0.04-0.21 ms at the bf16 tensor-core peak and the bf16 output 0.04-0.08 ms
// at 3.35 TB/s: the sep forms into 32 or 64 lanes at K = 96 are bound by the
// store, the rest by operations. The operand (at most 10 MB) stays in L2, but
// each tap reads its window again and each block the whole weight list:
// 1.2-3.6 GB a launch from L2, which can bind before either.
//
// What the design does: a block takes BM output rows x the chunk's N (32, 64
// or 128) in 8 warps, each warp 32 rows x N / WARPS_N columns, two m16 tiles by
// N / (8 WARPS_N) n8 tiles. The taps of the chunk run as one list of k-steps
// of up to 32 contraction lanes (made on the host, passed in the launch's
// parameters), each a cp.async 16-byte copy of the BM x kw A slab (rows past M
// zero-filled) and the kw x N weight slab into one of two shared stages, the
// next k-step's copies in flight while this one's mma.sync run. A tap's A row
// is the output row's base address plus one offset, (dr C + dc) L + l0. Shared
// rows are padded by 16 bytes, so the ldmatrix reads (A as is, the row-major
// (K, N) weight with .trans into the col-major B fragment) and the epilogue's
// writes touch every bank once. The epilogue stages the ReLU'd bf16 tile in
// shared memory and writes it out in 16-byte row pieces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int BK = 32;          // contraction lanes a k-step
constexpr int kMaxSteps = 128;  // k-steps a launch, over all chunks
constexpr int kMaxChunks = 8;
constexpr int kTapInts = 6;     // dr, dc, l0, K, w0, chunk

struct KStep {
  long long a_off;  // (dr C + dc) L + l0 + the k-step's first lane
  int w_row;        // w0 + the k-step's first lane
  int kw;           // 16 or 32
};

struct Plan {
  KStep step[kMaxSteps];
  int begin[kMaxChunks + 1];  // chunk j's k-steps: [begin[j], begin[j + 1])
};

template <int NC>
struct Tile {
  static constexpr int WARPS_N = NC == 32 ? 1 : 2;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int BM = 32 * WARPS_M;  // 256 at N = 32, else 128
  static constexpr int WN = NC / WARPS_N;  // a warp's columns: 32, 32, 64
  static constexpr int NT = WN / 8;        // its n8 tiles
  static constexpr int AS = BK + 8;        // bf16 a row of the A stage
  static constexpr int WS = NC + 8;        // bf16 a row of the weight stage and the output tile
  static constexpr int RPT = BM / 64;      // A rows a thread copies
  static constexpr int STAGE = BM * AS + BK * WS;  // bf16 a stage
  static constexpr int PIPE_BYTES = 2 * STAGE * 2;
  static constexpr int OUT_BYTES = BM * WS * 2;
  static constexpr int SMEM = PIPE_BYTES > OUT_BYTES ? PIPE_BYTES : OUT_BYTES;
  static_assert(SMEM <= 48 * 1024, "static shared memory");
  static_assert((BM * AS * 2) % 16 == 0 && (STAGE * 2) % 16 == 0, "16-byte aligned stages");
};

template <int NC>
__global__ void __launch_bounds__(kThreads)
    tap_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w, bf16* __restrict__ out,
                    int C, int L, int out_cols, long long M, int ldo,
                    const __grid_constant__ Plan plan) {
  using T = Tile<NC>;
  constexpr int CPR = NC / 8;  // 16-byte pieces a weight or output row
  __shared__ __align__(128) unsigned char smem[T::SMEM];
  bf16* const sm = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int chunk = blockIdx.y;
  const long long m0 = static_cast<long long>(blockIdx.x) * T::BM;

  // the A rows this thread copies: (tid >> 2) + 64 i of the block's, lanes
  // 8 part .. 8 part + 7 of each k-step
  const int part = tid & 3;
  long long rbase[T::RPT];
  bool rvalid[T::RPT];
#pragma unroll
  for (int i = 0; i < T::RPT; ++i) {
    const long long m = m0 + (tid >> 2) + 64 * i;
    rvalid[i] = m < M;
    const long long r = m / out_cols, x = m % out_cols;
    rbase[i] = rvalid[i] ? (r * C + x) * L + part * 8 : 0;
  }

  auto load = [&](int s, int buf) {
    const KStep st = plan.step[s];
    bf16* const as = sm + buf * T::STAGE;
    bf16* const ws = as + T::BM * T::AS;
    if (part * 8 < st.kw) {
#pragma unroll
      for (int i = 0; i < T::RPT; ++i)
        cp_async16(as + ((tid >> 2) + 64 * i) * T::AS + part * 8,
                   a + (rvalid[i] ? rbase[i] + st.a_off : 0), rvalid[i]);
    }
    for (int c = tid; c < st.kw * CPR; c += kThreads) {
      const int kr = c / CPR, cc = c % CPR;
      cp_async16(ws + kr * T::WS + cc * 8, w + static_cast<long long>(st.w_row + kr) * NC + cc * 8,
                 true);
    }
  };

  float acc[2][T::NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int s0 = plan.begin[chunk], s1 = plan.begin[chunk + 1];
  load(s0, 0);
  cp_async_commit();
  for (int s = s0; s < s1; ++s) {
    const int buf = (s - s0) & 1;
    if (s + 1 < s1) load(s + 1, buf ^ 1);
    cp_async_commit();  // an empty group after the last k-step keeps the count
    cp_async_wait_1();  // this k-step's copies have landed
    __syncthreads();
    const bf16* const as = sm + buf * T::STAGE;
    const bf16* const ws = as + T::BM * T::AS;
    const int kw = plan.step[s].kw;
#pragma unroll
    for (int k16 = 0; k16 < BK; k16 += 16) {
      if (k16 < kw) {
        unsigned af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * T::AS + k16 +
                                  (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < T::NT / 2; ++nj) {
          // b[0], b[1]: n8 tile 2 nj (k 0-7, 8-15); b[2], b[3]: tile 2 nj + 1
          unsigned b[4];
          ldmatrix_x4_trans(b, ws + (k16 + (lane & 15)) * T::WS + wn * T::WN + nj * 16 +
                                   (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][2 * nj], af[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  // ReLU, one rounding to bf16, staged as a BM x N tile
  bf16* const os = sm;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NT; ++ni) {
      const int r = wm * 32 + mi * 16 + (lane >> 2);
      const int c = wn * T::WN + ni * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(os + r * T::WS + c) =
          __floats2bfloat162_rn(fmaxf(acc[mi][ni][0], 0.f), fmaxf(acc[mi][ni][1], 0.f));
      *reinterpret_cast<__nv_bfloat162*>(os + (r + 8) * T::WS + c) =
          __floats2bfloat162_rn(fmaxf(acc[mi][ni][2], 0.f), fmaxf(acc[mi][ni][3], 0.f));
    }
  __syncthreads();
  bf16* const dst = out + static_cast<long long>(blockIdx.z) * M * ldo + chunk * NC;
  for (int e = tid; e < T::BM * CPR; e += kThreads) {
    const int r = e / CPR, cc = e % CPR;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(dst + (m0 + r) * ldo + cc * 8) =
          *reinterpret_cast<const uint4*>(os + r * T::WS + cc * 8);
  }
}

template <int NC>
int launch(const void* a, const void* w, void* out, int C, int L, int out_cols, long long M,
           int chunks, int steps, const Plan& plan, cudaStream_t stream) {
  const long long blocks = (M + Tile<NC>::BM - 1) / Tile<NC>::BM;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks),
                  static_cast<unsigned>(steps));
  tap_gemm_kernel<NC><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w), static_cast<bf16*>(out), C, L,
      out_cols, M, chunks * NC, plan);
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
      chunks <= 0 || chunks > kMaxChunks || steps <= 0 || steps > 65535)
    return bad;
  Plan plan;
  int count = 0;
  for (int j = 0; j < chunks; ++j) {
    plan.begin[j] = count;
    for (int t = 0; t < ntaps; ++t) {
      const int* tp = taps + kTapInts * t;
      const int dr = tp[0], dc = tp[1], l0 = tp[2], K = tp[3], w0 = tp[4], cj = tp[5];
      if (cj < 0 || cj >= chunks) return bad;
      if (cj != j) continue;
      if (dr < 0 || dc < 0 || l0 < 0 || w0 < 0 || K <= 0 || K % 16 || l0 % 8 ||
          dr + out_rows > R || dc + out_cols > C || l0 + K > L || w0 + K > w_rows)
        return bad;
      for (int kk = 0; kk < K; kk += BK) {
        if (count == kMaxSteps) return bad;
        plan.step[count].a_off = (static_cast<long long>(dr) * C + dc) * L + l0 + kk;
        plan.step[count].w_row = w0 + kk;
        plan.step[count].kw = K - kk < BK ? K - kk : BK;
        ++count;
      }
    }
    if (count == plan.begin[j]) return bad;
  }
  plan.begin[chunks] = count;
  const long long M = static_cast<long long>(out_rows) * out_cols;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n == 32) return launch<32>(a, w, out, C, L, out_cols, M, chunks, steps, plan, s);
  if (n == 64) return launch<64>(a, w, out, C, L, out_cols, M, chunks, steps, plan, s);
  return launch<128>(a, w, out, C, L, out_cols, M, chunks, steps, plan, s);
}
