"""Where the time of ``csrc/fused_wgmma.cu`` (``fused_srcnn_forward_bf16``)
goes, on the card.

Builds copies of ``fused_wgmma.cu`` and times each at 1080p on the bf16
stacks the fused kernel takes (the flagship 9-5-5, the 9-1-5 and the narrow
9-5-5, random weights from a seed), beside the kernel as it is. Every copy
carries ``phases``: the first consumer thread of each block adds the global
timer's nanoseconds of each phase of each tile to a device counter (waiting
for the tile's pixels; expanding them into the window; conv1; conv2;
conv3's products; conv3's sums and output), read back after one launch as
microseconds a tile. The parts (``PARTS``), each a set of edits of the
source text:

* ``phases``: the timers above (a few instructions a phase);
* ``zeroed sums``: every sum zeroed by the threads before the products,
  all of which then accumulate into it, in place of a first product
  (``wgmma_kk_first``) that overwrites it; the kernel is otherwise the
  same, and so are its outputs.

    python -m cnn_sr_tpu_torch.probes.fused_wgmma_parts [--reps N] [--rounds N]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..ops.fused import build, entry, reference
from ..utils.params_io import params_to_torch
from . import layout
from . import parts as shared
from .winograd import timer

SOURCE = build.CSRC / "fused_wgmma.cu"
STACKS = {"flagship 9-5-5": ([(9, 1, 64), (5, 64, 32), (5, 32, 1)], 1),
          "9-1-5": ([(9, 1, 64), (1, 64, 32), (5, 32, 1)], 1),
          "narrow 9-5-5": ([(9, 1, 8), (5, 8, 8), (5, 8, 1)], 1)}
PHASES = ("pixels", "expand", "conv1", "conv2", "conv3", "output")

# the C function that reads the phase counters and clears them
READER = '''
extern "C" int fw_phases_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
  return static_cast<int>(err);
}
'''

# part -> (text of fused_wgmma.cu, its replacement, times the text occurs)
PARTS = {
    "phases": [
        ("namespace {\n\nusing bf16 = __nv_bfloat16;\n",
         "namespace {\n\nusing bf16 = __nv_bfloat16;\n"
         "__device__ unsigned long long g_phase_ns[8];\n"
         "#define FW_PHASE(k) { const unsigned long long t1 = globaltimer_ns(); "
         "if (threadIdx.x == 0) atomicAdd(&g_phase_ns[k], t1 - t0); t0 = t1; }\n"
         "__device__ __forceinline__ unsigned long long globaltimer_ns() {\n"
         "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n", 1),
        ("    const Tile t(i, p.tile, tiles_x, tiles_y);\n"
         "    mbar_wait_or_trap(raw_full, n & 1);\n",
         "    const Tile t(i, p.tile, tiles_x, tiles_y);\n"
         "    unsigned long long t0 = globaltimer_ns();\n"
         "    mbar_wait_or_trap(raw_full, n & 1);\n    FW_PHASE(0)\n", 1),
        ("    if (n == 0) mbar_wait_or_trap(wbar, 0);\n",
         "    if (n == 0) mbar_wait_or_trap(wbar, 0);\n    FW_PHASE(1)\n", 1),
        ("    consumers_sync();  // a1 is whole; the window is free for a2\n",
         "    consumers_sync();  // a1 is whole; the window is free for a2\n"
         "    FW_PHASE(2)\n", 1),
        ("    consumers_sync();  // a2 is whole; a1 is free for conv3's sums\n",
         "    consumers_sync();  // a2 is whole; a1 is free for conv3's sums\n    FW_PHASE(3)\n",
         1),
        ("    consumers_sync();\n    conv3_sum(", "    consumers_sync();\n    FW_PHASE(4)\n"
         "    conv3_sum(", 1),
        ("              OW);\n  }\n}\n",
         "              OW);\n    FW_PHASE(5)\n"
         "    if (threadIdx.x == 0) atomicAdd(&g_phase_ns[6], 1ull);\n  }\n}\n", 1),
        ('extern "C" int wgmma_desc_probe(', READER + 'extern "C" int wgmma_desc_probe(', 1),
    ],
    "zeroed sums": [
        ("    wgmma_fence();\n    wgmma_kk_first<N>(acc, da(0), db(0));\n"
         "    for (int j = 1; j < p.f1 * ks; ++j)",
         "    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;\n    wgmma_fence();\n"
         "    for (int j = 0; j < p.f1 * ks; ++j)", 1),
        ("  float acc[P][N / 2];\n  int prev = -1;\n",
         "  float acc[P][N / 2];\n  for (int i = 0; i < P; ++i)\n"
         "    for (int e = 0; e < N / 2; ++e) acc[i][e] = 0.f;\n  int prev = -1;\n", 1),
        ("      for (int i = 0; i < P; ++i) wgmma_kk_first<N>(acc[i], da(i, 0), db(0));\n"
         "      k0 = 1;\n", "      k0 = 0;\n", 1),
        ("    wgmma_fence();\n#pragma unroll\n"
         "    for (int u = 0; u < kAtOnce; ++u) wgmma_kk_first<N>(acc[u], da(u, 0), db(0));\n"
         "    for (int j = 1; j < p.f3 * ks; ++j)",
         "    for (int u = 0; u < kAtOnce; ++u)\n"
         "      for (int e = 0; e < N / 2; ++e) acc[u][e] = 0.f;\n    wgmma_fence();\n"
         "    for (int j = 0; j < p.f3 * ks; ++j)", 1),
    ],
}
# the copies: name -> the parts applied
VARIANTS = {"kernel": ("phases",), "zeroed sums": ("phases", "zeroed sums")}


def patched(parts, text: str | None = None) -> str:
    """The source of ``fused_wgmma.cu`` (or ``text``) with ``parts``
    applied."""
    return shared.patched(SOURCE, PARTS, parts, text)


def _params(specs, dev, seed: int = 0):
    rng = np.random.default_rng(seed)
    return params_to_torch(
        [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k)))
          .astype(np.float32), "b": (rng.standard_normal(n) * 0.05).astype(np.float32)}
         for f, k, n in specs], dev)


def sass_counts() -> dict:
    """{copy: (HGMMA, WARPGROUP.DEPBAR)} in the SASS of each built copy's
    kernel (``cuobjdump -sass``): a DEPBAR after every HGMMA is ptxas
    serialising the products."""
    tool = build.find_nvcc().rsplit("/", 1)[0] + "/cuobjdump"
    out = {}
    for i, name in enumerate(VARIANTS):
        lib = shared.PARTS_DIR / f"lib{SOURCE.stem}_{i}.so"
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        kernel = sass[sass.find("fused_wgmma_kernel"):]
        out[name] = (kernel.count("HGMMA"), kernel.count("WARPGROUP.DEPBAR"))
    return out


def time_parts(reps: int, rounds: int) -> dict:
    """For each stack: {copy: (ms of each round, µs a tile of each phase,
    max |copy − plain|)} at 1080p, in ``rounds`` interleaved rounds of
    ``reps`` graph replays."""
    dev = layout.device_of("cuda")
    libs = shared.build_variants(
        SOURCE, PARTS, VARIANTS, "fused_srcnn_forward_bf16",
        build.load_library().fused_srcnn_forward_bf16.argtypes)
    run = timer(dev)
    out = {}
    for stack, (specs, c) in STACKS.items():
        params = _params(specs, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        x = (torch.rand((1, 1080, 1920, c), generator=gen, device=dev) - 0.5).contiguous()
        plan = entry.fused_wgmma_plan(c, specs)
        ptrs = [x.data_ptr()] + [t.data_ptr() for pair in entry.fused_weights(params)
                                 for t in pair]
        s = sum(f - 1 for f, _, _ in specs)
        y = torch.empty((1, 1080 - s, 1920 - s, specs[2][2]), device=dev)
        ref = reference.fused_forward(params, x, "bf16")
        dims = [v for f, _, n in specs for v in (f, n)]

        def call(lib):
            err = lib.fused_srcnn_forward_bf16(*ptrs, y.data_ptr(), 1, 1080, 1920, c, *dims,
                                               plan.smem, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"fused_wgmma_parts: launch failed ({err})")

        res = {}
        for _ in range(rounds):
            for name, lib in libs.items():
                graph = shared.captured(lambda: call(lib), reps)
                res.setdefault(name, [[], None, None])[0].append(run(graph.replay, 1) / reps)
        for name, lib in libs.items():
            reader = lib.fw_phases_read
            reader.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
            ns = (ctypes.c_ulonglong * 8)()
            reader(ns)
            call(lib)
            torch.cuda.synchronize()
            reader(ns)
            tiles = max(ns[6], 1)
            res[name][1] = [ns[k] / tiles / 1e3 for k in range(len(PHASES))]
            res[name][2] = float((y - ref).abs().max())
        out[stack] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.fused_wgmma_parts",
        description="Times and per-tile phases of csrc/fused_wgmma.cu and its copies at 1080p.")
    p.add_argument("--reps", type=int, default=10, help="launches a graph")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    times = time_parts(args.reps, args.rounds)
    print("SASS of each copy's kernel: " + "; ".join(
        f"{name} {hgmma} HGMMA, {depbar} WARPGROUP.DEPBAR"
        for name, (hgmma, depbar) in sass_counts().items()))
    print(f"fused_wgmma.cu copies at 1x1080x1920 on {torch.cuda.get_device_name(0)}, ms of "
          f"{args.rounds} rounds of {args.reps} graph replays; us a tile of each phase ("
          + ", ".join(PHASES) + "):")
    for stack, res in times.items():
        print(f"{stack}: " + " | ".join(
            f"{name} " + "/".join(f"{ms:.3f}" for ms in ms_rounds) + " ms, phases "
            + ", ".join(f"{us:.2f}" for us in phases) + f" (max |copy - plain| {err:.2e})"
            for name, (ms_rounds, phases, err) in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
