"""Where the time of ``csrc/conv_first_wgmma.cu`` (``conv_first_forward_wgmma``,
the bf16 chain's first layer) goes, on the card.

Builds copies of ``conv_first_wgmma.cu`` with parts of its work taken out
and times each at 1080p on the first layers the chain runs (RGB L1 3→32,
and the flagship's conv1 9→64 in the chain's three-launch form; random
weights from a seed), beside the kernel as it is. The parts (``PARTS``),
each a set of edits of the source text:

* ``raw loads``: the producer lands no pixels (it still arrives on each
  stage's mbarrier, so the stages cycle as before);
* ``16-byte copies``: the pixels land 4 bytes a copy on every row (the
  outputs stay right);
* ``expand``: the consumers neither quantise nor expand the pixels (the
  products read whatever the window holds);
* ``products``: no ``wgmma``; the sums are zeroed instead;
* ``staging``: the epilogue writes nothing into the output buffers;
* ``stores``: no tensor-copy store of the output;
* ``four warpgroups``: two consumer warpgroups instead of four (the plan's
  header inlined with ``kFirstWgs`` = 2, ``setmaxnreg`` 224 and 56 as in
  ``wgmma_conv.cuh``), each tile half as tall. The launch still passes the
  four-warpgroup plan's shared bytes, more than this copy's plan needs, so
  the copy takes the launch and computes the right output.

The other copies compute wrong outputs by design: only their times are
read.

    python -m cnn_sr_tpu_torch.probes.first_wgmma_parts [--reps N] [--rounds N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.fused import build, entry
from . import layout
from . import parts as shared
from .winograd import timer

SOURCE = build.CSRC / "conv_first_wgmma.cu"
PLAN = build.CSRC / "conv_first_plan.cuh"
# name -> ((f, c, n), input (N, H, W))
LAYERS = {"RGB L1 3->32": ((3, 3, 32), (1, 1080, 1920)),
          "conv1 9->64": ((9, 1, 64), (1, 1080, 1920))}

# part -> [(text of conv_first_wgmma.cu, its replacement, times the text occurs)]
PARTS = {
    "raw loads": [("            cp_async16_n(dst + j, bytes ? src + j : x, bytes);\n",
                   "            (void)bytes;\n", 1),
                  ("cp_async4(dst + j, j < in ? src + j : x, j < in);\n", "(void)in;\n", 1),
                  ("cp_async4(dst + j, ok ? x + at + j : x, ok);\n", "(void)ok, (void)at;\n", 1)],
    "16-byte copies": [("      const bool vec = reinterpret_cast<std::uintptr_t>(src) % 16 == 0 && "
                        "W * p.k % 4 == 0;\n", "      const bool vec = false;\n", 1)],
    "expand": [("    for (int pos = threadIdx.x; pos < win_pos; pos += kFirstConsumers) {\n",
                "    for (int pos = threadIdx.x; pos < 0 * win_pos; pos += kFirstConsumers) {\n",
                1)],
    "products": [("      tap(ad, nc, 0, std::true_type{});\n"
                  "      for (int dy = 1; dy < p.f; ++dy) tap(ad, nc, dy, std::false_type{});\n",
                  "      for (int s = 0; s < S; ++s)\n"
                  "        for (int e = 0; e < BN / 2; ++e) acc[s][e] = 0.f;\n", 1)],
    "staging": [("      for (int c8 = 0; c8 < BN / 8; ++c8) {\n"
                 "        const int col = c8 * 8 + q2, c = col % C::kLanes;\n",
                 "      for (int c8 = 0; c8 < 0; ++c8) {\n"
                 "        const int col = c8 * 8 + q2, c = col % C::kLanes;\n", 1)],
    "stores": [("          tma_store_4d(&to, ob + blk * kOutBlock, n0 + blk * C::kLanes, ox0, "
                "oy0, img);\n", "          (void)ob;\n", 1)],
    "four warpgroups": [
        ('#include "conv_first_plan.cuh"\n',
         PLAN.read_text().replace("#pragma once\n", "")
         .replace("constexpr int kFirstWgs = 4;", "constexpr int kFirstWgs = 2;"), 1),
        ("constexpr int kFirstConsumerRegs = 104, kFirstProducerRegs = 64;",
         "constexpr int kFirstConsumerRegs = 224, kFirstProducerRegs = 56;", 1)],
}
# the copies: name -> the parts taken out
VARIANTS = {"kernel": (), "no raw loads": ("raw loads",),
            "no 16-byte copies": ("16-byte copies",), "no expand": ("expand",),
            "no products": ("products",), "no stores": ("stores",),
            "no staging, no stores": ("staging", "stores"),
            "none of them": ("raw loads", "expand", "products", "staging", "stores"),
            "two warpgroups": ("four warpgroups",)}


def time_parts(reps: int, rounds: int) -> dict:
    """For each layer: {copy: ms of each round} at 1080p, in ``rounds``
    interleaved rounds of ``reps`` graph replays."""
    dev = layout.device_of("cuda")
    libs = shared.build_variants(SOURCE, PARTS, VARIANTS, "conv_first_forward_wgmma",
                                 build.load_library().conv_first_forward_wgmma.argtypes)
    run = timer(dev)
    out = {}
    rng = np.random.default_rng(0)
    for name, ((f, c, n), shape) in LAYERS.items():
        x = torch.from_numpy(rng.uniform(-0.6, 0.6, (*shape, c)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((f, f, c, n)) * (2 / (f * f * c)) ** 0.5)
                             .astype(np.float32)).to(dev)
        b = torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32)).to(dev)
        wp, bp = entry.pack_bf16(w, b, first=True)
        plan = entry.first_layer_plan(f, c, n)
        y = torch.empty((shape[0], shape[1] - f + 1, shape[2] - f + 1, n), dtype=torch.bfloat16,
                        device=dev)

        def call(lib):
            err = lib.conv_first_forward_wgmma(
                x.data_ptr(), wp.data_ptr(), bp.data_ptr(), y.data_ptr(), *shape, c, f, n,
                plan.smem, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"first_wgmma_parts: launch failed ({err})")

        res = {}
        for _ in range(rounds):
            for copy, lib in libs.items():
                graph = shared.captured(lambda: call(lib), reps)
                res.setdefault(copy, []).append(run(graph.replay, 1) / reps)
        out[name] = res
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.first_wgmma_parts",
        description="Times of csrc/conv_first_wgmma.cu and its copies without parts, at 1080p.")
    p.add_argument("--reps", type=int, default=10, help="launches a graph")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    times = time_parts(args.reps, args.rounds)
    print(f"conv_first_wgmma.cu copies at 1080p on {torch.cuda.get_device_name(0)}, ms of "
          f"{args.rounds} rounds of {args.reps} graph replays:")
    for name, res in times.items():
        print(f"{name}: " + " | ".join(
            f"{copy} " + "/".join(f"{ms:.4f}" for ms in rounds) for copy, rounds in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
