"""Where the time of ``csrc/rowpair.cu`` goes, on the card.

Builds copies of ``rowpair.cu`` with parts of its work taken out and times
each at the flagship's 1080p exit (both row parities of a 534 x 954 x L
operand, read with stride 2; L = 128 and 64, bf16 and f32 A), beside the
kernel as it is. The parts (``PARTS``), each a set of edits of the source
text:

* ``load``: the tensor copies of A (the producer arrives on each stage
  without them; the stages keep what they held);
* ``store``: the tensor copies of the output (the staging is still
  written);
* ``mma``: the ``wgmma`` and, for an f32 A, the threads' reads of A and
  their rounding to bf16.

A copy's outputs are wrong and only its time means anything: the time a
part costs is at most the kernel's time less that of the copy without it,
and what is left without every part but one is that part's own pace. Three
more copies are the kernel whole with a deeper ring (``ring3``, ``ring4``,
``ring8``: 3, 4 and 8 stages of 16 KB against the plan's 2), which is how
the plan's depth was chosen. Each time is of the device work alone: CUDA
graph replays of ``--reps`` pairs of launches. The kernel is also timed at
m = 264 rows a parity, where the 2,112 tiles a parity fill 16 rounds of
the 132 blocks exactly (at m = 267, 2,136 tiles take a 17th round on 24
blocks): the cost of that last round. The copies build as
``probes/parts.py`` builds them.

    python -m cnn_sr_tpu_torch.probes.rowpair_parts [--reps N] [--rounds N]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.fused import build
from . import layout, rowpair
from . import parts as shared
from .winograd import timer

SOURCE = build.CSRC / "rowpair.cu"

# part -> (text of rowpair.cu, its replacement, times the text occurs)
PARTS = {
    "load": [("          mbar_arrive_expect_tx(full + s, p.stage);\n"
              "          tma_load_3d(", "          mbar_arrive(full + s);\n"
              "          if (false) tma_load_3d(", 1)],
    "store": [("          tma_store_3d(&ty,", "          if (false) tma_store_3d(&ty,", 1)],
    "mma": [("          mma_rs<L>(acc,", "          if (false) mma_rs<L>(acc,", 1),
            ("          mma_ss<L>(acc,", "          if (false) mma_ss<L>(acc,", 1),
            ("      if constexpr (kF32) {\n        // rows r0",
             "      if constexpr (false) {\n        // rows r0", 1)],
    # a deeper ring: n stages, and room for them and their two mbarriers
    **{f"ring{n}": [("  const RowpairPlan p(L);\n",
                     f"  RowpairPlan p(L);\n  p.smem += ({n} - p.stages) * (p.stage + 16);\n"
                     f"  p.stages = {n};\n", 1)] for n in (3, 4, 8)},
}
# the copies: name -> the parts taken out
VARIANTS = {
    "kernel": (),
    "no load": ("load",),
    "no store": ("store",),
    "no mma": ("mma",),
    "load only": ("store", "mma"),
    "store only": ("load", "mma"),
    "3 stages": ("ring3",),
    "4 stages": ("ring4",),
    "8 stages": ("ring8",),
}
EVEN_ROWS = 264  # rows a parity whose tiles fill whole rounds of 132 blocks


def patched(parts, text: str | None = None) -> str:
    """The source of ``rowpair.cu`` (or ``text``) with ``parts`` taken out."""
    return shared.patched(SOURCE, PARTS, parts, text)


def time_parts(reps: int, rounds: int) -> dict:
    """ms of both parities' launches of every copy in every case at the
    1080p exit, and of the kernel at ``EVEN_ROWS`` rows a parity, in
    ``rounds`` interleaved rounds: {case: {name: [ms]}}."""
    dev = layout.device_of("cuda")
    libs = shared.build_variants(SOURCE, PARTS, VARIANTS, "rowpair_gemm",
                                 build.load_library().rowpair_gemm.argtypes)
    run = timer(dev)
    rows, cols = rowpair.EXIT_1080P
    times = {}
    for lanes in rowpair.LANES:
        for dtype in rowpair.DTYPES:
            gen = torch.Generator(device=dev).manual_seed(0)
            a = torch.randn((rows, cols, lanes), generator=gen, device=dev).to(
                rowpair.DTYPES[dtype])
            w = torch.randn((lanes, lanes), generator=gen, device=dev).to(torch.bfloat16)
            y = torch.empty((rows // 2, cols, lanes), dtype=torch.float32, device=dev)

            def call(lib, m):
                for rt in range(2):
                    err = lib.rowpair_gemm(a[rt].data_ptr(), w.data_ptr(), y.data_ptr(),
                                           int(dtype == "bf16"), lanes, m, cols,
                                           2 * cols * lanes,
                                           torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"rowpair_parts: launch failed ({err})")

            case = f"{dtype} L={lanes}"
            for _ in range(rounds):
                for name, lib in libs.items():
                    graph = shared.captured(lambda: call(lib, rows // 2), reps)
                    times.setdefault(case, {}).setdefault(name, []).append(
                        run(graph.replay, 1) / reps)
                graph = shared.captured(lambda: call(libs["kernel"], EVEN_ROWS), reps)
                times[case].setdefault(f"kernel, m = {EVEN_ROWS}", []).append(
                    run(graph.replay, 1) / reps)
            del a, w, y
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.rowpair_parts",
        description="Times of csrc/rowpair.cu with parts of its work taken out, at the "
                    "flagship's 1080p exit.")
    p.add_argument("--reps", type=int, default=20, help="pairs of launches a graph")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    times = time_parts(args.reps, args.rounds)
    print(f"ms of rowpair.cu copies, both parities of the 1080p exit, on "
          f"{torch.cuda.get_device_name(0)}, best of {args.rounds} rounds of {args.reps} graph "
          "replays (parts taken out: "
          + "; ".join(f"{n} = {', '.join(v) or 'none'}" for n, v in VARIANTS.items()) + "):")
    for case, by_name in times.items():
        print(f"{case:<10} " + "  ".join(f"{name} {min(ms):.4f}" for name, ms in by_name.items())
              + "  rounds " + " | ".join(" ".join(f"{t:.4f}" for t in ms)
                                         for ms in by_name.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
