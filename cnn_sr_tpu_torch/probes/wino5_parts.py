"""Where the time of ``csrc/wino5.cu`` goes, on the card.

Builds copies of ``wino5.cu`` with parts of its work taken out and times
every mode of each at the flagship's 1080p conv2, beside the kernel as it
is. The parts (``PARTS``), each a set of edits of the source text:

* ``window``: the quad modes' window load (their window is left unwritten);
* ``weights``: the weight streams (Wq's stages past the first two, Wf's rows);
* ``v``: w55f's V formation, its loads from the quad image and its stores;
* ``mma``: the ``mma.sync`` loops of both kernels.

A copy's outputs are wrong and only its time means anything: the time a
part costs is at most the kernel's time less that of the copy without it,
and what is left without every part but one is that part's own pace. The
copies build as ``probes/parts.py`` builds them.

    python -m cnn_sr_tpu_torch.probes.wino5_parts [--reps N] [--rounds N]
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import torch

from ..ops.fused import build
from . import layout, wino5
from . import parts as shared
from .winograd import timer

SOURCE = build.CSRC / "wino5.cu"

# part -> (text of wino5.cu, its replacement, times the text occurs)
PARTS = {
    "window": [("  load_quad_window(x, g, tr0, tc0, p.as, win);\n", "", 1)],
    "weights": [("    load_stage(s + kW5QuadStages - 1);\n", "    cp_async_commit();\n", 1),
                ("        load_wf(w, g.k, a, c0, wbuf + a * kWLen, tid);\n", "", 1)],
    "v": [("int tc0, int c0, int e, float4 (&d)[kW5WR][2]) {\n",
           "int tc0, int c0, int e, float4 (&d)[kW5WR][2]) {\n  return;\n", 1),
          ("void form_item(const float4 (&d)[kW5WR][2], int e, bf16* vb) {\n",
           "void form_item(const float4 (&d)[kW5WR][2], int e, bf16* vb) {\n  return;\n", 1)],
    "mma": [("    mma_stage(acc, win + c0,", "    if (false) mma_stage(acc, win + c0,", 1),
            ("          mma_stage(acc, vb", "          if (false) mma_stage(acc, vb", 1)],
}
# the copies: name -> the parts taken out
VARIANTS = {
    "kernel": (),
    "no window": ("window",),
    "no weights": ("weights",),
    "no v": ("v",),
    "no mma": ("mma",),
    "window only": ("weights", "v", "mma"),
    "mma only": ("window", "weights", "v"),
}


def patched(parts, text: str | None = None) -> str:
    """The source of ``wino5.cu`` (or ``text``) with ``parts`` taken out."""
    return shared.patched(SOURCE, PARTS, parts, text)


def time_parts(reps: int, rounds: int) -> dict:
    """ms of every mode of every copy at ``wino5.OUT_1080P``, in
    ``rounds`` interleaved rounds of ``reps`` calls: {name: {mode: [ms]}}."""
    dev = layout.device_of("cuda")
    libs = shared.build_variants(SOURCE, PARTS, VARIANTS, "wino5_forward",
                                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out_hw = wino5.OUT_1080P
    act, g = wino5.layer_inputs(out_hw, dev)
    x = layout.pack_quad(act)
    w = {mode: wino5.weights(g, mode, dev) for mode in wino5.MODES}
    tr, tc = out_hw[0] // 2, out_hw[1] // 2
    y = torch.empty((2, 2, tr, tc, wino5.KERNEL_N), dtype=torch.bfloat16, device=dev)
    run = timer(dev)

    def call(lib, mode):
        err = lib.wino5_forward(x.data_ptr(), w[mode].data_ptr(), y.data_ptr(), x.shape[0],
                                x.shape[1], wino5.K, tr, tc, wino5._MODE_CODE[mode],
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wino5_parts: launch failed ({err})")

    times = {}
    for _ in range(rounds):
        for name, lib in libs.items():
            for mode in wino5.MODES:
                times.setdefault(name, {}).setdefault(mode, []).append(
                    run(lambda: call(lib, mode), reps))
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.wino5_parts",
        description="Times of csrc/wino5.cu with parts of its work taken out, at the "
                    "flagship's 1080p conv2.")
    p.add_argument("--reps", type=int, default=10, help="timed calls per copy, mode and round")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    times = time_parts(args.reps, args.rounds)
    print(f"ms of wino5.cu copies at the 1080p conv2 on {torch.cuda.get_device_name(0)}, "
          f"best of {args.rounds} rounds of {args.reps} calls (parts taken out: "
          + "; ".join(f"{n} = {', '.join(v) or 'none'}" for n, v in VARIANTS.items()) + "):")
    for name, by_mode in times.items():
        print(f"{name:<12} " + "  ".join(f"{mode} {min(ms):.3f}" for mode, ms in by_mode.items())
              + "  rounds " + " | ".join(" ".join(f"{t:.3f}" for t in ms)
                                         for ms in by_mode.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
