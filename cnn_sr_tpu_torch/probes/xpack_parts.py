"""Where the time of ``csrc/xpack.cu`` goes, on the card.

Builds copies of ``xpack.cu`` with parts of its work taken out and times
each at a 1080p layer's steps (338 for probe 1, 85 for probe 2) in four of
the xpack variants (``CASES``: the 32→32 and 64→64 sep forms of probe 1,
its packed 64→64 form, whose weights stream through the ring, and probe
2's two-chunk ``xpk32t64o``), beside the kernel as it is. The parts
(``PARTS``), each a set of edits of the source text:

* ``load``: the tensor copies of A and W, resident or streamed (the
  producer arrives on each barrier without them; the buffers keep what
  they held);
* ``store``: the tensor copies of the output (the staging is still
  written);
* ``mma``: the ``wgmma``;
* ``regs``: not a part taken out but A fed from registers: each warp
  loads its 16 rows of a slice's two k16 steps from the swizzled box by
  ``ldmatrix`` and the group's products take A from registers (``wgmma``
  with A in registers, as a window shifted by a column would need it),
  against the kernel's A from shared memory by its descriptor;
* ``regp``: A from registers as in ``regs``, but the slices taken in
  pairs, one's rows loaded by ``ldmatrix`` while the other's products run,
  wherever nothing streams through the ring (in ``xpack_64to64``, whose
  weights stream, this copy is the kernel as it is).

The copies with a part taken out compute wrong outputs and only their time
means anything: the time a part costs is at most the kernel's time less
that of the copy without it, and what is left without every part but one
is that part's own pace. The copies that only feed A another way
(``FULL``) are held against the plain version and their agreement is
printed beside their times.
Each time is of the device work alone: CUDA graph replays of ``--reps``
launches. The copies build as ``probes/parts.py`` builds them.

    python -m cnn_sr_tpu_torch.probes.xpack_parts [--reps N] [--rounds N]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops.fused import build
from . import layout, xpack, xpack2
from . import parts as shared
from .winograd import timer

SOURCE = build.CSRC / "xpack.cu"
CASES = ("sep_32to32", "sep_64to64", "xpack_64to64", "xpk32t64o")

_MMA = "          for (int t = 0; t < G; ++t) mma_ss<N>(acc[t], da, db, scale);\n"
# wgmma m64nNk16 with A from registers, for the copies that feed A so
_MMA_RS = ("template <int N>\n"
           "__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const unsigned (&a)[4],\n"
           "                                       unsigned long long db, int scale_d) {\n"
           "  if constexpr (N == 128)\n"
           "    wgmma_m64n128k16_rs(d, a, db, scale_d);\n"
           "  else if constexpr (N == 64)\n"
           "    wgmma_m64n64k16_rs(d, a, db, scale_d);\n"
           "  else\n"
           "    wgmma_m64n32k16_rs(d, a, db, scale_d);\n"
           "}\n\n")
# part -> (text of xpack.cu, its replacement, times the text occurs)
PARTS = {
    "load": [
        ("          mbar_arrive_expect_tx(w_full, (se - sb) * p.wslice);\n",
         "          mbar_arrive(w_full);\n", 1),
        ("          mbar_arrive_expect_tx(a_full, (be - bb) * kXpackBox);\n",
         "          mbar_arrive(a_full);\n", 1),
        ("              mbar_arrive_expect_tx(full + s, p.stage);\n",
         "              mbar_arrive(full + s);\n", 1),
        ("    tma_load_2d(dst + b", "    if (false) tma_load_2d(dst + b", 1),
        ("            tma_load_3d(abuf", "            if (false) tma_load_3d(abuf", 1),
        ("                tma_load_3d(st, &ta",
         "                if (false) tma_load_3d(st, &ta", 1)],
    "store": [("            tma_store_4d(&to,", "            if (false) tma_store_4d(&to,", 1)],
    "mma": [(_MMA, _MMA.replace("mma_ss", "if (false) mma_ss"), 1)],
    "regs": [
        ("// byte offset of lane c (even) of row r in a block of N's swizzled rows\n",
         _MMA_RS + "// byte offset of lane c (even) of row r in a block of N's swizzled rows\n", 1),
        ("        wgmma_fence();\n#pragma unroll\n"
         "        for (int kk = 0; kk < 2; ++kk) {\n",
         "        unsigned af[2][4];  // this warp's 16 rows of each k16 step, from the box\n"
         "#pragma unroll\n"
         "        for (int kk = 0; kk < 2; ++kk) {\n"
         "          const int r = warp * 16 + (lane & 15);\n"
         "          const int c = sl.half * 4 + kk * 2 + (lane >> 4);\n"
         "          ldmatrix_x4(af[kk], a_addr - sl.half * 64 + r * 128 + (((c ^ r) & 7) << 4));\n"
         "        }\n"
         "        wgmma_fence();\n#pragma unroll\n"
         "        for (int kk = 0; kk < 2; ++kk) {\n", 1),
        (_MMA, "          for (int t = 0; t < G; ++t) mma_rs<N>(acc[t], af[kk], db, scale);\n",
         1)],
    "regp": [
        ("// byte offset of lane c (even) of row r in a block of N's swizzled rows\n",
         _MMA_RS +
         "// a slice's two k16 steps of A as wgmma takes them from registers: this\n"
         "// warp's 16 rows (row_addr, the first's, of a box) by ldmatrix\n"
         "__device__ __forceinline__ void load_a(unsigned (&f)[2][4], unsigned row_addr, int half,\n"
         "                                       int lane, int r) {\n"
         "#pragma unroll\n"
         "  for (int kk = 0; kk < 2; ++kk) {\n"
         "    const int c = half * 4 + kk * 2 + (lane >> 4);\n"
         "    ldmatrix_x4(f[kk], row_addr + (((c ^ r) & 7) << 4));\n"
         "  }\n"
         "}\n\n"
         "// the products of a slice for G steps, A from registers\n"
         "template <int N, int G>\n"
         "__device__ __forceinline__ void issue_rs(float (&acc)[G][N / 2], const unsigned (&f)[2][4],\n"
         "                                         unsigned long long db0, unsigned long long db1,\n"
         "                                         int scale0) {\n"
         "  wgmma_fence();\n"
         "#pragma unroll\n"
         "  for (int t = 0; t < G; ++t) mma_rs<N>(acc[t], f[0], db0, scale0);\n"
         "#pragma unroll\n"
         "  for (int t = 0; t < G; ++t) mma_rs<N>(acc[t], f[1], db1, 1);\n"
         "  wgmma_commit();\n"
         "}\n\n"
         "// byte offset of lane c (even) of row r in a block of N's swizzled rows\n", 1),
        ("      fence_acc();\n      for (int j = sb; j < se; ++j) {\n",
         "      fence_acc();\n"
         "      if constexpr (!kRing) {\n"
         "        // slices in pairs: one's A loaded into registers while the\n"
         "        // other's products run (an odd count's last partner multiplies\n"
         "        // the zeros)\n"
         "        unsigned af[2][2][4];\n"
         "        const int r = warp * 16 + (lane & 15);\n"
         "        const auto row = [&](int j) {\n"
         "          return smem_addr(abuf + p.slice[j].box * kXpackBox) + r * 128;\n"
         "        };\n"
         "        const auto wdesc = [&](int j, int kk, bool real) {\n"
         "          return real && kk < p.slice[j].k16\n"
         "                     ? b_desc<N>(smem_addr(wbuf + (j - sb) * p.wslice) + kk * 16 * Wd::kRow,\n"
         "                                 Wd::kWBlock)\n"
         "                     : zero_desc;\n"
         "        };\n"
         "        load_a(af[0], row(sb), p.slice[sb].half, lane, r);\n"
         "        for (int j = sb; j < se; j += 2) {\n"
         "          const bool pair = j + 1 < se;\n"
         "          const int j1 = pair ? j + 1 : j, j2 = j + 2 < se ? j + 2 : j;\n"
         "          issue_rs<N, G>(acc, af[0], wdesc(j, 0, true), wdesc(j, 1, true), j != sb);\n"
         "          wgmma_wait<1>();  // the pair before's second slice is done with af[1]\n"
         "          load_a(af[1], row(j1), p.slice[j1].half, lane, r);\n"
         "          issue_rs<N, G>(acc, af[1], wdesc(j1, 0, pair), wdesc(j1, 1, pair), 1);\n"
         "          wgmma_wait<1>();  // slice j is done with af[0]\n"
         "          load_a(af[0], row(j2), p.slice[j2].half, lane, r);\n"
         "        }\n"
         "      } else\n"
         "      for (int j = sb; j < se; ++j) {\n", 1)],
}
# the copies: name -> the parts taken out
VARIANTS = {
    "kernel": (),
    "no load": ("load",),
    "no store": ("store",),
    "no wgmma": ("mma",),
    "load only": ("store", "mma"),
    "store only": ("load", "mma"),
    "wgmma only": ("load", "store"),
    "A from registers": ("regs",),
    "A from registers, pipelined": ("regp",),
}
# the copies that compute the whole function
FULL = ("kernel", "A from registers", "A from registers, pipelined")


def patched(parts, text: str | None = None) -> str:
    """The source of ``xpack.cu`` (or ``text``) with ``parts`` taken out."""
    return shared.patched(SOURCE, PARTS, parts, text)


def time_parts(reps: int, rounds: int) -> dict:
    """ms of every copy in every case at a 1080p layer's steps, in
    ``rounds`` interleaved rounds, and how the ``FULL`` copies agree with
    the plain version: ({case: {name: [ms]}}, {case: {name: (max |diff|,
    bit-equal share, within the gate)}})."""
    dev = layout.device_of("cuda")
    libs = shared.build_variants(SOURCE, PARTS, VARIANTS, "tap_gemm_bf16",
                                 build.load_library().tap_gemm_bf16.argtypes)
    run = timer(dev)
    times, agrees = {}, {}
    for mod in (xpack, xpack2):
        inputs = mod.probe_inputs()
        steps = xpack.steps_1080p(mod.VARIANTS)
        for v in mod.VARIANTS:
            if v.name not in CASES:
                continue
            a, w = xpack.operands(v, *inputs[v.name], dev)
            xpack._check(a, w, v.taps, steps)
            out = torch.empty((steps, v.taps.rows, v.taps.cols, v.taps.chunks * v.taps.n),
                              dtype=torch.bfloat16, device=dev)

            def call(lib):
                err = xpack.launch(lib, a, w, out, v.taps, steps)
                if err:
                    raise RuntimeError(f"xpack_parts: launch failed ({err})")

            case = f"{v.name} ({steps} steps)"
            ref = xpack.tap_gemm_plain(a, w, v.taps, steps)
            for name in FULL:
                out.zero_()
                call(libs[name])
                agrees.setdefault(case, {})[name] = xpack.agree(out, ref)
            del ref
            for _ in range(rounds):
                for name, lib in libs.items():
                    graph = shared.captured(lambda: call(lib), reps)
                    times.setdefault(case, {}).setdefault(name, []).append(
                        run(graph.replay, 1) / reps)
            del a, w, out
    return times, agrees


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.xpack_parts",
        description="Times of csrc/xpack.cu with parts of its work taken out, at a 1080p "
                    "layer's steps.")
    p.add_argument("--reps", type=int, default=20, help="launches a graph")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    times, agrees = time_parts(args.reps, args.rounds)
    print(f"ms of xpack.cu copies on {torch.cuda.get_device_name(0)}, best of {args.rounds} "
          f"rounds of {args.reps} graph replays (parts taken out: "
          + "; ".join(f"{n} = {', '.join(v) or 'none'}" for n, v in VARIANTS.items()) + "):")
    for case, by_name in times.items():
        print(f"{case:<22} " + "  ".join(f"{name} {min(ms):.4f}" for name, ms in by_name.items())
              + "  rounds " + " | ".join(" ".join(f"{t:.4f}" for t in ms)
                                         for ms in by_name.values()))
    print("the copies that compute the whole function against the plain version (max |diff|, "
          "bit-equal, within one bf16 ulp and >= 99.9% bit-equal):")
    for case, by_name in agrees.items():
        print(f"{case:<22} " + "  ".join(f"{name} {err:.3e} {equal:.4%} {'ok' if ok else 'WRONG'}"
                                         for name, (err, equal, ok) in by_name.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
