"""Block shapes of the f32 fused kernel, built and timed side by side on the card.

    python -m cnn_sr_tpu_torch.ops.fused.tune [--reps 2]

The kernel's block shape is fixed at compile time in
``csrc/fused_srcnn.cu``: ``kThreads`` and each layer's ``(kNB, kPX)``
(output channels and rows a thread computes). For each of
``VARIANTS`` this copies ``csrc/`` into a temporary directory, rewrites
those constants, compiles ``fused_srcnn.cu`` alone into a library of its
own (every ``nvcc`` at once), holds the variant against the plain version
within 1e-4 (the timed stacks at a ragged batch and at 1080p, and
``CHECKED`` at the ragged batch), and then times every variant at the
flagship 9-5-5 and the 9-1-5 stacks on a 1080p plane, ``--reps`` turns
in a row (CUDA events, 10 launches each). Prints each variant's ptxas
registers and spills beside its times. The port itself never loads these
libraries: it runs the shape in ``csrc/fused_srcnn.cu``.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from . import build, entry, reference

# name -> (threads, ((NB, PX) of conv1, conv2, conv3)); "shipped" is the
# shape csrc/fused_srcnn.cu holds. Every shape but 512_conv2_px4 (400
# conv2 items) gives each thread one conv2 item at the flagship.
VARIANTS = {
    "shipped": (640, ((8, 4), (4, 5), (4, 2))),
    "640_conv1_nb4_px8": (640, ((4, 8), (4, 5), (4, 2))),
    "640_conv3_px1": (640, ((8, 4), (4, 5), (4, 1))),
    "320_conv2_nb8": (320, ((8, 8), (8, 5), (4, 2))),
    "320_conv1_px4": (320, ((8, 4), (8, 5), (4, 2))),
    "512_conv2_px4": (512, ((8, 4), (8, 4), (4, 1))),
    "160_conv2_nb16": (160, ((8, 8), (16, 5), (4, 2))),
}
FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]
C915 = [(9, 1, 64), (1, 64, 32), (5, 32, 1)]
# widths the kernel pads, and a conv2 of 64 outputs (more items than threads)
CHECKED = [[(9, 1, 60), (5, 60, 28), (5, 28, 1)], [(9, 1, 12), (1, 12, 4), (5, 4, 1)],
           [(9, 1, 32), (5, 32, 64), (5, 64, 1)]]


def variant_source(src: str, threads: int, shape) -> str:
    """``fused_srcnn.cu``'s text with the block shape replaced."""
    src, hits = re.subn(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};",
                        src)
    for i, (nb, px) in enumerate(shape, 1):
        src, h = re.subn(rf"constexpr int kNB{i} = \d+, kPX{i} = \d+;",
                         f"constexpr int kNB{i} = {nb}, kPX{i} = {px};", src)
        hits += h
    if hits != 4:
        raise ValueError("csrc/fused_srcnn.cu no longer declares its block shape as expected")
    return src


def build_variants(names, tmp: str) -> dict:
    """Compile each variant's ``fused_srcnn.cu`` into ``tmp``; returns
    name -> (library path, ptxas report of the f32 kernel)."""
    nvcc = build.find_nvcc()
    text = (build.CSRC / "fused_srcnn.cu").read_text()
    jobs = {}
    for name in names:
        d = os.path.join(tmp, name)
        shutil.copytree(build.CSRC, d)
        with open(os.path.join(d, "fused_srcnn.cu"), "w") as fh:
            fh.write(variant_source(text, *VARIANTS[name]))
        lib = os.path.join(d, "lib.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", lib, os.path.join(d, "fused_srcnn.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"{name}: nvcc failed\n{err}")
        out[name] = (lib, build.ptxas_entry(err, "fused_srcnn_kernel"))
    return out


def launcher(path: str, shape):
    """A function (params, x) -> y running one variant's library, of
    (NB, PX) per layer ``shape``."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_srcnn_forward.argtypes = [p] * 8 + [i] * 12 + [p]
    lib.fused_srcnn_forward.restype = i

    def run(params, x):
        dims = [(l["w"].shape[0], l["w"].shape[2], l["w"].shape[3]) for l in params]
        wbuf, smem = entry.smem_plan(x.shape[3], dims, shape)
        ops = entry.f32_weights(params, tuple(nb for nb, _ in shape))
        n, h, w, c = x.shape
        shrink = sum(f - 1 for f, _, _ in dims)
        y = torch.empty((n, h - shrink, w - shrink, dims[2][2]), device=x.device)
        (f1, _, n1), (f2, _, n2), (f3, _, n3) = dims
        err = lib.fused_srcnn_forward(x.data_ptr(), *(t.data_ptr() for pr in ops for t in pr),
                                      y.data_ptr(), n, h, w, c, f1, n1, f2, n2, f3, n3, wbuf,
                                      smem, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return y
    return run


def time_ms(fn, iters: int = 10) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune: needs an NVIDIA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)

    def stack(specs):
        return [{"w": torch.from_numpy((rng.standard_normal((f, f, k, n))
                                        * (2 / (f * f * k)) ** 0.5).astype(np.float32)).to(dev),
                 "b": torch.from_numpy((rng.standard_normal(n) * 0.05)
                                       .astype(np.float32)).to(dev)} for f, k, n in specs]

    stacks = {"flagship 9-5-5": stack(FLAGSHIP), "9-1-5": stack(C915)}
    checked = [stack(specs) for specs in CHECKED]
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 1080, 1920, 1)).astype(np.float32)).to(dev)
    xr = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 97, 131, 1)).astype(np.float32)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(args.variants, tmp)
        runs = {}
        for name in args.variants:
            threads, shape = VARIANTS[name]
            runs[name] = launcher(libs[name][0], shape)
            cases = [(p, inp) for p in stacks.values() for inp in (xr, x)]
            for params, inp in cases + [(p, xr) for p in checked]:
                err = float((runs[name](params, inp)
                             - reference.fused_forward(params, inp)).abs().max())
                if err > 1e-4:
                    dims = [tuple(l["w"].shape) for l in params]
                    raise SystemExit(f"tune: {name} {dims} {tuple(inp.shape)}: "
                                     f"max |kernel - plain| {err}")
            regs, spill = libs[name][1]
            print(f"[tune] {name}: {threads} threads, (NB, PX) {shape}, {regs} registers, "
                  f"{spill}")
        for sname, params in stacks.items():
            for rep in range(args.reps):
                parts = [f"{name} {time_ms(lambda: runs[name](params, x)):.3f}"
                         for name in args.variants]
                print(f"[tune] {smi} | {sname} f32 {tuple(x.shape)} turn {rep + 1}, ms: "
                      + ", ".join(parts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
