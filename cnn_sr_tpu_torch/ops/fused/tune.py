"""Block shapes of the f32 kernels, built and timed side by side on the card.

    python -m cnn_sr_tpu_torch.ops.fused.tune [--reps 2] [--variants ...]
        [--chain-variants ...]

The fused kernel's block shape is fixed at compile time in
``csrc/fused_srcnn.cu``: ``kThreads`` and each layer's ``(kNB, kPX)``
(output channels and rows a thread computes). For each of
``VARIANTS`` this copies ``csrc/`` into a temporary directory, rewrites
those constants, compiles ``fused_srcnn.cu`` alone into a library of its
own (every ``nvcc`` at once), holds the variant against the plain version
within 1e-4 (the timed stacks at a ragged batch and at 1080p, and
``CHECKED`` at the ragged batch), and then times every variant at the
flagship 9-5-5 and the 9-1-5 stacks on a 1080p plane, ``--reps`` turns
in a row (CUDA events, 10 launches each).

The chain's width classes are fixed in ``csrc/ffma_plan.cuh``
(``kChainNarrow``, ``kChainMid``, ``kChainWide``: NB, PX, threads,
blocks an SM, channels a stage; ``entry.CHAIN_SHAPE``).
Each of ``CHAIN_VARIANTS`` changes one class: its library is
``conv_layer.cu`` (with ``fused_srcnn.cu``, which holds the error
strings) compiled with that class rewritten, its plans
``entry._layer_plan`` at the same shapes. Each is held against the plain version within 1e-4
of the output's largest magnitude (the RGB 7-layer stack at a ragged
batch and at 1080p, and ``CHAIN_CHECKED``), then the RGB layers of its
class are timed at 1080p beside the shipped shape, in turns.

Prints each variant's ptxas registers and spills beside its times. The
port itself never loads these libraries: it runs the shapes in
``csrc/``.
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

from . import build, chain, entry, reference

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


# name -> (width class, (NB, PX, threads, blocks an SM, most channels a
# stage)); the other classes keep entry.CHAIN_SHAPE. Two block shapes a
# class beside the shipped one.
CHAIN_VARIANTS = {
    "narrow_2blocks_kc16": ("narrow", (4, 2, 512, 2, 16)),
    "narrow_px4_256": ("narrow", (4, 4, 256, 2, 16)),
    "mid_512_1block": ("mid", (8, 4, 512, 1, 16)),
    "mid_nb16": ("mid", (16, 4, 512, 1, 16)),
    "wide_256_2blocks": ("wide", (16, 4, 256, 2, 16)),
    "wide_nb8": ("wide", (8, 4, 512, 1, 16)),
}
# the RGB model's layers (configs/waifu2x_7layer_rgb*.json) and the other
# chain stacks each variant is held against the plain version on
RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128), (3, 128, 128),
        (3, 128, 3)]
CHAIN_CHECKED = [[(3, 1, 128), (9, 128, 16), (3, 16, 8), (3, 8, 1)],
                 [(9, 1, 128), (5, 128, 64), (5, 64, 1)], [(3, 3, 96), (3, 96, 200), (3, 200, 3)]]


def chain_shapes(name: str) -> dict:
    """The width classes of a chain variant (or "shipped")."""
    if name == "shipped":
        return dict(entry.CHAIN_SHAPE)
    cls, shape = CHAIN_VARIANTS[name]
    return {**entry.CHAIN_SHAPE, cls: shape}


def chain_variant_source(src: str, shapes: dict) -> str:
    """``ffma_plan.cuh``'s text with the chain's width classes replaced."""
    hits = 0
    for cls in ("narrow", "mid", "wide"):
        vals = ", ".join(str(v) for v in shapes[cls])
        src, h = re.subn(rf"constexpr int kChain{cls.capitalize()}\[5\] = \{{[^}}]*\}};",
                         f"constexpr int kChain{cls.capitalize()}[5] = {{{vals}}};", src)
        hits += h
    if hits != 3:
        raise ValueError("csrc/ffma_plan.cuh no longer declares the chain's classes as expected")
    return src


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


def build_chain_variants(names, tmp: str) -> dict:
    """Compile each chain variant's library into ``tmp``; returns
    name -> (library, ptxas (name, registers, spills) of its f=3 f32
    kernels)."""
    nvcc = build.find_nvcc()
    text = (build.CSRC / "ffma_plan.cuh").read_text()
    jobs = {}
    for name in names:
        d = os.path.join(tmp, "chain_" + name)
        shutil.copytree(build.CSRC, d)
        with open(os.path.join(d, "ffma_plan.cuh"), "w") as fh:
            fh.write(chain_variant_source(text, chain_shapes(name)))
        lib = os.path.join(d, "lib.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", lib, os.path.join(d, "conv_layer.cu"),
               os.path.join(d, "fused_srcnn.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    out = {}
    for name, (lib, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise build.KernelBuildError(f"{name}: nvcc failed\n{err}")
        cdll = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        cdll.conv_layer_forward.argtypes = [p] * 4 + [i] * 11 + [p]
        cdll.conv_layer_forward.restype = i
        cdll.cnn_sr_error_string.argtypes = [i]
        cdll.cnn_sr_error_string.restype = ctypes.c_char_p
        # f = 3 instances: "ILi<NB>ELi<PX>ELi3E" in the mangled name
        out[name] = (cdll, [e for e in build.ptxas_entries(err, "conv_layer_kernel")
                            if re.search(r"ILi\d+ELi\d+ELi3E", e[0])])
    return out


def chain_plan(shapes, f: int, k: int, n: int) -> entry.LayerPlan:
    """A chain variant's plan of one layer, at its width classes ``shapes``."""
    return entry._layer_plan(f, k, n, shapes[entry.chain_class(n)])


def chain_run(lib, shapes, params, x):
    """The stack ``params`` over ``x`` through a chain variant's library,
    one layer a launch into a fresh output."""
    stream = torch.cuda.current_stream().cuda_stream
    last = len(params) - 1
    for i, layer in enumerate(params):
        f, _, k, n = layer["w"].shape
        plan = chain_plan(shapes, f, k, n)
        wt, bt = entry.packed_f32(layer["w"], layer["b"], plan.nb)
        y = torch.empty((x.shape[0], x.shape[1] - f + 1, x.shape[2] - f + 1, n), device=x.device)
        chain.layer_forward(lib, x, wt, bt, y, plan, i == 0, i == last, False, stream)
        x = y
    return x


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


def chain_main(names, reps: int, smi: str, stack) -> None:
    """Build, check and time the chain variants ``names`` beside the
    shipped width classes (``CHAIN_VARIANTS``)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rgb = stack(RGB7)
    checked = [stack(specs) for specs in CHAIN_CHECKED]
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 1080, 1920, 3)).astype(np.float32)).to(dev)
    xr = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 97, 131, 3)).astype(np.float32)).to(dev)
    names = ["shipped"] + [n for n in names if n != "shipped"]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_chain_variants(names, tmp)
        for name in names:
            lib, ptx = libs[name]
            shapes = chain_shapes(name)
            cases = [(rgb, xr), (rgb, x)] + [
                (p, torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 50, 61, p[0]["w"].shape[2]))
                                     .astype(np.float32)).to(dev)) for p in checked]
            for params, inp in cases:
                ref = reference.fused_forward(params, inp)
                err = float((chain_run(lib, shapes, params, inp) - ref).abs().max())
                if err > 1e-4 * float(ref.abs().max()):
                    dims = [tuple(l["w"].shape) for l in params]
                    raise SystemExit(f"tune: chain {name} {dims} {tuple(inp.shape)}: "
                                     f"max |kernel - plain| {err}")
            nb_px = [re.search(r"ILi(\d+)ELi(\d+)", n).groups() for n, _, _ in ptx]
            print(f"[tune] chain {name}: classes {shapes}; f=3 kernels: "
                  + ", ".join(f"NB/PX {q} {r} registers, {sp}"
                              for q, (_, r, sp) in zip(nb_px, ptx))
                  + "; within 1e-4 of the plain version's magnitude")
        # each RGB layer on the stack's own 1080p activations, in its class's
        # variants beside the shipped shape, in turns
        stream = torch.cuda.current_stream().cuda_stream
        src = x
        last = len(rgb) - 1
        for i, layer in enumerate(rgb):
            f, _, k, n = layer["w"].shape
            cls = entry.chain_class(n)
            group = ["shipped"] + [v for v in names
                                   if v != "shipped" and CHAIN_VARIANTS[v][0] == cls]
            dst = torch.empty((1, src.shape[1] - f + 1, src.shape[2] - f + 1, n), device=dev)
            runs = {}
            for name in group:
                plan = chain_plan(chain_shapes(name), f, k, n)
                wt, bt = entry.packed_f32(layer["w"], layer["b"], plan.nb)
                runs[name] = (lambda lib=libs[name][0], plan=plan, wt=wt, bt=bt:
                              chain.layer_forward(lib, src, wt, bt, dst, plan, i == 0, i == last,
                                                  False, stream), plan)
            for rep in range(reps):
                order = group if rep % 2 == 0 else group[::-1]
                ms = {name: time_ms(runs[name][0]) for name in order}
                print(f"[tune] {smi} | chain L{i + 1} {k}->{n} ({cls}) 1080p turn {rep + 1}, ms: "
                      + ", ".join(f"{name} {ms[name]:.3f} (tile {runs[name][1].tile_h}x"
                                  f"{runs[name][1].tile_w}, {runs[name][1].items} threads, kc "
                                  f"{runs[name][1].kc})" for name in group))
            runs["shipped"][0]()
            src = dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--chain-variants", nargs="*", default=list(CHAIN_VARIANTS))
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
    if args.chain_variants:
        chain_main(args.chain_variants, args.reps, smi, stack)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
