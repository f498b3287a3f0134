#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds both CUDA kernels from ``cnn_sr_tpu_torch/csrc`` (``fused_srcnn.cu``,
the 3-layer luma stack in one launch, and ``conv_layer.cu``, the layer
chain, one launch per layer), holds each against its plain PyTorch version
on the card, then drives the port's two main paths through
``api.upscale_image``: three 1920x1080 requests of the in-repo flagship
SRCNN 9-5-5 checkpoint and three of the in-repo 7-layer RGB checkpoint.
Phases, one line each:

1. device: card name and power limit, torch and CUDA versions;
2. build: each kernel's ptxas report;
3. kernel vs plain: the fused kernel at the flagship (pretrained) and
   9-1-5 (random, seed 0) stacks; the chain at the RGB (pretrained) stack,
   a ragged batch of two and the wide 9-5-5 (random). Max |kernel − plain|
   ≤ 1e-4 absolute and ≤ 1e-4 of the output's largest magnitude, because
   the f32 sums (up to 1,600 terms a layer in the fused kernel, 1,152 a
   layer over seven layers in the chain) are taken in another order;
4. flagship main path: three requests, each exactly one fused launch and
   no chain launch; 5. RGB main path: three requests, each exactly seven
   chain launches and no fused launch. Both: output (1080, 1920, 3)
   uint8, border equal to the input's RGB, within ±1 uint8 of the same
   pipeline with the plain version on the card, the requests agree, the
   net changed the image; peak device memory of a request;
6. times (CUDA events, turns plain/kernel/kernel/plain) of each kernel,
   its plain version and the library's convolutions at the main paths'
   1080p shapes, and the chain's time per layer beside the library's.

Then one JSON line of kernels, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no result; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from cnn_sr_tpu_torch import api  # noqa: E402
from cnn_sr_tpu_torch.models.srcnn import strict_f32  # noqa: E402
from cnn_sr_tpu_torch.ops.fused import build, chain, entry, reference  # noqa: E402
from cnn_sr_tpu_torch.utils.config import read_config  # noqa: E402
from cnn_sr_tpu_torch.utils.params_io import (  # noqa: E402
    init_params,
    params_to_torch,
    random_parameters,
)

FLAGSHIP = os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json")
C915 = os.path.join(ROOT, "configs", "srcnn_9-1-5.json")
RGB7 = os.path.join(ROOT, "configs", "waifu2x_7layer_rgb_pretrained.json")
ATOL = 1e-4
SEED = 0
# published peaks of one H100 SXM: f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def make_image(h: int, w: int, seed: int) -> np.ndarray:
    """Seeded RGBA frame: smooth structure plus noise (no Pillow needed)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (128 + 70 * np.sin(yy / 23.0) * np.cos(xx / 31.0)
            + 40 * np.sin((xx + yy) / 57.0) + rng.normal(0, 10, (h, w)))
    rgb = np.stack([base, 0.8 * base + 30, 255 - 0.9 * base], axis=-1)
    rgba = np.concatenate([np.clip(rgb, 0, 255).astype(np.uint8),
                           np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return rgba


def reset_counts() -> None:
    entry.LAUNCHES = 0
    chain.LAUNCHES = 0


def counts():
    return entry.LAUNCHES, chain.LAUNCHES


def kernel_vs_plain(name, params, shape, seed, launches) -> float:
    """Run ``params`` on a seeded input through ``entry.fused_forward`` and
    its plain version; ``launches`` is the (fused, chain) launches the
    call must make, which proves the route."""
    x = torch.from_numpy(
        np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)).cuda()
    before = counts()
    y = entry.fused_forward(params, x)
    ref = reference.fused_forward(params, x)
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(counts(), before))
    check(made == launches, f"{name}: launches (fused, chain) {made}, expected {launches}")
    check(y.shape == ref.shape, f"{name}: shape {tuple(y.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[kernel] {name} {shape}: max_abs_err {err:.3e}, "
          f"max |plain| {scale:.3e}, rel {err / max(scale, 1e-30):.3e}")
    check(err <= ATOL, f"{name}: max abs err {err} > {ATOL}")
    check(err <= ATOL * scale, f"{name}: err {err} > {ATOL} x output scale {scale}")
    return err


def main_path(name, cfg, params, plain_fn, launches, smi):
    """Three 1920x1080 requests through ``api.upscale_image``, each making
    exactly ``launches`` = (fused, chain) launches, checked against the
    same pipeline with the plain version (``plain_fn``) on the card.
    Returns the path's launch counts, read just after its run."""
    h, w = 1080, 1920
    rgba = make_image(h, w, SEED)
    outs, req_ms, peak = [], [], []
    reset_counts()
    for _ in range(3):
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs.append(api.upscale_image(cfg, params, rgba))
        req_ms.append((time.perf_counter() - t0) * 1e3)
        peak.append(torch.cuda.max_memory_allocated())
        made = tuple(a - b for a, b in zip(counts(), before))
        check(made == launches,
              f"{name}: a request made (fused, chain) launches {made}, expected {launches}")
    total = counts()

    plain_out = plain_fn(torch.from_numpy(rgba).cuda()).cpu().numpy()
    s = cfg.total_padding()
    pad = s // 2
    inside = np.zeros((h, w), bool)
    inside[pad:pad + h - s, pad:pad + w - s] = True
    diff = 0
    for out in outs:
        check(out.shape == (h, w, 3) and out.dtype == np.uint8,
              f"{name}: output {out.shape} {out.dtype}")
        check(np.array_equal(out[~inside], rgba[..., :3][~inside]),
              f"{name}: border differs from the input")
        diff = max(diff, int(np.abs(out.astype(np.int16) - plain_out.astype(np.int16)).max()))
        check(diff <= 1, f"{name}: output vs plain pipeline: max diff {diff} uint8")
        check(np.array_equal(out, outs[0]), f"{name}: requests disagree")
    check(bool((outs[0][inside] != rgba[..., :3][inside]).any()),
          f"{name}: the net left the image unchanged")
    mpix = h * w / 1e6
    print(f"[main] {smi} | 3 requests 1920x1080 {name}: "
          + ", ".join(f"{ms:.2f} ms ({mpix / ms * 1e3:.1f} MPix/s)" for ms in req_ms)
          + f" | launches (fused, chain) {total} | max diff vs plain pipeline {diff} uint8"
          + " | peak device memory per request "
          + ", ".join(f"{b / 2**20:.1f}" for b in peak) + " MiB")
    return total, rgba


def time_ms(fn, iters: int = 10) -> float:
    """Mean ms of ``fn`` over ``iters`` calls, after one untimed call
    (first-call costs: the allocator's growth, cuDNN's plan)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def library_weights(params):
    """``(OIHW channels-last weight, bias)`` per layer, for ``library_convs``."""
    return [(l["w"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last),
             l["b"]) for l in params]


def library_convs(params, x: torch.Tensor) -> torch.Tensor:
    """The same layers as PyTorch's own convolutions (cuDNN, f32, TF32
    off) on channels-last tensors, ReLU in place; timed as the yardstick,
    never used by the port. ``params`` from ``library_weights``."""
    y = x.permute(0, 3, 1, 2)
    with strict_f32():
        for i, (w, b) in enumerate(params):
            y = torch.nn.functional.conv2d(y, w, b)
            if i != len(params) - 1:
                y.relu_()
    return y


def bound_ms(params, shape) -> tuple:
    """The least time of the stack's layers on this card: the larger of
    their f32 operations over the f32 peak and their bytes (each layer's
    input, weights and output once) over the memory rate."""
    n, h, w, c = shape
    flops = moved = 0
    for layer in params:
        f, _, k, m = layer["w"].shape
        oh, ow = h - f + 1, w - f + 1
        flops += 2 * n * oh * ow * f * f * k * m
        moved += 4 * (n * h * w * k + f * f * k * m + m + n * oh * ow * m)
        h, w = oh, ow
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_stack(name, params, x, smi) -> dict:
    """Kernel, plain and library times of one stack on ``x``, in turns:
    plain, kernel, kernel, plain, library, library."""
    kern = lambda: entry.fused_forward(params, x)  # noqa: E731
    plain = lambda: reference.fused_forward(params, x)  # noqa: E731
    lib_params = library_weights(params)
    lib = lambda: library_convs(lib_params, x)  # noqa: E731
    y, ref, yl = kern(), plain(), lib()
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    check(err <= ATOL, f"{name} at {tuple(x.shape)}: kernel vs plain {err}")
    check(float((yl.permute(0, 2, 3, 1) - ref).abs().max()) <= ATOL,
          f"{name}: library convolutions disagree with the plain version")
    p1, k1, k2, p2, l1, l2 = (time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain),
                              time_ms(lib), time_ms(lib))
    bound, bound_by = bound_ms(params, tuple(x.shape))
    print(f"[time] {smi} | {name} {tuple(x.shape)}: kernel {k1:.3f}/{k2:.3f} ms, "
          f"plain (cuDNN f32, TF32 off) {p1:.3f}/{p2:.3f} ms, library convolutions "
          f"{l1:.3f}/{l2:.3f} ms, bound {bound:.3f} ms ({bound_by})")
    return {"err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "library_ms": (l1 + l2) / 2, "bound_ms": bound, "bound_by": bound_by}


def layer_times(params, x, smi) -> None:
    """The chain's time per layer on the stack's own activations, beside
    the library's convolution of that layer (CUDA events)."""
    parts = []
    for i, layer in enumerate(params):
        lib_layer = library_weights([layer])
        k_ms = time_ms(lambda: entry.fused_forward([layer], x))
        l_ms = time_ms(lambda: library_convs(lib_layer, x))
        bound, bound_by = bound_ms([layer], tuple(x.shape))
        _, _, k, n = layer["w"].shape
        parts.append(f"L{i + 1} {k}->{n} {k_ms:.3f}/{l_ms:.3f}/{bound:.3f} ({bound_by})")
        x = reference.fused_forward([layer], x).relu_()
    print(f"[layers] {smi} | chain/library/bound ms per layer: " + ", ".join(parts))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    smi = smi_line()
    dev = torch.device("cuda")
    print(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    info = build.build()
    print(f"[build] {info['seconds']:.1f} s -> {os.path.relpath(info['path'], ROOT)}")
    for src, log in sorted(info["logs"].items()):
        ptxas = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"[build] {src}: {' | '.join(ptxas)}")
    build.load_library()

    cfg = read_config(FLAGSHIP)
    params = params_to_torch(init_params(cfg)[0], dev)
    cfg915 = read_config(C915)
    params915 = params_to_torch(
        random_parameters(cfg915.layer_specs(), cfg915.distributions, seed=0), dev)
    cfg_rgb = read_config(RGB7)
    check(cfg_rgb.channels == 3 and len(cfg_rgb.layer_specs()) == 7, "RGB config")
    params_rgb = params_to_torch(init_params(cfg_rgb)[0], dev)
    # the wide 9-5-5 (n1 = 128, n2 = 64) does not fit the fused kernel's tiles
    rng = np.random.default_rng(SEED)
    wide = [{"w": torch.from_numpy((rng.standard_normal((f, f, k, n)) * (2 / (f * f * k)) ** 0.5)
                                   .astype(np.float32)).to(dev),
             "b": torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32)).to(dev)}
            for f, k, n in [(9, 1, 128), (5, 128, 64), (5, 64, 1)]]

    fused_errs = [
        kernel_vs_plain("flagship 9-5-5", params, (1, 80, 272, 1), SEED, (1, 0)),
        kernel_vs_plain("flagship 9-5-5 ragged", params, (2, 97, 131, 1), SEED + 1, (1, 0)),
        kernel_vs_plain("9-1-5", params915, (1, 80, 272, 1), SEED + 2, (1, 0))]
    chain_errs = [
        kernel_vs_plain("chain RGB 7-layer", params_rgb, (1, 80, 272, 3), SEED + 3, (0, 7)),
        kernel_vs_plain("chain RGB 7-layer ragged", params_rgb, (2, 97, 131, 3), SEED + 4,
                        (0, 7)),
        kernel_vs_plain("chain wide 9-5-5", wide, (1, 80, 272, 1), SEED + 5, (0, 3))]

    # the main paths: three requests each through the public API
    flagship_counts, rgba = main_path(
        "flagship 9-5-5", cfg, params,
        lambda img: api._upscale_luma(lambda x: reference.fused_forward(params, x), img,
                                      add_mean=cfg.zero_mean_target,
                                      squared_mean=cfg.subtract_squared_mean),
        (1, 0), smi)
    rgb_counts, _ = main_path(
        "RGB 7-layer", cfg_rgb, params_rgb,
        lambda img: api._upscale_rgb(lambda x: reference.fused_forward(params_rgb, x), img,
                                     add_mean=cfg_rgb.zero_mean_target),
        (0, 7), smi)

    # each kernel at its main path's 1080p input
    from cnn_sr_tpu_torch.ops.color import extract_luma, subtract_mean

    img = torch.from_numpy(rgba).to(dev)
    x_luma = subtract_mean(extract_luma(img))[0][None, ..., None].contiguous()
    rgb = img[..., :3].to(torch.float32) / 255.0
    x_rgb = (rgb - rgb.mean(dim=(0, 1), keepdim=True))[None].contiguous()
    t_fused = time_stack("fused_srcnn, flagship 9-5-5", params, x_luma, smi)
    t_chain = time_stack("conv_layer chain, RGB 7-layer", params_rgb, x_rgb, smi)
    layer_times(params_rgb, x_rgb, smi)
    fused_errs.append(t_fused["err"])
    chain_errs.append(t_chain["err"])

    def row(name, source, replaces, launches, errs, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(errs), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    print(json.dumps({"kernels": [
        row("fused_srcnn", "cnn_sr_tpu_torch/csrc/fused_srcnn.cu",
            "cnn_sr_tpu/ops/pallas_fused/kernel.py:38", flagship_counts[0], fused_errs,
            t_fused),
        row("conv_layer", "cnn_sr_tpu_torch/csrc/conv_layer.cu",
            "cnn_sr_tpu/ops/pallas_fused/kernel.py:499", rgb_counts[1], chain_errs,
            t_chain),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
