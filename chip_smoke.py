#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernel from ``cnn_sr_tpu_torch/csrc``, holds it against its
plain PyTorch version on the card, then serves three 1920x1080 requests
through the port's main path (``api.upscale_image`` with the in-repo
flagship SRCNN 9-5-5 checkpoint) and checks their output. Phases, one line
each:

1. device: card name and power limit, torch and CUDA versions;
2. build: the kernel's build time and its ptxas report;
3. kernel vs plain at the flagship (pretrained) and 9-1-5 (random, seed 0)
   stacks: max |kernel − plain| ≤ 1e-4 absolute, and ≤ 1e-4 of the output's
   largest magnitude, because the f32 sums of up to 1,600 terms are taken
   in another order;
4. main path: three requests, each exactly one kernel launch, output
   (1080, 1920, 3) uint8, border equal to the input's RGB, within ±1 uint8
   of the same pipeline with the plain version on the card;
5. kernel and plain times at the flagship 1080p shape (CUDA events).

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
from cnn_sr_tpu_torch.ops.fused import build, entry, reference  # noqa: E402
from cnn_sr_tpu_torch.utils.config import read_config  # noqa: E402
from cnn_sr_tpu_torch.utils.params_io import (  # noqa: E402
    init_params,
    params_to_torch,
    random_parameters,
)

FLAGSHIP = os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json")
C915 = os.path.join(ROOT, "configs", "srcnn_9-1-5.json")
ATOL = 1e-4
SEED = 0


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


def kernel_vs_plain(name, params, shape, seed) -> float:
    x = torch.from_numpy(
        np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)).cuda()
    y = entry.fused_forward(params, x)
    ref = reference.fused_forward(params, x)
    torch.cuda.synchronize()
    check(y.shape == ref.shape, f"{name}: shape {tuple(y.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[kernel] {name} {shape}: max_abs_err {err:.3e}, "
          f"max |plain| {scale:.3e}, rel {err / max(scale, 1e-30):.3e}")
    check(err <= ATOL, f"{name}: max abs err {err} > {ATOL}")
    check(err <= ATOL * scale, f"{name}: err {err} > {ATOL} x output scale {scale}")
    return err


def time_ms(fn, iters: int = 10) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] {info['seconds']:.1f} s -> {os.path.relpath(info['path'], ROOT)} "
          f"| {' | '.join(ptxas)}")
    build.load_library()

    cfg = read_config(FLAGSHIP)
    params_np, _ = init_params(cfg)
    params = params_to_torch(params_np, dev)
    cfg915 = read_config(C915)
    params915 = params_to_torch(
        random_parameters(cfg915.layer_specs(), cfg915.distributions, seed=0), dev)
    errs = [kernel_vs_plain("flagship 9-5-5", params, (1, 80, 272, 1), SEED),
            kernel_vs_plain("flagship 9-5-5 ragged", params, (2, 97, 131, 1), SEED + 1),
            kernel_vs_plain("9-1-5", params915, (1, 80, 272, 1), SEED + 2)]

    # main path: three requests through the public API
    h, w = 1080, 1920
    rgba = make_image(h, w, SEED)
    outs, req_ms = [], []
    entry.LAUNCHES = 0
    for _ in range(3):
        before = entry.LAUNCHES
        t0 = time.perf_counter()
        outs.append(api.upscale_image(cfg, params, rgba))
        req_ms.append((time.perf_counter() - t0) * 1e3)
        check(entry.LAUNCHES == before + 1,
              f"request launched the kernel {entry.LAUNCHES - before} times")
    launches = entry.LAUNCHES

    plain_out = api._upscale_luma(
        lambda x: reference.fused_forward(params, x), torch.from_numpy(rgba).to(dev),
        add_mean=cfg.zero_mean_target, squared_mean=cfg.subtract_squared_mean,
    ).cpu().numpy()
    s = cfg.total_padding()
    pad = s // 2
    inside = np.zeros((h, w), bool)
    inside[pad:pad + h - s, pad:pad + w - s] = True
    for out in outs:
        check(out.shape == (h, w, 3) and out.dtype == np.uint8,
              f"output {out.shape} {out.dtype}")
        check(np.array_equal(out[~inside], rgba[..., :3][~inside]),
              "border differs from the input")
        diff = int(np.abs(out.astype(np.int16) - plain_out.astype(np.int16)).max())
        check(diff <= 1, f"output vs plain pipeline: max diff {diff} uint8")
        check(np.array_equal(out, outs[0]), "requests disagree")
    check(bool((outs[0][inside] != rgba[..., :3][inside]).any()),
          "the net left the image unchanged")
    mpix = h * w / 1e6
    print(f"[main] {smi} | 3 requests 1920x1080 flagship 9-5-5: "
          + ", ".join(f"{ms:.2f} ms ({mpix / ms * 1e3:.1f} MPix/s)" for ms in req_ms)
          + f" | launches {launches} | max diff vs plain pipeline {diff} uint8")

    # kernel and plain at the main path's shape; turns: plain, kernel, kernel, plain
    img = torch.from_numpy(rgba).to(dev)
    from cnn_sr_tpu_torch.ops.color import extract_luma, subtract_mean

    x = subtract_mean(extract_luma(img))[0][None, ..., None].contiguous()
    kern = lambda: entry.fused_forward(params, x)  # noqa: E731
    plain = lambda: reference.fused_forward(params, x)  # noqa: E731
    kern(), plain()
    p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
    errs.append(float((kern() - plain()).abs().max()))
    check(errs[-1] <= ATOL, f"1080p kernel vs plain {errs[-1]}")
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"[time] {smi} | conv stack 1x1080x1920x1: kernel {k1:.3f}/{k2:.3f} ms, "
          f"plain (cuDNN f32, TF32 off) {p1:.3f}/{p2:.3f} ms")

    print(json.dumps({"kernels": [{
        "name": "fused_srcnn",
        "route": "cuda",
        "source": "cnn_sr_tpu_torch/csrc/fused_srcnn.cu",
        "replaces": "cnn_sr_tpu/ops/pallas_fused/kernel.py:38",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
