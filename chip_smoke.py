#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``cnn_sr_tpu_torch/csrc`` (the 3-layer luma
stack in one launch, ``fused_srcnn.cu`` in f32 on the CUDA cores
(``ffma_stage.cuh``) and ``fused_wgmma.cu`` in the bf16 stream on the
tensor cores by ``wgmma``, and ``conv_layer.cu``, the layer chain, one
launch per layer, in f32 on the CUDA cores and in the bf16 stream on the
tensor cores (its first layer on ``conv_first_wgmma.cu``, every middle
layer on ``conv_wgmma.cu`` and the last on ``conv_last_wgmma.cu``, all
three ``wgmma``, their stores and the middle and last layers' loads by
tensor copies); and the
probes' ``winograd.cu``, ``parity_copy.cu``, ``wino5.cu``, ``rowpair.cu``
and ``xpack.cu``, of which ``winograd.cu`` and ``wino5.cu`` run on the
tensor cores by ``mma.sync`` and ``rowpair.cu`` and ``xpack.cu`` by
``wgmma``),
holds each against its
plain PyTorch version on the card, then drives the port's main paths
(training among them, ``[train]``):
three 1920x1080 requests of the in-repo flagship SRCNN 9-5-5 checkpoint
and three of the in-repo 7-layer RGB checkpoint through
``api.upscale_image`` in f32, one round of the HTTP server's
``DeviceWorker`` serving both checkpoints in bf16, and the entry points
of the six probes (``cnn_sr_tpu_torch.probes``). Phases, one line each:

1. device: card name and power limit, torch and CUDA versions;
2. build: each source's ptxas report, the registers of the f32 fused
   kernel, of every f32 chain kernel instance and of every ``winograd.cu``
   and ``wino5.cu`` instance (as many as their plans make; none may
   spill), and the HMMA instructions in the SASS of
   ``winograd_f2x3_forward``'s and of ``wino5_forward``'s, in each of its
   four modes (``cuobjdump -sass``), > 0; ``rowpair_kernel``'s
   four instances and ``tap_gemm_kernel``'s six (registers and spills:
   none, beside their plans' dynamic shared bytes),
   ``conv_first_wgmma_kernel``'s seven instances (the same, and the HGMMA
   of each, beside the plans at RGB L1, the flagship's and the wide
   9-5-5's conv1 and f = 9 4 -> 256), ``conv_layer_wgmma_kernel``'s
   nine instances (the same, and the HGMMA of each, beside the plans at
   the RGB L2-L6 and 128 -> 64), ``conv_last_wgmma_kernel``'s ten (the
   same, beside the plans at RGB L7, f = 5 32 -> 1, f = 9 256 -> 1 and
   f = 17 32 -> 8), each beside its SAME twins (``entry.same_instances``:
   one first, two middle, one last), ``fused_wgmma_kernel`` and
   ``wgmma_desc_probe_kernel`` (the same, the fused plan at the flagship,
   9-1-5 and RGB 3-layer stacks, and ptxas's injected ``warpgroup.arrive``
   count) and the HGMMA (``wgmma``) in the SASS of each, > 0; then the
   shifted-descriptor check (``descriptor_check``): one ``wgmma`` whose A
   starts 1, 7, 16 and 23 positions into a tile, in the no-swizzle planes
   the fused kernel reads (raster and 8 x 8 patch), in 128-byte swizzled
   rows with the matrix-base offset, and in 64-byte swizzled rows of 32
   lanes from their second 16 (the wgmma chain's boxes at K <= 32), equal
   to numpy's product where a kernel relies on it;
3. kernel vs plain, f32: the fused kernel at the flagship (pretrained)
   and 9-1-5 (random, seed 0) stacks; the chain at the RGB (pretrained)
   stack, a ragged batch of two, the wide 9-5-5 and a 4-layer stack with
   an f=9 layer over 128 channels (random; its window streams in channel
   chunks). Max |kernel − plain| ≤ 1e-4 absolute and ≤ 1e-4 of the output's largest
   magnitude, because the f32 sums (up to 1,600 terms a layer in the
   fused kernel, 1,152 a layer over seven layers in the chain) are taken
   in another order; and bf16: the fused kernel at the flagship, a
   ragged batch of two, the 9-1-5, the narrow 9-5-5 (n = 8) in a batch of
   three and the 3-layer RGB stack; the chain at the RGB stack, a
   ragged batch (both with L2-L6 on the wgmma stage and L7 on the
   last-layer kernel), the same 4-layer
   stack (its two narrow middles on the wgmma stage) and a 4-layer stack
   with two wgmma layers (64 -> 256, and f=9 over 256 channels to 128),
   a 4-layer stack whose last layer has f = 4 and a 3-layer stack whose
   first layer, f = 9 over 4 channels into 256, takes the widest branch of
   the first-layer plan (four chunks of N, one slab, W streamed); the
   ragged RGB batch and the 4->256 stack on inputs in (−1.3, 1.3), past
   the first layer's int8 clip at ±1, the others in (−0.5, 0.5).
   Max |kernel − plain| ≤ 2^-7
   of the output's largest magnitude: the products are exact in both, but a sum taken in
   another order can round an activation to the neighbouring bf16 value;
4. flagship main path: three requests, each exactly one fused f32 launch
   and no other; 5. RGB main path: three requests, each exactly seven
   chain f32 launches and no other. Both: output (1080, 1920, 3) uint8,
   border equal to the input's RGB, within ±1 uint8 of the same pipeline
   with the plain version on the card, the requests agree, the net
   changed the image; peak device memory of a request;
6. serve main path, bf16: a ``DeviceWorker`` with slots ``default``
   (flagship) and ``rgb`` (RGB), ``bucket=64``, ``max_batch=8``; four
   1080p flagship frames (one batch, one fused bf16 launch), two 1080p
   RGB frames (one batch, seven chain bf16 launches) and one 1000x700
   flagship frame (a bucketed single, padded to 1024x704) queued before
   it starts, then five sequential single 1080p flagship jobs. Each
   result: shape, border, within ±1 (luma) or ±2 (RGB) of the plain bf16
   pipeline with 99.9% of its bytes within ±1, within JAX's bf16 gates
   (4 luma, 6 RGB) of the f32 kernel pipeline; exact launch counts;
   (the RGB batch's L2-L6 on the wgmma stage and L7 on the last-layer
   kernel, each counted apart);
   ``ok`` 12, ``batched_jobs`` 6, ``errors`` 0; latencies, frames per
   second batched against single, peak device memory; then three single
   1080p requests of each checkpoint through ``api.upscale_image`` in
   bf16 (one fused bf16 or seven chain bf16 launches each, within ±1 or
   ±2 uint8 of the plain bf16 pipeline), for their latency and memory;
   then ``[rrdb]`` (``rrdb_phase``): each SAME launch of the three wgmma
   kernels at the Real-ESRGAN x4plus cell's shapes against
   ``reference.same_layer``, and one bf16 ``api.upscale_batch`` of 8
   540x960 frames through x4plus, its launches counted from 0 (351 SAME,
   70 with residuals: first 1, wgmma 349, last 1) and its first frame
   against the plain bf16 schedule;
7. times (CUDA events, turns plain/kernel/kernel/plain) of each kernel in
   f32 and in bf16, its plain version and the library's convolutions (f32
   with TF32 off, or bf16 on channels-last tensors: cuDNN on the tensor
   cores) at the main paths' 1080p shapes, and the chain's time per layer
   beside the library's, in both precisions (each layer with its own
   plan: ``entry.layer_plan`` in f32, ``entry.bf16_layer_plan`` in bf16,
   each bf16 layer on its own line, also against and beside
   ``reference.tap_layer``);
   then the flagship in f32 and in bf16 through the fused kernel beside
   the same stack through the chain's three launches (whether fusion
   pays), and the 9-1-5 stack in both precisions;
8. io: the port's native library (``native.py``, built with ``g++`` from
   ``native/cnnsr_native.cpp``), the codec that serves ``ops.image``
   (native, or Pillow where it does not build), a 1080p PNG round trip,
   bit-equal, the decode of a 1080p PNG that Pillow wrote (adaptive row
   filters), bit-equal and timed, and a JPEG round trip within
   tests/test_native.py's bound where a codec serves JPEG;
9. train: the training path at full width (``train_phase``): 128 PNG
   sample pairs of 128x128, the first epoch's gradient on the card
   within 2e-4 of the CPU's, 16 epochs of ``train_loop`` in ``highest``,
   ``high`` and ``bf16`` (ms per epoch, epochs/s, peak memory; the
   validation error falls), the parameters file saved and loaded back
   bit-exact, the trained weights' 1080p upscale (one ``fused_srcnn``
   launch, within ±1 uint8 of plain), and ``cnn_torch.py train`` in a
   subprocess;
10. parallel (``parallel_phase``, ``cuda:0`` named several times): three
   1080p flagship requests through ``api.upscale_image_spatial`` at 4
   shards in bf16 and in f32 (4 fused launches each, ±1 uint8 of the
   unsharded request, the conv stack's float difference, ms beside the
   unsharded request's, halo bytes, peak memory), a 7-layer RGB request
   at 2 shards in f32 and bf16 (14 chain launches), one data-parallel
   training step at ``n_data`` 2 and one over two processes on ``gloo``
   (this script again, ``--multihost-worker``) against one device's, and
   ``upscale_rgba`` in each resize method on the card against the CPU;
11. profile (``profile_phase``): ``cnn_torch.py ... profile --trace-dir``
   on a 1080p PNG through the flagship checkpoint in bf16 (``--pallas``)
   and f32 and the RGB checkpoint in both: exactly its one fused or seven
   chain launches (in bf16 one ``conv_first_wgmma_kernel``, five
   ``conv_layer_wgmma_kernel`` and one ``conv_last_wgmma_kernel``), by the
   counters and in the trace's op
   table, which names the kernels; the PNG byte-equal to an unprofiled run's; the
   kernel's share of device time, the copies, the device's idle share;
   then ``train dry profile`` for 2 epochs on ``[train]``'s samples and
   its op table's top rows;
12. tools (``tools_phase``): ``generate_training_samples --synthetic 8
   --backend torch`` on the card against the CPU (within 1 uint8 before
   encoding), ``evaluate`` with the flagship checkpoint on those pairs,
   card against CPU within 0.01 dB, ``weights_visualize``, and
   ``serve_latency``'s two workloads at ``--n-seq 5 --clients 2
   --n-per-client 3``, every request answered 200;
13. probe main path: ``strided_store.main``, ``winograd.main(["--check"])``
   (every Winograd mode and ``repack`` within 1e-2 of a float64 direct
   conv), ``wino5.main(["--check"])`` (every mode within 2e-2 of a float64
   direct 5x5 conv), ``rowpair.main([])`` (the probe's four cases within
   2e-2) and ``xpack.main(["--check"])``, ``xpack2.main(["--check"])``
   (14 variants at a 1080p layer's steps within one bf16 ulp of their plain
   versions, ≥ 99.9% bit-equal), with the probe kernels' counts set to 0
   just before and read just after; then the kernels against their plain versions: the strided
   roundtrip and the parity layouts bit-equal, the input transform
   bit-equal, ``winograd_f2x3`` in its three modes (three pairs, 24x256
   outputs, k = MAX_K on a ragged tile grid, and again at 1080p) and
   ``repack`` within 2^-7 of the
   output's magnitude with ≥ 99.9% of the elements bit-equal; and times
   at the RGB model's 1080p L5/L6 shapes (64→128, 128→128, and 128→64 at
   L6's shape) of each of ``winograd.layer_variants``: each Winograd
   mode, the shipped direct kernel (``sep``: the wgmma stage at 64→128,
   128→128 and 128→64), ``repack``, the parity pack
   and split, beside their plain versions, cuDNN bf16 (conv + ReLU on
   channels-last tensors) or ``.contiguous()`` of the strided view, and
   each one's own bound (``winograd_bound`` for the Winograd modes, with
   the direct form's beside it); ``wino5`` in its four modes within 2^-7
   with ≥ 99.9% bit-equal at the probe's chunk, at k = 16 and k = MAX_K
   on a ragged grid of its 4 x 32 block and at the flagship's 1080p
   conv2 (the quad modes also against ``sep``), timed beside ``sep`` at
   f=5, cuDNN bf16 conv + ReLU and ``wino5_bound``, with ``sep / <mode>``,
   ``pack_quad`` beside ``.contiguous()``, and the L5 input pack over four
   turns before and after them and as a CUDA graph's replays;
   ``rowpair_gemm`` within 1e-5 relative of its plain version in the
   probe's four cases and at the 1080p exit (534x954xL, L = 128 and 64,
   bf16 and f32), its routes bit-equal, timed as the strided read (also as
   CUDA graph replays: GB/s and share of the byte bound), the contiguous
   read and the copy route beside ``torch.mm`` with an f32 output (the
   same function), ``torch.matmul`` bf16 (bf16 out) and its bound; ``tap_gemm``
   in the 14 xpack variants at one step and the ragged and streamed cases,
   then timed at a 1080p layer's steps, eagerly and as CUDA graph replays,
   beside its plain version, ``torch.bmm`` of the gathered taps with batch
   stride 0 (the same steps; two chunks through one block-placed weight)
   and ``xpack_bound``,
   with the share of the bound and packed / sep per pair.

Then one JSON line of the twelve kernels (the shipped six also with their
launches on the ``[parallel]`` path, ``parallel_launches``, and the three
wgmma kernels with their SAME launches in ``[rrdb]``'s forward,
``same_launches``; the wgmma
stage's times are RGB L2 + ... + L6 at 1080p from ``[layers]``, the
first-layer kernel's ``conv_first_wgmma`` row L1 and its launches, the
last-layer kernel's ``conv_last_wgmma`` row L7 and its launches), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``. Any failed check raises,
so the script exits nonzero and prints no result; so does a machine
without CUDA, and a run that outlasts ``WATCHDOG_S`` (a hung kernel): a
watchdog then ends the process with code 1.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from cnn_sr_tpu_torch import api, serve  # noqa: E402
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
BF16_REL = 2.0 ** -7
RRDB_SENTINEL = 7.0  # what a SAME launch must leave in the channels it does not own
SEED = 0
# published peaks of one H100 SXM: f32 outside the tensor cores, bf16 on
# the tensor cores (dense), HBM3
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# the run's time limit, under the 1,200 s the script must end within
WATCHDOG_S = 1140


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
    entry.LAUNCHES = entry.LAUNCHES_BF16 = 0
    chain.LAUNCHES = chain.LAUNCHES_BF16 = chain.LAUNCHES_FIRST = 0
    chain.LAUNCHES_WGMMA = chain.LAUNCHES_LAST = 0
    chain.LAUNCHES_SAME = chain.LAUNCHES_RESIDUAL = 0


def counts():
    """Launches of (fused f32, chain f32, fused bf16, chain bf16, and of the
    chain's bf16 launches those of the first-layer kernel, of the wgmma
    stage and of the last-layer kernel)."""
    return (entry.LAUNCHES, chain.LAUNCHES, entry.LAUNCHES_BF16, chain.LAUNCHES_BF16,
            chain.LAUNCHES_FIRST, chain.LAUNCHES_WGMMA, chain.LAUNCHES_LAST)


def kernel_vs_plain(name, params, shape, seed, launches, precision="f32", span=0.5) -> float:
    """Run ``params`` on a seeded input in (−span, span) through
    ``entry.fused_forward`` and its plain version in ``precision``;
    ``launches`` is the launches the call must make (see ``counts``), which
    proves the route. A span past 1 puts pixels past the bf16 first layer's
    int8 clip."""
    x = torch.from_numpy(
        np.random.default_rng(seed).uniform(-span, span, shape).astype(np.float32)).cuda()
    before = counts()
    y = entry.fused_forward(params, x, precision)
    ref = reference.fused_forward(params, x, precision)
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(counts(), before))
    check(made == launches, f"{name}: launches {made}, expected {launches}")
    check(y.shape == ref.shape, f"{name}: shape {tuple(y.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[kernel] {name} {precision} {shape}: max_abs_err {err:.3e}, "
          f"max |plain| {scale:.3e}, rel {err / max(scale, 1e-30):.3e}")
    if precision == "bf16":
        check(err <= BF16_REL * scale,
              f"{name}: err {err} > 2^-7 x output scale {scale}")
    else:
        check(err <= ATOL, f"{name}: max abs err {err} > {ATOL}")
        check(err <= ATOL * scale, f"{name}: err {err} > {ATOL} x output scale {scale}")
    return err


def main_path(name, cfg, params, plain_fn, launches, smi, precision="f32", tol=1):
    """Three 1920x1080 requests through ``api.upscale_image`` in
    ``precision``, each making exactly ``launches`` (see ``counts``),
    checked within ``tol`` uint8 of the same pipeline with the plain
    version (``plain_fn``) on the card.
    Returns the path's launch counts, read just after its run."""
    h, w = 1080, 1920
    rgba = make_image(h, w, SEED)
    outs, req_ms, peak = [], [], []
    reset_counts()
    for _ in range(3):
        before = counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs.append(api.upscale_image(cfg, params, rgba, precision=precision))
        req_ms.append((time.perf_counter() - t0) * 1e3)
        peak.append(torch.cuda.max_memory_allocated())
        made = tuple(a - b for a, b in zip(counts(), before))
        check(made == launches,
              f"{name}: a request made launches {made}, expected {launches}")
    total = counts()

    plain_out = plain_fn(torch.from_numpy(rgba).cuda()).cpu().numpy()
    inside = ~border_mask(h, w, cfg.total_padding())
    diff = 0
    for out in outs:
        check(out.shape == (h, w, 3) and out.dtype == np.uint8,
              f"{name}: output {out.shape} {out.dtype}")
        check(np.array_equal(out[~inside], rgba[..., :3][~inside]),
              f"{name}: border differs from the input")
        diff = max(diff, int(np.abs(out.astype(np.int16) - plain_out.astype(np.int16)).max()))
        check(diff <= tol, f"{name}: output vs plain pipeline: max diff {diff} uint8")
        check(np.array_equal(out, outs[0]), f"{name}: requests disagree")
    check(bool((outs[0][inside] != rgba[..., :3][inside]).any()),
          f"{name}: the net left the image unchanged")
    mpix = h * w / 1e6
    print(f"[main] {smi} | 3 requests 1920x1080 {name} {precision}: "
          + ", ".join(f"{ms:.2f} ms ({mpix / ms * 1e3:.1f} MPix/s)" for ms in req_ms)
          + f" | launches (fused, chain, fused bf16, chain bf16, first, wgmma, last) {total}"
          + f" | max diff vs plain pipeline {diff} uint8"
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


def graph_ms(fn, iters: int = 10) -> float:
    """Mean ms of ``fn``'s device work: ``fn`` captured once in a CUDA
    graph, then ``iters`` replays timed as ``time_ms`` times a call. Where
    the host takes longer to launch ``fn``'s kernels than the card takes to
    run them, ``time_ms`` measures the host; this does not."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters)


def library_weights(params, precision="f32"):
    """``(OIHW channels-last weight, bias)`` per layer in ``precision``'s
    type, for ``library_convs``."""
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    return [(l["w"].permute(3, 2, 0, 1).to(dt).contiguous(memory_format=torch.channels_last),
             l["b"].to(dt)) for l in params]


def library_convs(params, x: torch.Tensor) -> torch.Tensor:
    """The same layers as PyTorch's own convolutions on channels-last
    tensors, ReLU in place: cuDNN in f32 with TF32 off, or in bf16 on the
    tensor cores for a bf16 ``x``; timed as the yardstick, never used by
    the port. ``params`` from ``library_weights``."""
    y = x.permute(0, 3, 1, 2)
    with strict_f32():
        for i, (w, b) in enumerate(params):
            y = torch.nn.functional.conv2d(y, w, b)
            if i != len(params) - 1:
                y.relu_()
    return y


def bound_ms(params, shape, precision="f32", first=True, last=True) -> tuple:
    """The least time of the stack on this card: the larger of its
    operations over the peak of ``precision`` and its bytes over the
    memory rate. The bytes are the stack's input, weights, biases and
    output, each once, at their stored sizes: f32; in bf16, bf16 weights
    and f32 biases, and an input and output of f32 where the stack
    starts (``first``) or ends (``last``) the stream, else bf16."""
    n, h, w, c = shape
    flops = 0
    wb = 2 if precision == "bf16" else 4
    moved = (4 if precision == "f32" or first else 2) * n * h * w * c
    for layer in params:
        f, _, k, m = layer["w"].shape
        h, w = h - f + 1, w - f + 1
        flops += 2 * n * h * w * f * f * k * m
        moved += wb * f * f * k * m + 4 * m
    moved += (4 if precision == "f32" or last else 2) * n * h * w * m
    t_ops, t_bytes = flops / PEAK_FLOPS[precision] * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_stack(name, params, x, smi, precision="f32") -> dict:
    """Kernel, plain and library times of one stack on ``x`` in
    ``precision``, in turns: plain, kernel, kernel, plain, library,
    library."""
    kern = lambda: entry.fused_forward(params, x, precision)  # noqa: E731
    plain = lambda: reference.fused_forward(params, x, precision)  # noqa: E731
    lib_params = library_weights(params, precision)
    x_lib = x.to(torch.bfloat16) if precision == "bf16" else x
    lib = lambda: library_convs(lib_params, x_lib)  # noqa: E731
    y, ref, yl = kern(), plain(), lib()
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    lib_err = float((yl.permute(0, 2, 3, 1).float() - ref).abs().max())
    scale = float(ref.abs().max())
    if precision == "bf16":
        check(err <= BF16_REL * scale, f"{name} at {tuple(x.shape)}: kernel vs plain {err}")
        # the library's bf16 convolutions take the input rounded to bf16,
        # not the int8 plane, and round every output: a yardstick of time
        check(bool(torch.isfinite(yl).all()), f"{name}: library convolutions not finite")
    else:
        check(err <= ATOL, f"{name} at {tuple(x.shape)}: kernel vs plain {err}")
        check(lib_err <= ATOL, f"{name}: library convolutions disagree with the plain version")
    p1, k1, k2, p2, l1, l2 = (time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain),
                              time_ms(lib), time_ms(lib))
    bound, bound_by = bound_ms(params, tuple(x.shape), precision)
    plain_what = ("cuDNN f32 over bf16-rounded values, TF32 off" if precision == "bf16"
                  else "cuDNN f32, TF32 off")
    print(f"[time] {smi} | {name} {precision} {tuple(x.shape)}: kernel {k1:.3f}/{k2:.3f} ms, "
          f"plain ({plain_what}) {p1:.3f}/{p2:.3f} ms, library convolutions "
          f"({'bf16' if precision == 'bf16' else 'f32'}) {l1:.3f}/{l2:.3f} ms "
          f"(max |library - plain| {lib_err:.3e}), bound {bound:.3f} ms ({bound_by})")
    return {"err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "library_ms": (l1 + l2) / 2, "bound_ms": bound, "bound_by": bound_by}


def layer_times(params, x, smi, precision="f32") -> dict:
    """The chain's time per layer in ``precision`` on the stack's own
    activations (``chain.layer_forward`` with the layer's plan:
    ``entry.layer_plan`` in f32, ``entry.bf16_layer_plan`` in bf16, where
    the first layer quantises the f32 input on the first-layer kernel, the
    last writes f32 on the last-layer kernel, the others read and write bf16
    on the wgmma stage), beside the library's convolution of that layer on the
    same activations (CUDA events). In f32 one line; in bf16 a line a layer,
    each checked against and timed beside its plain version
    (``reference.tap_layer`` over ``entry.pack_bf16``'s packing) in turns:
    plain, kernel, kernel, plain, library, library. Returns, in bf16, the
    summed ``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` and the
    largest error (``err``) of the wgmma layers (``"wgmma"``), of the first
    (``"first"``) and of the last (``"last"``); {} in f32."""
    bf16 = precision == "bf16"
    lib = build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    last = len(params) - 1
    dims = [tuple(l["w"].shape[1:]) for l in params]
    plans = [entry.bf16_layer_plan(*d, i == 0, i == last) if bf16 else entry.layer_plan(*d)
             for i, d in enumerate(dims)]
    operands = (entry.chain_bf16_weights(params, plans) if bf16
                else entry.f32_weights(params, [p.nb for p in plans]))
    parts, src, rows = [], x, {"wgmma": [], "first": [], "last": []}
    for i, (layer, (wt, bt), plan) in enumerate(zip(params, operands, plans)):
        f, _, k, n = layer["w"].shape
        nb, h, w, _ = src.shape
        dst = torch.empty((nb, h - f + 1, w - f + 1, n), device=src.device,
                          dtype=torch.bfloat16 if bf16 and i != last else torch.float32)
        kern = lambda: chain.layer_forward(lib, src, wt, bt, dst, plan, i == 0,  # noqa: E731
                                           i == last, bf16, stream)
        lib_layer = library_weights([layer], precision)
        src_lib = src.to(torch.bfloat16) if bf16 else src
        lib_fn = lambda: library_convs(lib_layer, src_lib)  # noqa: E731
        bound, bound_by = bound_ms([layer], tuple(src.shape), precision, i == 0, i == last)
        if not bf16:
            k_ms, l_ms = time_ms(kern), time_ms(lib_fn)
            parts.append(f"L{i + 1} {k}->{n} {k_ms:.3f}/{l_ms:.3f}/{bound:.4f} ({bound_by})")
            src = dst
            continue
        wp, bp = entry.packed_bf16(layer["w"], layer["b"], i == 0)
        plain = lambda: reference.tap_layer(src, wp, bp, f, n, i == 0, i == last)  # noqa: E731
        kern()
        what = f"L{i + 1} {k}->{n} {tuple(src.shape)}"
        if i == last:  # f32 out: the sums in another order, no rounding to compare bits
            ref = plain()
            err = float((dst - ref).abs().max())
            check(err <= BF16_REL * float(ref.abs().max()), f"{what}: kernel vs plain {err}")
        else:
            err = agree_bf16(what, dst, plain().to(torch.bfloat16))
        p1, k1, k2, p2, l1, l2 = (time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain),
                                  time_ms(lib_fn), time_ms(lib_fn))
        k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
        wg, fin = isinstance(plan, entry.WgmmaPlan), isinstance(plan, entry.LastPlan)
        rows["wgmma" if wg else "last" if fin else "first"].append(
            {"ms": k_ms, "plain_ms": (p1 + p2) / 2, "library_ms": l_ms, "bound_ms": bound,
             "bound_by": bound_by, "err": err})
        w_how = "resident" if plan.w_res else f"through {plan.w_ring} stages"
        stage = (f"wgmma ({plan.bn} columns, {plan.lanes}-lane boxes, {plan.slabs} slabs a "
                 f"warpgroup, {plan.a_ring} A stages, W {w_how})" if wg
                 else f"last-layer wgmma ({plan.f} dx taps x {plan.n} in {plan.npad} columns, "
                 f"{plan.tile_rows}x{entry.LAST_COLS} tiles of {plan.out_cols} output columns, "
                 f"{plan.lanes}-lane boxes, {plan.slabs} slabs a warpgroup, {plan.a_ring} A "
                 f"stages, W {w_how})" if fin
                 else f"first-layer wgmma ({plan.cols}x{plan.tile_rows} tiles, {plan.kx} lanes, "
                 f"{plan.bn} columns x {plan.nchunks}, {plan.slabs} slabs a warpgroup, "
                 f"{plan.raw_ring} raw stages, {plan.out_bufs} output buffers, W {w_how})")
        print(f"[layers] {smi} | bf16 {what} {stage}: kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"(tap_layer) {p1:.4f}/{p2:.4f}, library (cuDNN bf16) {l1:.4f}/{l2:.4f}, bound "
              f"{bound:.4f} ({bound_by}, {bound / k_ms * 100:.0f}% of it), library / kernel "
              f"{l_ms / k_ms:.2f}x, max_abs_err {err:.3e}")
        src = dst
    if not bf16:
        print(f"[layers] {smi} | {precision} chain/library ({precision})/bound ms per layer: "
              + ", ".join(parts))
        return {}
    out = {}
    for stage, rs in rows.items():
        out[stage] = {**{key: sum(r[key] for r in rs) for key in ("ms", "plain_ms", "library_ms",
                                                               "bound_ms")},
                      "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rs)
                      else "bytes", "err": max(r["err"] for r in rs)}
    return out


def fused_vs_chain(params, x, smi, precision="f32") -> None:
    """The flagship in ``precision`` through the fused kernel (one launch)
    beside the same stack through the chain (three launches, ``conv1`` and
    ``conv2`` through device memory: f32 on the CUDA cores, or bf16 on the
    tensor cores), both checked against the plain version, timed in turns:
    fused, chain, chain, fused. Shows whether fusion pays."""
    last = len(params) - 1
    dims = [(l["w"].shape[0], l["w"].shape[2], l["w"].shape[3]) for l in params]
    bf16 = precision == "bf16"
    plans = [entry.bf16_layer_plan(*d, i == 0, i == last) if bf16 else entry.layer_plan(*d)
             for i, d in enumerate(dims)]
    fused = lambda: entry.fused_forward(params, x, precision)  # noqa: E731
    chained = lambda: chain.chain_forward(params, x, plans, bf16=bf16)  # noqa: E731
    ref = reference.fused_forward(params, x, precision)
    scale = float(ref.abs().max())
    errs = [float((fn() - ref).abs().max()) for fn in (fused, chained)]
    check(max(errs) <= (BF16_REL * scale if bf16 else ATOL),
          f"flagship {precision} fused / chain vs plain {errs}")
    f1, c1, c2, f2 = time_ms(fused), time_ms(chained), time_ms(chained), time_ms(fused)
    cores = "tensor-core" if bf16 else "CUDA-core"
    print(f"[time] {smi} | flagship 9-5-5 {precision} {tuple(x.shape)}: fused kernel "
          f"{f1:.3f}/{f2:.3f} ms, chain of 3 {cores} launches {c1:.3f}/{c2:.3f} ms, chain / "
          f"fused {(c1 + c2) / (f1 + f2):.2f}x (max |kernel - plain| {errs[0]:.3e} fused, "
          f"{errs[1]:.3e} chain)")


def rowpair_build(log: str) -> None:
    """[build]: ``rowpair_kernel``'s four instances (L = 128, 64 x bf16, f32
    A) from ptxas: registers and spills (none allowed), beside the dynamic
    shared bytes of its plan (ptxas's own usage lines, static shared memory
    among them, are on the ``[build] rowpair.cu`` line)."""
    from cnn_sr_tpu_torch.probes import rowpair

    kernels = build.ptxas_entries(log, "rowpair_kernel")
    check(len(kernels) == 4, f"rowpair.cu: {len(kernels)} kernel instances in the ptxas "
          "report, expected 4 (L = 128, 64 x bf16, f32)")
    for name, regs, spill in kernels:
        plan = rowpair.plan(128 if "Li128E" in name else 64)
        print(f"[build] rowpair.cu (wgmma) {name}: {regs} registers; {spill}; dynamic shared "
              f"memory {plan['smem']} bytes (plan, {plan['stages']} ring stages)")
        check(" 0 bytes spill stores, 0 bytes spill loads" in spill, f"rowpair.cu {name} spills: "
              f"{spill}")


def xpack_build(log: str) -> None:
    """[build]: ``tap_gemm_kernel``'s six instances (N = 32, 64, 128, with
    and without the ring) from ptxas: registers and spills (none allowed),
    beside the most dynamic shared bytes its plan gives the probes'
    variants at that N; and any ptxas remark on its ``wgmma`` (a
    serialised pipeline is named there)."""
    from cnn_sr_tpu_torch.probes import xpack, xpack2

    kernels = build.ptxas_entries(log, "tap_gemm_kernel")
    check(len(kernels) == 6, f"xpack.cu: {len(kernels)} kernel instances in the ptxas report, "
          "expected 6 (N = 32, 64, 128, with and without the ring)")
    for name, regs, spill in kernels:
        n = next(n for n in xpack.WIDTHS if f"ILi{n}E" in name)
        smem = max(xpack.plan(v.taps)["smem"] for v in xpack.VARIANTS + xpack2.VARIANTS
                   if v.taps.n == n)
        print(f"[build] xpack.cu (wgmma) {name}: {regs} registers; {spill}; dynamic shared memory "
              f"up to {smem} bytes (plan, the probes' variants)")
        check(" 0 bytes spill stores, 0 bytes spill loads" in spill, f"xpack.cu {name} spills: "
              f"{spill}")
    remarks = [ln.strip() for ln in log.splitlines() if "gmma" in ln.lower()]
    print("[build] xpack.cu ptxas remarks on wgmma: " + (" | ".join(remarks) or "none"))


def same_of(kind: str) -> list:
    """The SAME instances of one wgmma kernel (``entry.same_instances``),
    without the kernel's name: ``kind`` "first", "wgmma" or "last"."""
    return [inst[1:] for inst in entry.same_instances() if inst[0] == kind]


def wgmma_build(log: str) -> None:
    """[build]: ``conv_layer_wgmma_kernel``'s instances (one each of
    ``entry.wgmma_instances``: block columns, box lanes, slabs a warpgroup;
    then the SAME twins of ``entry.same_instances``) from ptxas: registers
    and spills (none allowed) of each, beside the plans at the RGB model's
    L2-L6, at 128 -> 64 and at the widest f the card tests take (dynamic
    shared bytes, the instance each takes); and any ptxas remark on its
    ``wgmma`` (a serialised pipeline is named there)."""
    kernels = build.ptxas_entries(log, "conv_layer_wgmma_kernel")
    want = len(entry.wgmma_instances()) + len(same_of("wgmma"))  # VALID, then the SAME twins
    check(len(kernels) == want, f"conv_wgmma.cu: {len(kernels)} kernel instances in the "
          f"ptxas report, expected {want}")
    print("[build] conv_wgmma.cu (wgmma) instances (columns, lanes, slabs): "
          + ", ".join(f"{name} {regs} registers ({spill})" for name, regs, spill in kernels))
    for name, _, spill in kernels:
        check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
              f"conv_wgmma.cu {name} spills: {spill}")
    plans = {what: entry.wgmma_layer_plan(*layer) for what, layer in (
        ("L2 32->32", (3, 32, 32)), ("L3 32->64", (3, 32, 64)), ("L4 64->64", (3, 64, 64)),
        ("L5 64->128", (3, 64, 128)), ("L6 128->128", (3, 128, 128)),
        ("128->64", (3, 128, 64)), ("f=19 64->128", (19, 64, 128)))}
    print("[build] conv_wgmma.cu plans: " + ", ".join(
        f"{w} {p.smem} bytes (instance {p.bn}, {p.lanes}, {p.slabs}; {p.a_ring} A boxes of "
        f"{p.a_box}, W " + ("resident" if p.w_res else f"{p.w_ring} slices") + ")"
        for w, p in plans.items()))
    remarks = [ln.strip() for ln in log.splitlines() if "gmma" in ln.lower()
               and "entry function" not in ln and "Function properties" not in ln]
    print("[build] conv_wgmma.cu ptxas remarks on wgmma: " + (" | ".join(remarks) or "none"))


def first_build(log: str) -> None:
    """[build]: ``conv_first_wgmma_kernel``'s instances (one each of
    ``entry.first_instances``: block columns, slabs a warpgroup; then the
    SAME twin of ``entry.same_instances``) from ptxas: registers and spills
    (none allowed) of each, beside the plans at RGB L1, the flagship's and
    the wide 9-5-5's conv1, and ``[kernel]``'s f = 9 over 4 channels into
    256 (dynamic shared bytes, the instance each takes); and any ptxas
    remark on its ``wgmma`` (a serialised pipeline is named there)."""
    kernels = build.ptxas_entries(log, "conv_first_wgmma_kernel")
    want = len(entry.first_instances()) + len(same_of("first"))  # VALID, then the SAME twins
    check(len(kernels) == want, f"conv_first_wgmma.cu: {len(kernels)} kernel instances in "
          f"the ptxas report, expected {want}")
    print("[build] conv_first_wgmma.cu (wgmma) instances (columns, slabs): "
          + ", ".join(f"{name} {regs} registers ({spill})" for name, regs, spill in kernels))
    for name, _, spill in kernels:
        check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
              f"conv_first_wgmma.cu {name} spills: {spill}")
    plans = {what: entry.first_layer_plan(*layer) for what, layer in (
        ("RGB L1 3->32", (3, 3, 32)), ("f=9 1->64", (9, 1, 64)), ("f=9 1->128", (9, 1, 128)),
        ("f=9 4->256", (9, 4, 256)))}
    print("[build] conv_first_wgmma.cu plans: " + ", ".join(
        f"{w} {p.smem} bytes (instance {p.bn}, {p.slabs}; {p.cols}x{p.tile_rows} tiles, "
        f"{p.kx} lanes, {p.raw_ring} raw stages of {p.raw_bytes}, {p.out_bufs} output buffers, "
        "W " + ("resident" if p.w_res else f"{p.w_ring} slices") + ")" for w, p in plans.items()))
    remarks = [ln.strip() for ln in log.splitlines() if "gmma" in ln.lower()
               and "entry function" not in ln and "Function properties" not in ln]
    print("[build] conv_first_wgmma.cu ptxas remarks on wgmma: " + (" | ".join(remarks) or "none"))


def last_build(log: str) -> None:
    """[build]: ``conv_last_wgmma_kernel``'s instances (one each of
    ``entry.last_instances``: packed columns, box lanes, slabs a warpgroup;
    then the SAME twin of ``entry.same_instances``) from ptxas: registers
    and spills (none allowed) of each, beside the plans at RGB L7, the luma
    stacks' conv3 on the chain (f = 5 over 32 lanes), f = 9 over 256
    channels (W streamed) and f = 17 at 8 outputs (two dx groups)."""
    kernels = build.ptxas_entries(log, "conv_last_wgmma_kernel")
    want = len(entry.last_instances()) + len(same_of("last"))  # VALID, then the SAME twins
    check(len(kernels) == want, f"conv_last_wgmma.cu: {len(kernels)} kernel instances in "
          f"the ptxas report, expected {want}")
    print("[build] conv_last_wgmma.cu (wgmma) instances (columns, lanes, slabs): "
          + ", ".join(f"{name} {regs} registers ({spill})" for name, regs, spill in kernels))
    for name, _, spill in kernels:
        check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
              f"conv_last_wgmma.cu {name} spills: {spill}")
    plans = {what: entry.last_layer_plan(*layer) for what, layer in (
        ("RGB L7 128->3", (3, 128, 3)), ("f=5 32->1", (5, 32, 1)), ("f=9 256->1", (9, 256, 1)),
        ("f=17 32->8", (17, 32, 8)))}
    print("[build] conv_last_wgmma.cu plans: " + ", ".join(
        f"{w} {p.smem} bytes (instance {p.npad}, {p.lanes}, {p.slabs}; {p.dgroups} dx groups; "
        f"{p.tile_rows}x{entry.LAST_COLS} tiles; {p.a_ring} A boxes of {p.a_box}, W "
        + ("resident" if p.w_res else f"{p.w_ring} slices") + ")" for w, p in plans.items()))


def fused_wgmma_build(log: str) -> None:
    """[build]: ``fused_wgmma_kernel`` (the bf16 fused kernel, one instance)
    and ``wgmma_desc_probe_kernel`` from ptxas: registers and spills (none
    allowed), beside the dynamic shared bytes of the kernel's plan at the
    flagship, the 9-1-5 and the 3-layer RGB stack; and how many times ptxas
    says it injected a ``warpgroup.arrive`` before a ``wgmma`` (C7519)."""
    for key, what in (("fused_wgmma_kernel", "bf16 fused kernel"),
                      ("wgmma_desc_probe_kernel", "descriptor probe")):
        kernels = build.ptxas_entries(log, key)
        check(len(kernels) == 1, f"fused_wgmma.cu: {len(kernels)} {key} instances in the ptxas "
              "report, expected 1")
        name, regs, spill = kernels[0]
        plans = {what: entry.fused_wgmma_plan(c, layers) for what, c, layers in (
            ("flagship", 1, [(9, 1, 64), (5, 64, 32), (5, 32, 1)]),
            ("9-1-5", 1, [(9, 1, 64), (1, 64, 32), (5, 32, 1)]),
            ("RGB 3-layer", 3, [(3, 3, 16), (3, 16, 8), (3, 8, 3)]))}
        shared = ("; dynamic shared memory (plan) " + ", ".join(
            f"{w} {p.smem} bytes ({p.tile}x{p.tile} tile, {p.ring} w2 slots)"
            for w, p in plans.items())) if key == "fused_wgmma_kernel" else ""
        print(f"[build] fused_wgmma.cu ({what}) {name}: {regs} registers; {spill}{shared}")
        check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
              f"fused_wgmma.cu {name} spills: {spill}")
    injected = sum("C7519" in ln and "fused_wgmma_kernel" in ln for ln in log.splitlines())
    print(f"[build] fused_wgmma.cu ptxas remarks on wgmma: {injected} warpgroup.arrive injected "
          "(C7519) in fused_wgmma_kernel")


def descriptor_check(smi, dev) -> None:
    """[build] the shifted descriptor: one ``wgmma`` m64n32k16 by
    ``wgmma_desc_probe`` whose A starts 1, 7, 16 and 23 positions into a
    tile (``ops.fused.wgmma_probe.cases``), against numpy's product (small
    integers: exact). The forms the kernels read must equal it: the fused
    kernel's (no-swizzle planes as 64 raster rows and as an 8 x 8 patch, B
    K-major) at every start, and the wgmma chain's (128- and 64-byte
    swizzled rows, base offset 0, B MN-major) at a dy shift of 16 rows;
    every form's outcome is printed."""
    from cnn_sr_tpu_torch.ops.fused import wgmma_probe

    seen = {}
    for k in (1, 7, 16, 23):
        for case in wgmma_probe.cases(k):
            err = float(np.abs(wgmma_probe.product(case, dev) - case.want).max())
            name = (case.name.replace(f"base offset {k % 8}", "base offset = start row % 8")
                    if k % 8 else case.name)
            outcome = "exact" if err == 0 else f"max err {err:g}"
            seen.setdefault(name, []).append(f"k={k}: {outcome}")
            if case.name.startswith("no swizzle") and case.b_kmajor:
                check(err == 0, f"descriptor probe {case.name} at k={k}: max err {err}")
            if k == 16 and "base offset 0" in case.name and not case.b_kmajor:
                check(err == 0, f"descriptor probe {case.name} at k={k}: max err {err}")
    print(f"[build] {smi} | shifted wgmma descriptor (A starts k positions into a "
          f"{wgmma_probe.POSITIONS}-position tile, one m64n32k16): "
          + "; ".join(f"{name} {', '.join(v)}" for name, v in seen.items()))


def sass_hmma() -> tuple:
    """HMMA instructions in the SASS of the ``mma.sync`` entry points'
    kernels in the built library (``cuobjdump -sass``, beside ``nvcc``): the
    Winograd layer's six instances, and ``wino5_forward``'s, in all and in
    each mode's instance; and the HGMMA (``wgmma``) instructions in
    ``rowpair_gemm``'s, each of ``conv_first_forward_wgmma``'s seven
    instances (block columns / slabs a warpgroup), each of
    ``conv_layer_forward_wgmma``'s nine
    instances (block columns / box lanes / slabs a warpgroup), each of
    ``conv_last_forward_wgmma``'s ten (packed columns / box lanes / slabs),
    and of their SAME twins (``conv_*_forward_wgmma_same``, one key each),
    ``fused_srcnn_forward_bf16``'s (all three of its layers) and in each of
    ``tap_gemm_bf16``'s six instances (N = 32, 64, 128, resident or through
    the ring): the proof that they run on the tensor cores.
    Returns ``({entry point: HMMA}, {kernel: HGMMA})``."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path()], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    kernel = {"winograd_kernel": ["winograd_f2x3_forward"],
              **{f"wino5_quad_kernelILi{code}E": ["wino5_forward", f"wino5_forward {mode}"]
                 for code, mode in enumerate(("quad", "quadp", "quad1"))},
              "wino5_w55f_kernel": ["wino5_forward", "wino5_forward w55f"]}
    counts = {name: 0 for names in kernel.values() for name in names}
    wgmma = {"rowpair_kernel": "rowpair_gemm",
             **{f"conv_first_wgmma_kernelILi{bn}ELi{s}ELb{same:d}E":
                f"conv_first_forward_wgmma{'_same' * same} {bn}/{s}"
                for same, insts in ((False, entry.first_instances()), (True, same_of("first")))
                for bn, s in insts},
             **{f"conv_layer_wgmma_kernelILi{bn}ELi{lanes}ELi{s}ELb{same:d}E":
                f"conv_layer_forward_wgmma{'_same' * same} {bn}/{lanes}/{s}"
                for same, insts in ((False, entry.wgmma_instances()), (True, same_of("wgmma")))
                for bn, lanes, s in insts},
             **{f"conv_last_wgmma_kernelILi{npad}ELi{lanes}ELi{s}ELb{same:d}E":
                f"conv_last_forward_wgmma{'_same' * same} {npad}/{lanes}/{s}"
                for same, insts in ((False, entry.last_instances()), (True, same_of("last")))
                for npad, lanes, s in insts},
             "fused_wgmma_kernel": "fused_srcnn_forward_bf16",
             **{f"tap_gemm_kernelILi{n}ELb{ring}E": f"tap_gemm_bf16 N={n} "
                + ("ring" if ring else "resident") for n in (32, 64, 128) for ring in (0, 1)}}
    hgmma = {name: 0 for name in wgmma.values()}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0]
        for key, entry_points in kernel.items():
            if key in name:
                for entry_point in entry_points:
                    counts[entry_point] += part.count("HMMA")
        for key, entry_point in wgmma.items():
            if key in name:
                hgmma[entry_point] += part.count("HGMMA")
    return counts, hgmma


def agree_bf16(name, y, ref) -> float:
    """Check a bf16 kernel output against its plain version: within 2^-7 of
    the plain output's largest magnitude and ≥ 99.9% of the elements
    bit-equal (the products are exact, the sums taken in another order).
    Returns the max abs error."""
    check(y.shape == ref.shape, f"{name}: shape {tuple(y.shape)} vs {tuple(ref.shape)}")
    err = float((y.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    equal = float((y == ref).float().mean())
    check(err <= BF16_REL * scale and equal >= 0.999,
          f"{name}: kernel vs plain max {err} (scale {scale}), bit-equal {equal}")
    return err


def winograd_bound(x, u, out_hw, mode) -> tuple:
    """The least time of ``winograd_f2x3`` itself in ``mode`` on this card:
    the larger of its operations over the bf16 peak and its bytes over the
    memory rate. Operations: 16·k·n multiply-adds per 2x2 tile, the input
    transform's adds (48 per tile and input channel in mode "direct", 32
    in "factored", none in "pre") and the output transform's 36 per tile
    and output channel. Bytes, all bf16: its input ``x`` (the parity input,
    or V in mode "pre") and ``u`` read once, the parity output written
    once. ``bound_ms`` of the layer counts the direct form's 36 a tile."""
    k, n = u.shape[0] // 16, u.shape[1]
    tiles = (out_hw[0] // 2) * (out_hw[1] // 2)
    adds = {"direct": 48, "factored": 32, "pre": 0}[mode]
    ops = tiles * (2 * 16 * k * n + adds * k + 36 * n)
    moved = 2 * (x.numel() + u.numel() + 4 * tiles * n)
    t_ops, t_bytes = ops / PEAK_FLOPS["bf16"] * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def probe_phase(smi) -> list:
    """[probe]: the ports of the six ``tools/*_probe*.py``. Their entry
    points (the probes' main path: the strided roundtrip, ``--check`` and
    the rowpair cases) with the counts set to 0 just before; each kernel
    against its plain version at the probe's shapes and, for
    ``winograd.layer_variants``, at the RGB model's 1080p L5/L6 shapes,
    where each is timed beside cuDNN bf16 or ``.contiguous()`` and its
    bound; then ``wino5_phase``, ``rowpair_phase`` and ``xpack_phase``.
    Returns the six kernel rows."""
    from cnn_sr_tpu_torch.probes import (layout, rowpair, strided_store, wino5, winograd, xpack,
                                         xpack2)

    t_phase = time.perf_counter()
    layout.LAUNCHES = winograd.LAUNCHES = wino5.LAUNCHES = rowpair.LAUNCHES = 0
    xpack.LAUNCHES = 0
    check(strided_store.main(["--device", "cuda"]) == 0, "strided_store probe")
    check(winograd.main(["--check"]) == 0, "winograd probe --check")
    check(wino5.main(["--check"]) == 0, "wino5 probe --check")
    check(rowpair.main([]) == 0, "rowpair probe")
    check(xpack.main(["--check"]) == 0, "xpack probe --check")
    torch.cuda.synchronize()
    xpack_launches = xpack.LAUNCHES
    check(xpack2.main(["--check"]) == 0, "xpack2 probe --check")
    torch.cuda.synchronize()
    launches = {"winograd": winograd.LAUNCHES, "parity_copy": layout.LAUNCHES,
                "wino5": wino5.LAUNCHES, "rowpair": rowpair.LAUNCHES, "xpack": xpack_launches,
                "xpack2": xpack.LAUNCHES - xpack_launches}
    print(f"[probe] probes' main path launches: winograd_f2x3 {launches['winograd']}, "
          f"parity_copy {launches['parity_copy']}, wino5 {launches['wino5']}, "
          f"rowpair_gemm {launches['rowpair']}, tap_gemm {launches['xpack']} (xpack) + "
          f"{launches['xpack2']} (xpack2)")
    dev = torch.device("cuda")

    # kernel vs plain at the probes' own shapes
    a = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (strided_store.R, strided_store.C, strided_store.K)).astype(np.float32)).to(dev)
    rt = strided_store.strided_roundtrip(a)
    rt_plain = strided_store.strided_roundtrip_plain(a)
    copy_errs = [float((rt - rt_plain).abs().max()), float((rt - (a + 1.0)).abs().max())]
    check(torch.equal(rt, rt_plain) and max(copy_errs) == 0.0, f"strided roundtrip {copy_errs}")
    wino_errs = []
    rng = np.random.default_rng(SEED + 50)
    hw = (winograd.CH, winograd.OW)
    for k, n in winograd.PAIRS:
        act_np = (rng.random((hw[0] + 2, hw[1] + 2, k), np.float32) - 0.5).astype(np.float32)
        g = (rng.random((3, 3, k, n), np.float32) - 0.5).astype(np.float32)
        act = torch.from_numpy(act_np).to(dev, torch.bfloat16)
        a_par = layout.pack_rows_cols(act, winograd.CHUNK_CWP)
        u = winograd.weights_u(g, dev)
        for mode in ("direct", "factored"):
            check(torch.equal(winograd.input_transform(a_par, hw, mode),
                              winograd.input_transform_plain(a_par, hw, mode)),
                  f"input transform {mode} {k}->{n}")
        v = winograd.input_transform(a_par, hw)
        for mode, x in (("direct", a_par), ("factored", a_par), ("pre", v)):
            wino_errs.append(agree_bf16(f"winograd {mode} {k}->{n}",
                                        winograd.winograd_f2x3(x, u, hw, mode),
                                        winograd.winograd_f2x3_plain(x, u, hw, mode)))
        gb = torch.from_numpy(g).to(dev, torch.bfloat16)
        agree_bf16(f"repack {k}->{n}", winograd.repack(act, gb), winograd.repack_plain(act, gb))
    # the widest layer the kernel takes, where U streams in stages of part
    # of a position, on a ragged tile grid (out 20x68: 10 x 34 tiles)
    k, hw_r = winograd.MAX_K, (20, 68)
    act = torch.from_numpy((rng.random((hw_r[0] + 2, hw_r[1] + 2, k), np.float32) - 0.5)
                           .astype(np.float32)).to(dev, torch.bfloat16)
    g = (rng.random((3, 3, k, 128), np.float32) - 0.5).astype(np.float32)
    a_par = layout.pack_rows_cols(act)
    u = winograd.weights_u(g, dev)
    v = winograd.input_transform(a_par, hw_r)
    check(torch.equal(v, winograd.input_transform_plain(a_par, hw_r)),
          f"input transform direct {k}->128 {hw_r}")
    for mode, x in (("direct", a_par), ("factored", a_par), ("pre", v)):
        wino_errs.append(agree_bf16(f"winograd {mode} {k}->128 {hw_r}",
                                    winograd.winograd_f2x3(x, u, hw_r, mode),
                                    winograd.winograd_f2x3_plain(x, u, hw_r, mode)))
    print(f"[probe] kernel vs plain at the probes' shapes: strided roundtrip (24, 256, 128) "
          f"f32 bit-equal, error {max(copy_errs)}; input transforms bit-equal; winograd_f2x3 "
          f"(3 modes x 3 pairs, 24x256 out, and {k}->128 at 20x68 out) max |kernel - plain| "
          f"{max(wino_errs):.3e}; repack within 2^-7")

    # every variant at 1080p, checked, then timed in turns: plain, kernel,
    # kernel, plain, library, library
    rows = {}
    for k, n in winograd.PAIRS:
        out_hw = winograd.OUT_1080P[(k, n)]
        variants, inp = winograd.layer_variants(k, n, out_hw, dev, seed=SEED)
        act, y, u = inp["act"], inp["y"], inp["u"]
        lib_w = library_weights([{"w": inp["gb"].float(), "b": torch.zeros(n, device=dev)}],
                                "bf16")
        conv_ms = [time_ms(lambda: library_convs(lib_w, act[None]).relu_()) for _ in range(2)]
        # the copies' yardstick: .contiguous() of a strided view (the
        # split's plain version is itself one)
        library = {"pack": lambda: act.view(act.shape[0] // 2, 2, act.shape[1] // 2, 2, k)
                   .permute(1, 0, 2, 3, 4).contiguous(),
                   "split": lambda: layout.split_quadrants_plain(y)}
        conv_bound = bound_ms([{"w": inp["gb"], "b": None}], (1, *act.shape), "bf16",
                              False, False)
        bounds = {"sep": conv_bound, "repack": conv_bound,
                  "wino": winograd_bound(inp["a_par"], u, out_hw, "direct"),
                  "winoF": winograd_bound(inp["a_par"], u, out_hw, "factored"),
                  "winoD": winograd_bound(inp["v"], u, out_hw, "pre"),
                  **{kind: (2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3, "bytes")
                     for kind, x in (("pack", act), ("split", y))}}
        name = f"{k}->{n} 1080p ({act.shape[0]}x{act.shape[1]} in, {out_hw[0]}x{out_hw[1]} out)"
        # the direct form is the shipped layer: a middle layer on the wgmma stage
        direct_kernel = "conv_layer_forward_wgmma"
        t = {}
        for kind, (kern, plain) in variants.items():
            got, ref = kern(), plain()
            if kind in library:
                check(torch.equal(got, ref), f"{kind} {name}: kernel differs from plain")
                copy_errs.append(float((got.float() - ref.float()).abs().max()))
            else:
                err = agree_bf16(f"{kind} {name}", got, ref)
                if kind.startswith("wino"):
                    wino_errs.append(err)
            del got, ref
            p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
            l1, l2 = ((time_ms(library[kind]), time_ms(library[kind])) if kind in library
                      else conv_ms)
            bound, bound_by = bounds[kind]
            t[kind] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                       "library_ms": (l1 + l2) / 2, "bound_ms": bound, "bound_by": bound_by}
            what = ".contiguous()" if kind in library else "cuDNN bf16 conv + ReLU"
            direct = (f"; the direct form's {conv_bound[0]:.4f} ms ({conv_bound[1]})"
                      if kind.startswith("wino") else "")
            label = f"{kind} ({direct_kernel})" if kind in ("sep", "repack") else kind
            print(f"[probe] {smi} | {name} {label}: kernel {k1:.3f}/{k2:.3f} ms, plain "
                  f"{p1:.3f}/{p2:.3f} ms, library ({what}) {l1:.3f}/{l2:.3f} ms, "
                  f"bound {bound:.4f} ms ({bound_by}{direct})")
        print(f"[probe] {smi} | {name}: sep / wino {t['sep']['ms'] / t['wino']['ms']:.2f}x, "
              f"sep / winoF {t['sep']['ms'] / t['winoF']['ms']:.2f}x, sep / winoD "
              f"{t['sep']['ms'] / t['winoD']['ms']:.2f}x")
        rows[(k, n)] = t
        del variants, inp
    w5_row = wino5_phase(smi, dev)
    rp_row = rowpair_phase(smi, dev)
    xp_rows = xpack_phase(smi, dev)
    print(f"[probe] phase {time.perf_counter() - t_phase:.1f} s")

    l6 = rows[(128, 128)]
    return [
        {"name": "winograd_f2x3", "source": "cnn_sr_tpu_torch/csrc/winograd.cu",
         "replaces": "tools/winograd_probe.py:291", "launches": launches["winograd"],
         "err": max(wino_errs), **l6["wino"]},
        {"name": "parity_copy", "source": "cnn_sr_tpu_torch/csrc/parity_copy.cu",
         "replaces": "tools/strided_store_probe.py:30", "launches": launches["parity_copy"],
         "err": max(copy_errs), **l6["pack"]},
        {"name": "wino5", "source": "cnn_sr_tpu_torch/csrc/wino5.cu",
         "replaces": "tools/wino5_probe.py:253", "launches": launches["wino5"], **w5_row},
        {"name": "rowpair_gemm", "source": "cnn_sr_tpu_torch/csrc/rowpair.cu",
         "replaces": "tools/rowpair_probe.py:46", "launches": launches["rowpair"], **rp_row},
        {"name": "xpack", "source": "cnn_sr_tpu_torch/csrc/xpack.cu",
         "replaces": "tools/xpack_probe.py:114", "launches": launches["xpack"],
         **xp_rows["xpack"]},
        {"name": "xpack2", "source": "cnn_sr_tpu_torch/csrc/xpack.cu",
         "replaces": "tools/xpack_probe2.py:172", "launches": launches["xpack2"],
         **xp_rows["xpack2"]},
    ]


def wino5_bound(x, w, out_hw, mode) -> tuple:
    """The least time of ``wino5`` itself in ``mode`` on this card: the
    larger of its operations over the bf16 peak and its bytes over the
    memory rate. Operations: the quad modes' dense 9·4k·4n multiply-adds a
    quad pixel; w55f's 6·3·2k·2n, the B6 row combinations' products and
    adds over (TC + 2) columns and the AT25 products and adds. Bytes: the
    f32 quad image and the bf16 weights read once, the bf16 parity output
    written once."""
    from cnn_sr_tpu_torch.probes import wino5

    tr, tc = out_hw[0] // 2, out_hw[1] // 2
    k, n = x.shape[2] // 4, wino5.KERNEL_N
    if mode == "w55f":
        nnz_b = (wino5.B6 != 0).sum(axis=1)
        nnz_at = (wino5.AT25 != 0).sum(axis=0)
        ops = (tr * tc * 2 * 6 * 3 * 2 * k * 2 * n
               + int((2 * nnz_b - 1).sum()) * tr * (tc + 2) * 2 * k
               + int(nnz_at.sum()) * 2 * tr * tc * 2 * n)
    else:
        ops = tr * tc * 2 * 9 * 4 * k * 4 * n
    moved = 4 * x.numel() + 2 * w.numel() + 2 * 4 * tr * tc * n
    t_ops, t_bytes = ops / PEAK_FLOPS["bf16"] * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def turns(kern, plain, library) -> dict:
    """Times in turns: plain, kernel, kernel, plain, library, library (no
    library times where ``library`` is None)."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
    l1, l2 = (time_ms(library), time_ms(library)) if library else (None, None)
    return {"k": (k1, k2), "p": (p1, p2), "l": (l1, l2), "ms": (k1 + k2) / 2,
            "plain_ms": (p1 + p2) / 2, "library_ms": (l1 + l2) / 2 if library else None}


def wino5_phase(smi, dev) -> dict:
    """``wino5`` in its four modes against its plain version at the probe's
    chunk, at k = 16 and k = ``MAX_K`` on a ragged grid of its 4 x 32 block
    and at the flagship's 1080p conv2, where each mode, ``sep`` (the
    shipped direct layer at f=5) and ``pack_quad`` are timed in turns
    beside cuDNN bf16 conv + ReLU (``.contiguous()`` of the strided view for
    the pack) and their bounds; and the L5 input pack (``pack_rows_cols``
    of the same bf16 input shape) over four turns before the variants are
    made, four after and four of a CUDA graph's replays (its device work
    alone). Returns the w55f row with every mode's and ``sep``'s 1080p ms
    beside it (``mode_ms``)."""
    from cnn_sr_tpu_torch.probes import layout, wino5

    g, a = wino5.probe_inputs()
    x = torch.from_numpy(a).to(dev)
    hw = (2 * wino5.TR, 2 * wino5.TC)
    errs = [agree_bf16(f"wino5 {mode} chunk",
                       wino5.wino5(x, wino5.weights(g, mode, dev), hw, mode),
                       wino5.wino5_plain(x, wino5.weights(g, mode, dev), hw, mode))
            for mode in wino5.MODES]
    # k = 16 and k = MAX_K on a ragged grid of the 4 x 32 block (13 x 35
    # quad outputs)
    rng = np.random.default_rng(SEED + 60)
    hw_r = (26, 70)
    for k in (16, wino5.MAX_K):
        act_k = torch.from_numpy(rng.random((hw_r[0] + 4, hw_r[1] + 4, k), np.float32) - 0.5)
        g_k = (rng.random((5, 5, k, wino5.N), np.float32) - 0.5).astype(np.float32)
        x_k = layout.pack_quad(act_k.to(dev))
        for mode in wino5.MODES:
            w_k = wino5.weights(g_k, mode, dev)
            errs.append(agree_bf16(f"wino5 {mode} k={k} {hw_r}", wino5.wino5(x_k, w_k, hw_r, mode),
                                   wino5.wino5_plain(x_k, w_k, hw_r, mode)))
    print(f"[probe] wino5 kernel vs plain at the probe's chunk (12x128 quad outputs, "
          f"4 modes) and at k = 16 and {wino5.MAX_K} on 13x35 quad outputs: max |kernel - "
          f"plain| {max(errs):.3e}")

    # the L5 input pack (pack_rows_cols of the same input shape in bf16),
    # four turns in a fresh process state and four after the 1080p variants
    out_hw = wino5.OUT_1080P
    act_l5 = wino5.layer_inputs(out_hw, dev, SEED)[0].to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pack_l5 = [time_ms(lambda: layout.pack_rows_cols(act_l5)) for _ in range(4)]
    variants, inp = wino5.layer_variants(out_hw, dev, seed=SEED)
    act, act_bf16, xq = inp["act"], inp["act_bf16"], inp["x"]
    lib_w = library_weights([{"w": inp["gb"].float(), "b": torch.zeros(wino5.N, device=dev)}],
                            "bf16")
    cudnn = lambda: library_convs(lib_w, act_bf16[None]).relu_()  # noqa: E731
    rh, cw = act.shape[0] // 2, act.shape[1] // 2
    library = {"pack": lambda: act.view(rh, 2, cw, 2, wino5.K).permute(0, 2, 1, 3, 4)
               .contiguous()}
    direct = bound_ms([{"w": inp["gb"], "b": None}], (1, *act.shape), "bf16", False, False)
    bounds = {"sep": direct, "pack": (8 * act.numel() / PEAK_BYTES * 1e3, "bytes"),
              **{m: wino5_bound(xq, inp["w"][m], out_hw, m) for m in wino5.MODES}}
    name = (f"flagship conv2 1080p ({act.shape[0]}x{act.shape[1]}x{wino5.K} in, "
            f"{out_hw[0]}x{out_hw[1]}x{wino5.N} out)")
    ysep = variants["sep"][0]()
    t = {}
    for kind, (kern, plain) in variants.items():
        got, ref = kern(), plain()
        if kind == "pack":
            check(torch.equal(got, ref), f"pack_quad {name}: kernel differs from plain")
        else:
            err = agree_bf16(f"{kind} {name}", got, ref)
            if kind != "sep":
                errs.append(err)
            if kind in wino5.GROUP:
                # the direct layer's exact products (and zeros), summed in another order
                agree_bf16(f"{kind} vs sep {name}", layout.merge_quadrants(got), ysep)
        del got, ref
        t[kind] = turns(kern, plain, library.get(kind, cudnn))
        bound, bound_by = bounds[kind]
        t[kind].update(bound_ms=bound, bound_by=bound_by)
        what = ".contiguous()" if kind == "pack" else "cuDNN bf16 conv + ReLU"
        extra = (f"; the direct form's {direct[0]:.4f} ms ({direct[1]})"
                 if kind in wino5.MODES else "")
        print(f"[probe] {smi} | {name} {kind}: kernel {t[kind]['k'][0]:.3f}/"
              f"{t[kind]['k'][1]:.3f} ms, plain {t[kind]['p'][0]:.3f}/{t[kind]['p'][1]:.3f} ms, "
              f"library ({what}) {t[kind]['l'][0]:.3f}/{t[kind]['l'][1]:.3f} ms, bound "
              f"{bound:.4f} ms ({bound_by}{extra})")
    print(f"[probe] {smi} | {name}: " + ", ".join(
        f"sep / {m} {t['sep']['ms'] / t[m]['ms']:.2f}x" for m in wino5.MODES))
    after = [time_ms(lambda: layout.pack_rows_cols(act_l5)) for _ in range(4)]
    graphed = [graph_ms(lambda: layout.pack_rows_cols(act_l5)) for _ in range(4)]
    print(f"[probe] {smi} | L5 input pack (pack_rows_cols, {tuple(act_l5.shape)} bf16), "
          f"4 turns before the conv2 variants: " + "/".join(f"{v:.3f}" for v in pack_l5)
          + " ms, 4 after them: " + "/".join(f"{v:.3f}" for v in after) + " ms, 4 of its "
          "device work alone (a CUDA graph's replays): " + "/".join(f"{v:.3f}" for v in graphed)
          + f" ms, bound {4 * act_l5.numel() / PEAK_BYTES * 1e3:.4f} ms (bytes)")
    del variants, inp
    row = {k: t["w55f"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    return {"err": max(errs), **row,
            "mode_ms": {m: t[m]["ms"] for m in (*wino5.MODES, "sep")}}


def rowpair_phase(smi, dev) -> dict:
    """``rowpair_gemm`` against its plain version (rel ≤ 1e-5) in the
    probe's four cases and at the flagship's 1080p exit (a 534x954xL
    operand, L = 128 and 64, bf16 and f32), where the strided read, the
    contiguous read and the copy route are timed in turns beside the plain
    version, ``torch.mm`` with ``out_dtype=torch.float32`` (the same
    function; "not measured" where this torch refuses it), ``torch.matmul``
    bf16 (bf16 out) and the bound, the strided read and ``torch.mm`` also
    as CUDA graph replays (their device work alone); each case with its
    achieved GB/s and share of the byte bound. Returns the bf16 L=128
    strided row: ``ms``, ``plain_ms`` and ``library_ms`` of calls in turns,
    as every row, and the replays' ``graph_ms`` and ``library_graph_ms``
    beside them."""
    from cnn_sr_tpu_torch.probes import rowpair

    errs = []
    for lanes in rowpair.LANES:
        for dtype in rowpair.DTYPES:
            a, wm = rowpair.probe_inputs(lanes)
            at = torch.from_numpy(a).to(dev, rowpair.DTYPES[dtype])
            wt = torch.from_numpy(wm).to(dev, torch.bfloat16)
            for rt in range(2):
                y = rowpair.rowpair_gemm(at, wt, rowpair.M_ROWS, rt)
                ref = rowpair.rowpair_gemm_plain(at, wt, rowpair.M_ROWS, rt)
                errs.append(float((y - ref).abs().max()))
                check(errs[-1] <= 1e-5 * float(ref.abs().max()),
                      f"rowpair {dtype} {lanes}: kernel vs plain {errs[-1]}")
    print(f"[probe] rowpair_gemm kernel vs plain at the probe's shape (64, 128, L), 4 cases: "
          f"max |kernel - plain| {max(errs):.3e}")
    row = None
    for lanes in rowpair.LANES:
        for dtype in rowpair.DTYPES:
            ways, plain, a, w = rowpair.routes(lanes, dtype, dev, seed=SEED)
            ref = plain()
            outs = {kind: ways[kind]() for kind in ("strided", "contiguous", "copy")}
            torch.cuda.synchronize()
            for y, r in zip(outs["strided"], ref):
                errs.append(float((y - r).abs().max()))
                check(errs[-1] <= 1e-5 * float(r.abs().max()),
                      f"rowpair 1080p {dtype} {lanes}: kernel vs plain {errs[-1]}")
            check(all(torch.equal(s, c) for s, c in zip(outs["strided"], outs["contiguous"]))
                  and all(torch.equal(s, c) for s, c in zip(outs["strided"], outs["copy"])),
                  f"rowpair 1080p {dtype} {lanes}: the routes differ")
            try:  # the yardstick: bf16 in, f32 out, the kernel's function
                lib_err = max(float((l.view(r.shape) - r).abs().max())
                              for l, r in zip(ways["library"](), ref))
                library = f"max |mm - plain| {lib_err:.3e}"
            except (TypeError, RuntimeError, NotImplementedError) as e:
                library = f"not measured ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
            del outs, ref
            m = a.shape[0] // 2
            macs = 2 * m * a.shape[1] * lanes * lanes
            moved = a.numel() * a.element_size() + 2 * w.numel() + 4 * 2 * m * a.shape[1] * lanes
            t_ops, t_bytes = 2 * macs / PEAK_FLOPS["bf16"] * 1e3, moved / PEAK_BYTES * 1e3
            bound = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
            t = turns(ways["strided"], plain,
                      None if library.startswith("not measured") else ways["library"])
            c1, c2, n1, n2 = (time_ms(ways["contiguous"]), time_ms(ways["copy"]),
                              time_ms(ways["copy"]), time_ms(ways["contiguous"]))
            b1, b2 = time_ms(ways["bf16_out"]), time_ms(ways["bf16_out"])
            g1, g2 = graph_ms(ways["strided"]), graph_ms(ways["strided"])
            t["graph_ms"], t["library_graph_ms"] = (g1 + g2) / 2, None
            if t["library_ms"] is not None:
                gl1, gl2 = graph_ms(ways["library"]), graph_ms(ways["library"])
                t["library_graph_ms"] = (gl1 + gl2) / 2
                library = (f"{t['l'][0]:.3f}/{t['l'][1]:.3f} ms (graph replays {gl1:.3f}/"
                           f"{gl2:.3f} ms; {library})")
            print(f"[probe] {smi} | rowpair 1080p exit ({a.shape[0]}x{a.shape[1]}x{lanes} "
                  f"{dtype}, both parities, {moved / 1e6:.1f} MB): strided {t['k'][0]:.3f}/"
                  f"{t['k'][1]:.3f} ms ({moved / t['ms'] / 1e6:.0f} GB/s, "
                  f"{bound[0] / t['ms']:.0%} of the {bound[1]} bound; graph replays {g1:.3f}/"
                  f"{g2:.3f} ms: {moved / t['graph_ms'] / 1e6:.0f} GB/s, "
                  f"{bound[0] / t['graph_ms']:.0%}), contiguous {c1:.3f}/{n2:.3f} ms, copy route "
                  f"{c2:.3f}/{n1:.3f} ms, plain {t['p'][0]:.3f}/{t['p'][1]:.3f} ms, torch.mm "
                  f"out_dtype=f32 {library}, torch.matmul bf16 (bf16 out) {b1:.3f}/{b2:.3f} ms, "
                  f"bound {bound[0]:.4f} ms ({bound[1]})")
            if (lanes, dtype) == (128, "bf16"):
                row = {**t, "bound_ms": bound[0], "bound_by": bound[1]}
            del ways, plain, a, w
    row["err"] = max(errs)
    return row


def xpack_bound(variant, steps: int) -> tuple:
    """The least time of ``tap_gemm`` of an xpack ``variant`` at ``steps`` on
    this card: the larger of its multiply-adds (two operations each) over
    the bf16 peak and its bytes over the memory rate: the bf16 operand and
    weights read once, the bf16 output of every step written once."""
    moved = 2 * (math.prod(variant.a_shape) + sum(math.prod(s) for s in variant.w_shapes)
                 + steps * math.prod(variant.out_shape))
    t_ops = 2 * variant.taps.mac * steps / PEAK_FLOPS["bf16"] * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def xpack_library(v, a, w, steps):
    """The one PyTorch call that computes a variant's ``steps``:
    ``torch.bmm`` of the taps' windows, gathered once into a (rows·cols, ΣK)
    bf16 operand and expanded with batch stride 0 over the steps, against
    the taps' weight rows stacked into a (ΣK, chunks·N) matrix, then
    ``relu_``. Tap t's rows sit in the columns of its chunk and are zero in
    the others, so with two chunks every output lane also sums exact zero
    products (``xpack_library_mac`` counts them) and each chunk's f32 sums
    are unchanged. Returns ``(fn, copies)``: ``copies`` names the copy
    kernels ``torch.profiler`` saw in one call; where there are any, ``fn``
    takes a contiguous operand (made once) instead."""
    taps = v.taps
    op = torch.cat([a[t.dr:t.dr + taps.rows, t.dc:t.dc + taps.cols, t.l0:t.l0 + t.k]
                    .reshape(-1, t.k) for t in taps.taps], dim=1)
    wk = torch.zeros(op.shape[1], taps.chunks * taps.n, dtype=w.dtype, device=w.device)
    k0 = 0
    for t in taps.taps:
        wk[k0:k0 + t.k, t.chunk * taps.n:(t.chunk + 1) * taps.n] = w[t.w0:t.w0 + t.k]
        k0 += t.k
    ops, ws = op.expand(steps, *op.shape), wk.expand(steps, *wk.shape)
    fn = lambda: torch.bmm(ops, ws).relu_()  # noqa: E731
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    copies = sorted({e.key for e in prof.key_averages()
                     if e.key in ("aten::copy_", "aten::clone") or "copy" in e.key.lower()})
    if copies:
        opc, wc = ops.contiguous(), ws.contiguous()
        fn = lambda: torch.bmm(opc, wc).relu_()  # noqa: E731
    return fn, copies


def xpack_library_mac(taps) -> int:
    """Multiply-adds a step of ``xpack_library``'s product: every tap's K
    rows against all chunks·N columns."""
    return taps.rows * taps.cols * sum(t.k for t in taps.taps) * taps.chunks * taps.n


def xpack_phase(smi, dev) -> dict:
    """``tap_gemm`` (``csrc/xpack.cu``) against its plain version in the 14
    variants of the two xpack probes at one step, and in the ragged
    (``xpack.ragged``) and streamed (``xpack.streamed``) cases at every N
    at 3 steps, one launch each; then each variant at a 1080p layer's steps
    (338 or 85), timed in turns beside its plain version and the one
    PyTorch call that computes the same steps (``xpack_library``:
    ``torch.bmm`` with batch stride 0, two chunks as one block-placed
    weight), and both as CUDA graph replays (the device work: a launch is
    40–300 µs, near the host's cost of one); printed with µs a step, ms per 1080p layer, the
    bound and the kernel's share of it, and packed / sep. Returns each
    probe's kernel row: its 64→64 packed variant, ``ms`` eager, its
    ``graph_ms`` and ``library_graph_ms`` beside it."""
    from cnn_sr_tpu_torch.probes import xpack, xpack2

    probes = {"xpack": xpack, "xpack2": xpack2}
    errs, ops = {name: [] for name in probes}, {}
    cases = []
    for name, mod in probes.items():
        inputs = mod.probe_inputs()
        for v in mod.VARIANTS:
            ops[v.name] = xpack.operands(v, *inputs[v.name], dev)
            cases.append((name, v.name, *ops[v.name], v.taps, 1))
    cases += [("xpack", f"{kind} N={n}", *getattr(xpack, kind)(n, dev, SEED), 3)
              for kind in ("ragged", "streamed") for n in xpack.WIDTHS]
    for name, what, a, w, taps, steps in cases:
        before = xpack.LAUNCHES
        y = xpack.tap_gemm(a, w, taps, steps)
        ref = xpack.tap_gemm_plain(a, w, taps, steps)
        torch.cuda.synchronize()
        check(xpack.LAUNCHES == before + 1, f"tap_gemm {what}: {xpack.LAUNCHES - before} launches")
        err, equal, ok = xpack.agree(y, ref)
        check(ok, f"tap_gemm {what}: kernel vs plain max {err}, bit-equal {equal}")
        errs[name].append(err)
    print(f"[probe] tap_gemm kernel vs plain, 14 variants at one step and the ragged and streamed "
          f"cases at N = 32/64/128 (3 steps): max |kernel - plain| "
          f"{max(max(e) for e in errs.values()):.3e}, within one bf16 ulp, >= 99.9% bit-equal")

    rows = {}
    for name, mod in probes.items():
        steps = xpack.steps_1080p(mod.VARIANTS)
        t = {}
        for v in mod.VARIANTS:
            a, w = ops[v.name]
            kern = lambda: xpack.tap_gemm(a, w, v.taps, steps)  # noqa: E731
            plain = lambda: xpack.tap_gemm_plain(a, w, v.taps, steps)  # noqa: E731
            library, copies = xpack_library(v, a, w, steps)
            ref = plain()
            lib_err, lib_equal, _ = xpack.agree(library().view(ref.shape), ref)
            del ref
            extra = xpack_library_mac(v.taps) / v.taps.mac
            lib_what = (f"torch.bmm batch stride 0 + relu_ (max |bmm - plain| {lib_err:.3e}, "
                        f"{lib_equal:.2%} bit-equal to plain; {extra:.2f}x the kernel's "
                        "multiply-adds; "
                        + (f"copies seen {copies}: timed on a contiguous operand"
                           if copies else "no copy of the expanded operand") + ")")
            t[v.name] = turns(kern, plain, library)
            g1, g2 = graph_ms(kern), graph_ms(kern)
            lg = graph_ms(library), graph_ms(library)
            bound, bound_by = xpack_bound(v, steps)
            layer, (oh, ow) = xpack.LAYERS[v.pair]
            per_layer = oh * ow / (v.positions * steps)
            tv = t[v.name]
            tv.update(g=(g1, g2), graph_ms=(g1 + g2) / 2, bound_ms=bound, bound_by=bound_by,
                      library_graph_ms=(lg[0] + lg[1]) / 2,
                      us_step=(g1 + g2) / 2 * 1e3 / steps, share=bound / ((g1 + g2) / 2))
            lib_ms = (f"{tv['l'][0]:.4f}/{tv['l'][1]:.4f} ms eager, {lg[0]:.4f}/{lg[1]:.4f} ms "
                      "as graph replays")
            print(f"[probe] {smi} | {name} {v.name} ({v.pair[0]}->{v.pair[1]}, {steps} steps, "
                  f"{v.taps.mac * steps / 1e9:.1f} G MAC): kernel {g1:.4f}/{g2:.4f} ms as graph "
                  f"replays ({tv['share']:.0%} of the bound; {tv['us_step']:.3f} us/step, "
                  f"{tv['graph_ms'] * per_layer:.4f} ms per 1080p {layer}), {tv['k'][0]:.4f}/"
                  f"{tv['k'][1]:.4f} ms eager ({bound / tv['ms']:.0%}), plain {tv['p'][0]:.3f}/"
                  f"{tv['p'][1]:.3f} ms, library {lib_what} {lib_ms}, bound {bound:.4f} ms "
                  f"({bound_by})")
        sep = None
        for v in mod.VARIANTS:
            if v.sep:
                sep = v.name
                continue
            print(f"[probe] {smi} | {name} {v.pair[0]}->{v.pair[1]}: {v.name} / {sep} "
                  f"{t[v.name]['graph_ms'] / t[sep]['graph_ms']:.3f}x as graph replays, "
                  f"{t[v.name]['ms'] / t[sep]['ms']:.3f}x eager; bound "
                  f"{t[v.name]['bound_ms'] / t[sep]['bound_ms']:.3f}x")
        l4 = t[mod.VARIANTS[-1].name]
        rows[name] = {"err": max(errs[name]), **{k: l4[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "graph_ms",
            "library_graph_ms", "share")}}
    return rows


def border_mask(h: int, w: int, s: int) -> np.ndarray:
    """True outside the valid-conv window that the swap writes."""
    pad = s // 2
    inside = np.zeros((h, w), bool)
    inside[pad:pad + h - s, pad:pad + w - s] = True
    return ~inside


def serve_path(cfg, params, cfg_rgb, params_rgb, smi) -> tuple:
    """The serving main path in bf16: one ``serve.DeviceWorker`` with the
    slots ``default`` (flagship) and ``rgb`` (RGB 7-layer), ``bucket=64``,
    ``max_batch=8``. Four 1080p flagship frames, two 1080p RGB frames and
    one 1000x700 flagship frame are queued before the worker starts, so
    that its first round groups them: two ``upscale_batch`` calls and one
    bucketed single. Then five single 1080p flagship jobs, one at a time.
    Returns the path's launch counts, read just after its run."""
    h, w = 1080, 1920
    luma_frames = [make_image(h, w, SEED + 10 + i) for i in range(4)]
    rgb_frames = [make_image(h, w, SEED + 20 + i) for i in range(2)]
    odd = make_image(700, 1000, SEED + 30)
    singles = [make_image(h, w, SEED + 40 + i) for i in range(5)]
    # untimed, uncounted: the first calls at these shapes grow the allocator
    api.upscale_batch(cfg, params, np.stack(luma_frames), precision="bf16")
    api.upscale_batch(cfg_rgb, params_rgb, np.stack(rgb_frames), precision="bf16")
    api.upscale_image(cfg, params, singles[0], bucket=64, precision="bf16")
    torch.cuda.synchronize()

    slots = {"default": {"cfg": cfg, "params": params},
             "rgb": {"cfg": cfg_rgb, "params": params_rgb}}
    worker = serve.DeviceWorker(slots, precision="bf16", bucket=64, max_batch=8)
    jobs = ([serve._Job("default", f) for f in luma_frames]
            + [serve._Job("rgb", f) for f in rgb_frames] + [serve._Job("default", odd)])
    for job in jobs:
        worker.submit(job)
    done_at = [0.0] * len(jobs)

    def stamp(i):
        jobs[i].done.wait(600)
        done_at[i] = time.perf_counter()

    waiters = [threading.Thread(target=stamp, args=(i,)) for i in range(len(jobs))]
    for t in waiters:
        t.start()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    worker.start()
    for t in waiters:
        t.join()
    single_jobs, single_ms = [], []
    for rgba in singles:
        job = serve._Job("default", rgba)
        t1 = time.perf_counter()
        worker.submit(job)
        check(job.done.wait(600), "serve: a single job timed out")
        single_ms.append((time.perf_counter() - t1) * 1e3)
        single_jobs.append(job)
    worker.stop()
    worker.join(60)
    torch.cuda.synchronize()
    total = counts()
    peak = torch.cuda.max_memory_allocated()
    stats = worker.snapshot()

    # the worker launched on its thread's current stream: the same one as here
    seen = []
    probe = threading.Thread(target=lambda: seen.append(torch.cuda.current_stream().cuda_stream))
    probe.start()
    probe.join()
    check(seen == [torch.cuda.current_stream().cuda_stream], f"serve: worker stream {seen}")
    check(not worker.is_alive(), "serve: the worker did not stop")
    check(total == (0, 0, 7, 7, 1, 5, 1),
          f"serve: launches (fused, chain, fused bf16, chain bf16, first, wgmma, last) {total}, "
          "expected (0, 0, 7, 7, 1, 5, 1): one fused batch of 4, one bucketed single, 5 singles; 7 "
          "chain layers, 5 of them (L2-L6) on the wgmma stage and L7 on the last-layer kernel")
    check(stats["ok"] == 12 and stats["batched_jobs"] == 6 and stats["errors"] == 0,
          f"serve: stats {stats}")

    def plain_pipeline(c, p, img, bucketed):
        net = lambda x: reference.fused_forward(p, x, "bf16")  # noqa: E731
        if bucketed:
            return api._upscale_bucketed(c, net, img, 64)
        if c.channels == 3:
            return api._upscale_rgb(net, img, add_mean=c.zero_mean_target)
        return api._upscale_luma(net, img, add_mean=c.zero_mean_target,
                                 squared_mean=c.subtract_squared_mean)

    cases = ([(j, cfg, params, False) for j in jobs[:4]]
             + [(j, cfg_rgb, params_rgb, False) for j in jobs[4:6]]
             + [(jobs[6], cfg, params, True)] + [(j, cfg, params, True) for j in single_jobs])
    worst_plain = worst_f32 = 0
    worst_share = 1.0
    for job, c, p, bucketed in cases:
        check(job.error is None, f"serve: job failed: {job.error!r}")
        out, rgba = job.result, job.rgba
        hh, ww = rgba.shape[:2]
        name = f"serve {'rgb' if c.channels == 3 else 'flagship'} {ww}x{hh}"
        check(out.shape == (hh, ww, 3) and out.dtype == np.uint8, f"{name}: {out.shape}")
        border = border_mask(hh, ww, c.total_padding())
        check(np.array_equal(out[border], rgba[..., :3][border]), f"{name}: border differs")
        plain = plain_pipeline(c, p, torch.from_numpy(rgba).cuda(), bucketed).cpu().numpy()
        d = np.abs(out.astype(np.int16) - plain.astype(np.int16))
        share = float((d <= 1).mean())
        check(int(d.max()) <= (2 if c.channels == 3 else 1) and share >= 0.999,
              f"{name}: vs plain bf16 pipeline max {int(d.max())}, within ±1 {share}")
        f32 = api.upscale_image(c, p, rgba)
        d32 = int(np.abs(out.astype(np.int16) - f32.astype(np.int16)).max())
        check(d32 <= (6 if c.channels == 3 else 4), f"{name}: vs the f32 kernels {d32} uint8")
        worst_plain, worst_f32 = max(worst_plain, int(d.max())), max(worst_f32, d32)
        worst_share = min(worst_share, share)

    ms = [(t - t0) * 1e3 for t in done_at]
    batch_fps = 4 / (ms[0] / 1e3)
    single_fps = len(single_ms) / (sum(single_ms) / 1e3)
    print(f"[serve] {smi} | bf16, bucket 64, max_batch 8 | first round done at (ms): "
          f"4 flagship 1080p (one batch) " + ", ".join(f"{v:.2f}" for v in ms[:4])
          + f"; 2 RGB 1080p (one batch) " + ", ".join(f"{v:.2f}" for v in ms[4:6])
          + f"; flagship 1000x700 (bucketed single) {ms[6]:.2f} | 5 single flagship 1080p: "
          + ", ".join(f"{v:.2f}" for v in single_ms)
          + f" ms | flagship frames/s batched {batch_fps:.2f} vs single {single_fps:.2f}"
          + f" | launches (fused, chain, fused bf16, chain bf16, first, wgmma, last) {total}"
          + f" | stats ok {stats['ok']} batched_jobs {stats['batched_jobs']} errors "
          f"{stats['errors']} rounds {stats['rounds']} max_batch_seen {stats['max_batch_seen']}"
          + f" | vs plain bf16 pipeline max {worst_plain} uint8 (within ±1: "
          f"{worst_share * 100:.4f}% or more), vs f32 kernels max {worst_f32} uint8"
          + f" | worker stream {seen[0]} | peak device memory {peak / 2**20:.1f} MiB")
    return total


def io_phase(smi) -> None:
    """[io]: build the port's native library (``native.py``), name the codec
    that serves ``ops.image`` (native, or Pillow where the library does not
    build), and round-trip a 1080p frame through it: PNG bit-equal; a PNG
    of the same frame written by Pillow (whose adaptive row filters user
    files carry) decoded bit-equal, and its decode timed; JPEG on
    tests/test_native.py's kind of image within its bound (mean |error| <
    6) where a JPEG codec serves, else the refusal must name libjpeg."""
    import PIL
    from PIL import Image

    from cnn_sr_tpu_torch import native
    from cnn_sr_tpu_torch.ops import image

    t0 = time.perf_counter()
    built = native.available()
    secs = time.perf_counter() - t0
    print(f"[io] native library (native/cnnsr_native.cpp, g++): "
          f"{'built' if built else 'did not build'} in {secs:.1f} s; codec: {image.codec()}")
    if not built:
        err = native.build_error().strip().splitlines()
        print("[io] build error: " + " | ".join(ln.strip() for ln in err[-4:]))
    frame = make_image(1080, 1920, SEED)[..., :3].copy()
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as d:
        path = os.path.join(d, "frame.png")
        t0 = time.perf_counter()
        image.write_image(path, frame)
        t1 = time.perf_counter()
        back = image.load_image(path)
        t2 = time.perf_counter()
        check(back.shape == (1080, 1920, 4) and np.array_equal(back[..., :3], frame)
              and bool((back[..., 3] == 255).all()), "[io] 1080p PNG round trip not bit-equal")
        print(f"[io] 1920x1080 PNG round trip bit-equal: encode {(t1 - t0) * 1e3:.1f} ms, "
              f"decode {(t2 - t1) * 1e3:.1f} ms, {os.path.getsize(path)} bytes")
        pil_path = os.path.join(d, "frame_pillow.png")
        Image.fromarray(frame, mode="RGB").save(pil_path)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            back = image.load_image(pil_path)
            times.append(time.perf_counter() - t0)
        check(np.array_equal(back[..., :3], frame) and bool((back[..., 3] == 255).all()),
              "[io] Pillow-written 1080p PNG not decoded bit-equal")
        print(f"[io] 1920x1080 PNG written by Pillow {PIL.__version__} (adaptive filters, "
              f"{os.path.getsize(pil_path)} bytes) decoded bit-equal by load_image: "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms")
        # JPEG on tests/test_native.py's image (a ramp plus N(0, 2) noise), at 1080p
        yy, xx = np.mgrid[0:1080, 0:1920].astype(np.float32)
        ramp = (yy * 255 / 1079 + xx * 255 / 1919) / 2
        smooth = np.clip(ramp[..., None] + np.random.default_rng(SEED).normal(0, 2, frame.shape),
                         0, 255).astype(np.uint8)
        jpg = os.path.join(d, "frame.jpg")
        try:
            image.write_image(jpg, smooth)
        except IOError as e:
            check("libjpeg" in str(e), f"[io] JPEG refusal does not name libjpeg: {e}")
            print(f"[io] JPEG: no codec here ({str(e).splitlines()[0][:200]})")
            return
        err = float(np.abs(image.load_image(jpg)[..., :3].astype(np.int32)
                           - smooth.astype(np.int32)).mean())
        check(err < 6.0, f"[io] 1080p JPEG round trip mean |error| {err}")
        print(f"[io] 1920x1080 JPEG round trip (a ramp plus N(0, 2) noise) mean |error| "
              f"{err:.3f} (bound 6)")


def train_phase(smi, dev, work):
    """[train]: the training path at full width, ``configs/srcnn_9-5-5.json``
    (n1 = 64, n2 = 32, f 9/5/5) from random parameters at seed 0.

    128 sample pairs of 128x128 written as PNG through ``ops.image``: the
    larges are crops of two ``make_image`` 1080p frames, the smalls the
    same crops down and up 2x with the port's bicubic (``ops.resize``).
    Loaded by ``find_training_samples`` and ``load_sample_set``. The first
    epoch's gradient on the card is held against the same ``_grads`` on the
    CPU, TF32 off, within tests/test_backprop_parity.py's rtol = atol =
    2e-4 of each tensor's largest entry. Then 16 epochs of ``train_loop``
    (``mini_batch_count`` 2, ``epochs_per_dispatch`` 4,
    ``validation_cadence`` 4; 25% validation, so that the 96 training
    samples split into two chunks) in ``highest``, ``high`` and ``bf16``
    from the same start: the validation error finite and lower at the end
    than at epoch 0; ms per epoch of each dispatch of four (the first
    holds the samples' upload and cuDNN's first plans), epochs/s, peak
    device memory. The ``highest`` weights are saved with
    ``save_parameters_file`` and loaded back bit-exact, then upscale one
    1080p frame through ``api.upscale_image``: one ``fused_srcnn`` launch,
    within ±1 uint8 of the plain version's pipeline. Last, the CLI:
    ``cnn_torch.py train -c configs/srcnn_9-5-5.json -i <dir> -e 4 -o
    p.json`` in a subprocess, rc 0, the file loadable. The samples are
    written under ``work``, where ``[profile]`` trains on them again.
    Returns the loaded sample set (``[parallel]`` trains on it)."""
    from cnn_sr_tpu_torch.ops.image import codec, write_image
    from cnn_sr_tpu_torch.ops.resize import degrade
    from cnn_sr_tpu_torch.training import samples as tsamples
    from cnn_sr_tpu_torch.training import trainer
    from cnn_sr_tpu_torch.utils.params_io import load_parameters_file, save_parameters_file

    t_phase = time.perf_counter()
    cfg_path = os.path.join(ROOT, "configs", "srcnn_9-5-5.json")
    cfg = read_config(cfg_path)
    rng = np.random.default_rng(SEED)
    frames = [make_image(1080, 1920, SEED + 50 + i)[..., :3] for i in range(2)]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        sample_dir = os.path.join(work, "samples")
        os.makedirs(sample_dir)
        t0 = time.perf_counter()
        for i in range(128):
            y, x = rng.integers(0, 1080 - 128), rng.integers(0, 1920 - 128)
            large = np.ascontiguousarray(frames[i % 2][y:y + 128, x:x + 128])
            small = degrade(torch.from_numpy(large).to(dev, torch.float32), 2.0)
            small = torch.clamp(torch.round(small), 0, 255).to(torch.uint8).cpu().numpy()
            write_image(os.path.join(sample_dir, f"crop{i:03d}_large.png"), large)
            write_image(os.path.join(sample_dir, f"crop{i:03d}_small.png"), small)
        t1 = time.perf_counter()
        pairs = tsamples.find_training_samples(sample_dir)
        data = tsamples.load_sample_set(pairs)
        t2 = time.perf_counter()
        check(len(pairs) == 128 and data.input_luma.shape == (128, 128, 128, 1),
              f"[train] samples: {len(pairs)} pairs, {data.input_luma.shape}")
        print(f"[train] 128 pairs of 128x128 PNG written in {t1 - t0:.2f} s, found and loaded "
              f"in {t2 - t1:.2f} s (codec: {codec()})")

        # the first epoch's gradient, card against CPU, TF32 off
        state0 = trainer.init_train_state(cfg, seed=SEED)
        train_idx, _ = tsamples.divide_samples(128, 32, np.random.default_rng(SEED))
        grads = {}
        for name, gdev in (("cpu", torch.device("cpu")), ("card", dev)):
            p = params_to_torch(state0.params, gdev)
            x = torch.from_numpy(data.input_luma[train_idx]).to(gdev)
            t = torch.from_numpy(data.expected_luma[train_idx]).to(gdev)
            t0 = time.perf_counter()
            g = trainer._grads(p, x, t, 2)
            grads[name] = [{k: v.cpu().numpy() for k, v in layer.items()} for layer in g]
            grads[name + "_s"] = time.perf_counter() - t0
        rels = []
        for i, (a, b) in enumerate(zip(grads["card"], grads["cpu"])):
            for k in ("w", "b"):
                scale = float(np.abs(b[k]).max())
                err = np.abs(a[k] - b[k]) / scale
                check(bool((err <= 2e-4 + 2e-4 * np.abs(b[k]) / scale).all()),
                      f"[train] card gradient layer {i + 1} {k}: max {float(err.max())} of "
                      f"the largest entry {scale}")
                rels.append(f"L{i + 1}{k} {float(err.max()):.1e}")
        print(f"[train] {smi} | first epoch's gradient (96 samples, 2 chunks), card vs CPU, "
              f"TF32 off: max |diff| / max |grad| per tensor " + ", ".join(rels)
              + f" (gate 2e-4) | card {grads['card_s'] * 1e3:.1f} ms (first call), "
              f"CPU {grads['cpu_s']:.2f} s")

        trained = None
        for precision in ("highest", "high", "bf16"):
            state = trainer.init_train_state(cfg, seed=SEED)
            stamps, errs = [], []

            def on_epoch(e, v):
                if e % 4 == 0:
                    stamps.append(time.perf_counter())
                if v is not None:
                    errs.append((e, v))

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            error = trainer.train_loop(
                cfg, data, state, 16, validation_percent=25, mini_batch_count=2,
                validation_cadence=4, epochs_per_dispatch=4, seed=SEED,
                precision=None if precision == "highest" else precision, device=dev,
                log=lambda *a: None, on_epoch=on_epoch)
            total = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            check(not error and state.epochs == 16, f"[train] {precision}: error {error}, "
                  f"epochs {state.epochs}")
            check([e for e, _ in errs] == [0, 4, 8, 12, 15], f"[train] val epochs {errs}")
            check(all(math.isfinite(v) for _, v in errs) and errs[-1][1] < errs[0][1],
                  f"[train] {precision}: validation error did not fall: {errs}")
            per = [(stamps[0] - t0) * 1e3 / 4] + [(b - a) * 1e3 / 4
                                                  for a, b in zip(stamps, stamps[1:])]
            med = float(np.median(per[1:]))
            print(f"[train] {smi} | 9-5-5 full width, {precision}: ms per epoch of each "
                  "dispatch of 4: " + ", ".join(f"{v:.2f}" for v in per)
                  + f" (median of the warm three {med:.2f}; {1e3 / med:.1f} epochs/s; "
                  f"16 epochs in {total:.2f} s) | mean validation error at epochs "
                  + ", ".join(f"{e}: {v / 32:.4f}" for e, v in errs)
                  + f" | peak device memory {peak / 2**20:.1f} MiB")
            if trained is None:
                trained = state

        path = os.path.join(d, "trained.json")
        save_parameters_file(path, trained.params, epochs=trained.epochs)
        back, epochs = load_parameters_file(path, cfg.layer_specs())
        check(epochs == 16 and all(a["w"].tobytes() == b["w"].tobytes()
                                   and a["b"].tobytes() == b["b"].tobytes()
                                   for a, b in zip(back, trained.params)),
              "[train] the saved parameters file does not load back bit-exact")

        params = params_to_torch(back, dev)
        rgba = make_image(1080, 1920, SEED + 60)
        reset_counts()
        out = api.upscale_image(cfg, params, rgba)
        made = counts()
        check(made == (1, 0, 0, 0, 0, 0, 0),
              f"[train] upscale launches {made}, expected (1, 0, 0, 0, 0, 0, 0)")
        plain = api._upscale_luma(lambda x: reference.fused_forward(params, x),
                                  torch.from_numpy(rgba).to(dev), add_mean=cfg.zero_mean_target,
                                  squared_mean=cfg.subtract_squared_mean).cpu().numpy()
        diff = int(np.abs(out.astype(np.int16) - plain.astype(np.int16)).max())
        border = border_mask(1080, 1920, cfg.total_padding())
        check(out.shape == (1080, 1920, 3) and diff <= 1
              and np.array_equal(out[border], rgba[..., :3][border]),
              f"[train] trained upscale: {out.shape}, max diff {diff} uint8 vs plain")
        print(f"[train] saved and loaded back bit-exact (epochs {epochs}); 1920x1080 upscale "
              f"with the trained weights: launches (fused, chain, fused bf16, chain bf16, first, "
              "wgmma, last) "
              f"{made}, max diff vs plain pipeline {diff} uint8")

        out_path = os.path.join(d, "cli.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "cnn_torch.py"), "train", "-c", cfg_path,
             "-i", sample_dir, "-e", "4", "-o", out_path, "--seed", "0"],
            capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"[train] cnn_torch.py train rc {proc.returncode}: "
              f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        _, epochs = load_parameters_file(out_path, cfg.layer_specs())
        check(epochs == 4, f"[train] cnn_torch.py train wrote epochs {epochs}")
        timing = [ln for ln in proc.stdout.splitlines() if ln.startswith("Training time")]
        print(f"[train] cnn_torch.py train -c configs/srcnn_9-5-5.json -i <128 pairs> -e 4: "
              f"rc 0 in {secs:.1f} s, {timing[0] if timing else ''}; parameters file loads "
              f"(epochs {epochs})")
    print(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return data


# the card-vs-card tolerance of [train] (tests/test_backprop_parity.py's
# rtol = atol, of each tensor's largest entry)
TRAIN_GATE = 2e-4


def spatial_requests(name, cfg, params, rgba, shards, precision, want, tol, smi, n=3) -> tuple:
    """``n`` requests of ``rgba`` through ``api.upscale_image_spatial`` over
    ``shards`` bands on ``cuda:0`` named ``shards`` times, beside ``n``
    unsharded ``api.upscale_image`` requests (each side warmed once, out of
    the counted run): each sharded request makes exactly ``want`` launches
    (see ``counts``) and is within ``tol`` uint8 of the unsharded one.
    Returns the launches of the sharded run (counts set to 0 just before
    it and read just after), the outputs' max uint8 difference, and the
    ms and peak bytes of both sides."""
    cards = [torch.device("cuda", 0)] * shards
    side = {}
    for label, fn in (("single", lambda: api.upscale_image(cfg, params, rgba,
                                                           precision=precision)),
                      ("sharded", lambda: api.upscale_image_spatial(
                          cfg, params, rgba, shards, precision=precision, devices=cards))):
        fn()
        if label == "sharded":
            reset_counts()
        outs, ms, peak = [], [], 0
        for _ in range(n):
            before = counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs.append(fn())
            ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())
            made = tuple(a - b for a, b in zip(counts(), before))
            if label == "sharded":
                check(made == want, f"[parallel] {name} {precision}: a sharded request made "
                      f"launches {made}, expected {want}")
        side[label] = (outs, ms, peak, counts())
    (ref, *_), single_ms, single_peak, _ = side["single"]
    outs, ms, peak, made = side["sharded"]
    h, w = rgba.shape[:2]
    border = border_mask(h, w, cfg.total_padding())
    diff = 0
    for out in outs:
        check(out.shape == (h, w, 3) and out.dtype == np.uint8
              and np.array_equal(out[border], rgba[..., :3][border]),
              f"[parallel] {name} {precision}: output {out.shape}, border")
        check(np.array_equal(out, outs[0]), f"[parallel] {name} {precision}: requests disagree")
        diff = max(diff, int(np.abs(out.astype(np.int16) - ref.astype(np.int16)).max()))
    check(diff <= tol, f"[parallel] {name} {precision}: sharded vs unsharded max diff {diff} "
          f"uint8 > {tol}")
    return made, diff, ms, single_ms, peak, single_peak


def halo_bytes(params, x: torch.Tensor, n_spatial: int) -> int:
    """Bytes ``sharded_forward``'s halo exchange copies: the stack's shrink
    rows of every band but the last."""
    shrink = sum(layer["w"].shape[0] - 1 for layer in params)
    n, _, w, c = x.shape
    return (n_spatial - 1) * n * shrink * w * c * x.element_size()


def spatial_float_diff(params, x, shards, precision) -> float:
    """Max |sharded − unsharded| of the conv stack's f32 output on ``x``:
    ``sharded_forward`` with each band through ``SRCNN`` against one
    ``entry.fused_forward`` over the whole input (outside any counted run)."""
    from cnn_sr_tpu_torch.models.srcnn import SRCNN
    from cnn_sr_tpu_torch.parallel import make_mesh, sharded_forward

    mesh = make_mesh(1, shards, devices=[torch.device("cuda", 0)] * shards)
    y = sharded_forward(mesh, params, x, forward_fn=lambda p, band: SRCNN(p, precision)(band))
    ref = entry.fused_forward(params, x, precision)
    check(y.shape == ref.shape, f"[parallel] sharded stack {tuple(y.shape)} vs {tuple(ref.shape)}")
    return float((y - ref).abs().max())


def rel_diff(got, want) -> float:
    """Max over the tensors of two layer lists (numpy) of max |got − want|
    / max |want|: ``[train]``'s card-vs-card measure."""
    worst = 0.0
    for g, w in zip(got, want):
        for k in ("w", "b"):
            rel = float(np.abs(g[k] - w[k]).max() / max(float(np.abs(w[k]).max()), 1e-30))
            worst = max(worst, rel if math.isfinite(rel) else math.inf)
    return worst


def multihost_worker(argv) -> int:
    """``chip_smoke.py --multihost-worker <rank> <port> <dir>``: one of the
    two processes of ``[parallel]``'s multi-process step. Joins a ``gloo``
    group on 127.0.0.1:<port> (NCCL refuses two ranks on one card), takes
    its half of ``<dir>/mh_in.npz``'s samples on a one-replica mesh of
    ``cuda:0``, runs one step of ``make_train_step(cfg, mesh=…)`` over the
    9-5-5 at full width and writes the new parameters and momentum to
    ``<dir>/mh_out<rank>.npz``."""
    import torch.distributed as dist

    from cnn_sr_tpu_torch.parallel import initialize_multihost, make_mesh, process_count
    from cnn_sr_tpu_torch.training import trainer

    rank, port, d = int(argv[0]), argv[1], argv[2]
    dev = torch.device("cuda", 0)
    check(initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
          and process_count() == 2, "[parallel] process group")
    cfg = read_config(os.path.join(ROOT, "configs", "srcnn_9-5-5.json"))
    state = trainer.init_train_state(cfg, seed=SEED)
    data = np.load(os.path.join(d, "mh_in.npz"))
    half = data["x"].shape[0] // 2
    x = torch.from_numpy(data["x"][rank * half:(rank + 1) * half]).to(dev)
    t = torch.from_numpy(data["t"][rank * half:(rank + 1) * half]).to(dev)
    p, prev = params_to_torch(state.params, dev), params_to_torch(state.prev_delta, dev)
    step = trainer.make_train_step(cfg, mesh=make_mesh(1, devices=[dev]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(p, prev, x, t)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    np.savez(os.path.join(d, f"mh_out{rank}.npz"),
             **{f"{k}{i}": l[k].cpu().numpy() for i, l in enumerate(p) for k in ("w", "b")},
             **{f"d{k}{i}": l[k].cpu().numpy() for i, l in enumerate(prev) for k in ("w", "b")})
    dist.destroy_process_group()
    print(f"worker {rank}: step {ms:.1f} ms", flush=True)
    return 0


def parallel_phase(smi, dev, cfg, params, cfg_rgb, params_rgb, data) -> dict:
    """[parallel]: the port's parallelism on the card, ``cuda:0`` named
    several times (the machine has one card).

    Spatial: three 1920x1080 requests of the flagship checkpoint through
    ``api.upscale_image_spatial`` at 4 shards, in bf16 and in f32: exactly
    4 fused launches each (one a band, ragged: 270 + 16 rows), within ±1
    uint8 of ``api.upscale_image`` on the same frame, with the conv stack's
    max float difference, ms per request beside the unsharded request's,
    the halo bytes and the peak device memory of both. RGB: one 7-layer
    request at 2 shards, 14 chain launches, within ±1 (f32) or ±2 (bf16)
    of the unsharded request. Data parallel: one full-width 9-5-5 step on
    ``[train]``'s 96-sample train split with ``n_data = 2`` (``cuda:0``
    twice) against one step on ``cuda:0`` alone, TF32 off: the change of
    parameters and the momentum (the step's undivided delta) within
    ``TRAIN_GATE`` of each tensor's largest entry; timed. Multihost: two processes (``multihost_worker``), each
    half the samples, one step over ``gloo``: equal to each other bit for
    bit and to the single step within ``TRAIN_GATE``. Resize:
    ``upscale_rgba`` of a 540x960 frame by 2 in each method on the card
    against the CPU, within 1 uint8. Returns the sharded runs' launches."""
    from cnn_sr_tpu_torch.ops.color import extract_luma, subtract_mean
    from cnn_sr_tpu_torch.ops.resize import upscale_rgba
    from cnn_sr_tpu_torch.parallel import make_mesh
    from cnn_sr_tpu_torch.training import samples as tsamples
    from cnn_sr_tpu_torch.training import trainer

    t_phase = time.perf_counter()
    launches = {}
    rgba = make_image(1080, 1920, SEED)
    img = torch.from_numpy(rgba).to(dev)
    x = subtract_mean(extract_luma(img))[0][None, ..., None].contiguous()
    for precision, want in (("bf16", (0, 0, 4, 0, 0, 0, 0)), ("f32", (4, 0, 0, 0, 0, 0, 0))):
        made, diff, ms, single_ms, peak, single_peak = spatial_requests(
            "flagship 9-5-5", cfg, params, rgba, 4, precision, want, 1, smi)
        launches[f"flagship {precision}"] = made
        fdiff = spatial_float_diff(params, x, 4, precision)
        print(f"[parallel] {smi} | spatial, flagship 9-5-5 {precision}, 1920x1080 over 4 bands "
              f"of cuda:0: ms per request " + ", ".join(f"{v:.2f}" for v in ms)
              + " (unsharded " + ", ".join(f"{v:.2f}" for v in single_ms)
              + f") | launches (fused, chain, fused bf16, chain bf16, first, wgmma, last) {made} "
              "| max diff vs "
              f"unsharded {diff} uint8, conv stack max |float diff| {fdiff:.3e} | halo "
              f"{halo_bytes(params, x, 4)} bytes | peak device memory {peak / 2**20:.1f} MiB "
              f"(unsharded {single_peak / 2**20:.1f})")
    rgb = img[..., :3].to(torch.float32) / 255.0
    x_rgb = (rgb - rgb.mean(dim=(0, 1), keepdim=True))[None].contiguous()
    for precision, want, tol in (("f32", (0, 14, 0, 0, 0, 0, 0), 1),
                                 ("bf16", (0, 0, 0, 14, 2, 10, 2), 2)):
        made, diff, ms, single_ms, peak, single_peak = spatial_requests(
            "RGB 7-layer", cfg_rgb, params_rgb, rgba, 2, precision, want, tol, smi, n=1)
        launches[f"RGB {precision}"] = made
        fdiff = spatial_float_diff(params_rgb, x_rgb, 2, precision)
        print(f"[parallel] {smi} | spatial, RGB 7-layer {precision}, 1920x1080 over 2 bands: "
              f"{ms[0]:.2f} ms (unsharded {single_ms[0]:.2f}) | launches {made} | max diff vs "
              f"unsharded {diff} uint8 (gate {tol}), conv stack max |float diff| {fdiff:.3e} "
              f"| halo {halo_bytes(params_rgb, x_rgb, 2)} bytes | peak device memory "
              f"{peak / 2**20:.1f} MiB (unsharded {single_peak / 2**20:.1f})")

    # data parallel: one step of the 9-5-5 at full width on [train]'s split
    cfg_t = read_config(os.path.join(ROOT, "configs", "srcnn_9-5-5.json"))
    state0 = trainer.init_train_state(cfg_t, seed=SEED)
    start = [{k: l[k].copy() for k in ("w", "b")} for l in state0.params]
    train_idx, _ = tsamples.divide_samples(128, 32, np.random.default_rng(SEED))
    xs, ts = data.input_luma[train_idx], data.expected_luma[train_idx]
    xt, tt = torch.from_numpy(xs).to(dev), torch.from_numpy(ts).to(dev)
    results = {}
    for label, mesh in (("single", None), ("n_data 2", make_mesh(2, devices=[dev, dev]))):
        step = trainer.make_train_step(cfg_t, mesh=mesh)
        ms = []
        for _ in range(4):
            # copies: the step updates them in place
            p = params_to_torch([{k: l[k].copy() for k in ("w", "b")} for l in start], dev)
            prev = params_to_torch([{k: np.zeros_like(l[k]) for k in ("w", "b")}
                                    for l in start], dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(p, prev, xt, tt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        results[label] = ([{k: l[k].cpu().numpy().copy() for k in ("w", "b")} for l in p],
                          [{k: l[k].cpu().numpy().copy() for k in ("w", "b")} for l in prev], ms)
    (p1, d1, ms1), (p2, d2, ms2) = results["single"], results["n_data 2"]
    rel_p, rel_d = rel_diff(p2, p1), rel_diff(d2, d1)
    check(rel_p <= TRAIN_GATE and rel_d <= TRAIN_GATE,
          f"[parallel] data-parallel step vs single: parameters {rel_p}, momentum {rel_d} "
          f"of the largest entry (gate {TRAIN_GATE})")
    print(f"[parallel] {smi} | data parallel, 9-5-5 full width, 96 samples of 128x128, TF32 "
          f"off: n_data 2 (cuda:0 twice) vs one device, max |diff| / max |entry| parameters "
          f"{rel_p:.2e}, momentum {rel_d:.2e} (gate {TRAIN_GATE}) | ms per step (first, then "
          f"warm) single " + ", ".join(f"{v:.2f}" for v in ms1) + ", n_data 2 "
          + ", ".join(f"{v:.2f}" for v in ms2))

    # two processes on cuda:0 over gloo, each half the samples
    import socket

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d, socket.socket() as sock:
        np.savez(os.path.join(d, "mh_in.npz"), x=xs, t=ts)
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
        sock.close()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--multihost-worker", str(r), port, d],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            logs.append("timed out after 240 s")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        secs = time.perf_counter() - t0
        check(len(logs) == 2 and all(proc.returncode == 0 for proc in procs),
              "[parallel] multihost workers: " + " | ".join(log[-1500:] for log in logs))
        outs = [np.load(os.path.join(d, f"mh_out{r}.npz")) for r in range(2)]
        for k in outs[0].files:
            check(np.array_equal(outs[0][k], outs[1][k]),
                  f"[parallel] multihost: {k} differs across the two processes")
        mp = [{k: outs[0][f"{k}{i}"] for k in ("w", "b")} for i in range(len(p1))]
        md = [{k: outs[0][f"d{k}{i}"] for k in ("w", "b")} for i in range(len(p1))]
        rel_mp, rel_md = rel_diff(mp, p1), rel_diff(md, d1)
        check(rel_mp <= TRAIN_GATE and rel_md <= TRAIN_GATE,
              f"[parallel] multihost step vs single: parameters {rel_mp}, momentum {rel_md}")
    steps = [ln.strip() for log in logs for ln in log.splitlines() if "step" in ln]
    print(f"[parallel] {smi} | multihost: 2 processes on cuda:0 over gloo, 48 samples each, "
          f"one step: equal across processes bit for bit; vs one device max |diff| / max |entry| "
          f"parameters {rel_mp:.2e}, momentum {rel_md:.2e} | {'; '.join(steps)} | both "
          f"processes in {secs:.1f} s")

    frame = make_image(540, 960, SEED + 70)
    on_card = torch.from_numpy(frame).to(dev)
    parts = []
    for method in ("bicubic", "linear", "nearest", "lanczos"):
        want = upscale_rgba(torch.from_numpy(frame), 2.0, method).numpy()
        got = upscale_rgba(on_card, 2.0, method).cpu().numpy()
        check(got.shape == want.shape == (1080, 1920, 4), f"[parallel] resize {method} shape")
        diff = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        check(diff <= 1, f"[parallel] resize {method}: card vs CPU max diff {diff} uint8")
        parts.append(f"{method} {time_ms(lambda: upscale_rgba(on_card, 2.0, method), 5):.3f} ms "
                     f"(max diff {diff}, {int((got != want).sum())} bytes differ)")
    print(f"[parallel] {smi} | resize: upscale_rgba 960x540 → 1920x1080 on the card vs the "
          f"CPU: " + ", ".join(parts))
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` (``cnn_torch.py``) in this process: its rc, its
    standard output, and how many host-blocking operations
    ``warn_blocking_transfers`` warned at (``profile`` mode only)."""
    import contextlib
    import io
    import warnings

    from cnn_sr_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        rc = cli.main(argv)
    return rc, buf.getvalue(), sum("synchronizing" in str(w.message) for w in seen)


def short(name: str, n: int = 70) -> str:
    """A kernel's demangled name cut to its head (template names run long)."""
    return name if len(name) <= n else name[:n] + "..."


def trace_summary(trace: str) -> tuple:
    """(rows, device op time in µs, idle share of the whole traced window,
    idle share between the first and the last device op) of a trace."""
    from cnn_sr_tpu_torch import profiling

    rows = profiling.op_shares(trace)
    total = sum(t for _, t, _ in rows)
    busy = profiling.idle_share(trace)
    check(bool(rows) and busy is not None, f"[profile] no device ops in the trace {trace}")
    return rows, total, 1 - busy["busy"] / busy["window"], 1 - busy["busy"] / busy["span"]


def profile_phase(smi, work) -> None:
    """[profile]: ``cnn_torch.py ... profile`` (``cli.main`` in this process)
    on one 1920x1080 PNG through the flagship checkpoint in bf16
    (``--pallas``) and f32 and the RGB checkpoint in bf16 and f32, each
    with ``--trace-dir``: rc 0; exactly one ``fused_wgmma_kernel``, one
    ``fused_srcnn_kernel``, one ``conv_first_wgmma_kernel``, five
    ``conv_layer_wgmma_kernel`` and one ``conv_last_wgmma_kernel`` or seven
    ``conv_layer_kernel`` launches, by
    the ``LAUNCHES*`` counters and by the
    op table of the trace (``profiling.op_shares``), which must name the
    kernel; the PNG byte-equal to an unprofiled run's. Prints the kernel's
    share of device time, the copies, the device's idle share over the
    traced window and between its first and last op, the stage table and
    the host-blocking warnings. Then ``train dry profile`` for 2 epochs on
    ``[train]``'s samples (``configs/srcnn_9-5-5.json``, full width) and its
    op table's top rows. Between them, one warm 1080p request of each of
    the four alone in its trace (``profiling.StageProfiler`` around
    ``api.upscale_image``): its device time by op and the device's idle
    share between the upload and the readback."""
    from cnn_sr_tpu_torch.ops.image import write_image
    from cnn_sr_tpu_torch.tools.profile import STAGE_LINE

    t_phase = time.perf_counter()
    src = os.path.join(work, "frame.png")
    write_image(src, make_image(1080, 1920, SEED + 70)[..., :3])
    # each run's kernels and their launches in the op table
    runs = (("flagship 9-5-5", FLAGSHIP, "bf16", (0, 0, 1, 0, 0, 0, 0),
             {"fused_wgmma_kernel": 1}),
            ("flagship 9-5-5", FLAGSHIP, "f32", (1, 0, 0, 0, 0, 0, 0), {"fused_srcnn_kernel": 1}),
            ("RGB 7-layer", RGB7, "bf16", (0, 0, 0, 7, 1, 5, 1),
             {"conv_first_wgmma_kernel": 1, "conv_layer_wgmma_kernel": 5,
              "conv_last_wgmma_kernel": 1}),
            ("RGB 7-layer", RGB7, "f32", (0, 7, 0, 0, 0, 0, 0), {"conv_layer_kernel": 7}))
    for i, (name, cfg_path, precision, want, kernels) in enumerate(runs):
        line = ["-c", cfg_path, "-i", src] + (["--pallas"] if precision == "bf16" else [])
        plain, profiled = (os.path.join(work, f"{k}{i}.png") for k in ("plain", "profiled"))
        trace = os.path.join(work, f"trace{i}")
        rc, text, _ = run_cli(line + ["-o", plain])
        check(rc == 0, f"[profile] {name} {precision} unprofiled: rc {rc}: {text[-1500:]}")
        reset_counts()
        t0 = time.perf_counter()
        rc, text, blocking = run_cli(["profile", *line, "-o", profiled, "--trace-dir", trace])
        secs = time.perf_counter() - t0
        made = counts()
        check(rc == 0, f"[profile] {name} {precision}: rc {rc}: {text[-1500:]}")
        check(made == want, f"[profile] {name} {precision}: launches {made}, expected {want}")
        with open(plain, "rb") as a, open(profiled, "rb") as b:
            check(a.read() == b.read(),
                  f"[profile] {name} {precision}: the profiled PNG differs from the unprofiled")
        rows, total, idle_window, idle_span = trace_summary(trace)
        mine = [r for r in rows if any(k in r[0] for k in kernels)]
        for k, n in kernels.items():
            seen = [r for r in rows if k in r[0]]
            check(sum(c for _, _, c in seen) == n and k in text,
                  f"[profile] {name} {precision}: {k} in the op table {seen}, expected {n} "
                  "launches")
        kernel = " + ".join(kernels)
        kernel_us = sum(t for _, t, _ in mine)
        copies = [r for r in rows if r[0].startswith(("Memcpy", "Memset"))]
        stages = [STAGE_LINE.match(ln) for ln in text.splitlines()]
        print(f"[profile] {smi} | cnn_torch.py profile, 1920x1080 PNG, {name} {precision}: rc 0 "
              f"in {secs:.2f} s, launches (fused, chain, fused bf16, chain bf16, first, wgmma, "
              "last) "
              f"{made}, PNG byte-equal to the unprofiled run's | {kernel} "
              f"x{sum(kernels.values())} "
              f"{kernel_us / 1e3:.3f} ms = {kernel_us * 100 / total:.1f}% of device op time "
              f"{total / 1e3:.3f} ms | copies: "
              + ", ".join(f"{n} x{c} {t / 1e3:.3f} ms" for n, t, c in copies)
              + f" | device idle {idle_window * 100:.2f}% of the traced window, "
              f"{idle_span * 100:.2f}% between its first and last op | stages: "
              + ", ".join(f"{m.group(4)} {float(m.group(1)) * 1e3:.1f} ms" for m in stages if m)
              + f" | host-blocking warnings {blocking}")
        print("[profile]   top ops: " + "; ".join(
            f"{short(n)} x{c} {t / 1e3:.3f} ms ({t * 100 / total:.1f}%)" for n, t, c in rows[:5]))

    # one warm request alone in its trace, through the API: its device
    # time by op and its idle share between the upload and the readback
    from cnn_sr_tpu_torch.profiling import StageProfiler

    rgba = make_image(1080, 1920, SEED + 70)
    for i, (name, cfg_path, precision, want, kernels) in enumerate(runs):
        cfg = read_config(cfg_path)
        params = params_to_torch(init_params(cfg)[0], torch.device("cuda"))
        api.upscale_image(cfg, params, rgba, precision=precision)
        trace = os.path.join(work, f"trace_request{i}")
        prof = StageProfiler(profile_dir=trace)
        prof.start_trace()
        t0 = time.perf_counter()
        api.upscale_image(cfg, params, rgba, precision=precision)
        ms = (time.perf_counter() - t0) * 1e3
        prof.stop_trace()
        rows, total, idle_window, idle_span = trace_summary(trace)
        mine = sum(t for n, t, _ in rows if any(k in n for k in kernels))
        kernel = " + ".join(kernels)
        copies = sum(t for n, t, _ in rows if n.startswith(("Memcpy", "Memset")))
        print(f"[profile] {smi} | one warm 1920x1080 request alone in its trace, "
              f"api.upscale_image, {name} {precision}: {ms:.2f} ms on the host clock (traced) "
              f"| device op time {total / 1e3:.3f} ms: {kernel} {mine / 1e3:.3f} ms "
              f"({mine * 100 / total:.1f}%), copies {copies / 1e3:.3f} ms "
              f"({copies * 100 / total:.1f}%), other ops {(total - mine - copies) / 1e3:.3f} ms "
              f"in {sum(c for _, _, c in rows)} ops | device idle {idle_span * 100:.2f}% "
              f"between the upload and the readback, {idle_window * 100:.2f}% of the traced "
              f"window")

    trace = os.path.join(work, "trace_train")
    cfg_path = os.path.join(ROOT, "configs", "srcnn_9-5-5.json")
    t0 = time.perf_counter()
    rc, text, blocking = run_cli(["train", "dry", "profile", "-c", cfg_path, "-i",
                                  os.path.join(work, "samples"), "-e", "2", "--seed", "0",
                                  "--trace-dir", trace])
    secs = time.perf_counter() - t0
    check(rc == 0 and "---- op profile (device time) ----" in text,
          f"[profile] train dry profile: rc {rc}: {text[-1500:]}")
    rows, total, idle_window, idle_span = trace_summary(trace)
    stages = [STAGE_LINE.match(ln) for ln in text.splitlines()]
    print(f"[profile] {smi} | cnn_torch.py train dry profile -c configs/srcnn_9-5-5.json, 128 "
          f"pairs of 128x128, 2 epochs: rc 0 in {secs:.2f} s | device op time "
          f"{total / 1e3:.3f} ms in {sum(c for _, _, c in rows)} ops, idle "
          f"{idle_window * 100:.2f}% of the traced window, {idle_span * 100:.2f}% between its "
          f"first and last op | stages: "
          + ", ".join(f"{m.group(4)} {float(m.group(1)) * 1e3:.1f} ms" for m in stages if m)
          + f" | host-blocking warnings {blocking}")
    print("[profile]   top ops: " + "; ".join(
        f"{short(n)} x{c} {t / 1e3:.3f} ms ({t * 100 / total:.1f}%)" for n, t, c in rows[:8]))
    print(f"[profile] phase {time.perf_counter() - t_phase:.1f} s")


def record_psnr(run) -> list:
    """Run ``run()`` (rc 0 required) recording each PSNR(Y) that
    ``utils.metrics.psnr_y`` returns in it, unrounded."""
    from cnn_sr_tpu_torch.utils import metrics

    scores, real = [], metrics.psnr_y
    metrics.psnr_y = lambda a, b: scores.append(real(a, b)) or scores[-1]
    try:
        check(run() == 0, "[tools] evaluate: rc != 0")
    finally:
        metrics.psnr_y = real
    return scores


def tools_phase(smi, work) -> None:
    """[tools]: the user tools (``cnn_sr_tpu_torch.tools``) on the card.
    ``generate_training_samples --synthetic 8 -s 128 --backend torch`` on
    the card and on the CPU: the larges byte-equal, each crop's lanczos3
    degradation (``_degrade_torch``, before encoding) within 1 uint8
    between the two. ``evaluate`` with the flagship checkpoint on the
    card's 8 pairs, on the card and on the CPU (f32): every PSNR(Y) within
    0.01 dB; and on the card with ``--pallas``. ``weights_visualize`` on
    the flagship checkpoint: three sheets. ``serve_latency`` with its two
    workloads (1080p luma, 540p RGB) at ``--n-seq 5 --clients 2
    --n-per-client 3``, bf16: every request answered 200; its rows."""
    import contextlib
    import io

    from PIL import Image

    from cnn_sr_tpu_torch.tools import (evaluate, generate_training_samples, serve_latency,
                                        weights_visualize)

    t_phase = time.perf_counter()
    dirs = {dev: os.path.join(work, f"pairs_{dev}") for dev in ("cuda", "cpu")}
    for dev, d in dirs.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = generate_training_samples.main(["--synthetic", "8", "-o", d, "-s", "128",
                                                 "--backend", "torch", "--device", dev,
                                                 "--seed", "0"])
        check(rc == 0 and len(os.listdir(d)) == 16, f"[tools] generate on {dev}: rc {rc}")
        print(f"[tools] generate_training_samples --synthetic 8 -s 128 --backend torch "
              f"--device {dev}: 8 pairs in {time.perf_counter() - t0:.2f} s")
    worst, differ = 0, 0
    for i in range(8):
        with open(os.path.join(dirs["cuda"], f"sample_{i}_large.png"), "rb") as a, \
                open(os.path.join(dirs["cpu"], f"sample_{i}_large.png"), "rb") as b:
            check(a.read() == b.read(), f"[tools] sample {i}: the larges differ")
        with Image.open(os.path.join(dirs["cuda"], f"sample_{i}_large.png")) as im:
            large = im.convert("RGB")
        got = np.asarray(generate_training_samples._degrade_torch(large, 128, 2, "cuda"))
        want = np.asarray(generate_training_samples._degrade_torch(large, 128, 2, "cpu"))
        worst = max(worst, int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()))
        differ += int((got != want).sum())
    check(worst <= 1, f"[tools] torch-backend degradation card vs CPU: max diff {worst} uint8")
    print(f"[tools] the 8 crops' lanczos3 degradation before encoding, card vs CPU: max diff "
          f"{worst} uint8, {differ} of {8 * 128 * 128 * 3} bytes differ; larges byte-equal")

    line = ["-c", FLAGSHIP, "-i", dirs["cuda"]]
    scores = {}
    for key, extra in (("cuda", ["--device", "cuda"]), ("cpu", ["--device", "cpu"]),
                       ("cuda bf16", ["--device", "cuda", "--pallas"])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            scores[key] = record_psnr(lambda: evaluate.main(line + extra))
        scores[key + " s"] = time.perf_counter() - t0
        check(len(scores[key]) == 16, f"[tools] evaluate {key}: {len(scores[key])} scores")
    gap = float(np.abs(np.array(scores["cuda"]) - np.array(scores["cpu"])).max())
    check(gap <= 0.01, f"[tools] evaluate: card vs CPU PSNR(Y) max gap {gap} dB > 0.01")
    mean = {k: (float(np.mean(scores[k][0::2])), float(np.mean(scores[k][1::2])))
            for k in ("cuda", "cpu", "cuda bf16")}
    print(f"[tools] {smi} | evaluate -c configs/srcnn_9-5-5_pretrained.json on the 8 pairs: "
          f"mean PSNR(Y) bicubic {mean['cuda'][0]:.4f} dB, network f32 card "
          f"{mean['cuda'][1]:.4f} ({scores['cuda s']:.2f} s), CPU {mean['cpu'][1]:.4f} "
          f"({scores['cpu s']:.2f} s), card bf16 {mean['cuda bf16'][1]:.4f} "
          f"({scores['cuda bf16 s']:.2f} s) | card vs CPU max gap {gap:.2e} dB (gate 0.01)")

    out = os.path.join(work, "weights")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = weights_visualize.main(["-c", FLAGSHIP, "-o", out])
    check(rc == 0 and sorted(os.listdir(out)) == [f"weights{i}.png" for i in (1, 2, 3)],
          f"[tools] weights_visualize: rc {rc}")
    print("[tools] weights_visualize -c configs/srcnn_9-5-5_pretrained.json: " + "; ".join(
        ln.strip() for ln in buf.getvalue().splitlines()))

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_latency.main(["--n-seq", "5", "--clients", "2", "--n-per-client", "3"])
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    check(rc == 0 and len(rows) == 4, f"[tools] serve_latency: rc {rc}, {len(rows)} rows")
    for r in rows:
        seq = r["metric"].endswith("sequential")
        check(r["n"] == (5 if seq else 6) and r.get("failed", 0) == 0,
              f"[tools] serve_latency: a request did not answer 200: {r}")
        print(f"[tools] {smi} | serve_latency (bf16): {json.dumps(r)}")
    print(f"[tools] serve_latency in {time.perf_counter() - t0:.1f} s")
    print(f"[tools] phase {time.perf_counter() - t_phase:.1f} s")


def same_close(name, got, want, sentinel=None) -> float:
    """``got`` within 2^-7 of ``want``'s largest magnitude (the same bf16
    products in f32, summed in another order), finite, ``want`` not all
    zero, and every value of ``sentinel`` (the channels the launch does not
    own) still ``RRDB_SENTINEL``. Returns the relative error."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err, scale = float((got.float() - want).abs().max()), float(want.abs().max())
    check(scale > 0, f"{name}: the plain version is all zero")
    check(err <= BF16_REL * scale, f"{name}: err {err} > 2^-7 x output scale {scale}")
    if sentinel is not None:
        check(bool((sentinel == RRDB_SENTINEL).all()), f"{name}: wrote outside its channels")
    return err / scale


def rrdb_phase(smi, dev) -> dict:
    """[rrdb]: the SAME launches of the three wgmma kernels
    (``chain.same_forward``, ``entry.same_instances``) at the shapes of the
    benchmark's Real-ESRGAN x4plus cell (8 frames of 540x960 in, 2160x3840
    out), each held against ``reference.same_layer`` in bf16 on the card
    within 2^-7 of the output's magnitude (``same_close``): conv_first (RGB
    in 0..1 as its 0..255 levels, no activation) into the first 64 channels
    of a 192-channel buffer; the dense block's conv1-4 (channel prefixes K
    64, 96, 128, 160, LeakyReLU, each into the n = 32 slice after its
    input) and conv5 (K 192 into another buffer's first 64 channels with
    two scaled f32 residuals, its f32 copy written over the second in
    place); conv_body's residual of scale 1; a head conv (64 -> 64,
    LeakyReLU) at 2 x 2160x3840; conv_last (64 -> 3, f32 out) at 8 x
    2160x3840; the channels outside each launch's slice untouched. Then
    one bf16 ``api.upscale_batch`` of 8 540x960 frames through x4plus (the
    benchmark's seeded init) with the counters set to 0 just before: 351
    SAME launches, 70 with residuals, first 1 / wgmma 349 / last 1; the
    answers (8, 2160, 3840, 3) uint8; the first frame against the plain bf16
    schedule on the card (``rrdb``'s plain version) within the cell's
    limits (mean gap 1.5 levels, widest 16, share off by two or more 0.1).
    Returns the forward's launches of each kernel."""
    from benchmark.inits import rrdbnet_basicsr
    from cnn_sr_tpu_torch.ops.fused import rrdb
    from cnn_sr_tpu_torch.utils.config import parse_config

    lib = build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(SEED + 29)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)
    n, h, w = 8, 540, 960

    def rand(*shape, normal=False):  # seeded, made on the card
        make = torch.randn if normal else torch.rand
        return make(shape, generator=gen, device=dev)

    def weights(f, k, nn):
        return (torch.from_numpy((rng.standard_normal((f, f, k, nn)) * (2 / (f * f * k)) ** 0.5)
                                 .astype(np.float32)).to(dev),
                torch.from_numpy((rng.standard_normal(nn) * 0.05).astype(np.float32)).to(dev))

    def launch(src, k, wt, bt, dst, c0, lrelu=False, residuals=(), out32=None, first=False,
               last=False):
        plan = entry.bf16_layer_plan(3, k, wt.shape[3], first=first, last=last)
        wp, bp = (entry.pack_last(wt, bt, plan) if last
                  else entry.pack_bf16(wt, bt, first, 255 if first else 127))
        chain.same_forward(lib, src, k, wp, bp, dst, c0, plan, lrelu, residuals, out32, stream)

    errs = {}
    reset_counts()
    x = torch.floor(rand(n, h, w, 3) * 256.0) / 255.0  # each value a 0..255 level
    buf = torch.full((n, h, w, 192), RRDB_SENTINEL, dtype=torch.bfloat16, device=dev)
    wt, bt = weights(3, 3, 64)
    launch(x, 3, wt, bt, buf, 0, first=True)
    want, _ = reference.same_layer(x, wt, bt, False, first=True)
    errs["conv_first 3->64"] = same_close("conv_first", buf[..., :64], want, buf[..., 64:])
    del x, want
    for i, k in enumerate((64, 96, 128, 160)):
        wt, bt = weights(3, k, 32)
        launch(buf, k, wt, bt, buf, k, lrelu=True)
        want, _ = reference.same_layer(buf[..., :k].float(), wt, bt, True)
        errs[f"conv{i + 1} {k}->32"] = same_close(f"conv{i + 1}", buf[..., k:k + 32], want,
                                                  buf[..., k + 32:])
        del want
    r0, r1 = rand(n, h, w, 64, normal=True), rand(n, h, w, 64, normal=True)
    wt, bt = weights(3, 192, 64)
    want, want32 = reference.same_layer(buf.float(), wt, bt, False, [(r0, 0.2), (r1, 0.2)])
    out = torch.full((n, h, w, 192), RRDB_SENTINEL, dtype=torch.bfloat16, device=dev)
    launch(buf, 192, wt, bt, out, 0, residuals=[(r0, 0.2), (r1, 0.2)], out32=r1)
    errs["conv5 192->64, two residuals"] = same_close("conv5", out[..., :64], want, out[..., 64:])
    errs["conv5's f32 copy"] = same_close("conv5 f32 copy", r1, want32)
    del want, want32, r1
    wt, bt = weights(3, 64, 64)
    out.fill_(RRDB_SENTINEL)
    launch(buf, 64, wt, bt, out, 0, residuals=[(r0, 1.0)])
    want, _ = reference.same_layer(buf[..., :64].float(), wt, bt, False, [(r0, 1.0)])
    errs["conv_body 64->64, residual"] = same_close("conv_body", out[..., :64], want,
                                                    out[..., 64:])
    del buf, out, r0, want
    hr = rand(2, 4 * h, 4 * w, 64).to(torch.bfloat16)
    y = torch.empty_like(hr)
    launch(hr, 64, wt, bt, y, 0, lrelu=True)
    want, _ = reference.same_layer(hr.float(), wt, bt, True)
    errs["head 64->64 at 2160x3840"] = same_close("head conv", y, want)
    del hr, y, want
    hr = rand(n, 4 * h, 4 * w, 64).to(torch.bfloat16)
    wt, bt = weights(3, 64, 3)
    y = torch.empty((n, 4 * h, 4 * w, 3), dtype=torch.float32, device=dev)
    launch(hr, 64, wt, bt, y, 0, last=True)
    want, _ = reference.same_layer(hr.float(), wt, bt, False, last=True)
    errs["conv_last 64->3 at 2160x3840"] = same_close("conv_last", y, want)
    del hr, y, want
    torch.cuda.synchronize()
    seen = (chain.LAUNCHES_SAME, chain.LAUNCHES_RESIDUAL, chain.LAUNCHES_FIRST,
            chain.LAUNCHES_WGMMA, chain.LAUNCHES_LAST)
    check(seen == (9, 2, 1, 7, 1), f"the SAME launches (same, residual, first, wgmma, last) "
          f"{seen}, expected (9, 2, 1, 7, 1)")
    print(f"[rrdb] {smi} | SAME launches against reference.same_layer (bf16), 8 x 540x960 in: "
          + ", ".join(f"{k} rel {v:.3e}" for k, v in errs.items()))
    torch.cuda.empty_cache()

    cfg = parse_config({"arch": "rrdbnet", "channels": 3, "scale": 4, "num_feat": 64,
                        "num_grow_ch": 32, "num_block": 23})
    params = [{"w": torch.from_numpy(wa).to(dev), "b": torch.from_numpy(ba).to(dev)}
              for wa, ba in rrdbnet_basicsr.make(cfg.layers(), SEED + 29)]
    rgbas = np.stack([make_image(h, w, SEED + 30 + i) for i in range(n)])
    api.upscale_batch(cfg, params, rgbas[:1, :64, :64], "bf16")  # builds the packed weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    got = api.upscale_batch(cfg, params, rgbas, "bf16")
    ms = (time.perf_counter() - t0) * 1e3
    made = {"same": chain.LAUNCHES_SAME, "residual": chain.LAUNCHES_RESIDUAL,
            "first": chain.LAUNCHES_FIRST, "wgmma": chain.LAUNCHES_WGMMA,
            "last": chain.LAUNCHES_LAST, "bf16": chain.LAUNCHES_BF16,
            "other": entry.LAUNCHES + chain.LAUNCHES + entry.LAUNCHES_BF16}
    check(made == {"same": 351, "residual": 70, "first": 1, "wgmma": 349, "last": 1,
                   "bf16": 351, "other": 0}, f"x4plus forward: launches {made}")
    check(got.shape == (n, 4 * h, 4 * w, 3) and got.dtype == np.uint8,
          f"x4plus: answers {got.shape} {got.dtype}")
    peak = torch.cuda.max_memory_allocated()
    x = torch.from_numpy(rgbas[:1, ..., :3].astype(np.float32) / 255.0).to(dev)
    plain = rrdb._schedule(rrdb._plain_conv(params, "bf16"), rrdb._plain_alloc(x), x,
                           rrdb.layout(params))
    plain = torch.round(torch.clamp(plain, 0.0, 1.0) * 255.0).to(torch.uint8)[0].cpu().numpy()
    gap = np.abs(got[0].astype(np.int16) - plain.astype(np.int16))
    mean_gap, max_gap, over_1 = float(gap.mean()), int(gap.max()), float((gap >= 2).mean())
    check(mean_gap <= 1.5 and max_gap <= 16 and over_1 <= 0.1,
          f"x4plus vs the plain bf16 schedule: mean {mean_gap}, max {max_gap}, "
          f"share off by 2 or more {over_1}")
    inside = float(((got > 0) & (got < 255)).mean())
    print(f"[rrdb] {smi} | x4plus bf16 upscale_batch 8 x 540x960 -> 2160x3840: {ms:.1f} ms "
          f"({n * 16 * h * w / ms / 1e3:.1f} MPix/s out, first call after a warm-up), "
          f"peak device memory {peak / 2**30:.2f} GiB | launches {made} | frame 0 vs the plain "
          f"bf16 schedule: mean {mean_gap:.4f}, max {max_gap}, share off by 2 or more "
          f"{over_1:.3e} | values inside 1..254 {inside:.3f}")
    del params, got, x, plain
    torch.cuda.empty_cache()
    return made


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(sys.argv[2:])
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
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
    if info["logs"]:
        report = build.ptxas_entry(info["logs"]["fused_srcnn.cu"], "fused_srcnn_kernel")
        check(report is not None, "fused_srcnn_kernel: no ptxas report")
        print(f"[build] fused_srcnn_kernel (f32, ffma_stage.cuh): {report[0]} registers, "
              f"{report[1]}")
        check(" 0 bytes spill stores, 0 bytes spill loads" in report[1],
              f"fused_srcnn_kernel spills: {report[1]}")
        chain_kernels = build.ptxas_entries(info["logs"]["conv_layer.cu"], "conv_layer_kernel")
        check(len(chain_kernels) == 15, f"conv_layer_kernel: {len(chain_kernels)} f32 instances "
              "in the ptxas report, expected 15 (3 width classes x 5 f)")
        print("[build] conv_layer_kernel (f32, ffma_stage.cuh), registers of each instance: "
              + ", ".join(f"{name} {regs}" for name, regs, _ in chain_kernels))
        for name, _, spill in chain_kernels:
            check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
                  f"conv_layer_kernel {name} spills: {spill}")
        for src, key, expected, what in (
                ("winograd.cu", "winograd_", 8, "3 modes x 2 NB, 2 transforms"),
                ("wino5.cu", "wino5_", 4, "3 quad modes, w55f")):
            kernels = build.ptxas_entries(info["logs"][src], key)
            check(len(kernels) == expected, f"{src}: {len(kernels)} kernel instances in the "
                  f"ptxas report, expected {expected} ({what})")
            print(f"[build] {src} (tensor cores), registers and spills of each instance: "
                  + ", ".join(f"{name} {regs} ({spill})" for name, regs, spill in kernels))
            for name, _, spill in kernels:
                check(" 0 bytes spill stores, 0 bytes spill loads" in spill,
                      f"{src} {name} spills: {spill}")
        rowpair_build(info["logs"]["rowpair.cu"])
        first_build(info["logs"]["conv_first_wgmma.cu"])
        wgmma_build(info["logs"]["conv_wgmma.cu"])
        last_build(info["logs"]["conv_last_wgmma.cu"])
        fused_wgmma_build(info["logs"]["fused_wgmma.cu"])
        xpack_build(info["logs"]["xpack.cu"])
    build.load_library()
    hmma, hgmma = sass_hmma()
    print("[build] HMMA instructions in the SASS (cuobjdump -sass): "
          + ", ".join(f"{k} {v}" for k, v in hmma.items()))
    print("[build] HGMMA (wgmma) instructions in the SASS: "
          + ", ".join(f"{k} {v}" for k, v in hgmma.items()))
    for k, v in hmma.items():
        check(v > 0, f"{k}: no HMMA in its kernels' SASS")
    for k, v in hgmma.items():
        check(v > 0, f"{k}: no HGMMA in its kernels' SASS")
    descriptor_check(smi, dev)

    cfg = read_config(FLAGSHIP)
    params = params_to_torch(init_params(cfg)[0], dev)
    cfg915 = read_config(C915)
    params915 = params_to_torch(
        random_parameters(cfg915.layer_specs(), cfg915.distributions, seed=0), dev)
    cfg_rgb = read_config(RGB7)
    check(cfg_rgb.channels == 3 and len(cfg_rgb.layer_specs()) == 7, "RGB config")
    params_rgb = params_to_torch(init_params(cfg_rgb)[0], dev)
    rng = np.random.default_rng(SEED)

    def he(specs):
        return [{"w": torch.from_numpy((rng.standard_normal((f, f, k, n))
                                        * (2 / (f * f * k)) ** 0.5).astype(np.float32)).to(dev),
                 "b": torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32)).to(dev)}
                for f, k, n in specs]

    # the wide 9-5-5 (n1 = 128, n2 = 64) does not fit the fused kernel's f32 tiles
    wide = he([(9, 1, 128), (5, 128, 64), (5, 64, 1)])
    # an f=9 layer over 128 channels: its whole window (294,912 f32 bytes)
    # exceeds a block's shared memory, so both chains stream it in chunks
    wide_f9 = he([(3, 1, 128), (9, 128, 16), (3, 16, 8), (3, 8, 1)])
    # two middle layers on the wgmma stage: 64 -> 256 (two 128-column
    # chunks) and an f=9 layer over 256 channels (four 64-lane chunks)
    wide_n256 = he([(3, 1, 64), (3, 64, 256), (9, 256, 128), (3, 128, 1)])
    # a last layer of even f: the last-layer kernel takes any f up to 63
    even_last = he([(3, 3, 32), (3, 32, 32), (3, 32, 32), (4, 32, 1)])
    # a first layer on the widest branch of its plan: f = 9 over 4 channels
    # into 256 (four chunks of N, one slab a warpgroup, W streamed)
    wide_first = he([(9, 4, 256), (3, 256, 32), (3, 32, 1)])

    fused_errs = [
        kernel_vs_plain("flagship 9-5-5", params, (1, 80, 272, 1), SEED,
                        (1, 0, 0, 0, 0, 0, 0)),
        kernel_vs_plain("flagship 9-5-5 ragged", params, (2, 97, 131, 1), SEED + 1,
                        (1, 0, 0, 0, 0, 0, 0)),
        kernel_vs_plain("9-1-5", params915, (1, 80, 272, 1), SEED + 2,
                        (1, 0, 0, 0, 0, 0, 0))]
    chain_errs = [
        kernel_vs_plain("chain RGB 7-layer", params_rgb, (1, 80, 272, 3), SEED + 3,
                        (0, 7, 0, 0, 0, 0, 0)),
        kernel_vs_plain("chain RGB 7-layer ragged", params_rgb, (2, 97, 131, 3), SEED + 4,
                        (0, 7, 0, 0, 0, 0, 0)),
        kernel_vs_plain("chain wide 9-5-5", wide, (1, 80, 272, 1), SEED + 5,
                        (0, 3, 0, 0, 0, 0, 0)),
        kernel_vs_plain("chain f=9 over 128 channels, 4-layer", wide_f9, (1, 80, 272, 1),
                        SEED + 6, (0, 4, 0, 0, 0, 0, 0))]
    fused_bf16_errs = [
        kernel_vs_plain("flagship 9-5-5", params, (1, 80, 272, 1), SEED, (0, 0, 1, 0, 0, 0, 0),
                        "bf16"),
        kernel_vs_plain("flagship 9-5-5 ragged", params, (2, 97, 131, 1), SEED + 1,
                        (0, 0, 1, 0, 0, 0, 0), "bf16"),
        kernel_vs_plain("9-1-5", params915, (1, 80, 272, 1), SEED + 2, (0, 0, 1, 0, 0, 0, 0),
                        "bf16"),
        kernel_vs_plain("narrow 9-5-5 (n = 8)", he([(9, 1, 8), (5, 8, 8), (5, 8, 1)]),
                        (3, 45, 70, 1), SEED + 8, (0, 0, 1, 0, 0, 0, 0), "bf16"),
        kernel_vs_plain("RGB 3-layer", he([(3, 3, 16), (3, 16, 8), (3, 8, 3)]), (2, 50, 77, 3),
                        SEED + 9, (0, 0, 1, 0, 0, 0, 0), "bf16")]
    chain_bf16_errs = [
        kernel_vs_plain("chain RGB 7-layer", params_rgb, (1, 80, 272, 3), SEED + 3,
                        (0, 0, 0, 7, 1, 5, 1), "bf16"),
        kernel_vs_plain("chain RGB 7-layer ragged", params_rgb, (2, 97, 131, 3), SEED + 4,
                        (0, 0, 0, 7, 1, 5, 1), "bf16", span=1.3),
        kernel_vs_plain("chain f=9 over 128 channels, 4-layer", wide_f9, (1, 80, 272, 1),
                        SEED + 6, (0, 0, 0, 4, 1, 2, 1), "bf16"),
        kernel_vs_plain("chain n=256 and f=9 over 256 channels, 4-layer", wide_n256,
                        (2, 61, 83, 1), SEED + 7, (0, 0, 0, 4, 1, 2, 1), "bf16"),
        kernel_vs_plain("chain f=4 last layer, 4-layer", even_last, (2, 45, 77, 3), SEED + 10,
                        (0, 0, 0, 4, 1, 2, 1), "bf16"),
        kernel_vs_plain("chain f=9 4->256 first layer, 3-layer", wide_first, (2, 40, 90, 4),
                        SEED + 11, (0, 0, 0, 3, 1, 1, 1), "bf16", span=1.3)]

    # the main paths: three requests each through the public API in f32,
    # and one round of the server in bf16
    flagship_counts, rgba = main_path(
        "flagship 9-5-5", cfg, params,
        lambda img: api._upscale_luma(lambda x: reference.fused_forward(params, x), img,
                                      add_mean=cfg.zero_mean_target,
                                      squared_mean=cfg.subtract_squared_mean),
        (1, 0, 0, 0, 0, 0, 0), smi)
    rgb_counts, _ = main_path(
        "RGB 7-layer", cfg_rgb, params_rgb,
        lambda img: api._upscale_rgb(lambda x: reference.fused_forward(params_rgb, x), img,
                                     add_mean=cfg_rgb.zero_mean_target),
        (0, 7, 0, 0, 0, 0, 0), smi)
    serve_counts = serve_path(cfg, params, cfg_rgb, params_rgb, smi)
    # single bf16 requests of both checkpoints, beside the f32 ones
    main_path("flagship 9-5-5", cfg, params,
              lambda img: api._upscale_luma(
                  lambda x: reference.fused_forward(params, x, "bf16"), img,
                  add_mean=cfg.zero_mean_target, squared_mean=cfg.subtract_squared_mean),
              (0, 0, 1, 0, 0, 0, 0), smi, "bf16")
    main_path("RGB 7-layer", cfg_rgb, params_rgb,
              lambda img: api._upscale_rgb(
                  lambda x: reference.fused_forward(params_rgb, x, "bf16"), img,
                  add_mean=cfg_rgb.zero_mean_target),
              (0, 0, 0, 7, 1, 5, 1), smi, "bf16", tol=2)
    # Real-ESRGAN x4plus: the SAME launches at its cell's shapes, then a batch
    same_counts = rrdb_phase(smi, dev)

    # each kernel at its main path's 1080p input
    from cnn_sr_tpu_torch.ops.color import extract_luma, subtract_mean

    img = torch.from_numpy(rgba).to(dev)
    x_luma = subtract_mean(extract_luma(img))[0][None, ..., None].contiguous()
    rgb = img[..., :3].to(torch.float32) / 255.0
    x_rgb = (rgb - rgb.mean(dim=(0, 1), keepdim=True))[None].contiguous()
    t_fused = time_stack("fused_srcnn, flagship 9-5-5", params, x_luma, smi)
    t_chain = time_stack("conv_layer chain, RGB 7-layer", params_rgb, x_rgb, smi)
    layer_times(params_rgb, x_rgb, smi)
    t_fused_bf16 = time_stack("fused_srcnn, flagship 9-5-5", params, x_luma, smi, "bf16")
    t_chain_bf16 = time_stack("conv_layer chain, RGB 7-layer", params_rgb, x_rgb, smi, "bf16")
    t_layers = layer_times(params_rgb, x_rgb, smi, "bf16")
    fused_vs_chain(params, x_luma, smi, "f32")
    fused_vs_chain(params, x_luma, smi, "bf16")
    # the 9-1-5 stack (random, seed 0) beside its library time, both precisions
    for precision in ("f32", "bf16"):
        time_stack("fused_srcnn, 9-1-5", params915, x_luma, smi, precision)
    io_phase(smi)
    work = tempfile.mkdtemp(dir=build.BUILD_DIR)
    try:
        train_data = train_phase(smi, dev, work)
        parallel_counts = parallel_phase(smi, dev, cfg, params, cfg_rgb, params_rgb,
                                         train_data)
        profile_phase(smi, work)
        tools_phase(smi, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    probe_rows = probe_phase(smi)
    fused_errs.append(t_fused["err"])
    chain_errs.append(t_chain["err"])
    fused_bf16_errs.append(t_fused_bf16["err"])
    chain_bf16_errs += [t_chain_bf16["err"], t_layers["first"]["err"]]
    rgb_bf16 = parallel_counts["RGB bf16"]

    def row(name, source, replaces, launches, errs, t, parallel=None, same=None):
        check(launches > 0, f"{name}: no launch on its main path")
        extra = {} if parallel is None else {"parallel_launches": parallel}
        if same is not None:
            extra["same_launches"] = same
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **extra, "max_abs_err": max(errs), "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                **{k: t[k] for k in ("mode_ms", "graph_ms", "library_graph_ms", "share")
                   if k in t}}

    print(json.dumps({"kernels": [
        row("fused_srcnn", "cnn_sr_tpu_torch/csrc/fused_srcnn.cu",
            "cnn_sr_tpu/ops/pallas_fused/kernel.py:38", flagship_counts[0], fused_errs,
            t_fused, parallel_counts["flagship f32"][0]),
        row("conv_layer", "cnn_sr_tpu_torch/csrc/conv_layer.cu",
            "cnn_sr_tpu/ops/pallas_fused/kernel.py:499", rgb_counts[1], chain_errs,
            t_chain, parallel_counts["RGB f32"][1]),
        row("fused_srcnn_bf16", "cnn_sr_tpu_torch/csrc/fused_wgmma.cu",
            "cnn_sr_tpu/ops/pallas_fused/kernel.py:730", serve_counts[2], fused_bf16_errs,
            t_fused_bf16, parallel_counts["flagship bf16"][2]),
        # the first layer (RGB L1 at 1080p: ms, plain (tap_layer), library
        # (cuDNN bf16) and bound) and its launches
        row("conv_first_wgmma", "cnn_sr_tpu_torch/csrc/conv_first_wgmma.cu",
            "cnn_sr_tpu/ops/pallas_fused/plane.py:23", serve_counts[4], chain_bf16_errs,
            t_layers["first"], rgb_bf16[4], same_counts["first"]),
        # every middle layer: RGB L2 + L3 + L4 + L5 + L6 at 1080p, ms, plain
        # (tap_layer), library (cuDNN bf16) and bound summed over the five
        row("conv_layer_wgmma", "cnn_sr_tpu_torch/csrc/conv_wgmma.cu",
            "cnn_sr_tpu/ops/pallas_fused/kernel.py:499", serve_counts[5],
            [t_layers["wgmma"]["err"]], t_layers["wgmma"], rgb_bf16[5], same_counts["wgmma"]),
        # the last layer: RGB L7 at 1080p
        row("conv_last_wgmma", "cnn_sr_tpu_torch/csrc/conv_last_wgmma.cu",
            "cnn_sr_tpu/ops/pallas_fused/kernel.py:585", serve_counts[6],
            [t_layers["last"]["err"]], t_layers["last"], rgb_bf16[6], same_counts["last"]),
        *(row(r["name"], r["source"], r["replaces"], r["launches"], [r["err"]], r)
          for r in probe_rows),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
