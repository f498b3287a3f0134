"""``fused_forward``: the whole SRCNN conv stack in one kernel launch.

Counterpart of ``cnn_sr_tpu/ops/pallas_fused/entry.py:fused_forward``.
A CPU tensor takes the plain version (``reference.fused_forward``); a
CUDA tensor always takes the hand-written kernel in
``csrc/fused_srcnn.cu``, or raises. There is no fallback from one to the
other.
"""

from __future__ import annotations

import torch

from . import reference

# kernel launches in this process; the smoke run reads it to show that the
# main path went through the kernel
LAUNCHES = 0

TILE_H = TILE_W = 16
SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt into on sm_90
_ROADMAP = "ROADMAP.md Queue 2"


def tile_bytes(c: int, dims) -> int:
    """Shared bytes of one block's activations: the input window with its
    halo, the conv1 tile and the conv2 tile, f32. ``dims`` is ((f, n) per
    layer)."""
    (f1, n1), (f2, n2), (f3, _) = dims
    a2 = (TILE_H + f3 - 1, TILE_W + f3 - 1)
    a1 = (a2[0] + f2 - 1, a2[1] + f2 - 1)
    win = (a1[0] + f1 - 1, a1[1] + f1 - 1)
    return 4 * (c * win[0] * win[1] + n1 * a1[0] * a1[1] + n2 * a2[0] * a2[1])


def smem_plan(c: int, layers):
    """``(weight_chunk_floats, total_bytes)`` for ``layers`` = ((f, k, n),
    ...): the shared memory left beside the tiles, up to the block limit,
    holds the weights a chunk of input channels at a time (the whole layer
    where it fits). Raises NotImplementedError when not even one input
    channel's weights of a layer fit."""
    tiles = tile_bytes(c, [(f, n) for f, _, n in layers])
    need = max(f * f * n for f, _, n in layers)  # one input channel
    full = max(f * f * k * n for f, k, n in layers)
    chunk = min((SMEM_LIMIT - tiles) // 16 * 4, -(-full // 4) * 4)
    if chunk < need:
        raise NotImplementedError(
            f"a {TILE_H}x{TILE_W} tile of this stack needs {tiles} shared "
            f"bytes plus {4 * need} for weights (> {SMEM_LIMIT}); wide "
            f"stacks need the tensor-core kernel ({_ROADMAP} #1)")
    return chunk, tiles + 4 * chunk


def _check(params, x):
    """Raise ValueError for malformed input and NotImplementedError for a
    well-formed stack outside the kernel's envelope, on every device, so
    the CPU and CUDA paths take the same stacks. Returns the kernel's
    shared-memory plan."""
    if x.dim() != 4 or x.shape[0] == 0:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    tensors = [x] + [t for layer in params for t in (layer["w"], layer["b"])]
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_forward takes contiguous float32 tensors on "
                             f"one device; got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")
    k = x.shape[3]
    for i, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        if (w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != k
                or tuple(b.shape) != (w.shape[3],)):
            raise ValueError(f"layer {i + 1}: weights {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not chain from {k} channels")
        k = w.shape[3]
    shrink = sum(layer["w"].shape[0] - 1 for layer in params)
    if x.shape[1] <= shrink or x.shape[2] <= shrink:
        raise ValueError(f"input {x.shape[2]}x{x.shape[1]} is not larger than "
                         f"the stack's receptive field ({shrink}+1 px)")
    if len(params) != 3:
        raise NotImplementedError(
            f"the CUDA kernel runs 3-layer stacks; {len(params)} layers need "
            f"the L-layer chain ({_ROADMAP} #4)")
    if x.shape[3] > 4 or k > 4:
        raise NotImplementedError(
            f"the CUDA kernel takes c_in <= 4 and n_out <= 4; got "
            f"c_in={x.shape[3]}, n_out={k} ({_ROADMAP} #4)")
    if x.shape[0] > 65535:
        raise NotImplementedError("more than 65535 images in one launch")
    return smem_plan(x.shape[3], [tuple(l["w"].shape[1:]) for l in params])


def fused_forward(params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) f32 → (N, H−s, W−s, n_out) f32, s = Σ(f−1): ReLU on
    every layer but the last. ``params`` is ``[{"w": (f, f, k, n),
    "b": (n,)}, ...]`` (HWIO), on the same device as ``x``."""
    global LAUNCHES
    chunk, smem = _check(params, x)
    if x.device.type == "cpu":
        return reference.fused_forward(params, x)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    dims = [(layer["w"].shape[0], layer["w"].shape[3]) for layer in params]
    n, h, w, c = x.shape
    from .build import load_library

    lib = load_library()
    shrink = sum(f - 1 for f, _ in dims)
    y = torch.empty((n, h - shrink, w - shrink, dims[2][1]),
                    dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr()]
    for layer in params:
        ptrs += [layer["w"].data_ptr(), layer["b"].data_ptr()]
    (f1, n1), (f2, n2), (f3, n3) = dims
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_srcnn_forward(
            *ptrs, y.data_ptr(), n, h, w, c, f1, n1, f2, n2, f3, n3,
            TILE_H, TILE_W, chunk, smem, stream)
    if err:
        raise RuntimeError("fused_srcnn launch failed: "
                           + lib.fused_srcnn_error_string(err).decode())
    LAUNCHES += 1
    return y
