"""The layer chain: ``csrc/conv_layer.cu``, one launch per layer.

The route ``entry.fused_forward`` takes on the card for every well-formed
stack outside the fused kernel's envelope (the 7-layer RGB model first).
``entry`` checks the shapes and plans each layer (``entry.layer_plan``);
``chain_forward`` allocates two intermediates, ping-pongs the layers
through them and writes the last layer into a fresh output. Its plain
version is ``reference.fused_forward``, the same as the fused kernel's.
"""

from __future__ import annotations

import math

import torch

# layer launches in this process, one per layer of each stack; the smoke
# run reads it to show that the main path went through the kernel
LAUNCHES = 0


def chain_forward(params, x: torch.Tensor, plans) -> torch.Tensor:
    """Run ``params`` over the CUDA tensor ``x`` (N, H, W, C), layer i
    with ``plans[i]`` (an ``entry.LayerPlan``), on the current stream.
    The shapes are the caller's to check (``entry.fused_forward``)."""
    global LAUNCHES
    if not x.is_cuda:
        raise NotImplementedError(f"conv_layer.cu runs on CUDA tensors, not {x.device}")
    from .build import load_library

    lib = load_library()
    n, h, w, _ = x.shape
    shapes = []
    for layer in params:
        f, _, _, c = layer["w"].shape
        h, w = h - f + 1, w - f + 1
        shapes.append((n, h, w, c))
    last = len(params) - 1
    # layer i < last writes bufs[i % 2]; each buffer holds the largest
    # activation it will carry
    bufs = [torch.empty(max((math.prod(s) for s in shapes[p:last:2]), default=0),
                        dtype=torch.float32, device=x.device) for p in (0, 1)]
    y = torch.empty(shapes[last], dtype=torch.float32, device=x.device)
    src = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, (layer, shape, plan) in enumerate(zip(params, shapes, plans)):
            dst = y if i == last else bufs[i % 2][:math.prod(shape)].view(shape)
            f, _, k, c = layer["w"].shape
            err = lib.conv_layer_forward(
                src.data_ptr(), layer["w"].data_ptr(), layer["b"].data_ptr(),
                dst.data_ptr(), n, src.shape[1], src.shape[2], k, f, c, int(i != last),
                plan.tile_h, plan.tile_w, plan.chunk, plan.smem, stream)
            if err:
                raise RuntimeError(f"conv_layer launch failed at layer {i + 1}: "
                                   + lib.cnn_sr_error_string(err).decode())
            LAUNCHES += 1
            src = dst
    return y
