"""The layer chain: ``csrc/conv_layer.cu``, one launch per layer.

The route ``entry.fused_forward`` takes on the card for every well-formed
stack outside the fused kernel's envelope (the 7-layer RGB model first).
``entry`` checks the shapes and plans each layer (``entry.layer_plan``
in f32, ``entry.bf16_layer_plan`` in bf16); ``chain_forward`` allocates two
intermediates, ping-pongs the layers through them and writes the last
layer into a fresh f32 output. In f32 (on the CUDA cores,
``csrc/ffma_stage.cuh``) each layer's weights are packed channel-major at
its plan's NB (``entry.f32_weights``) and its input window streams
through shared memory beside them, a chunk of input channels at a time.
In bf16 (on the tensor cores) the intermediates are bf16, the weights
packed tap-major (``entry.bf16_weights``), the first layer quantises the
f32 input at its window load and the last writes f32; each layer's plan
(``entry.bf16_layer_plan``) names its stage: ``csrc/conv_wgmma.cu``
(``conv_layer_forward_wgmma``) for a middle layer at n > 64, else
``csrc/tc_stage.cuh`` (``conv_layer_forward_bf16``). Its plain version
is ``reference.fused_forward``, the same as the fused kernel's;
``reference.tap_layer`` is the plain version of one bf16 launch.
"""

from __future__ import annotations

import math

import torch

# layer launches in this process, one per layer of each stack, in f32
# (``LAUNCHES``) and in bf16 (``LAUNCHES_BF16``), and of the bf16 ones
# those of the wgmma stage (``LAUNCHES_WGMMA``); the smoke run reads them
# to show that the main path went through the kernels
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_WGMMA = 0


def layer_forward(lib, src: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  dst: torch.Tensor, plan, first: bool, last: bool, bf16: bool,
                  stream: int) -> None:
    """Launch one layer of ``src`` (N, H, W, K) into ``dst`` (N, H', W', n)
    on ``stream``. f32: ``w`` and ``b`` from ``entry.pack_f32`` at
    ``plan.nb``, ``plan`` an ``entry.LayerPlan``, ReLU unless ``last``.
    bf16: ``w`` and ``b`` from ``entry.pack_bf16``,
    ``plan`` an ``entry.TcPlan`` or ``entry.WgmmaPlan`` (a middle layer at n
    > 64, whose tensor maps need 16-byte aligned tensors: raises
    ValueError otherwise), ``src`` f32 when ``first`` else bf16,
    ``dst`` f32 when ``last`` else bf16, ReLU unless ``last``."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_WGMMA
    from .entry import WgmmaPlan

    n, h, wd, k = src.shape
    args = (src.data_ptr(), w.data_ptr(), b.data_ptr(), dst.data_ptr(), n, h, wd, k)
    wgmma = bf16 and isinstance(plan, WgmmaPlan)
    if wgmma:
        if any(t.data_ptr() % 16 for t in (src, w, b, dst)):
            raise ValueError("the wgmma stage's tensor copies need 16-byte aligned tensors")
        err = lib.conv_layer_forward_wgmma(*args, plan.f, dst.shape[3], plan.smem, stream)
    elif bf16:
        err = lib.conv_layer_forward_bf16(*args, plan.f, dst.shape[3], int(first), int(last),
                                          plan.kc, plan.tps, plan.smem, stream)
    else:
        f = src.shape[1] - dst.shape[1] + 1
        err = lib.conv_layer_forward(*args, f, dst.shape[3], int(not last), plan.tile_h,
                                     plan.tile_w, plan.kc, plan.smem, stream)
    if err:
        raise RuntimeError(f"conv_layer{'_wgmma' if wgmma else '_bf16' if bf16 else ''} "
                           "launch failed: " + lib.cnn_sr_error_string(err).decode())
    if bf16:
        LAUNCHES_BF16 += 1
        LAUNCHES_WGMMA += int(wgmma)
    else:
        LAUNCHES += 1


def chain_forward(params, x: torch.Tensor, plans, bf16: bool = False) -> torch.Tensor:
    """Run ``params`` over the CUDA tensor ``x`` (N, H, W, C), layer i
    with ``plans[i]`` (``entry.LayerPlan`` or, in bf16, ``entry.TcPlan`` or
    ``entry.WgmmaPlan``),
    on the current stream, in
    f32 or, with ``bf16``, as the bf16 stream. The shapes are the caller's
    to check (``entry.fused_forward``)."""
    if not x.is_cuda:
        raise NotImplementedError(f"conv_layer.cu runs on CUDA tensors, not {x.device}")
    from .build import load_library
    from .entry import bf16_weights, f32_weights

    lib = load_library()
    operands = bf16_weights(params) if bf16 else f32_weights(params, [p.nb for p in plans])
    n, h, w, _ = x.shape
    shapes = []
    for layer in params:
        f, _, _, c = layer["w"].shape
        h, w = h - f + 1, w - f + 1
        shapes.append((n, h, w, c))
    last = len(params) - 1
    # layer i < last writes bufs[i % 2]; each buffer holds the largest
    # activation it will carry
    mid = torch.bfloat16 if bf16 else torch.float32
    bufs = [torch.empty(max((math.prod(s) for s in shapes[p:last:2]), default=0),
                        dtype=mid, device=x.device) for p in (0, 1)]
    y = torch.empty(shapes[last], dtype=torch.float32, device=x.device)
    src = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, ((wt, bt), shape, plan) in enumerate(zip(operands, shapes, plans)):
            dst = y if i == last else bufs[i % 2][:math.prod(shape)].view(shape)
            layer_forward(lib, src, wt, bt, dst, plan, i == 0, i == last, bf16, stream)
            src = dst
    return y
