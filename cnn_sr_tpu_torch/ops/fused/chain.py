"""The layer chain: one launch per layer.

The route ``entry.fused_forward`` takes on the card for every well-formed
stack outside the fused kernel's envelope (the 7-layer RGB model first).
``entry`` checks the shapes and plans each layer (``entry.layer_plan``
in f32, ``entry.bf16_layer_plan`` in bf16); ``chain_forward`` allocates two
intermediates, ping-pongs the layers through them and writes the last
layer into a fresh f32 output. In f32 (``csrc/conv_layer.cu`` on the CUDA cores,
``csrc/ffma_stage.cuh``) each layer's weights are packed channel-major at
its plan's NB (``entry.f32_weights``) and its input window streams
through shared memory beside them, a chunk of input channels at a time.
In bf16 (on the tensor cores) the intermediates are bf16, the weights
packed as each layer's stage takes them (``entry.chain_bf16_weights``), the
first layer quantises the f32 input in shared memory and the last writes
f32; each layer's plan (``entry.bf16_layer_plan``) names its kernel:
``csrc/conv_first_wgmma.cu`` (``conv_first_forward_wgmma``) for the first,
``csrc/conv_wgmma.cu`` (``conv_layer_forward_wgmma``) for every middle
layer and ``csrc/conv_last_wgmma.cu`` (``conv_last_forward_wgmma``) for the
last. Its plain version
is ``reference.fused_forward``, the same as the fused kernel's;
``reference.tap_layer`` is the plain version of one bf16 launch.
"""

from __future__ import annotations

import math

import torch

# layer launches in this process, one per layer of each stack, in f32
# (``LAUNCHES``) and in bf16 (``LAUNCHES_BF16``), and of the bf16 ones
# those of the first-layer kernel (``LAUNCHES_FIRST``), of the wgmma stage
# (``LAUNCHES_WGMMA``) and of the last-layer kernel (``LAUNCHES_LAST``); the
# smoke run reads them to show that the main path went through the kernels;
# of the bf16 ones those of a SAME model (``LAUNCHES_SAME``, ``same_forward``)
# and of them those with a residual epilogue (``LAUNCHES_RESIDUAL``)
LAUNCHES = 0
LAUNCHES_BF16 = 0
LAUNCHES_FIRST = 0
LAUNCHES_WGMMA = 0
LAUNCHES_LAST = 0
LAUNCHES_SAME = 0
LAUNCHES_RESIDUAL = 0


def layer_forward(lib, src: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  dst: torch.Tensor, plan, first: bool, last: bool, bf16: bool,
                  stream: int) -> None:
    """Launch one layer of ``src`` (N, H, W, K) into ``dst`` (N, H', W', n)
    on ``stream``. f32: ``w`` and ``b`` from ``entry.pack_f32`` at
    ``plan.nb``, ``plan`` an ``entry.LayerPlan``, ReLU unless ``last``.
    bf16: ``plan`` an ``entry.FirstPlan`` (the first layer),
    ``entry.WgmmaPlan`` (a middle layer) or ``entry.LastPlan`` (the last),
    ``w`` and ``b`` from ``entry.pack_bf16`` or, for a ``LastPlan``,
    ``entry.pack_last``; the wgmma kernels' tensor maps need 16-byte aligned
    tensors (raises ValueError otherwise), the wgmma stage launches at its
    plan's A stages; ``src`` f32
    when ``first`` else bf16, ``dst`` f32 when ``last`` else bf16, ReLU
    unless ``last``."""
    global LAUNCHES, LAUNCHES_BF16, LAUNCHES_FIRST, LAUNCHES_WGMMA, LAUNCHES_LAST
    from .entry import FirstPlan, LastPlan, WgmmaPlan

    n, h, wd, k = src.shape
    args = (src.data_ptr(), w.data_ptr(), b.data_ptr(), dst.data_ptr(), n, h, wd, k)
    stage = ({FirstPlan: "first", WgmmaPlan: "wgmma", LastPlan: "last"}.get(type(plan))
             if bf16 else None)
    if bf16 and stage is None:
        raise TypeError(f"no bf16 kernel takes a {type(plan).__name__}")
    if bf16 and any(t.data_ptr() % 16 for t in (src, w, b, dst)):
        raise ValueError("the wgmma kernels' tensor copies need 16-byte aligned tensors")
    if stage == "first":
        err = lib.conv_first_forward_wgmma(*args, plan.f, dst.shape[3], plan.smem, stream)
    elif stage == "wgmma":
        err = lib.conv_layer_forward_wgmma(*args, plan.f, dst.shape[3], plan.a_ring, plan.smem,
                                           stream)
    elif stage == "last":
        err = lib.conv_last_forward_wgmma(*args, plan.f, dst.shape[3], plan.smem, stream)
    else:
        f = src.shape[1] - dst.shape[1] + 1
        err = lib.conv_layer_forward(*args, f, dst.shape[3], int(not last), plan.tile_h,
                                     plan.tile_w, plan.kc, plan.smem, stream)
    if err:
        what = {"first": "conv_first_wgmma", "wgmma": "conv_layer_wgmma",
                "last": "conv_last_wgmma", None: "conv_layer"}[stage]
        raise RuntimeError(f"{what} launch failed: " + lib.cnn_sr_error_string(err).decode())
    if bf16:
        LAUNCHES_BF16 += 1
        LAUNCHES_FIRST += int(stage == "first")
        LAUNCHES_WGMMA += int(stage == "wgmma")
        LAUNCHES_LAST += int(stage == "last")
    else:
        LAUNCHES += 1


def chain_forward(params, x: torch.Tensor, plans, bf16: bool = False) -> torch.Tensor:
    """Run ``params`` over the CUDA tensor ``x`` (N, H, W, C), layer i
    with ``plans[i]`` (``entry.LayerPlan`` or, in bf16, ``entry.FirstPlan``,
    ``entry.WgmmaPlan`` or ``entry.LastPlan``), on the current stream, in
    f32 or, with ``bf16``, as the bf16 stream. The shapes are the caller's
    to check (``entry.fused_forward``)."""
    if not x.is_cuda:
        raise NotImplementedError(f"the layer chain runs on CUDA tensors, not {x.device}")
    from .build import load_library
    from .entry import chain_bf16_weights, f32_weights

    lib = load_library()
    operands = (chain_bf16_weights(params, plans) if bf16
                else f32_weights(params, [p.nb for p in plans]))
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


def same_forward(lib, src: torch.Tensor, k: int, w: torch.Tensor, b: torch.Tensor,
                 dst: torch.Tensor, c0: int, plan, lrelu: bool, residuals=(), out32=None,
                 stream: int = 0) -> None:
    """Launch one SAME-padded layer of a SAME model (``ops/fused/rrdb.py``)
    on ``stream``: the first ``k`` channels of ``src`` (N, H, W, XS) into
    channels ``c0`` .. ``c0 + n`` of ``dst`` (N, H, W, YS), n the plan's.
    ``plan`` names the kernel as in ``layer_forward``, and must be one of
    ``entry.same_instances`` (the kernels refuse others: RuntimeError): a
    ``FirstPlan`` (``src`` f32 RGB in 0..1 taken as 0..255 levels, ``w`` from
    ``entry.pack_bf16`` with ``levels=255``, no activation), a ``WgmmaPlan``
    (``src`` bf16, any XS and YS) or a ``LastPlan`` (``dst`` f32 (N, H, W,
    n), no activation). Only a ``WgmmaPlan`` takes ``lrelu``, LeakyReLU(0.2)
    after the bias (``csrc/wgmma_conv.cuh``), ``residuals``, at most two
    ``(tensor, scale)`` of f32 (N, H, W, RS) whose first n channels at the
    output's position make the epilogue ``r + scale·v`` in turn, and
    ``out32``, an f32 (N, H, W, RS) whose first n channels take the result
    before its rounding to bf16; ``out32`` may be one of the residuals. Pointers must be 16-byte
    aligned (ValueError); the kernels refuse channel strides that are not
    multiples of 8 (RuntimeError)."""
    global LAUNCHES_BF16, LAUNCHES_FIRST, LAUNCHES_WGMMA, LAUNCHES_LAST, LAUNCHES_SAME
    global LAUNCHES_RESIDUAL
    from .entry import FirstPlan, LastPlan, WgmmaPlan

    n, h, wd, xs = src.shape
    ys = dst.shape[3]
    y = dst.data_ptr() + c0 * dst.element_size()
    if (lrelu or residuals or out32 is not None) and not isinstance(plan, WgmmaPlan):
        raise ValueError("only a middle layer takes LeakyReLU, residuals and an f32 copy")
    if len(residuals) > 2:
        raise ValueError(f"at most two residuals, got {len(residuals)}")
    if any(t.data_ptr() % 16 for t in (src, w, b)) or y % 16:
        raise ValueError("the wgmma kernels' tensor copies need 16-byte aligned tensors")
    if isinstance(plan, LastPlan) and xs != k:
        raise ValueError(f"the last layer reads all of its input's channels, not {k} of {xs}")
    if isinstance(plan, FirstPlan):
        err = lib.conv_first_forward_wgmma_same(src.data_ptr(), w.data_ptr(), b.data_ptr(), y,
                                                ys, n, h, wd, xs, plan.f, plan.n, plan.smem,
                                                stream)
    elif isinstance(plan, LastPlan):
        err = lib.conv_last_forward_wgmma_same(src.data_ptr(), w.data_ptr(), b.data_ptr(), y, n,
                                               h, wd, k, plan.f, plan.n, plan.smem, stream)
    elif isinstance(plan, WgmmaPlan):
        res = [(r.data_ptr(), r.shape[3], float(s)) for r, s in residuals]
        res += [(None, 0, 0.0)] * (2 - len(res))
        o32 = (None, 0) if out32 is None else (out32.data_ptr(), out32.shape[3])
        err = lib.conv_layer_forward_wgmma_same(src.data_ptr(), xs, w.data_ptr(), b.data_ptr(),
                                                y, ys, n, h, wd, k, plan.f, plan.n, int(lrelu),
                                                *res[0], *res[1], *o32, plan.a_ring, plan.smem,
                                                stream)
    else:
        raise TypeError(f"no bf16 kernel takes a {type(plan).__name__}")
    if err:
        raise RuntimeError(f"{type(plan).__name__} SAME launch failed: "
                           + lib.cnn_sr_error_string(err).decode())
    LAUNCHES_BF16 += 1
    LAUNCHES_SAME += 1
    LAUNCHES_FIRST += int(isinstance(plan, FirstPlan))
    LAUNCHES_WGMMA += int(isinstance(plan, WgmmaPlan))
    LAUNCHES_LAST += int(isinstance(plan, LastPlan))
    LAUNCHES_RESIDUAL += int(bool(residuals))
