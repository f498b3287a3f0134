"""Plain PyTorch version of both kernels (the fused ``csrc/fused_srcnn.cu``
and, in bf16, ``csrc/fused_wgmma.cu``, and the layer chain
``csrc/conv_layer.cu``), in both precisions, and of one tensor-core layer
over packed weights (``tap_layer``).

``precision="f32"``: a layer loop of ``F.conv2d`` in strict f32 (TF32 off
for cuDNN and matmuls).

``precision="bf16"``: the JAX package's bf16 stream with the int8 first
layer (``cnn_sr_tpu/ops/pallas_fused/entry.py:fused_forward`` with
``dtype=bf16, input_int8=True``), computed directly:

* the input is quantised as ``weights._quantize_planes`` does it,
  ``round(clip(x, −1, 1) · 127)`` with ties to even (``quantize``), and
  the 1/127 scale is folded into w1 before it is rounded to bf16
  (``fold_first``);
* every layer's activations and weights are bf16 values and the products
  are summed in f32; the bias is added in f32, then ReLU on every layer
  but the last, and each output that feeds another layer is rounded to
  bf16 (round to nearest even). The last layer's output stays f32.

A bf16 × bf16 product is exact in f32, so the bf16 stream is a strict-f32
convolution over bf16-rounded values. ``entry.fused_forward`` takes this
module for CPU tensors on every route; the tests and ``chip_smoke.py``
hold each kernel against it on the card. Nothing on the main path calls
it with a CUDA tensor.
"""

from __future__ import annotations

import torch

from ...models.srcnn import conv_layer, forward, strict_f32

PRECISIONS = ("f32", "bf16")


def quantize(x: torch.Tensor, levels: int = 127) -> torch.Tensor:
    """The int8 plane's values, ``round(clip(x, −1, 1) · 127)`` (ties to
    even, as ``jnp.round``), kept as f32 integers in [−127, 127]. A SAME
    model's first layer takes ``levels`` 255: its RGB input in 0..1 as its
    0..255 levels, each exact in bf16."""
    return torch.round(torch.clamp(x, -1.0, 1.0) * float(levels))


def fold_first(w: torch.Tensor, levels: int = 127) -> torch.Tensor:
    """First-layer weights with the int8 plane's 1/127 scale (1/``levels``)
    folded in, rounded once to bf16: ``(w1 / 127.0).astype(bf16)``."""
    return (w / float(levels)).to(torch.bfloat16)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bf16 value, held in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def fused_forward(params, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(N, H, W, C) f32 → (N, H−s, W−s, n_out) f32, the kernels' math in
    ``precision`` ("f32" or "bf16")."""
    if precision == "f32":
        return forward(params, x)
    if precision != "bf16":
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    last = len(params) - 1
    y = quantize(x)
    with strict_f32():
        for i, layer in enumerate(params):
            w = fold_first(layer["w"]) if i == 0 else layer["w"].to(torch.bfloat16)
            y = conv_layer(y, w.to(torch.float32), layer["b"], relu=i != last)
            if i != last:
                y = round_bf16(y)
    return y.contiguous()


def tap_layer(x: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, f: int, n: int,
              first: bool, last: bool) -> torch.Tensor:
    """Plain version of one bf16 chain launch (``csrc/conv_first_wgmma.cu`` first,
    ``csrc/conv_wgmma.cu`` middle, ``csrc/conv_last_wgmma.cu`` last; the
    last-layer kernel takes the same weights packed with its dx taps side by
    side, ``entry.pack_last``) over the packed operands ``wp`` (taps, K_pad,
    N_pad) bf16 and ``bp`` (N_pad,) f32 (``entry.pack_bf16``): the sum over
    taps of shifted windows of ``x`` (N, H, W, k) @ ``wp[tap]``, in f32, then
    the bias, ReLU unless ``last``, and bf16 rounding unless ``last``; (N,
    H−f+1, W−f+1, n) f32. The first layer quantises ``x`` (f32) and builds the
    dx-expanded window, lane ``dx·k + ci``; its taps are the f rows dy.
    Padding lanes are zero, as the kernel's. Only the tests call it: they hold
    the packing and the tap indexing against ``fused_forward``."""
    nb, h, w, k = x.shape
    oh, ow = h - f + 1, w - f + 1
    kp = wp.shape[1]
    if first:
        q = quantize(x)
        win = torch.cat([q[:, :, dx:dx + ow, :] for dx in range(f)], dim=3)
        win = torch.nn.functional.pad(win, (0, kp - f * k))
        shifts = [(dy, 0) for dy in range(f)]
    else:
        win = torch.nn.functional.pad(x.to(torch.float32), (0, kp - k))
        shifts = [(dy, dx) for dy in range(f) for dx in range(f)]
    with strict_f32():
        y = torch.zeros((nb, oh, ow, wp.shape[2]), dtype=torch.float32, device=x.device)
        for t, (dy, dx) in enumerate(shifts):
            y += win[:, dy:dy + oh, dx:dx + ow, :] @ wp[t].to(torch.float32)
    y = (y + bp)[..., :n]
    if not last:
        y = round_bf16(torch.relu(y))
    return y.contiguous()


LRELU_SLOPE = 0.2  # a SAME launch's LeakyReLU (csrc/wgmma_conv.cuh: SameEpi)


def same_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, lrelu: bool = False,
               residuals=(), first: bool = False, last: bool = False,
               precision: str = "bf16") -> tuple:
    """Plain version of one SAME launch of a SAME model (``ops/fused/rrdb.py``
    on ``csrc/conv_first_wgmma.cu``, ``conv_wgmma.cu`` and
    ``conv_last_wgmma.cu``): ``x`` (N, H, W, k) f32 through ``w`` (f, f, k,
    n) HWIO, zero-padded by (f − 1) / 2, into (N, H, W, n) f32. The sum
    and the bias, then LeakyReLU(0.2) where ``lrelu``, then for each ``(r, s)`` of ``residuals`` in
    turn ``r + s·v`` (``r`` (N, H, W, n)), each product and sum rounded in
    f32 as the kernels' epilogue rounds them. In bf16 the operands are bf16
    values (the first layer's input its 0..255 levels, ``quantize(x, 255)``,
    with 1/255 folded into w, ``fold_first(w, 255)``), the products summed
    in f32, and the result rounded once to bf16 unless ``last``; in f32
    nothing is rounded. Each image is computed alone, so that its answer
    does not depend on the batch. Returns ``(y, v)``: the stored output and
    the f32 result before its rounding (the launch's ``out32``)."""
    bf16 = precision == "bf16"
    if bf16:
        if first:
            x, w = quantize(x, 255), fold_first(w, 255)
        w = w.to(torch.bfloat16).to(torch.float32)
    pad = w.shape[0] // 2
    wt = w.permute(3, 2, 0, 1)
    with strict_f32():
        # an image at a time: the CPU's convolution sums in an order that
        # depends on the batch, and each image's answer must not
        v = torch.cat([torch.nn.functional.conv2d(im.permute(0, 3, 1, 2), wt, b, padding=pad)
                       for im in x.split(1)]).permute(0, 2, 3, 1)
    if lrelu:
        v = torch.where(v < 0, v * LRELU_SLOPE, v)
    for r, s in residuals:
        v = r + s * v
    return (round_bf16(v) if bf16 and not last else v).contiguous(), v
