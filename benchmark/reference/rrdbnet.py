"""Real-ESRGAN x4plus (basicsr's ``RRDBNet``) in plain PyTorch, f32 with
TF32 off, and RealESRGANer's pipeline around it.

Written from basicsr's ``basicsr/archs/rrdbnet_arch.py`` (ESRGAN,
arXiv:1809.00219; Real-ESRGAN, arXiv:2107.10833), not from the program:
``F.conv2d(padding=1)``, ``torch.cat``, ``F.leaky_relu(·, 0.2)`` and
``F.interpolate(mode="nearest")``, NCHW.

* A dense block: ``x_i = lrelu(conv_i(cat(x, x_1..x_{i-1})))`` for i =
  1..4, then ``x + 0.2·conv_5(cat(x, x_1..x_4))``; an RRDB: ``x +
  0.2·RDB3(RDB2(RDB1(x)))``; the trunk ``f = conv_first(x)``, ``f +
  conv_body(RRDBs(f))``; the head two rounds of nearest x2, a conv and
  lrelu, then ``conv_last(lrelu(conv_hr(·)))``.
* ``weights`` is ``[(w HWIO (3, 3, k, n), b (n,)), ...]`` in the
  ``state_dict`` order; the number of RRDBs is (len − 6) / 15.
* ``upscale_frame``: uint8 RGBA (h, w, 4) → uint8 RGB (4h, 4w, 3): RGB/255
  in f32, the net, clamped to 0..1, ×255, rounded (half to even), as
  ``RealESRGANer`` with ``tile`` 0 returns it.

``control`` rounds every convolution's input and weights before an f32
product (``srcnn.round_to``: ``"fp8"``, e4m3 with one scale a tensor, the
step below the bf16 stream).

Counts (``core.Cell.flops``, ``bound_ms``): every convolution at its own
resolution, the trunk's at the input's, conv_up1's at 2x, the rest at 4x:
17,926,848 multiply-adds a low-resolution pixel at x4plus's widths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..roofline import PEAK_BYTES, PEAK_FLOPS
from .srcnn import round_to, strict_f32


def _conv(x, wb, control):
    w, b = wb
    return F.conv2d(round_to(x, control), round_to(w.permute(3, 2, 0, 1).contiguous(), control),
                    b, padding=1)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _rdb(x, convs, control):
    feats = [x]
    for wb in convs[:4]:
        feats.append(_lrelu(_conv(torch.cat(feats, 1), wb, control)))
    return _conv(torch.cat(feats, 1), convs[4], control) * 0.2 + x


def net(x: torch.Tensor, weights, control=None) -> torch.Tensor:
    """(N, C, h, w) f32 in 0..1 → (N, C, 4h, 4w) f32, unclamped."""
    blocks = (len(weights) - 6) // 15
    feat = _conv(x, weights[0], control)
    body = feat
    for b in range(blocks):
        convs = weights[1 + 15 * b:16 + 15 * b]
        out = body
        for r in range(3):
            out = _rdb(out, convs[5 * r:5 * r + 5], control)
        body = out * 0.2 + body
    feat = feat + _conv(body, weights[-5], control)
    feat = _lrelu(_conv(F.interpolate(feat, scale_factor=2, mode="nearest"), weights[-4], control))
    feat = _lrelu(_conv(F.interpolate(feat, scale_factor=2, mode="nearest"), weights[-3], control))
    return _conv(_lrelu(_conv(feat, weights[-2], control)), weights[-1], control)


def upscale_frame(rgba: torch.Tensor, weights, channels: int = 3, zero_mean_target: bool = False,
                  squared_mean: bool = False, control=None) -> torch.Tensor:
    """One uint8 RGBA frame (h, w, 4) → uint8 RGB (4h, 4w, 3). The colour
    arguments are the configuration's; RealESRGANer has no mean shift, so
    a configuration of this model sets none."""
    if channels != 3 or zero_mean_target or squared_mean:
        raise ValueError("Real-ESRGAN takes RGB with no mean shift")
    with strict_f32():
        x = (rgba[..., :3].to(torch.float32) / 255.0).permute(2, 0, 1)[None]
        y = net(x, weights, control)[0].permute(1, 2, 0)
    return torch.round(torch.clamp(y, 0.0, 1.0) * 255.0).to(torch.uint8)


def _layers(cfg):
    return [tuple(x) for x in cfg["layers"]]


def _macs(layers, shape, part="all") -> int:
    """Multiply-adds of ``layers`` on the input ``(n, h, w, c)``: the trunk's
    (every layer but the last four) at the input's pixels, conv_up1's at
    four times them, conv_up2's, conv_hr's and conv_last's at sixteen."""
    n, h, w, _ = shape
    px = n * h * w
    trunk = sum(9 * k * m for _, k, m in layers[:-4]) * px
    up1 = 9 * layers[-4][1] * layers[-4][2] * 4 * px
    rest = sum(9 * k * m for _, k, m in layers[-3:]) * 16 * px
    return {"trunk": trunk, "head": up1 + rest, "all": trunk + up1 + rest}[part]


def _weight_bytes(layers, precision):
    wb = 2 if precision == "bf16" else 4
    return sum(wb * 9 * k * m + 4 * m for _, k, m in layers)


def _bound(flops, moved, precision) -> tuple:
    t_ops = flops / PEAK_FLOPS[precision] * 1e3
    t_bytes = moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def flops(cfg, shape) -> int:
    """2 x the model's multiply-adds on the API's input ``(n, h, w, c)``."""
    return 2 * _macs(_layers(cfg), shape)


def bound_ms(cfg, shape, precision) -> tuple:
    """The whole model's least time: its operations, or its f32 input,
    weights and f32 output once over the memory rate."""
    layers = _layers(cfg)
    n, h, w, c = shape
    moved = 4 * n * h * w * c + _weight_bytes(layers, precision) + 4 * 16 * n * h * w * c
    return _bound(2 * _macs(layers, shape), moved, precision)


def _act_bytes(precision):
    return 2 if precision == "bf16" else 4


def trunk_bound_ms(cfg, shape, precision) -> tuple:
    """The trunk's least time, conv_first through the trunk's residual: its
    operations, or the f32 input, its weights and its features (num_feat
    channels at the input's size, in the stream's precision) once."""
    layers = _layers(cfg)
    n, h, w, c = shape
    nf = layers[0][2]
    moved = (4 * n * h * w * c + _weight_bytes(layers[:-4], precision)
             + _act_bytes(precision) * n * h * w * nf)
    return _bound(2 * _macs(layers, shape, "trunk"), moved, precision)


def head_bound_ms(cfg, shape, precision) -> tuple:
    """The head's least time, the upsamples through conv_last: its
    operations, or the trunk's features, its weights and the f32 output
    once."""
    layers = _layers(cfg)
    n, h, w, c = shape
    nf = layers[0][2]
    moved = (_act_bytes(precision) * n * h * w * nf + _weight_bytes(layers[-4:], precision)
             + 4 * 16 * n * h * w * c)
    return _bound(2 * _macs(layers, shape, "head"), moved, precision)
