"""The SRCNN upscale pipeline in plain PyTorch, f32 with TF32 off.

Written from the model's description, not from the program: uint8 RGBA
in, uint8 RGB out.

* luma models (``channels`` 1): Rec.601 luma of the frame in 0..1, minus
  the frame's mean (or E[luma^2] under ``subtract_squared_mean``), the
  valid convolutions (ReLU on all but the last), the mean added back under
  ``zero_mean_target``; the new luma recombined with the frame's own
  chroma through the fixed YCbCr matrices, clamped to 0..255 and
  truncated to uint8 inside the window the convolutions leave, the
  border passed through;
* RGB models (``channels`` 3): the same with each channel in 0..1 minus
  its own mean, and the output clamped and truncated directly.

``pre_scale`` is the bicubic (Keys, a = -0.5) resize as separable weight
matrices, rounded half to even and clamped to uint8.

``control`` rounds every convolution's input and weights to a lower
precision before an f32 product, the control of the comparison: ``"tf32"``
(10 mantissa bits) for an f32 stack; ``"fp8"`` (e4m3 with one scale a
tensor), the step below the bf16 stream, for every operand.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

RGB2CB = (-0.1687, -0.3312, 0.5)
RGB2CR = (0.5, -0.4186, -0.0813)
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_f32():
    """TF32 off for convolutions and matmuls, restored afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def round_to(x: torch.Tensor, control) -> torch.Tensor:
    """``x`` (f32) rounded to the control's precision, back in f32."""
    if control is None:
        return x
    if control == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    if control == "fp8":
        scale = torch.clamp(x.abs().max(), min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"unknown control {control!r}")


def conv_stack(weights, x: torch.Tensor, control=None) -> torch.Tensor:
    """(N, C, H, W) f32 through the valid convolutions; ``weights`` is
    ``[(w HWIO (f, f, k, n), b (n,)), ...]``."""
    last = len(weights) - 1
    for i, (w, b) in enumerate(weights):
        x = F.conv2d(round_to(x, control), round_to(w.permute(3, 2, 0, 1).contiguous(), control), b)
        if i != last:
            x = torch.relu(x)
    return x


def _byte(v: torch.Tensor) -> torch.Tensor:
    return torch.trunc(torch.clamp(v, 0.0, 255.0)).to(torch.uint8)


def upscale_frame(rgba: torch.Tensor, weights, channels: int, zero_mean_target: bool,
                  squared_mean: bool = False, control=None) -> torch.Tensor:
    """One uint8 RGBA frame (H, W, 4) → uint8 RGB (H, W, 3)."""
    h, w = rgba.shape[0], rgba.shape[1]
    rgb = rgba[..., :3].to(torch.float32)
    s = sum(wt.shape[0] - 1 for wt, _ in weights)
    o = s // 2
    out = rgba[..., :3].clone()
    with strict_f32():
        if channels == 3:
            x = rgb / 255.0
            mean = x.mean(dim=(0, 1))
            y = conv_stack(weights, (x - mean).permute(2, 0, 1)[None], control)[0].permute(1, 2, 0)
            if zero_mean_target:
                y = y + mean
            out[o:h - s + o, o:w - s + o] = _byte(y * 255.0)
            return out
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        luma = (0.299 * r + 0.587 * g + 0.114 * b) / 255.0
        mean = (luma * luma).mean() if squared_mean else luma.mean()
        y = conv_stack(weights, (luma - mean)[None, None], control)[0, 0]
        if zero_mean_target:
            y = y + mean
        y = y * 255.0
        win = (slice(o, h - s + o), slice(o, w - s + o))
        r, g, b = r[win], g[win], b[win]
        cb = RGB2CB[0] * r + RGB2CB[1] * g + RGB2CB[2] * b
        cr = RGB2CR[0] * r + RGB2CR[1] * g + RGB2CR[2] * b
        out[win] = torch.stack([_byte(y + 1.4 * cr), _byte(y - 0.343 * cb - 0.711 * cr),
                                _byte(y + 1.765 * cb)], dim=-1)
    return out


def _keys(x: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    x = x.abs()
    near = ((a + 2) * x - (a + 3)) * x * x + 1
    far = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return torch.where(x <= 1, near, torch.where(x < 2, far, torch.zeros_like(x)))


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) bicubic weights of an upscale, each row over the
    input samples in range, divided by its sum."""
    sample = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * n_in / n_out - 0.5
    taps = torch.arange(n_in, dtype=torch.float64, device=device)
    wts = _keys(taps[None, :] - sample[:, None])
    return (wts / wts.sum(dim=1, keepdim=True)).to(torch.float32)


def pre_scale(rgba: torch.Tensor, factor: float) -> torch.Tensor:
    """uint8 (H, W, C) → uint8 (round(H·factor), round(W·factor), C)."""
    h, w = rgba.shape[0], rgba.shape[1]
    oh, ow = int(round(h * factor)), int(round(w * factor))
    with strict_f32():
        x = rgba.to(torch.float32).permute(2, 0, 1)  # (C, H, W)
        y = _resize_matrix(h, oh, rgba.device) @ x @ _resize_matrix(w, ow, rgba.device).T
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8).permute(1, 2, 0).contiguous()
