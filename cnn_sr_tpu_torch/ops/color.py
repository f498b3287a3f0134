"""Color-space ops: luma extraction, mean subtraction, luma and RGB swap.

Counterpart of ``cnn_sr_tpu/ops/color.py`` (rank-3 forms; the uint32
``*_packed`` forms wait). Each function keeps the JAX expression order, so
that the CPU results match it byte for byte:

* ``extract_luma``  — Rec.601 ``0.299·R + 0.587·G + 0.114·B`` from uint8
  RGBA, optionally /255 (extract_luma.cl:5-21);
* ``subtract_mean`` — subtract the per-image mean, or E[luma²] with the
  reference binary's ``squared`` quirk (DataPipeline.cpp:268-280);
* ``swap_luma``     — recombine the net's luma with the original chroma
  through the fixed YCbCr matrices, clamp to 0..255, truncate to uint8;
  the window offset comes from the width alone and the border passes
  the original through (swap_luma.cl:19-69);
* ``swap_rgb``      — the RGB model's counterpart: paste the net's 0..1 RGB,
  clamped to 0..255 and truncated to uint8, into the original.

All take and return tensors on any device; images are uint8 (H, W, C≥3).
"""

from __future__ import annotations

import torch

# Rec.601 matrices (swap_luma.cl:7-16); the ±128 chroma offsets cancel
RGB2CB = (-0.1687, -0.3312, 0.5)
RGB2CR = (0.5, -0.4186, -0.0813)
YCBCR2R_CR = 1.4
YCBCR2G = (-0.343, -0.711)  # (cb, cr)
YCBCR2B_CB = 1.765


def extract_luma(image: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """uint8 RGB(A) (H, W, C>=3) → float32 luma (H, W)."""
    r, g, b = (image[..., c].to(torch.float32) for c in range(3))
    luma = r * 0.299 + g * 0.587 + b * 0.114
    return luma / 255.0 if normalize else luma


def subtract_mean(luma: torch.Tensor, squared: bool = False):
    """Returns ``(luma − mean, mean)``; ``squared=True`` subtracts E[luma²]
    instead (config ``subtract_squared_mean``, the reference binary's
    behaviour — see ``cnn_sr_tpu.ops.color.subtract_mean``). The mean stays
    a 0-d tensor on the device."""
    mean = torch.mean(torch.square(luma) if squared else luma)
    return luma - mean, mean


def swap_luma(original_rgb: torch.Tensor, new_luma: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, C>=3) image + float luma (lh, lw) in 0..1 → uint8
    (H, W, 3). The luma window sits at offset ``(W − lw) // 2`` on both
    axes; pixels outside it copy the original."""
    h, w = original_rgb.shape[0], original_rgb.shape[1]
    lh, lw = new_luma.shape[0], new_luma.shape[1]
    pad = (w - lw) // 2
    r, g, b = (original_rgb[..., c].to(torch.float32) for c in range(3))

    # the write start clamps like lax.dynamic_update_slice; the mask does not
    y_new = torch.zeros((h, w), dtype=torch.float32, device=original_rgb.device)
    r0 = min(max(pad, 0), h - lh)
    c0 = min(max(pad, 0), w - lw)
    y_new[r0:r0 + lh, c0:c0 + lw] = new_luma.to(torch.float32)
    y_new = y_new * 255.0

    cb = r * RGB2CB[0] + g * RGB2CB[1] + b * RGB2CB[2]
    cr = r * RGB2CR[0] + g * RGB2CR[1] + b * RGB2CR[2]
    ro = y_new + cr * YCBCR2R_CR
    go = y_new + cb * YCBCR2G[0] + cr * YCBCR2G[1]
    bo = y_new + cb * YCBCR2B_CB

    def _byte(v):
        # clamp 0..255 then truncate (OpenCL convert_uint rounds toward 0)
        return torch.trunc(torch.clamp(v, 0.0, 255.0)).to(torch.uint8)

    combined = torch.stack([_byte(ro), _byte(go), _byte(bo)], dim=-1)
    rows = torch.arange(h, device=original_rgb.device)[:, None]
    cols = torch.arange(w, device=original_rgb.device)[None, :]
    inside = (rows >= pad) & (rows < pad + lh) & (cols >= pad) & (cols < pad + lw)
    return torch.where(inside[..., None], combined, original_rgb[..., :3])


def swap_rgb(original_rgb: torch.Tensor, new_rgb: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, C>=3) image + float RGB (lh, lw, 3) in 0..1 → uint8
    (H, W, 3): ``trunc(clip(new·255, 0, 255))`` pasted at offset
    ``(W − lw) // 2`` on both axes; the border copies the original."""
    h, w = original_rgb.shape[0], original_rgb.shape[1]
    lh, lw = new_rgb.shape[0], new_rgb.shape[1]
    pad = (w - lw) // 2
    out = torch.trunc(torch.clamp(new_rgb * 255.0, 0.0, 255.0)).to(torch.uint8)
    canvas = original_rgb[..., :3].clone()
    # the write start clamps like lax.dynamic_update_slice
    r0 = min(max(pad, 0), h - lh)
    c0 = min(max(pad, 0), w - lw)
    canvas[r0:r0 + lh, c0:c0 + lw] = out
    return canvas
