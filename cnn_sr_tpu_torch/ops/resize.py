"""On-device image scaling (the pipeline's pre-upscale and degradation).

Counterpart of ``cnn_sr_tpu/ops/resize.py`` for ``method="bicubic"``:

* ``resize_plane`` — resize a float (H, W) or (H, W, C) image;
* ``upscale_rgba`` — upscale a uint8 image by a factor before the net
  (``cnn_torch --scale``, the server's ``--scale``);
* ``degrade``     — the training degradation: down by a factor, then back.

``jax.image.resize(…, "cubic")`` is the Keys cubic (a = −0.5) with its
kernel widened by the scale when downsampling; ``F.interpolate`` computes
the same with ``antialias=True`` (its default ``antialias=False`` uses
a = −0.75 and no widening, and is off by 0.37 at 2x down on a unit-scale
image). Torch has no lanczos3, and its ``nearest`` picks other pixels
than ``jax.image.resize``'s, so the other methods are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_METHODS = ("bicubic", "cubic")
_ROADMAP = "ROADMAP.md Queue 1 #8"


def _check_method(method: str) -> None:
    if method not in _METHODS:
        raise NotImplementedError(
            f"resize method {method!r} is not ported yet (only bicubic; {_ROADMAP})")


def resize_plane(img: torch.Tensor, out_h: int, out_w: int,
                 method: str = "bicubic") -> torch.Tensor:
    """Resize a float (H, W) or (H, W, C) image to (out_h, out_w[, C])."""
    _check_method(method)
    x = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(out_h, out_w), mode="bicubic", align_corners=False,
                      antialias=True)[0]
    return y[0] if img.dim() == 2 else y.permute(1, 2, 0)


def upscale_rgba(rgba: torch.Tensor, factor: float, method: str = "bicubic") -> torch.Tensor:
    """Upscale a uint8 (H, W, C) image by ``factor``; returns uint8 with
    the same channel count: ``clip(round(y), 0, 255)``, ties to even."""
    h, w = rgba.shape[0], rgba.shape[1]
    out_h, out_w = int(round(h * factor)), int(round(w * factor))
    y = resize_plane(rgba.to(torch.float32), out_h, out_w, method)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def degrade(img: torch.Tensor, factor: float, method: str = "bicubic") -> torch.Tensor:
    """The training degradation model: downscale by ``factor`` then scale
    back to the original size (generate_training_samples.py:34-40), on
    the image's device. ``img``: float (H, W[, C])."""
    h, w = img.shape[0], img.shape[1]
    small_h, small_w = max(1, int(h / factor)), max(1, int(w / factor))
    small = resize_plane(img, small_h, small_w, method)
    return resize_plane(small, h, w, method)
