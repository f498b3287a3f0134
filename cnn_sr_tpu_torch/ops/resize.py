"""On-device image scaling (the pipeline's pre-upscale and degradation).

Counterpart of ``cnn_sr_tpu/ops/resize.py`` (``jax.image.resize``) for
all of its methods, ``bicubic`` (``cubic``), ``linear``, ``nearest`` and
``lanczos`` (lanczos3):

* ``resize_plane`` — resize a float (H, W) or (H, W, C) image;
* ``upscale_rgba`` — upscale a uint8 image by a factor before the net
  (``cnn_torch --scale``, the server's ``--scale``);
* ``degrade``     — the training degradation: down by a factor, then back.

``jax.image.resize(…, "cubic")`` is the Keys cubic (a = −0.5) with its
kernel widened by the scale when downsampling; ``F.interpolate`` computes
the same with ``antialias=True`` (its default ``antialias=False`` uses
a = −0.75 and no widening, and is off by 0.37 at 2x down on a unit-scale
image). Torch has no lanczos3, and its ``nearest`` picks other pixels
than JAX's, so ``linear`` and ``lanczos`` resample as JAX's
``scale_and_translate`` does, one (out, in) f32 weight matrix an axis
(``weight_matrix``) applied by matmul on the image's device, and
``nearest`` takes JAX's pixel ``floor((i + 0.5) · in / out)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models.srcnn import strict_f32

_METHODS = ("bicubic", "cubic", "linear", "nearest", "lanczos")


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    """jax's ``_fill_lanczos_kernel(3., x)``, in f32."""
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    safe = torch.where(x != 0, math.pi ** 2 * (x * x), torch.ones_like(x))
    out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
    return torch.where(x > radius, torch.zeros_like(x), out)


_KERNELS = {"linear": _triangle, "lanczos": _lanczos3}


def weight_matrix(in_size: int, out_size: int, method: str,
                  device=None) -> torch.Tensor:
    """The (out, in) resampling matrix of one axis, as
    ``jax._src.image.scale.compute_weight_mat`` builds it for a plain
    resize (scale out/in, no translation, antialias): the kernel widened
    by in/out when downsampling, each output's weights divided by their
    sum (zero where the sum is below 1000 f32 eps), and zero rows for
    samples outside the input."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale
              - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                                 device=device)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = torch.sum(w, dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.contiguous()


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    """``jax.image.resize``'s nearest pixel: ``floor((i + 0.5) · in / out)``
    in f32."""
    pos = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * in_size
    return torch.floor(pos / out_size).to(torch.int64)


def resize_plane(img: torch.Tensor, out_h: int, out_w: int,
                 method: str = "bicubic") -> torch.Tensor:
    """Resize a float (H, W) or (H, W, C) image to (out_h, out_w[, C])."""
    if method not in _METHODS:
        raise ValueError(f"unknown resize method {method!r}; one of {_METHODS}")
    h, w = img.shape[0], img.shape[1]
    if method in ("bicubic", "cubic"):
        x = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
        y = F.interpolate(x, size=(out_h, out_w), mode="bicubic", align_corners=False,
                          antialias=True)[0]
        return y[0] if img.dim() == 2 else y.permute(1, 2, 0)
    if method == "nearest":
        return img[_nearest_index(h, out_h, img.device)][:, _nearest_index(w, out_w, img.device)]
    # an axis whose size does not change is left as it is (an identity
    # warp of an interpolating kernel), as JAX skips it
    with strict_f32():
        y = img
        if out_h != h:
            y = torch.tensordot(weight_matrix(h, out_h, method, img.device), y, dims=([1], [0]))
        if out_w != w:
            y = torch.tensordot(weight_matrix(w, out_w, method, img.device), y.transpose(0, 1),
                                dims=([1], [0])).transpose(0, 1)
    return y.contiguous()


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
