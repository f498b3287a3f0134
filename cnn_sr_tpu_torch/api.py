"""High-level inference API: one upscale per call, on the model's device.

Counterpart of ``cnn_sr_tpu/api.py:upscale_image`` (unbucketed) and its
``_upscale_luma_jit`` and ``_upscale_rgb_jit``. The uint8 image goes to
the device once and uint8 RGB comes back once; in between, the color ops,
the mean, the conv stack and the swap all run on the device, and the mean
never visits the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .models.srcnn import SRCNN
from .ops.color import extract_luma, subtract_mean, swap_luma, swap_rgb
from .utils.config import Config


def _upscale_luma(net: Callable[[torch.Tensor], torch.Tensor], rgba: torch.Tensor,
                  add_mean: bool, squared_mean: bool) -> torch.Tensor:
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3) through ``net``, a
    function from (1, H, W, 1) to (1, H−s, W−s, 1) on the image's device.
    ``add_mean``: the model predicts mean-relative luma (config
    ``zero_mean_target``), so the input mean is added back."""
    luma = extract_luma(rgba, normalize=True)
    luma0, mean = subtract_mean(luma, squared=squared_mean)
    y = net(luma0[None, ..., None])[0, ..., 0]
    if add_mean:
        y = y + mean
    return swap_luma(rgba, y)


def _upscale_rgb(net: Callable[[torch.Tensor], torch.Tensor], rgba: torch.Tensor,
                 add_mean: bool) -> torch.Tensor:
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3) through ``net``, a
    function from (1, H, W, 3) to (1, H−s, W−s, 3): the per-channel mean
    is subtracted from the input and, with ``add_mean``, added back to the
    output. The RGB model has no squared-mean mode (the JAX package's RGB
    path ignores ``subtract_squared_mean`` too)."""
    rgb = rgba[..., :3].to(torch.float32) / 255.0
    mean = torch.mean(rgb, dim=(0, 1), keepdim=True)
    y = net((rgb - mean)[None])[0]
    if add_mean:
        y = y + mean
    return swap_rgb(rgba, y)


def upscale_image(cfg: Config, params, rgba: np.ndarray) -> np.ndarray:
    """Run the model over a decoded uint8 RGBA image; returns uint8 RGB.

    ``params`` is the layer list as torch tensors (``params_to_torch``);
    the image runs on their device, through the CUDA kernels on a card and
    their plain version on the CPU. A luma model (``channels: 1``)
    replaces Y inside the valid-conv window, an RGB model
    (``channels: 3``) all three channels; the border passes through.
    """
    shrink = cfg.total_padding()
    if rgba.shape[0] <= shrink or rgba.shape[1] <= shrink:
        raise ValueError(
            f"image {rgba.shape[1]}x{rgba.shape[0]} is not larger than the "
            f"model's receptive field ({shrink}+1 px per side)")
    device = params[0]["w"].device
    # torch refuses to wrap read-only arrays (a decoded image may be one)
    img = torch.as_tensor(np.require(rgba, requirements=("C", "W")), device=device)
    net = SRCNN(params)
    if cfg.channels == 3:
        out = _upscale_rgb(net, img, add_mean=cfg.zero_mean_target)
    else:
        out = _upscale_luma(net, img, add_mean=cfg.zero_mean_target,
                            squared_mean=cfg.subtract_squared_mean)
    return out.cpu().numpy()
