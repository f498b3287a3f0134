"""High-level inference API: one luma upscale per call, on the model's device.

Counterpart of ``cnn_sr_tpu/api.py:upscale_image`` (luma models,
unbucketed) and ``_upscale_luma_jit``. The uint8 image goes to the device
once and uint8 RGB comes back once; in between, luma extraction, mean
subtraction, the fused conv stack and the luma swap all run on the
device, and the mean never visits the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .models.srcnn import SRCNN
from .ops.color import extract_luma, subtract_mean, swap_luma
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


def upscale_image(cfg: Config, params, rgba: np.ndarray) -> np.ndarray:
    """Run a luma model over a decoded uint8 RGBA image; returns uint8 RGB.

    ``params`` is the layer list as torch tensors (``params_to_torch``);
    the image runs on their device, through the fused kernel on CUDA and
    its plain version on the CPU. The net's luma replaces Y inside the
    valid-conv window and the border passes through.
    """
    if cfg.channels != 1:
        raise NotImplementedError(
            "the RGB pipeline is not ported yet (ROADMAP.md Queue 1 #7)")
    shrink = cfg.total_padding()
    if rgba.shape[0] <= shrink or rgba.shape[1] <= shrink:
        raise ValueError(
            f"image {rgba.shape[1]}x{rgba.shape[0]} is not larger than the "
            f"model's receptive field ({shrink}+1 px per side)")
    device = params[0]["w"].device
    # torch refuses to wrap read-only arrays (a decoded image may be one)
    img = torch.as_tensor(np.require(rgba, requirements=("C", "W")), device=device)
    out = _upscale_luma(SRCNN(params), img, add_mean=cfg.zero_mean_target,
                        squared_mean=cfg.subtract_squared_mean)
    return out.cpu().numpy()
