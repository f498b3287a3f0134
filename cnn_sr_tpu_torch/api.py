"""High-level inference API: one image or a batch per call, on the model's
device.

Counterpart of ``cnn_sr_tpu/api.py``: ``upscale_image`` (exact shapes,
``_upscale_luma_jit`` / ``_upscale_rgb_jit``, or shape buckets,
``_upscale_luma_bucketed`` / ``_upscale_rgb_bucketed``) and
``upscale_batch`` (``_upscale_luma_batch_jit`` / ``_upscale_rgb_batch_jit``)
and ``upscale_image_spatial`` (one image's rows over several devices).
The uint8 images go to the device once and uint8 RGB comes back once; in
between, the color ops, the means, the conv stack and the swap all run on
the device, and no mean visits the host.

``precision="f32"`` (the default, as JAX's default ``use_pallas=False``
gives its XLA f32 forward) runs the conv stack in f32; ``"bf16"`` runs
the bf16 stream with the int8 first layer, the counterpart of
``use_pallas=True`` with its default precision.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .models.srcnn import SRCNN
from .ops.color import extract_luma, subtract_mean, swap_luma, swap_rgb
from .utils.config import Config

Net = Callable[[torch.Tensor], torch.Tensor]


def _upscale_luma_batch(net: Net, rgbas: torch.Tensor, add_mean: bool,
                        squared_mean: bool) -> torch.Tensor:
    """uint8 RGBA (S, H, W, 4) → uint8 RGB (S, H, W, 3) through ``net``, a
    function from (S, H, W, 1) to (S, H−s, W−s, 1) on the images' device,
    called once. Each image is centred on its own mean (E[luma²] with
    ``squared_mean``); ``add_mean``: the model predicts mean-relative luma
    (config ``zero_mean_target``), so the mean is added back."""
    centred = [subtract_mean(extract_luma(im, normalize=True), squared=squared_mean)
               for im in rgbas]
    ys = net(torch.stack([luma0 for luma0, _ in centred])[..., None])[..., 0]
    return torch.stack([swap_luma(im, y + mean if add_mean else y)
                        for im, y, (_, mean) in zip(rgbas, ys, centred)])


def _upscale_luma(net: Net, rgba: torch.Tensor, add_mean: bool,
                  squared_mean: bool) -> torch.Tensor:
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3); ``_upscale_luma_batch``
    of one image."""
    return _upscale_luma_batch(net, rgba[None], add_mean, squared_mean)[0]


def _upscale_rgb_batch(net: Net, rgbas: torch.Tensor, add_mean: bool) -> torch.Tensor:
    """uint8 RGBA (S, H, W, 4) → uint8 RGB (S, H, W, 3) through ``net``, a
    function from (S, H, W, 3) to (S, H−s, W−s, 3), called once: each
    image's per-channel mean is subtracted from its input and, with
    ``add_mean``, added back to its output. The RGB model has no
    squared-mean mode (the JAX package's RGB path ignores
    ``subtract_squared_mean`` too)."""
    rgbs = [im[..., :3].to(torch.float32) / 255.0 for im in rgbas]
    means = [torch.mean(rgb, dim=(0, 1), keepdim=True) for rgb in rgbs]
    ys = net(torch.stack([rgb - mean for rgb, mean in zip(rgbs, means)]))
    return torch.stack([swap_rgb(im, y + mean if add_mean else y)
                        for im, y, mean in zip(rgbas, ys, means)])


def _upscale_rgb(net: Net, rgba: torch.Tensor, add_mean: bool) -> torch.Tensor:
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3); ``_upscale_rgb_batch``
    of one image."""
    return _upscale_rgb_batch(net, rgba[None], add_mean)[0]


def _pad_edge(img: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(H, W, C) → (hp, wp, C), the last row and column repeated
    (``np.pad(mode="edge")``)."""
    rows = torch.arange(hp, device=img.device).clamp_(max=img.shape[0] - 1)
    cols = torch.arange(wp, device=img.device).clamp_(max=img.shape[1] - 1)
    return img[rows][:, cols]


def _valid_mean(stat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Mean of ``stat`` (Hp, Wp[, C]) over its top-left (h, w) region, per
    channel for a 3-d ``stat``: an f32 sum under the mask over h·w, as
    ``_luma_forward_padded`` / ``_rgb_forward_padded`` take it."""
    rows = torch.arange(stat.shape[0], device=stat.device)[:, None]
    cols = torch.arange(stat.shape[1], device=stat.device)[None, :]
    valid = (rows < h) & (cols < w)
    if stat.dim() == 3:
        valid = valid[..., None]
    total = torch.sum(torch.where(valid, stat, 0.0), dim=(0, 1), keepdim=stat.dim() == 3)
    return total / float(h * w)


def _upscale_bucketed(cfg: Config, net: Net, rgba: torch.Tensor, bucket: int) -> torch.Tensor:
    """``_upscale_luma_bucketed`` / ``_upscale_rgb_bucketed``: the image is
    edge-padded to multiples of ``bucket``, centred on the mean of its
    valid region, run through ``net`` padded, cropped to the unpadded
    output, and swapped onto the unpadded image. Valid-conv outputs
    inside the valid region read only valid pixels, so they equal the
    unpadded run's."""
    h, w = rgba.shape[0], rgba.shape[1]
    s = cfg.total_padding()
    padded = _pad_edge(rgba, -(-h // bucket) * bucket, -(-w // bucket) * bucket)
    if cfg.channels == 3:
        rgb = padded[..., :3].to(torch.float32) / 255.0
        mean = _valid_mean(rgb, h, w)
        y = net((rgb - mean)[None])[0, :h - s, :w - s]
        return swap_rgb(rgba, y + mean if cfg.zero_mean_target else y)
    luma = extract_luma(padded, normalize=True)
    mean = _valid_mean(torch.square(luma) if cfg.subtract_squared_mean else luma, h, w)
    y = net((luma - mean)[None, ..., None])[0, :h - s, :w - s, 0]
    return swap_luma(rgba, y + mean if cfg.zero_mean_target else y)


def _check_size(cfg: Config, h: int, w: int, what: str) -> None:
    shrink = cfg.total_padding()
    if h <= shrink or w <= shrink:
        raise ValueError(
            f"{what} {w}x{h} {'is' if what == 'image' else 'are'} not larger than the "
            f"model's receptive field ({shrink}+1 px per side)")


def _upload(params, arr: np.ndarray) -> torch.Tensor:
    # torch refuses to wrap read-only arrays (a decoded image may be one)
    return torch.as_tensor(np.require(arr, requirements=("C", "W")),
                           device=params[0]["w"].device)


def upscale_image(cfg: Config, params, rgba: np.ndarray, bucket: int = 0,
                  precision: str = "f32") -> np.ndarray:
    """Run the model over a decoded uint8 RGBA image; returns uint8 RGB.

    ``params`` is the layer list as torch tensors (``params_to_torch``);
    the image runs on their device, through the CUDA kernels on a card and
    their plain version on the CPU. A luma model (``channels: 1``)
    replaces Y inside the valid-conv window, an RGB model
    (``channels: 3``) all three channels; the border passes through.

    ``bucket`` > 0 runs the net on the image edge-padded to multiples of
    ``bucket`` (the JAX package's compile-reuse buckets; the results
    match the exact path). ``precision``: "f32" or "bf16" (the module's
    docstring).
    """
    _check_size(cfg, rgba.shape[0], rgba.shape[1], "image")
    img = _upload(params, rgba)
    net = SRCNN(params, precision)
    if bucket > 0:
        out = _upscale_bucketed(cfg, net, img, bucket)
    elif cfg.channels == 3:
        out = _upscale_rgb(net, img, add_mean=cfg.zero_mean_target)
    else:
        out = _upscale_luma(net, img, add_mean=cfg.zero_mean_target,
                            squared_mean=cfg.subtract_squared_mean)
    return out.cpu().numpy()


def upscale_batch(cfg: Config, params, rgbas: np.ndarray,
                  precision: str = "f32") -> np.ndarray:
    """Batched upscaling of same-sized uint8 RGBA images (S, H, W, 4) →
    uint8 RGB (S, H, W, 3): one upload, one conv-stack call over the
    batch (one fused launch, or one chain launch per layer), one
    readback. Each image's output equals ``upscale_image``'s."""
    if rgbas.ndim != 4 or rgbas.shape[0] == 0:
        raise ValueError(f"rgbas must be (S, H, W, 4), got shape {rgbas.shape}")
    _check_size(cfg, rgbas.shape[1], rgbas.shape[2], "images")
    imgs = _upload(params, rgbas)
    net = SRCNN(params, precision)
    if cfg.channels == 3:
        out = _upscale_rgb_batch(net, imgs, add_mean=cfg.zero_mean_target)
    else:
        out = _upscale_luma_batch(net, imgs, add_mean=cfg.zero_mean_target,
                                  squared_mean=cfg.subtract_squared_mean)
    return out.cpu().numpy()


def upscale_image_spatial(cfg: Config, params, rgba: np.ndarray, n_shards: int,
                          precision: str = "f32", devices=None) -> np.ndarray:
    """``upscale_image`` of one image with its rows split over ``n_shards``
    devices: halo-exchange spatial parallelism
    (``parallel.spatial.sharded_forward``), each band through
    ``SRCNN(params, precision)`` on its device (the fused kernel or the
    chain, f32 or bf16). The luma (or, for RGB, each channel's) mean is
    taken over the whole image; the image is bottom-padded with zeros to a
    multiple of ``n_shards`` and the padded rows' outputs are cut off
    before the swap, so the result is the single-device one.

    ``devices`` (default: ``parallel.available_devices`` of the
    parameters' device kind, every card, or the CPU named once per core)
    lists the devices the bands go to, the first holding the parameters
    and the image; it may name one card several times. The JAX function
    has no such argument: its mesh is ``jax.devices()``, and its tests'
    eight virtual CPU devices play the part a repeated device plays here.
    """
    from .parallel.mesh import available_devices, make_mesh
    from .parallel.spatial import sharded_forward

    if devices is None:
        devices = available_devices(params[0]["w"].device.type)
    if n_shards > len(devices):
        raise ValueError(f"--spatial-shard {n_shards} > {len(devices)} devices")
    h, w = rgba.shape[0], rgba.shape[1]
    shrink = cfg.total_padding()
    if (h - shrink) <= 0 or (w - shrink) <= 0:
        raise ValueError(f"image {w}x{h} smaller than the receptive field")
    pad_rows = (-h) % n_shards
    shard_rows = (h + pad_rows) // n_shards
    if shard_rows < shrink:
        raise ValueError(f"shard height {shard_rows} < receptive-field shrink {shrink}; "
                         f"use fewer shards for this image")
    mesh = make_mesh(n_data=1, n_spatial=n_shards, devices=devices[:n_shards])
    img = _upload(params, rgba)

    def net(x: torch.Tensor) -> torch.Tensor:
        # bottom-pad the rows to a multiple of the shards; the padded rows
        # feed only outputs past the valid region, cut off here
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad_rows))
        y = sharded_forward(mesh, params, x,
                            forward_fn=lambda p, band: SRCNN(p, precision)(band))
        return y[:, :h - shrink]

    if cfg.channels == 3:
        out = _upscale_rgb(net, img, add_mean=cfg.zero_mean_target)
    else:
        out = _upscale_luma(net, img, add_mean=cfg.zero_mean_target,
                            squared_mean=cfg.subtract_squared_mean)
    return out.cpu().numpy()
