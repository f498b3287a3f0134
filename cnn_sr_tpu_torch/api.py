"""High-level inference API: one image or a batch per call, on the model's
device.

Counterpart of ``cnn_sr_tpu/api.py``: ``upscale_image`` (exact shapes,
``_upscale_luma_jit`` / ``_upscale_rgb_jit``, or shape buckets,
``_upscale_luma_bucketed`` / ``_upscale_rgb_bucketed``) and
``upscale_batch`` (``_upscale_luma_batch_jit`` / ``_upscale_rgb_batch_jit``)
and ``upscale_image_spatial`` (one image's rows over several devices).
The uint8 images go to the device once and uint8 RGB comes back once; in
between, the color ops, the means, the conv stack and the swap all run on
the device, and no mean visits the host. On a card both copies go through
page-locked host memory a frame at a time (``_upload``, ``_readback``;
``TRANSFERS`` counts their bytes); the answer is a new array each call.

``precision="f32"`` (the default, as JAX's default ``use_pallas=False``
gives its XLA f32 forward) runs the conv stack in f32; ``"bf16"`` runs
the bf16 stream with the int8 first layer, the counterpart of
``use_pallas=True`` with its default precision.

A SAME model (``cfg.same``; the arch "rrdbnet": Real-ESRGAN x4plus, ``RRDBNet``)
takes the low-resolution image and returns it four times as wide and tall,
as Real-ESRGAN's ``RealESRGANer`` does: RGB/255 in f32, no mean, the net,
then clamp to 0..1, ×255 and round (``_upscale_x4_batch``); only
``upscale_batch`` and ``upscale_image`` without buckets take it, in bf16 on
a card (f32 on the CPU too).

Each public call is one ``profiling.span`` named after it
(``api.upscale_batch``, ``api.upscale_image``, ``api.upscale_image_spatial``)
around spans of its parts: ``api.upload``, ``api.pixels`` (the colour,
mean and pad work before the net, and the swap and stack after it),
``model.forward`` (``SRCNN.forward``) and ``api.readback``. They are
recorded only while a ``torch.profiler`` records.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .models.rrdbnet import RRDBNet
from .models.srcnn import SRCNN
from .ops.color import extract_luma, subtract_mean, swap_luma, swap_rgb
from .profiling import span
from .utils.config import Config

Net = Callable[[torch.Tensor], torch.Tensor]

# Bytes the public calls move between the caller's arrays and the device,
# by way: staged through page-locked host memory on a card (``pinned_in``,
# ``pinned_out``), or copied pageable (``pageable_in``, ``pageable_out``:
# on the CPU, and on a card where page-locked memory cannot be had).
TRANSFERS = {"pinned_in": 0, "pinned_out": 0, "pageable_in": 0, "pageable_out": 0}


def _upscale_luma_batch(net: Net, rgbas: torch.Tensor, add_mean: bool,
                        squared_mean: bool) -> list[torch.Tensor]:
    """uint8 RGBA (S, H, W, 4) → S uint8 RGB (H, W, 3) through ``net``, a
    function from (S, H, W, 1) to (S, H−s, W−s, 1) on the images' device,
    called once. Each image is centred on its own mean (E[luma²] with
    ``squared_mean``); ``add_mean``: the model predicts mean-relative luma
    (config ``zero_mean_target``), so the mean is added back."""
    with span("api.pixels"):
        centred = [subtract_mean(extract_luma(im, normalize=True), squared=squared_mean)
                   for im in rgbas]
        x = torch.stack([luma0 for luma0, _ in centred])[..., None]
    ys = net(x)
    del x  # as large as the batch: free it before the swap
    with span("api.pixels"):
        return [swap_luma(im, y + mean if add_mean else y)
                for im, y, (_, mean) in zip(rgbas, ys[..., 0], centred)]


def _upscale_luma(net: Net, rgba: torch.Tensor, add_mean: bool,
                  squared_mean: bool) -> torch.Tensor:
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3); ``_upscale_luma_batch``
    of one image."""
    return _upscale_luma_batch(net, rgba[None], add_mean, squared_mean)[0]


def _upscale_rgb_batch(net: Net, rgbas: torch.Tensor,
                       add_mean: bool) -> list[torch.Tensor]:
    """uint8 RGBA (S, H, W, 4) → S uint8 RGB (H, W, 3) through ``net``, a
    function from (S, H, W, 3) to (S, H−s, W−s, 3), called once: each
    image's per-channel mean is subtracted from its input and, with
    ``add_mean``, added back to its output. The RGB model has no
    squared-mean mode (the JAX package's RGB path ignores
    ``subtract_squared_mean`` too)."""
    with span("api.pixels"):
        rgbs = [im[..., :3].to(torch.float32) / 255.0 for im in rgbas]
        means = [torch.mean(rgb, dim=(0, 1), keepdim=True) for rgb in rgbs]
        x = torch.stack([rgb - mean for rgb, mean in zip(rgbs, means)])
    ys = net(x)
    del x  # as large as the batch: free it before the swap
    with span("api.pixels"):
        return [swap_rgb(im, y + mean if add_mean else y)
                for im, y, mean in zip(rgbas, ys, means)]


def _upscale_rgb(net: Net, rgba: torch.Tensor, add_mean: bool) -> torch.Tensor:
    """uint8 RGBA (H, W, 4) → uint8 RGB (H, W, 3); ``_upscale_rgb_batch``
    of one image."""
    return _upscale_rgb_batch(net, rgba[None], add_mean)[0]


def _upscale_x4_batch(net: Net, rgbas: torch.Tensor) -> list[torch.Tensor]:
    """uint8 RGBA (S, h, w, 4) → S uint8 RGB (4h, 4w, 3) through a SAME
    model ``net``, a function from (S, h, w, 3) to (S, 4h, 4w, 3), called
    once: RealESRGANer's pipeline, RGB/255 in f32 with no mean, then the
    output clamped to 0..1, ×255 and rounded (half to even). The alpha
    channel is dropped."""
    with span("api.pixels"):
        x = rgbas[..., :3].to(torch.float32).contiguous() / 255.0
    ys = net(x)
    del x  # free it before the output's own pass
    with span("api.pixels"):
        out = torch.round(torch.clamp(ys, 0.0, 1.0) * 255.0).to(torch.uint8)
    return list(out.unbind(0))


def _model(cfg: Config, params, precision: str):
    """The config's inference model over ``params``: ``RRDBNet`` for a SAME
    model (``cfg.same``: the arch "rrdbnet"), else ``SRCNN``."""
    return RRDBNet(params, precision) if cfg.same else SRCNN(params, precision)


def _valid_only(cfg: Config, what: str) -> None:
    """A SAME model on a path whose equal-to-exact guarantee needs VALID
    convolutions (buckets, bands): ValueError (ROADMAP #C5)."""
    if cfg.same:
        raise ValueError(f"{what} needs VALID convolutions; a {cfg.arch} model takes only "
                         "upscale_batch and upscale_image without buckets (ROADMAP #C5)")


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
    with span("api.pixels"):
        padded = _pad_edge(rgba, -(-h // bucket) * bucket, -(-w // bucket) * bucket)
        if cfg.channels == 3:
            rgb = padded[..., :3].to(torch.float32) / 255.0
            mean = _valid_mean(rgb, h, w)
            x = (rgb - mean)[None]
        else:
            luma = extract_luma(padded, normalize=True)
            mean = _valid_mean(torch.square(luma) if cfg.subtract_squared_mean else luma, h, w)
            x = (luma - mean)[None, ..., None]
    ys = net(x)
    del x  # as large as the batch: free it before the swap
    with span("api.pixels"):
        if cfg.channels == 3:
            y = ys[0, :h - s, :w - s]
            return swap_rgb(rgba, y + mean if cfg.zero_mean_target else y)
        y = ys[0, :h - s, :w - s, 0]
        return swap_luma(rgba, y + mean if cfg.zero_mean_target else y)


def _check_size(cfg: Config, h: int, w: int, what: str) -> None:
    if cfg.same:  # SAME convolutions: any image of at least 1 px
        if h < 1 or w < 1:
            raise ValueError(f"{what} {w}x{h} {'is' if what == 'image' else 'are'} smaller "
                             "than 1 px")
        return
    shrink = cfg.total_padding()
    if h <= shrink or w <= shrink:
        raise ValueError(
            f"{what} {w}x{h} {'is' if what == 'image' else 'are'} not larger than the "
            f"model's receptive field ({shrink}+1 px per side)")


def _pinned(shape) -> torch.Tensor | None:
    """A page-locked uint8 host tensor from torch's caching host allocator,
    which keeps its blocks between calls and hands one out again only
    after the copies recorded on it have run; None where page-locked
    memory cannot be had."""
    try:
        return torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    except RuntimeError:
        return None


def _stage(host: torch.Tensor, frame: np.ndarray) -> None:
    """Copy one frame of the caller's array into page-locked ``host`` in
    one pass: torch's multi-threaded copy, which gathers a strided frame as
    it goes, or numpy's where torch cannot wrap the array (read-only, as a
    decoded image may be, or with a negative stride)."""
    if frame.flags.writeable and min(frame.strides) >= 0:
        host.copy_(torch.from_numpy(frame))
    else:
        np.copyto(host.numpy(), frame)


def _upload(params, arr: np.ndarray) -> torch.Tensor:
    """The caller's uint8 array on the parameters' device. On a card it
    goes through page-locked memory a frame (a leading index of a batch;
    an image is one frame) at a time, each frame's copy to the device
    issued without blocking as soon as it is staged, so the host stages
    frame s+1 while frame s crosses the link. On the CPU, and where
    page-locked memory cannot be had, ``torch.as_tensor``'s copy."""
    device = params[0]["w"].device
    host = (_pinned(arr.shape) if device.type == "cuda" and arr.dtype == np.uint8
            else None)
    if host is None:
        TRANSFERS["pageable_in"] += arr.nbytes
        # torch refuses to wrap read-only arrays (a decoded image may be one)
        return torch.as_tensor(np.require(arr, requirements=("C", "W")), device=device)
    TRANSFERS["pinned_in"] += arr.nbytes
    out = torch.empty(arr.shape, dtype=torch.uint8, device=device)
    frames = zip(host, out, arr) if arr.ndim == 4 else [(host, out, arr)]
    for host_frame, frame, src in frames:
        _stage(host_frame, src)
        frame.copy_(host_frame, non_blocking=True)
    return out


def _readback(frames: list[torch.Tensor]) -> np.ndarray:
    """The uint8 (H, W, 3) answers, on one device, as one host array
    (S, H, W, 3) that owns its memory. On a card each frame's copy into a
    new page-locked tensor is issued without blocking and the call waits
    on the stream once, before the array is handed out; on the CPU, and
    where page-locked memory cannot be had, ``torch.stack`` and
    ``.cpu()``."""
    device = frames[0].device
    host = (_pinned((len(frames), *frames[0].shape)) if device.type == "cuda"
            else None)
    if host is None:
        out = torch.stack(frames).cpu().numpy()
        TRANSFERS["pageable_out"] += out.nbytes
        return out
    for host_frame, frame in zip(host, frames):
        host_frame.copy_(frame, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    TRANSFERS["pinned_out"] += host.nbytes
    return host.numpy()


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
    docstring). A SAME model returns uint8 RGB four times as wide and tall
    (``_upscale_x4_batch``) and takes no ``bucket``.
    """
    if bucket > 0:
        _valid_only(cfg, "upscale_image with a bucket")
    with span("api.upscale_image"):
        with span("api.upload"):
            _check_size(cfg, rgba.shape[0], rgba.shape[1], "image")
            img = _upload(params, rgba)
        net = _model(cfg, params, precision)
        if cfg.same:
            out = _upscale_x4_batch(net, img[None])[0]
        elif bucket > 0:
            out = _upscale_bucketed(cfg, net, img, bucket)
        elif cfg.channels == 3:
            out = _upscale_rgb(net, img, add_mean=cfg.zero_mean_target)
        else:
            out = _upscale_luma(net, img, add_mean=cfg.zero_mean_target,
                                squared_mean=cfg.subtract_squared_mean)
        with span("api.readback"):
            return _readback([out])[0]


def upscale_batch(cfg: Config, params, rgbas: np.ndarray,
                  precision: str = "f32") -> np.ndarray:
    """Batched upscaling of same-sized uint8 RGBA images (S, H, W, 4) →
    uint8 RGB (S, H, W, 3): one upload, one conv-stack call over the
    batch (one fused launch, or one chain launch per layer), one
    readback. Each image's output equals ``upscale_image``'s. A SAME model
    returns (S, 4H, 4W, 3) (``_upscale_x4_batch``)."""
    if rgbas.ndim != 4 or rgbas.shape[0] == 0:
        raise ValueError(f"rgbas must be (S, H, W, 4), got shape {rgbas.shape}")
    with span("api.upscale_batch"):
        with span("api.upload"):
            _check_size(cfg, rgbas.shape[1], rgbas.shape[2], "images")
            imgs = _upload(params, rgbas)
        net = _model(cfg, params, precision)
        if cfg.same:
            outs = _upscale_x4_batch(net, imgs)
        elif cfg.channels == 3:
            outs = _upscale_rgb_batch(net, imgs, add_mean=cfg.zero_mean_target)
        else:
            outs = _upscale_luma_batch(net, imgs, add_mean=cfg.zero_mean_target,
                                       squared_mean=cfg.subtract_squared_mean)
        with span("api.readback"):
            return _readback(outs)


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

    _valid_only(cfg, "upscale_image_spatial")
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

    def net(x: torch.Tensor) -> torch.Tensor:
        # bottom-pad the rows to a multiple of the shards; the padded rows
        # feed only outputs past the valid region, cut off here
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad_rows))
        y = sharded_forward(mesh, params, x,
                            forward_fn=lambda p, band: SRCNN(p, precision)(band))
        return y[:, :h - shrink]

    with span("api.upscale_image_spatial"):
        with span("api.upload"):
            img = _upload(params, rgba)
        if cfg.channels == 3:
            out = _upscale_rgb(net, img, add_mean=cfg.zero_mean_target)
        else:
            out = _upscale_luma(net, img, add_mean=cfg.zero_mean_target,
                                squared_mean=cfg.subtract_squared_mean)
        with span("api.readback"):
            return _readback([out])[0]
