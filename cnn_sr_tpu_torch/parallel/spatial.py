"""Spatial (halo-exchange) sharding: one image's rows over several devices.

Counterpart of ``cnn_sr_tpu/parallel/spatial.py``, the image-domain
analog of sequence parallelism: the H axis of an (N, H, W, C) image is
split into ``n_spatial`` bands over the mesh's ``"spatial"`` axis.
Valid convolutions need ``shrink = Σ(f − 1)`` rows below each band, so
each band takes its successor's top ``shrink`` rows (one device-to-device
copy, as JAX's one ``lax.ppermute``) and runs the whole stack on its
device: one exchange of ``shrink · W · C`` values a boundary, whatever
the depth. The last band has no successor and gets zeros; the rows
computed from them are cut off (the output has ``H − shrink`` valid rows
anyway).
"""

from __future__ import annotations

import contextlib

import torch

from ..models.srcnn import forward
from .data_parallel import replicate
from .mesh import Mesh


def sharded_forward(mesh: Mesh, params, x: torch.Tensor, forward_fn=None) -> torch.Tensor:
    """Run the model over NHWC ``x`` with its rows split over the mesh's
    "spatial" axis; returns the (N, H − shrink, W − shrink, C_out) output
    on the first device.

    Requires ``H % n_spatial == 0`` and a band height of at least the
    stack's shrink (so one neighbour's halo suffices). ``forward_fn(params,
    band)`` (default ``models.srcnn.forward``) runs on each band's device
    after the exchange; ``api.upscale_image_spatial`` passes the kernel
    route (``SRCNN``). The parameters are copied to each device once per
    call (a device named twice shares one copy); every band is launched
    before anything waits, so that bands on different cards overlap, each
    on its card's current stream."""
    if forward_fn is None:
        forward_fn = forward
    shrink = sum(layer["w"].shape[0] - 1 for layer in params)
    devs = mesh.spatial_devices
    n_spatial = len(devs)
    h = x.shape[1]
    if h % n_spatial != 0:
        raise ValueError(f"image height {h} not divisible by spatial axis {n_spatial}")
    rows = h // n_spatial
    if rows < shrink:
        raise ValueError(f"shard height {rows} smaller than receptive-field shrink {shrink}")
    copies = replicate(mesh, params)
    bands = [x[:, i * rows:(i + 1) * rows].to(d) for i, d in enumerate(devs)]
    outs = []
    for i, d in enumerate(devs):
        if i + 1 < n_spatial:
            halo = bands[i + 1][:, :shrink].to(d)
        else:
            halo = torch.zeros((x.shape[0], shrink) + tuple(x.shape[2:]), dtype=x.dtype,
                               device=d)
        guard = torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext()
        with guard:
            outs.append(forward_fn(copies[d], torch.cat([bands[i], halo], dim=1)))
    y = torch.cat([o.to(devs[0]) for o in outs], dim=1)
    return y[:, :h - shrink]
