"""The ``(data, spatial)`` device mesh.

Counterpart of ``cnn_sr_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` over ``jax.devices()`` with two named axes:

* ``"data"``: batch parallelism (``data_parallel``: the samples are split
  over the replicas and their raw-sum gradients are summed);
* ``"spatial"``: one image's rows split over devices with one halo
  exchange (``spatial``).

Here a mesh is a plain grid of ``torch.device``s in one process. Across
processes every process builds its own mesh over its own devices, and
``torch.distributed`` joins them (``multihost``). A mesh may name one
device more than once, as the JAX tests' virtual CPU devices share one
CPU: the shard and reduction logic then runs on one card, or on the
CPU, with a repeated device costing no copy.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch


class Mesh:
    """A ``(n_data, n_spatial)`` grid of devices: ``devices[i][j]`` is
    data replica ``i``'s ``j``-th spatial shard."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [list(row) for row in grid]
        self.shape = {"data": len(self.devices), "spatial": len(self.devices[0])}

    @property
    def data_devices(self) -> List[torch.device]:
        """The first device of each data replica."""
        return [row[0] for row in self.devices]

    @property
    def spatial_devices(self) -> List[torch.device]:
        """The devices of the first data replica's spatial shards."""
        return self.devices[0]


def available_devices(kind: str = "cuda") -> List[torch.device]:
    """Every card for ``"cuda"`` (a RuntimeError without one: never the
    CPU in its place); for ``"cpu"``, the CPU named ``os.cpu_count()``
    times, the counterpart of XLA's virtual CPU devices."""
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")] * (os.cpu_count() or 1)
    raise ValueError(f"unknown device kind {kind!r}")


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the current card's ``cuda:i``, so that devices compare."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(data, spatial)`` mesh over ``devices`` (default: every
    card). Defaults to all devices on the data axis. ``n_data *
    n_spatial`` must not exceed the device count; excess devices are left
    unused."""
    if devices is None:
        devices = available_devices("cuda")
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_spatial
    needed = n_data * n_spatial
    if needed > len(devices):
        raise ValueError(f"mesh {n_data}x{n_spatial} needs {needed} devices, "
                         f"only {len(devices)} available")
    if needed < 1:
        raise ValueError(f"mesh {n_data}x{n_spatial} has no device")
    return Mesh([devices[i * n_spatial:(i + 1) * n_spatial] for i in range(n_data)])
