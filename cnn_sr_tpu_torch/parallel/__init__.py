"""Parallelism: the ``(data, spatial)`` mesh, data-parallel gradients,
halo-exchange spatial sharding and the multi-process group."""

from .data_parallel import all_reduce_grads, replicate, shard_batch
from .mesh import Mesh, available_devices, make_mesh
from .multihost import initialize_multihost, process_count, shard_host_local_batch
from .spatial import sharded_forward

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "Mesh",
    "available_devices",
    "all_reduce_grads",
    "sharded_forward",
    "initialize_multihost",
    "process_count",
    "shard_host_local_batch",
]
