"""Multi-process data parallelism over ``torch.distributed``.

Counterpart of ``cnn_sr_tpu/parallel/multihost.py``. The JAX package
runs one process per host, ``jax.distributed.initialize`` joins them and
a mesh then spans every host's devices. Here every process builds a mesh
over its own devices (``mesh.make_mesh``), ``initialize_multihost``
joins the processes in a ``torch.distributed`` process group, and
``data_parallel.all_reduce_grads`` sums the gradients across it, so the
trainer's data-parallel step runs unchanged. Each process feeds only its
own samples (``shard_host_local_batch``), as many as every other
process; the update divides by the global count.

Nothing here names a cluster: give the address, the number of processes
and this process's rank, or set ``MASTER_ADDR``/``MASTER_PORT``,
``RANK`` and ``WORLD_SIZE`` (as ``torchrun`` does).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def process_count() -> int:
    """Ranks of the process group, 1 where none is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def default_backend(num_processes: int) -> str:
    """``nccl`` where every process on this host has a card of its own
    (``LOCAL_WORLD_SIZE``, else all ``num_processes`` on this host), else
    ``gloo``: NCCL refuses two ranks on one card."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> bool:
    """Join this process to the process group. Returns True if the group
    was (or already had been) initialized.

    ``coordinator_address`` is ``host:port`` of rank 0 (``init_method``
    ``tcp://host:port``); without it the ``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE`` variables serve (``env://``). A no-op
    returning False when neither arguments nor those variables are
    given. ``backend`` is the one argument the JAX function lacks (XLA
    picks its transport itself): ``None`` is ``default_backend``; pass
    ``"gloo"`` for several processes on one card or on the CPU."""
    import torch.distributed as dist

    given = coordinator_address is not None or num_processes is not None
    if not given and not any(v in os.environ for v in _ENV):
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend or default_backend(num_processes), init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def shard_host_local_batch(mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """This process's samples ``t`` as its share of the global batch: its
    contiguous chunks, one on each of its data replicas' devices (rank
    ``r``'s samples are global samples ``r·S .. (r+1)·S − 1``, as
    ``jax.make_array_from_process_local_data`` places them)."""
    from .data_parallel import shard_batch

    return shard_batch(mesh, t)
