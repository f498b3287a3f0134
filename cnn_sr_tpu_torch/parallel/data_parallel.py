"""Data parallelism: the batch split over the mesh's replicas, their
gradients summed.

Counterpart of ``cnn_sr_tpu/parallel/data_parallel.py``. There the batch
axis is sharded over the ``"data"`` axis, the parameters are replicated
and XLA inserts the gradient ``psum``: the replacement for the
reference's atomic gradient accumulation across its sample NDRange axis
(backpropagate.cl:110-112). Here each replica computes the raw-sum
gradient of its contiguous chunk of the batch on its device and
``all_reduce_grads`` sums them, in a fixed order, on the first replica's
device, then across processes where a process group is up
(``multihost``).

The sum is a sum, not a mean: the reference's loss is a raw sum and the
update divides by the GLOBAL train-split size (the trainer counts every
process's samples).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .mesh import Mesh
from .multihost import process_count


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of same-shaped trees of lists, tuples and
    dicts (a layer list ``[{"w": ..., "b": ...}, ...]``, for one)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *items) for items in zip(*trees))
    raise TypeError(f"not a tree of tensors: {type(first).__name__}")


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, in ``tree_map``'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def shard_batch(mesh: Mesh, t) -> List[torch.Tensor]:
    """The ``(S, ...)`` batch ``t`` as ``n_data`` contiguous chunks of its
    first axis, chunk ``i`` on replica ``i``'s device (a view where it
    already lies there). S must divide by ``n_data``. A list of
    per-replica shards (``multihost.shard_host_local_batch``'s) is
    returned as it is, as ``jax.device_put`` leaves a placed array."""
    devs = mesh.data_devices
    if isinstance(t, list):
        if len(t) != len(devs):
            raise ValueError(f"{len(t)} shards for {len(devs)} data replicas")
        return t
    s = t.shape[0]
    if s % len(devs):
        raise ValueError(f"batch of {s} does not divide over {len(devs)} data replicas")
    c = s // len(devs)
    return [t[i * c:(i + 1) * c].to(d) for i, d in enumerate(devs)]


def replicate(mesh: Mesh, tree) -> Dict[torch.device, object]:
    """A copy of ``tree`` (a layer list, say) on each distinct device of
    the mesh, keyed by device. ``.to`` leaves a tensor already on its
    device as it is, so a device the mesh names twice costs nothing, and
    the tree's own device gets the tree itself."""
    out: Dict[torch.device, object] = {}
    for row in mesh.devices:
        for d in row:
            if d not in out:
                out[d] = tree_map(lambda v, d=d: v.to(d), tree)
    return out


def all_reduce_grads(mesh: Mesh, grads_per_replica):
    """The sum of the replicas' gradient trees (one per data replica, each
    on its device) on the first replica's device: added in replica order
    (the counterpart of XLA's psum), then, where a process group of more
    than one rank is up, ``dist.all_reduce(SUM)`` over one flat buffer,
    which gives every rank the same bits."""
    dev = mesh.data_devices[0]
    acc = grads_per_replica[0]
    for g in grads_per_replica[1:]:
        acc = tree_map(lambda a, b: a + b.to(dev), acc, g)
    if process_count() > 1:
        import torch.distributed as dist

        leaves = tree_leaves(acc)
        flat = torch.cat([v.reshape(-1) for v in leaves])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        parts = iter(torch.split(flat, [v.numel() for v in leaves]))
        acc = tree_map(lambda v: next(parts).view_as(v), acc)
    return acc
