"""The training loop: whole-epoch steps on the device, orchestrated from the host.

Counterpart of ``cnn_sr_tpu/training/trainer.py`` (Main_cl.cpp:161-195,
ConfigBasedDataPipeline.cpp:128-195, 325-361):

* an epoch is the gradient of ``models.loss_sum`` over the whole train
  split (a raw sum, optionally taken in ``mini_batch_count`` sequential
  chunks, which bounds activation memory), then one update with the
  reference's exact rule (``optim.update_parameters``, divided by the
  train split's size);
* a reshuffled validation split every epoch (``divide_samples``), the
  validation error every ``validation_cadence`` epochs and on the last,
  and an abort on a NaN or infinite error;
* the samples, parameters, momentum buffers and gradients stay on the
  device for the whole run; the samples are uploaded once;
* ``epochs_per_dispatch = K``: the host draws K epochs of
  ``divide_samples``, uploads them as one (K, T) index tensor, queues
  the K epochs without waiting, and reads the K validation errors back
  once, as the JAX package's scan over K epochs does.

``precision`` (the CLI's ``--train-precision``): None or ``"highest"``
is f32 with TF32 off; ``"high"`` and ``"default"`` are TF32 convolutions
on the card (``torch.backends.cudnn.allow_tf32``), its nearest
counterpart of the MXU's reduced passes, and plain f32 on the CPU;
``"bf16"`` is mixed precision (``loss_sum``'s ``compute_dtype``). The
validation forward is strict f32 in every mode.

``mesh`` (``parallel.make_mesh``): data parallelism. Each data replica
runs ``_grads`` on its contiguous chunk of the train split (in
``num_chunks`` chunks within the chunk, in the run's precision) on its
device, ``parallel.all_reduce_grads`` sums the raw-sum gradients on the
first replica's device (and across processes, where a process group is
up), and one update, divided by the GLOBAL split size, runs there; the
parameters live on the first device and are copied to the others each
step (a device the mesh names twice shares them). Validation sums the
replicas' squared errors. The counterpart of JAX's batch sharding with
XLA's gradient psum.

Not ported: the compiled-step cache (nothing is compiled per shape
here). Nothing is compiled with ``torch.compile``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models.srcnn import conv_precision, loss_sum, luma_mse_metrics
from ..optim import update_parameters
from ..parallel import all_reduce_grads, process_count, replicate, shard_batch
from ..utils.config import Config
from ..utils.params_io import init_params
from .samples import SampleSet, divide_samples


@dataclass
class TrainState:
    """Parameters + momentum buffers + the persistent epoch counter
    (the reference's ``epochs`` field, serialized in the params file).
    Numpy arrays between runs of ``train_loop``."""

    params: list
    prev_delta: list
    epochs: int = 0


def _grads(params, inputs, gts, num_chunks: int, precision=None, relu_gate: bool = True):
    """Raw-sum gradients of ``loss_sum`` over the batch, accumulated over
    ``num_chunks`` sequential chunks (the reference's mini-batch split,
    Main_cl.cpp:92-93,128); the caller guarantees divisibility.
    ``precision``: see the module docstring."""
    kw = {"relu_gate": relu_gate}
    if precision == "bf16":
        kw["compute_dtype"] = torch.bfloat16
    else:
        kw["precision"] = precision
    leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()} for layer in params]
    flat = [layer[k] for layer in leaves for k in ("w", "b")]
    chunk = inputs.shape[0] // max(num_chunks, 1)
    acc = None
    with conv_precision(precision):
        for c in range(max(num_chunks, 1)):
            sl = slice(c * chunk, (c + 1) * chunk)
            g = torch.autograd.grad(loss_sum(leaves, inputs[sl], gts[sl], **kw), flat)
            acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
    return [{"w": acc[2 * i], "b": acc[2 * i + 1]} for i in range(len(params))]


def _replica_grads(mesh, params, xs, ts, num_chunks: int, precision, relu_gate: bool):
    """``_grads`` of each data replica over its shard (``xs[i]``, ``ts[i]``
    on replica i's device), summed by ``all_reduce_grads`` on the first
    replica's device."""
    copies = replicate(mesh, params)
    return all_reduce_grads(mesh, [
        _grads(copies[d], x, t, num_chunks, precision, relu_gate)
        for d, x, t in zip(mesh.data_devices, xs, ts)])


def make_train_step(cfg: Config, num_chunks: int = 1, precision=None, mesh=None) -> Callable:
    """The epoch step ``(params, prev_delta, inputs, gts) -> (params,
    prev_delta)``, updating both lists' tensors in place. ``inputs``,
    ``gts``: (T, H, W, C) on the parameters' device; the update divides
    by T (Main_cl.cpp:167-170). With ``mesh`` (the parameters on its
    first device), the batch is split over its data replicas
    (``shard_batch``; or give the shards, ``shard_host_local_batch``'s)
    and T counts every process's samples."""
    lrs = tuple(cfg.learning_rates)
    relu_gate = cfg.last_layer_relu_gate

    def step(params, prev_delta, inputs, gts):
        if mesh is None:
            grads = _grads(params, inputs, gts, num_chunks, precision, relu_gate)
            count = inputs.shape[0]
        else:
            xs, ts = shard_batch(mesh, inputs), shard_batch(mesh, gts)
            grads = _replica_grads(mesh, params, xs, ts, num_chunks, precision, relu_gate)
            count = sum(x.shape[0] for x in xs) * process_count()
        update_parameters(params, prev_delta, grads, lrs, cfg.momentum, cfg.weight_decay, count)
        return params, prev_delta

    return step


def make_multi_epoch_step(cfg: Config, num_chunks: int = 1, precision=None,
                          mesh=None) -> Callable:
    """K epochs in one call: ``(params, prev, inputs, gts, train_idx[K,T],
    val_idx[K,V], do_val[K]) -> (params, prev, val_errs[K])``, the index
    tensors on the device and ``do_val`` a host list of bools. Each epoch
    gathers its split on the device; nothing waits on the device until
    the caller reads ``val_errs`` (a device tensor: the post-update
    validation squared error where ``do_val[k]``, else -1).

    With ``mesh``, ``inputs`` and ``gts`` are ``replicate(mesh, samples)``,
    the samples on each device (``train_loop`` uploads them once a run),
    and each replica gathers its contiguous part of each epoch's index
    rows from its device's copy."""
    step = make_train_step(cfg, num_chunks, precision, mesh)
    validate = make_validation_fn(mesh)

    def multi(params, prev_delta, inputs, gts, train_idx, val_idx, do_val):
        errs = torch.full((len(do_val),), -1.0, dtype=torch.float32,
                          device=params[0]["w"].device)
        if mesh is not None:
            devs = mesh.data_devices

            def gather(idx):
                parts = shard_batch(mesh, idx)
                return ([inputs[d][i] for d, i in zip(devs, parts)],
                        [gts[d][i] for d, i in zip(devs, parts)])
        else:
            def gather(idx):
                return inputs[idx], gts[idx]
        for k, dv in enumerate(do_val):
            step(params, prev_delta, *gather(train_idx[k]))
            if dv:
                errs[k] = validate(params, *gather(val_idx[k]))
        return params, prev_delta, errs

    return multi


def make_validation_fn(mesh=None) -> Callable:
    """Validation: total squared error over the set, a 0-d device tensor
    (execute_batch(false, ...), ConfigBasedDataPipeline.cpp:178-187).
    With ``mesh``, each data replica takes its part (``shard_batch``, or
    the shards themselves) and the errors are summed (``all_reduce_grads``)."""
    if mesh is None:
        return luma_mse_metrics

    def sharded(params, inputs, gts):
        copies = replicate(mesh, params)
        return all_reduce_grads(mesh, [
            luma_mse_metrics(copies[d], x, t)
            for d, x, t in zip(mesh.data_devices, shard_batch(mesh, inputs),
                               shard_batch(mesh, gts))])

    return sharded


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (``cuda`` with its index); a CUDA
    device without a card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def train_loop(
    cfg: Config,
    samples: SampleSet,
    state: TrainState,
    epochs: int,
    *,
    validation_percent: int = 20,   # hardcoded in the reference (Main_cl.cpp:92)
    mini_batch_count: int = 1,      # memory chunking; 2 in the reference (Main_cl.cpp:93)
    validation_cadence: int = 25,   # Main_cl.cpp:174
    epochs_per_dispatch: int = 1,   # >1: K epochs queued per host round trip
    mesh=None,                      # data parallelism over its replicas
    precision=None,                 # None/"highest", "high", "default", "bf16"
    seed: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,  # overrides seed (resume)
    log: Callable[[str], None] = print,
    on_epoch: Optional[Callable[[int, Optional[float]], None]] = None,
    device=None,
) -> bool:
    """Run ``epochs`` epochs on ``device`` (default: the first device of
    ``mesh``, else ``"cuda"``), mutating ``state``. Returns True on error
    (a NaN or infinite validation error, Main_cl.cpp:179-184). With
    ``mesh``, ``device`` must be its first device, and the train and
    validation splits must divide over its data replicas."""
    if device is None:
        device = mesh.data_devices[0] if mesh is not None else "cuda"
    dev = resolve_device(device)
    if mesh is not None and mesh.data_devices[0] != dev:
        raise ValueError(f"device {dev} is not the mesh's first device "
                         f"{mesh.data_devices[0]}")
    if rng is None:
        rng = np.random.default_rng(seed)
    s = samples.count
    validation_size = int(s * validation_percent / 100.0)
    train_size = s - validation_size
    if validation_size == 0:
        log("[WARNING] Validation set is empty")
    else:
        log(
            f"validation_set_size: {validation_size}/{s} = "
            f"{validation_size * 100.0 / s}%"
        )

    num_chunks = 1
    # each replica's share of the train split (the whole split without a mesh)
    local = train_size // (mesh.shape["data"] if mesh is not None else 1)
    if mini_batch_count > 1:
        # the largest chunk count <= mini_batch_count dividing the share
        for c in range(min(mini_batch_count, local), 0, -1):
            if local % c == 0:
                num_chunks = c
                break

    inputs = torch.from_numpy(np.ascontiguousarray(samples.input_luma)).to(dev)
    gts = torch.from_numpy(np.ascontiguousarray(samples.expected_luma)).to(dev)

    def upload(layers):
        return [{k: torch.from_numpy(np.array(layer[k], dtype=np.float32)).to(dev)
                 for k in ("w", "b")} for layer in layers]

    params, prev = upload(state.params), upload(state.prev_delta)

    def _is_val_epoch(e):
        return validation_size > 0 and ((e % validation_cadence) == 0 or e == epochs - 1)

    def report(epoch_id, val_err) -> bool:
        """Log one epoch's validation error; True if it is not finite."""
        if val_err is not None:
            # the reference aborts on NaN only; inf is as unrecoverable
            if not math.isfinite(val_err):
                log(f"Error: squared error is NAN/Inf, after {epoch_id}/{epochs} epochs")
                return True
            mean_err = val_err / validation_size
            log(f"[{epoch_id}] mean validation error: {mean_err} "
                f"({mean_err / samples.pixels_per_sample} per px)")
        if on_epoch is not None:
            on_epoch(epoch_id, val_err)
        return False

    error = False
    if epochs_per_dispatch > 1 and epochs > 1:
        step_k = make_multi_epoch_step(cfg, num_chunks, precision, mesh)
        # with a mesh, the samples go to each device once per run
        data = (inputs, gts) if mesh is None else (replicate(mesh, inputs),
                                                    replicate(mesh, gts))
        epoch_id = 0
        while epoch_id < epochs and not error:
            k = min(epochs_per_dispatch, epochs - epoch_id)
            t_rows, v_rows, dv = [], [], []
            for i in range(k):
                t_idx, v_idx = divide_samples(s, validation_size, rng)
                t_rows.append(t_idx)
                v_rows.append(v_idx)
                dv.append(_is_val_epoch(epoch_id + i))
            idx = torch.from_numpy(np.concatenate([np.stack(t_rows), np.stack(v_rows)], axis=1)
                                   .astype(np.int64)).to(dev)
            params, prev, errs = step_k(params, prev, *data, idx[:, :train_size],
                                        idx[:, train_size:], dv)
            errs = errs.cpu().numpy()  # the one read-back of these k epochs
            state.epochs += k
            for i in range(k):
                if report(epoch_id + i, float(errs[i]) if dv[i] else None):
                    error = True
                    break
            epoch_id += k
    else:
        step = make_train_step(cfg, num_chunks, precision, mesh)
        validate = make_validation_fn(mesh)
        for epoch_id in range(epochs):
            train_idx, val_idx = divide_samples(s, validation_size, rng)
            t_idx = torch.from_numpy(train_idx).to(dev)
            params, prev = step(params, prev, inputs[t_idx], gts[t_idx])
            state.epochs += 1  # ++epochs per update (ConfigBasedDataPipeline.cpp:360)
            val_err = None
            if _is_val_epoch(epoch_id):
                v_idx = torch.from_numpy(val_idx).to(dev)
                val_err = float(validate(params, inputs[v_idx], gts[v_idx]))
            if report(epoch_id, val_err):
                error = True
                break

    state.params = [{k: l[k].cpu().numpy() for k in ("w", "b")} for l in params]
    state.prev_delta = [{k: l[k].cpu().numpy() for k in ("w", "b")} for l in prev]
    return error


def init_train_state(cfg: Config, seed: Optional[int] = None) -> TrainState:
    """Fresh state: load ``cfg.parameters_file`` if set, else random init
    (ConfigBasedDataPipeline::init, ConfigBasedDataPipeline.cpp:32-52)."""
    params, epochs = init_params(cfg, seed=seed)
    prev_delta = [{"w": np.zeros_like(l["w"]), "b": np.zeros_like(l["b"])} for l in params]
    return TrainState(params=params, prev_delta=prev_delta, epochs=epochs)
