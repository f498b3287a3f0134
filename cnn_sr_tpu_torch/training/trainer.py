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

Not ported: the JAX ``mesh`` argument (data parallelism goes to
``torch.distributed``) and the compiled-step cache (nothing is compiled
per shape here). Nothing is compiled with ``torch.compile``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models.srcnn import conv_precision, loss_sum, luma_mse_metrics
from ..optim import update_parameters
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


def make_train_step(cfg: Config, num_chunks: int = 1, precision=None) -> Callable:
    """The epoch step ``(params, prev_delta, inputs, gts) -> (params,
    prev_delta)``, updating both lists' tensors in place. ``inputs``,
    ``gts``: (T, H, W, C) on the parameters' device; the update divides
    by T (Main_cl.cpp:167-170)."""
    lrs = tuple(cfg.learning_rates)

    def step(params, prev_delta, inputs, gts):
        grads = _grads(params, inputs, gts, num_chunks, precision, cfg.last_layer_relu_gate)
        update_parameters(params, prev_delta, grads, lrs, cfg.momentum, cfg.weight_decay,
                          inputs.shape[0])
        return params, prev_delta

    return step


def make_multi_epoch_step(cfg: Config, num_chunks: int = 1, precision=None) -> Callable:
    """K epochs in one call: ``(params, prev, inputs, gts, train_idx[K,T],
    val_idx[K,V], do_val[K]) -> (params, prev, val_errs[K])``, the index
    tensors on the device and ``do_val`` a host list of bools. Each epoch
    gathers its split on the device; nothing waits on the device until
    the caller reads ``val_errs`` (a device tensor: the post-update
    validation squared error where ``do_val[k]``, else -1)."""
    step = make_train_step(cfg, num_chunks, precision)

    def multi(params, prev_delta, inputs, gts, train_idx, val_idx, do_val):
        errs = torch.full((len(do_val),), -1.0, dtype=torch.float32, device=inputs.device)
        for k, dv in enumerate(do_val):
            t_idx = train_idx[k]
            step(params, prev_delta, inputs[t_idx], gts[t_idx])
            if dv:
                v_idx = val_idx[k]
                errs[k] = luma_mse_metrics(params, inputs[v_idx], gts[v_idx])
        return params, prev_delta, errs

    return multi


def make_validation_fn() -> Callable:
    """Validation: total squared error over the set, a 0-d device tensor
    (execute_batch(false, ...), ConfigBasedDataPipeline.cpp:178-187)."""
    return luma_mse_metrics


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda: no CUDA device is available")
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
    precision=None,                 # None/"highest", "high", "default", "bf16"
    seed: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,  # overrides seed (resume)
    log: Callable[[str], None] = print,
    on_epoch: Optional[Callable[[int, Optional[float]], None]] = None,
    device="cuda",
) -> bool:
    """Run ``epochs`` epochs on ``device``, mutating ``state``. Returns
    True on error (a NaN or infinite validation error, Main_cl.cpp:179-184)."""
    dev = resolve_device(device)
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
    if mini_batch_count > 1:
        # the largest chunk count <= mini_batch_count dividing train_size
        for c in range(min(mini_batch_count, train_size), 0, -1):
            if train_size % c == 0:
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
        step_k = make_multi_epoch_step(cfg, num_chunks, precision)
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
            params, prev, errs = step_k(params, prev, inputs, gts, idx[:, :train_size],
                                        idx[:, train_size:], dv)
            errs = errs.cpu().numpy()  # the one read-back of these k epochs
            state.epochs += k
            for i in range(k):
                if report(epoch_id + i, float(errs[i]) if dv[i] else None):
                    error = True
                    break
            epoch_id += k
    else:
        step = make_train_step(cfg, num_chunks, precision)
        validate = make_validation_fn()
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
