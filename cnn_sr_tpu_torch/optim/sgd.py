"""The reference's exact SGD + momentum + weight-decay update.

Counterpart of ``cnn_sr_tpu/optim/sgd.py`` (update_parameters.cl:17-32),
on torch tensors, with every quirk kept:

* ``delta_w = momentum · prev_delta_w + lr · grad_w + weight_decay · w``
  — weight decay sits INSIDE the momentum-tracked delta;
* the applied step is ``delta_w / batch_size`` (the gradients are raw
  sums over the train set), but ``prev_delta_w`` stores the undivided
  delta (update_parameters.cl:22-24);
* the bias gets no weight decay (update_parameters.cl:27-32);
* each layer has its own learning rate.

The update is in place, under ``torch.no_grad()``, on the f32 master
tensors, and each expression is taken in the JAX function's order with
the step multiplied by the f32 reciprocal of the batch size, as there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def init_optimizer_state(params):
    """Zero previous-delta buffers, one per weight/bias tensor."""
    return [{"w": torch.zeros_like(l["w"]), "b": torch.zeros_like(l["b"])} for l in params]


@torch.no_grad()
def update_parameters(params, prev_delta, grads, learning_rates: Sequence[float],
                      momentum: float, weight_decay: float, batch_size: int) -> None:
    """One optimizer step, in place on ``params`` and ``prev_delta``.

    ``batch_size`` is the train-set size of this epoch (the reference
    passes ``train_set.size()``, Main_cl.cpp:167-170)."""
    inv_bs = float(np.float32(1.0) / np.float32(batch_size))
    for layer, prev, grad, lr in zip(params, prev_delta, grads, learning_rates):
        delta_w = prev["w"] * momentum + grad["w"] * lr + layer["w"] * weight_decay
        delta_b = prev["b"] * momentum + grad["b"] * lr
        layer["w"].sub_(delta_w * inv_bs)
        layer["b"].sub_(delta_b * inv_bs)
        prev["w"].copy_(delta_w)
        prev["b"].copy_(delta_b)
