"""The layer-list SRCNN model: plain f32 forward, training loss, ``nn.Module``.

Counterpart of ``cnn_sr_tpu/models/srcnn.py``. Each layer is a VALID
stride-1 cross-correlation + bias, with ReLU on every layer but the
last. Weights stay HWIO ``(f, f, k, n)`` and activations NHWC at the
public functions, as in the JAX package; ``F.conv2d`` gets them as
OIHW/NCHW.

Training differentiates ``loss_sum`` with autograd over ``F.conv2d``
(cuDNN on the card), as the JAX package differentiates its XLA
convolutions: no kernel of its own lies on that path. ``ReluBackpropGate``
keeps the reference's last-layer quirk (last_layer_delta.cl:42-47): the
linear last layer's delta is gated by ``(y > 0)``. The hidden layers' ReLU
(``Relu``) passes half the incoming gradient at y = 0, as ``jnp.maximum``
does in the JAX package (the reference's hand-written deltas take 0 there).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def strict_f32():
    """Full-f32 convolutions and matmuls on CUDA. cuDNN runs f32
    convolutions in TF32 by default (about three decimal digits), which the
    JAX package rules out by pinning ``Precision.HIGHEST``. Only the TF32
    flags change: cuDNN stays enabled (``torch.backends.cudnn.flags``
    would also disable it, through its ``enabled=False`` default)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def conv_precision(precision=None):
    """The convolutions' precision on CUDA for the JAX trainer's
    ``precision`` names: None or ``"highest"`` is ``strict_f32`` (TF32
    off); ``"high"`` and ``"default"``, the MXU's reduced passes on the
    TPU, are TF32 convolutions and matmuls, the card's nearest
    counterpart; ``"bf16"`` (mixed precision, ``loss_sum``'s
    ``compute_dtype``) leaves the f32 ones strict. On the CPU every name
    computes plain f32."""
    if precision not in (None, "highest", "high", "default", "bf16"):
        raise ValueError(f"unknown training precision {precision!r}")
    if precision not in ("high", "default"):
        with strict_f32():
            yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def conv_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               relu: bool) -> torch.Tensor:
    """One layer on NHWC ``x`` with HWIO ``w`` (f, f, K, n) and ``b`` (n,)."""
    wt = w.permute(3, 2, 0, 1)
    if w.requires_grad and w.device.type == "cpu":
        # the CPU backward (slow_conv2d) refuses the channels-last weight
        # gradient that the permuted weight gets for a one-sample batch
        # into one output channel
        wt = wt.contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, b)
    y = y.permute(0, 2, 3, 1)
    if not relu:
        return y
    return Relu.apply(y) if y.requires_grad else torch.relu(y)


class Relu(torch.autograd.Function):
    """ReLU whose gradient at exactly 0 is half the incoming one, as that of
    the JAX package's ``jnp.maximum(y, 0.0)`` (``torch.relu``'s is 0; zero
    biases put a pixel there whenever a layer's whole input is 0). Saves
    the output, which the next layer saves anyway, and a bool mask of the
    ties (``torch.maximum`` would keep the input alive beside the output),
    and adds the ties' half in place: one more pass over the gradient than
    ``torch.relu``'s backward."""

    @staticmethod
    def forward(ctx, y):
        out = torch.relu(y)
        ctx.save_for_backward(out, y == 0)
        return out

    @staticmethod
    def backward(ctx, g):
        out, tie = ctx.saved_tensors
        return torch.ops.aten.threshold_backward(g, out, 0.0).addcmul_(g, tie, value=0.5)


def _stack(params, x: torch.Tensor) -> torch.Tensor:
    last = len(params) - 1
    for i, layer in enumerate(params):
        x = conv_layer(x, layer["w"], layer["b"], relu=i != last)
    return x


def forward(params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, H−s, W−s, n_out), s = Σ(f−1), in strict f32."""
    with strict_f32():
        return _stack(params, x).contiguous()


def forward_activations(params, x: torch.Tensor):
    """Every layer's output, in strict f32 (for tests and debugging)."""
    acts, last = [], len(params) - 1
    with strict_f32():
        for i, layer in enumerate(params):
            x = conv_layer(x, layer["w"], layer["b"], relu=i != last)
            acts.append(x)
    return acts


class ReluBackpropGate(torch.autograd.Function):
    """Identity whose backward multiplies the gradient by ``(y > 0)``:
    the reference's ReLU' on the linear last layer's delta
    (last_layer_delta.cl:42-47 against the SKIP_RELU forward)."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward((y > 0).to(y.dtype))
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return g * mask


def center_crop(gt: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Crop NHWC ground truth to the net output size at the symmetric
    offset ``(gt_w − out_w) // 2`` (last_layer_delta.cl:30-36)."""
    pad_h = (gt.shape[-3] - out_h) // 2
    pad_w = (gt.shape[-2] - out_w) // 2
    return gt[..., pad_h:pad_h + out_h, pad_w:pad_w + out_w, :]


def loss_sum(params, x: torch.Tensor, gt: torch.Tensor, precision=None,
             relu_gate: bool = True, compute_dtype=None) -> torch.Tensor:
    """``0.5 · Σ (y − crop(gt))²`` over pixels, channels and samples: the
    training loss whose gradient is the reference's raw-sum backprop.

    ``precision``: see ``conv_precision``; differentiate inside the same
    ``conv_precision`` so that the backward convolutions take it too.
    ``relu_gate=False`` (config ``last_layer_relu_gate``) drops the
    last-layer ReLU' quirk. ``compute_dtype=torch.bfloat16`` is mixed
    precision: the parameters and the input are cast to it for the
    forward and its backward, the output is cast back to f32 before the
    gate, the difference and the sum, so that the gradients reaching the
    f32 masters (through the casts) are f32.
    """
    if compute_dtype is not None:
        params = [{k: v.to(compute_dtype) for k, v in layer.items()} for layer in params]
        y = _stack(params, x.to(compute_dtype)).to(torch.float32)
    else:
        with conv_precision(precision):
            y = _stack(params, x)
    if relu_gate:
        y = ReluBackpropGate.apply(y)
    d = y - center_crop(gt, y.shape[-3], y.shape[-2])
    return 0.5 * torch.sum(d * d)


def squared_error_sum(y: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Validation metric: Σ (y − crop(gt))² over pixels and samples
    (squared_error.cl:63-91); the caller divides by the set's size."""
    d = y - center_crop(gt, y.shape[-3], y.shape[-2])
    return torch.sum(d * d)


def luma_mse_metrics(params, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Strict-f32 forward + squared-error sum, for validation batches."""
    with torch.no_grad():
        return squared_error_sum(forward(params, x), gt)


class SRCNN(nn.Module):
    """Inference model holding one layer list; ``forward`` runs the whole
    stack through ``ops.fused.fused_forward`` (the fused kernel or the
    layer chain, by shape) in ``precision`` ("f32" or "bf16"). The tensors
    are buffers, shared with the list it was built from."""

    def __init__(self, params, precision: str = "f32"):
        super().__init__()
        self.num_layers = len(params)
        self.precision = precision
        for i, layer in enumerate(params):
            self.register_buffer(f"w{i + 1}", layer["w"])
            self.register_buffer(f"b{i + 1}", layer["b"])

    def layers(self):
        return [{"w": getattr(self, f"w{i + 1}"), "b": getattr(self, f"b{i + 1}")}
                for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.fused import fused_forward

        return fused_forward(self.layers(), x, self.precision)
