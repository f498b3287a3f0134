"""The layer-list SRCNN model: plain f32 forward and the ``nn.Module``.

Counterpart of ``cnn_sr_tpu/models/srcnn.py`` (forward only; training
comes later). Each layer is a VALID stride-1 cross-correlation + bias,
with ReLU on every layer but the last. Weights stay HWIO
``(f, f, k, n)`` and activations NHWC at the public functions, as in the
JAX package; ``F.conv2d`` gets them as OIHW/NCHW.
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


def conv_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               relu: bool) -> torch.Tensor:
    """One layer on NHWC ``x`` with HWIO ``w`` (f, f, K, n) and ``b`` (n,)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    y = y.permute(0, 2, 3, 1)
    return torch.relu(y) if relu else y


def forward(params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, H−s, W−s, n_out), s = Σ(f−1), in strict f32."""
    last = len(params) - 1
    with strict_f32():
        for i, layer in enumerate(params):
            x = conv_layer(x, layer["w"], layer["b"], relu=i != last)
    return x.contiguous()


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
