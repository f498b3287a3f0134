"""Plain PyTorch version of both kernels (``csrc/fused_srcnn.cu`` and the
layer chain ``csrc/conv_layer.cu``).

A layer loop of ``F.conv2d`` in strict f32 (TF32 off for cuDNN and
matmuls). ``entry.fused_forward`` takes it for CPU tensors on either
route; the tests and ``chip_smoke.py`` hold each kernel against it on the
card. Nothing on the main path calls it with a CUDA tensor.
"""

from __future__ import annotations

import torch

from ...models.srcnn import forward


def fused_forward(params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) f32 → (N, H−s, W−s, n_out) f32, the kernels' math."""
    return forward(params, x)
