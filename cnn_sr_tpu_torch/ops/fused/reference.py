"""Plain PyTorch version of the fused kernel (``csrc/fused_srcnn.cu``).

A layer loop of ``F.conv2d`` in strict f32 (TF32 off for cuDNN and
matmuls). ``entry.fused_forward`` takes it for CPU tensors; the tests and
``chip_smoke.py`` hold the kernel against it on the card. Nothing on the
main path calls it with a CUDA tensor.
"""

from __future__ import annotations

import torch

from ...models.srcnn import forward


def fused_forward(params, x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) f32 → (N, H−s, W−s, n_out) f32, the kernel's math."""
    return forward(params, x)
