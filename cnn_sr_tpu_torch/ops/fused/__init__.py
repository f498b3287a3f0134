"""The fused SRCNN conv stack: CUDA kernel, its plain version, its build."""

from .entry import fused_forward

__all__ = ["fused_forward"]
