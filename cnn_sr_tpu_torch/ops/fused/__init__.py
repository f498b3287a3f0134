"""The SRCNN conv stack on the card: the fused 3-layer kernel, the layer
chain, their routing, their plain version and their build."""

from .entry import fused_forward

__all__ = ["fused_forward"]
