from .srcnn import SRCNN, conv_layer, forward

__all__ = ["SRCNN", "conv_layer", "forward"]
