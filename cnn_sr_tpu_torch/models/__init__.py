from .rrdbnet import RRDBNet
from .srcnn import (
    SRCNN,
    ReluBackpropGate,
    center_crop,
    conv_layer,
    conv_precision,
    forward,
    forward_activations,
    loss_sum,
    luma_mse_metrics,
    squared_error_sum,
)

__all__ = [
    "RRDBNet",
    "SRCNN",
    "ReluBackpropGate",
    "center_crop",
    "conv_layer",
    "conv_precision",
    "forward",
    "forward_activations",
    "loss_sum",
    "luma_mse_metrics",
    "squared_error_sum",
]
