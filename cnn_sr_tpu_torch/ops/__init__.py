from .color import extract_luma, subtract_mean, swap_luma, swap_rgb
from .fused import fused_forward
from .image import load_image, write_image

__all__ = [
    "extract_luma",
    "subtract_mean",
    "swap_luma",
    "swap_rgb",
    "fused_forward",
    "load_image",
    "write_image",
]
