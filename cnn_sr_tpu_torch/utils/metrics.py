"""Quality metrics: PSNR, and PSNR on the luma channel.

The port's copy of ``cnn_sr_tpu/utils/metrics.py``, on numpy as there.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two arrays of the same
    shape (float images in 0..peak, or uint8 with peak=255)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(((a - b) ** 2).mean())
    if mse == 0:
        return float("inf")
    return 10.0 * float(np.log10(peak * peak / mse))


def psnr_y(rgb_a: np.ndarray, rgb_b: np.ndarray) -> float:
    """PSNR on the Rec.601 luma of two uint8 RGB images."""
    def luma(img):
        px = np.asarray(img, dtype=np.float64)
        return 0.299 * px[..., 0] + 0.587 * px[..., 1] + 0.114 * px[..., 2]

    return psnr(luma(rgb_a), luma(rgb_b), peak=255.0)
