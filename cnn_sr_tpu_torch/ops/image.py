"""Host-side image decode/encode (the pipeline's disk edges).

Counterpart of ``cnn_sr_tpu/ops/image.py`` (``load_image``,
``write_image``), through Pillow only. Pillow is imported inside the
functions, so the rest of the port imports and runs where it is not
installed.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGBA (H, W, 4)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def write_image(path: str, rgb: np.ndarray) -> None:
    """Encode a uint8 (H, W, 3) array; the format follows the extension."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb, dtype=np.uint8), mode="RGB").save(path)
