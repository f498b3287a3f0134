"""Host-side image decode/encode (the pipeline's disk edges).

Counterpart of ``cnn_sr_tpu/ops/image.py``:

* ``load_image``  — decode to uint8 RGBA (H, W, 4);
* ``write_image`` — encode uint8 RGB (H, W, 3), PNG or JPEG by extension;
* ``write_greyscale_image`` — a float (H, W) array, min-max normalised to
  0..255, as a greyscale image (UtilsOpenCL.cpp:97-123).

Codecs, in the JAX package's order: the port's build of the native
library (libpng, libjpeg; ``native.py``), then Pillow, imported inside
the functions, for what the native library does not take or where it
does not build. ``codec()`` names the codec that serves. Where neither
can, the error names what is missing.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native


def codec() -> str:
    """The codecs that serve ``load_image`` and ``write_image`` here."""
    if native.available():
        return f"native ({os.path.basename(native.library_path())}: libpng, libjpeg)"
    lines = (native.build_error() or "unknown").strip().splitlines()
    why = next((ln.strip() for ln in lines if "error" in ln), lines[-1].strip())
    try:
        import PIL

        other = f"Pillow {PIL.__version__}"
    except ImportError:
        other = "none (Pillow is not installed)"
    return f"{other} (the native library did not build: {why})"


def _pillow(path: str, what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise IOError(
            f"cannot {what} '{path}': the native library (libpng, libjpeg) did not build "
            f"({native.build_error()}) and Pillow is not installed") from e
    return Image


def load_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGBA (H, W, 4)."""
    if native.available():
        try:
            return native.decode_rgba(path)
        except IOError:
            pass  # a format the native layer does not take -> Pillow
    Image = _pillow(path, "decode")
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def write_image(path: str, rgb: np.ndarray) -> None:
    """Encode a uint8 (H, W, 3) array; the format follows the extension."""
    arr = np.ascontiguousarray(rgb, dtype=np.uint8)
    lower = path.lower()
    if native.available():
        if lower.endswith(".png"):
            native.encode_png(path, arr)
            return
        if lower.endswith((".jpg", ".jpeg")):
            native.encode_jpeg(path, arr)
            return
    _pillow(path, "encode").fromarray(arr, mode="RGB").save(path)


def write_greyscale_image(path: str, data: np.ndarray) -> None:
    """Min-max-normalize a float array (H, W) to 0..255 greyscale and
    write it through Pillow, as the JAX package does (UtilsOpenCL.cpp:97-123)."""
    arr = np.asarray(data, dtype=np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi > lo:
        norm = (arr - lo) / (hi - lo)
    else:
        norm = np.full_like(arr, 0.5)
    grey = (norm * 255.0).astype(np.uint8)
    _pillow(path, "encode").fromarray(grey, mode="L").save(path)
