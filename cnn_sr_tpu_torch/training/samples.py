"""Training-sample discovery and loading.

Counterpart of ``cnn_sr_tpu/training/samples.py`` (Main_cl.cpp:132-149,
244-301):

* ``find_training_samples`` — pair ``<base>_large`` / ``<base>_small``
  (.jpg, .jpeg, .png) files by basename, warn on unpaired or non-sample
  files, and refuse a base that two files claim in one role;
* ``load_sample_set`` — decode both images, normalised luma (or RGB),
  mean-subtract the small input only, stack into (S, H, W, C) float32
  numpy arrays, which the trainer uploads once; the luma set of plain
  means goes through the native batch loader (``native.py``) where the
  port's native library builds;
* ``divide_samples`` — shuffle all samples each epoch, the first
  ``validation_size`` indices are the validation set (membership is
  reshuffled every epoch, as in the reference).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..ops.color import extract_luma, subtract_mean
from ..ops.image import load_image

_SAMPLE_EXTS = (".jpg", ".jpeg", ".png")


def find_training_samples(dir_path: str) -> List[Tuple[str, str]]:
    """Return (large_path, small_path) pairs found in ``dir_path``."""
    by_base = {}
    for name in sorted(os.listdir(dir_path)):
        path = os.path.join(dir_path, name)
        if not os.path.isfile(path):
            continue
        stem, ext = os.path.splitext(name)
        if ext.lower() not in _SAMPLE_EXTS:
            print(f"'{name}' is not a sample image. Skipping")
            continue
        if stem.endswith("_large"):
            role, base = "large", stem[: -len("_large")]
        elif stem.endswith("_small"):
            role, base = "small", stem[: -len("_small")]
        else:
            print(f"'{name}' is not a sample image. Skipping")
            continue
        node = by_base.setdefault(base, {})
        if role in node:
            # e.g. x_large.jpg and x_large.png: pairing either risks a stale file
            raise ValueError(
                f"ambiguous sample: both '{node[role]}' and '{path}' "
                f"claim {base}_{role}; remove one")
        node[role] = path

    pairs = []
    for base in sorted(by_base):
        node = by_base[base]
        if "large" not in node or "small" not in node:
            print(f"Only 1 image for pair with name '{base}'. Skipping sample")
            continue
        pairs.append((node["large"], node["small"]))
    return pairs


@dataclass
class SampleSet:
    """A loaded training set: zero-mean inputs and raw targets, both
    (S, H, W, C) float32 numpy arrays."""

    input_luma: np.ndarray     # mean-subtracted, normalized small-image luma
    expected_luma: np.ndarray  # normalized large-image luma (NOT mean-subtracted)
    width: int
    height: int

    @property
    def count(self) -> int:
        return self.input_luma.shape[0]

    @property
    def pixels_per_sample(self) -> int:
        return self.width * self.height


def load_sample_set(pairs: List[Tuple[str, str]], channels: int = 1,
                    zero_mean_target: bool = False,
                    squared_mean: bool = False) -> SampleSet:
    """Decode and preprocess all sample pairs into stacked arrays.

    ``channels=1``: normalized Rec.601 luma, the input mean-subtracted.
    ``channels=3``: normalized RGB, the input mean-subtracted per channel.
    Targets stay raw 0..1, or, with ``zero_mean_target``, become
    ``large − mean(small input)``. All samples share one size.
    """
    if not pairs:
        raise ValueError("no training samples found")

    # the native loader computes the plain mean; the squared-mean quirk
    # and the mean-relative targets take the per-image path
    if channels == 1 and not zero_mean_target and not squared_mean:
        native_set = _load_sample_set_native(pairs)
        if native_set is not None:
            return native_set

    inputs, expecteds = [], []
    shape = None
    for large_path, small_path in pairs:
        large = load_image(large_path)
        small = load_image(small_path)
        if large.shape[:2] != small.shape[:2]:
            raise ValueError(
                f"sample pair size mismatch: {large_path} {large.shape[:2]} vs "
                f"{small_path} {small.shape[:2]}"
            )
        if shape is None:
            shape = large.shape[:2]
        elif large.shape[:2] != shape:
            raise ValueError(
                f"all samples must share one size; got {large.shape[:2]} vs {shape}"
            )
        if channels == 1:
            raw = extract_luma(torch.from_numpy(small))[..., None]
            inp, in_mean = subtract_mean(raw, squared=squared_mean)  # input only
            inp = inp.numpy()
            exp = extract_luma(torch.from_numpy(large)).numpy()[..., None]
            if zero_mean_target:
                exp = exp - in_mean.numpy()
        else:
            inp = small[..., :3].astype(np.float32) / 255.0
            in_mean = inp.mean(axis=(0, 1), keepdims=True)
            inp = inp - in_mean
            exp = large[..., :3].astype(np.float32) / 255.0
            if zero_mean_target:
                exp = exp - in_mean
        inputs.append(inp)
        expecteds.append(exp)
    h, w = shape
    return SampleSet(
        input_luma=np.stack(inputs).astype(np.float32),
        expected_luma=np.stack(expecteds).astype(np.float32),
        width=w,
        height=h,
    )


def _load_sample_set_native(pairs: List[Tuple[str, str]]) -> Optional[SampleSet]:
    """The native batch loader (decode + luma + mean-subtract in C++,
    threaded). None where the library does not build or a file does not
    decode there, so that the caller takes the per-image path."""
    if not native.available():
        return None
    try:
        w, h = native.image_size(pairs[0][0])
        inp = native.load_sample_batch([p[1] for p in pairs], w, h,
                                       normalize=True, subtract_mean=True)
        exp = native.load_sample_batch([p[0] for p in pairs], w, h,
                                       normalize=True, subtract_mean=False)
    except IOError:
        return None
    return SampleSet(input_luma=inp[..., None], expected_luma=exp[..., None],
                     width=w, height=h)


def divide_samples(count: int, validation_size: int,
                   rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Per-epoch shuffle + split. Returns (train_idx, validation_idx)."""
    perm = rng.permutation(count)
    return perm[validation_size:], perm[:validation_size]
