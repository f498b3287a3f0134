"""The configurations' weights: the repo's trained checkpoints, read by
the benchmark's own JSON reader and pinned by their SHA-256.

A checkpoint holds ``"layer<i>": {"weights": [...], "bias": [...]}`` with
the weights flat in ``(f, f, k, n)`` order, ``n`` fastest (HWIO). The same
numpy arrays go to the program and to the reference.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np


class WeightsError(ValueError):
    """The checkpoint is missing, changed or of the wrong shape."""


def load(root: Path, cfg: dict) -> list:
    """``[(w (f, f, k, n) f32, b (n,) f32), ...]`` of the configuration
    ``cfg`` (its ``weights`` path, relative to the checkout ``root``, and
    ``weights_sha256``)."""
    path = root / cfg["weights"]
    try:
        raw = path.read_bytes()
    except OSError as e:
        raise WeightsError(f"cannot read {cfg['weights']}: {e}") from e
    digest = hashlib.sha256(raw).hexdigest()
    if digest != cfg["weights_sha256"]:
        raise WeightsError(f"{cfg['weights']} has SHA-256 {digest}, the configuration "
                           f"pins {cfg['weights_sha256']}")
    doc = json.loads(raw)
    out = []
    for i, (f, k, n) in enumerate(cfg["layers"]):
        node = doc[f"layer{i + 1}"]
        w = np.asarray(node["weights"], dtype=np.float32)
        b = np.asarray(node["bias"], dtype=np.float32)
        if w.size != f * f * k * n or b.size != n:
            raise WeightsError(f"layer{i + 1}: {w.size} weights, {b.size} biases for "
                               f"f={f}, k={k}, n={n}")
        out.append((w.reshape(f, f, k, n), b))
    return out
