"""The configurations' weights, in one of two forms, each pinned by a
SHA-256 in the configuration file (``weights_sha256``):

* a checkpoint: ``weights``, a path relative to the checkout, read by the
  benchmark's own JSON reader. It holds ``"layer<i>": {"weights": [...],
  "bias": [...]}`` with the weights flat in ``(f, f, k, n)`` order, ``n``
  fastest (HWIO); the digest is of the file's bytes;
* seeded: ``init``, the module ``inits/<init>.py`` that draws them on the
  host, with the configuration's own ``weights_seed`` and optional
  ``init_args``; the digest is ``digest`` of the arrays it made, so a
  changed init, or a numpy that draws differently, is refused as a
  changed checkpoint is.

A configuration gives exactly one of ``weights`` and ``init``. The seed is
the configuration's, not the run's: every run hands the same numpy arrays
to the program and to the reference.
"""

from __future__ import annotations

import hashlib
import importlib
import json
from pathlib import Path

import numpy as np


class WeightsError(ValueError):
    """The weights are missing, changed or of the wrong shape."""


def digest(arrays) -> str:
    """SHA-256 of every array's little-endian f32 bytes in order: w, then
    b, layer by layer."""
    h = hashlib.sha256()
    for w, b in arrays:
        for a in (w, b):
            h.update(np.ascontiguousarray(a, dtype="<f4").tobytes())
    return h.hexdigest()


def load(root: Path, cfg: dict) -> list:
    """``[(w (f, f, k, n) f32, b (n,) f32), ...]`` of the configuration
    ``cfg`` in the order of its ``layers``, from its checkpoint (relative
    to the checkout ``root``) or its init."""
    if ("weights" in cfg) == ("init" in cfg):
        raise WeightsError("a configuration gives exactly one of weights and init")
    return _seeded(cfg) if "init" in cfg else _checkpoint(root, cfg)


def _checkpoint(root: Path, cfg: dict) -> list:
    path = root / cfg["weights"]
    try:
        raw = path.read_bytes()
    except OSError as e:
        raise WeightsError(f"cannot read {cfg['weights']}: {e}") from e
    got = hashlib.sha256(raw).hexdigest()
    if got != cfg["weights_sha256"]:
        raise WeightsError(f"{cfg['weights']} has SHA-256 {got}, the configuration "
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


def _seeded(cfg: dict) -> list:
    init = importlib.import_module(f"benchmark.inits.{cfg['init']}")
    layers = [tuple(x) for x in cfg["layers"]]
    made = init.make(layers, int(cfg["weights_seed"]), **cfg.get("init_args", {}))
    out = [(np.asarray(w, dtype=np.float32), np.asarray(b, dtype=np.float32)) for w, b in made]
    if len(out) != len(layers):
        raise WeightsError(f"init {cfg['init']} made {len(out)} layers for {len(layers)}")
    for i, ((f, k, n), (w, b)) in enumerate(zip(layers, out)):
        if w.shape != (f, f, k, n) or b.shape != (n,):
            raise WeightsError(f"layer{i + 1}: weights {w.shape}, biases {b.shape} for "
                               f"f={f}, k={k}, n={n}")
    got = digest(out)
    if got != cfg["weights_sha256"]:
        raise WeightsError(f"init {cfg['init']} with seed {cfg['weights_seed']} made weights "
                           f"of SHA-256 {got}, the configuration pins {cfg['weights_sha256']}")
    return out
