"""Full-training-state checkpointing: the ``--full-state`` sidecar.

Counterpart of ``cnn_sr_tpu/training/checkpoint.py``, writing and reading
the same file: the reference's only checkpoint is the parameters JSON,
and resuming from it resets the SGD momentum buffers and the shuffle RNG.
``save_full_state`` writes ``<params>.state.npz`` beside the parameters
file with the momentum buffers, the numpy ``Generator`` state, the epoch
counter and a SHA-1 of the weights; ``load_full_state`` restores them
when all match, so that an interrupted run equals a straight one. A
sidecar written by either package resumes in the other.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Optional, Tuple

import numpy as np


def sidecar_path(params_path: str) -> str:
    return params_path + ".state.npz"


def _params_digest(params) -> str:
    """SHA-1 over the weight/bias bytes — ties a sidecar to the exact
    params file it was saved with (epoch counters alone can collide when
    a file is retrained from scratch)."""
    import hashlib

    h = hashlib.sha1()
    for l in params:
        h.update(np.ascontiguousarray(l["w"], np.float32).tobytes())
        h.update(np.ascontiguousarray(l["b"], np.float32).tobytes())
    return h.hexdigest()


def save_full_state(params_path: str, state, rng: np.random.Generator) -> str:
    """Write momentum buffers + RNG state alongside ``params_path``."""
    path = sidecar_path(params_path)
    arrays = {}
    for i, l in enumerate(state.prev_delta):
        arrays[f"pd_w{i}"] = np.asarray(l["w"], np.float32)
        arrays[f"pd_b{i}"] = np.asarray(l["b"], np.float32)
    arrays["rng_state"] = np.frombuffer(
        json.dumps(rng.bit_generator.state).encode(), dtype=np.uint8)
    arrays["epochs"] = np.int64(state.epochs)
    arrays["params_sha1"] = np.frombuffer(
        _params_digest(state.params).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def load_full_state(params_path: str, state) -> Optional[np.random.Generator]:
    """If a sidecar exists and matches ``state`` (epoch counter, momentum
    shapes AND a digest of the loaded weights), restore the momentum
    buffers in place and return the restored RNG; else return None
    (fresh momentum/RNG, reference behavior). Corrupt or truncated
    sidecars are ignored, never fatal."""
    path = sidecar_path(params_path)
    if not os.path.isfile(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["epochs"]) != state.epochs:
                return None  # params file was swapped/retrained; don't mix
            if bytes(z["params_sha1"]).decode() != _params_digest(state.params):
                return None  # sidecar belongs to a different training run
            prev = []
            for i, l in enumerate(state.prev_delta):
                kw, kb = f"pd_w{i}", f"pd_b{i}"
                if (kw not in z or kb not in z
                        or z[kw].shape != l["w"].shape
                        or z[kb].shape != l["b"].shape):
                    return None
                prev.append({"w": z[kw], "b": z[kb]})
            rng_state = json.loads(bytes(z["rng_state"]).decode())
        rng = np.random.default_rng()
        rng.bit_generator.state = rng_state
    except (KeyError, ValueError, OSError, json.JSONDecodeError, TypeError,
            zipfile.BadZipFile, zlib.error):
        # np.load surfaces a killed-mid-write/truncated .npz as BadZipFile
        # (not an OSError subclass) and a corrupt member as zlib.error
        return None  # truncated/corrupt sidecar -> fresh momentum/RNG
    for dst, src in zip(state.prev_delta, prev):
        dst["w"] = src["w"]
        dst["b"] = src["b"]
    return rng
