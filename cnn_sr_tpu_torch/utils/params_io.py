"""Codec for the reference's JSON parameters file, and the bridge to torch.

The port's own copy of ``cnn_sr_tpu/utils/params_io.py`` (numpy only):
it reads and writes the same bytes. The file holds ``"layer<i>": {"weights": [...], "bias": [...]}``
with the weights flat in the reference's ``[f, f, k, n]`` order, ``n``
fastest (layer_uber_kernel.cl:3-12): HWIO, which the port keeps at its
public functions. ``params_to_torch`` carries a loaded list onto a device.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import Config, LayerSpec


class ParametersFileError(ValueError):
    """Raised when a parameters file is unreadable or shape-incompatible."""


Params = List[dict]  # [{"w": (f,f,k,n) f32 array, "b": (n,) f32 array}, ...]


def flat_to_hwio(flat: Sequence[float], f: int, k: int, n: int) -> np.ndarray:
    """Reshape the reference's flat weight list into HWIO ``(f, f, k, n)``."""
    arr = np.asarray(flat, dtype=np.float32)
    expected = f * f * k * n
    if arr.size != expected:
        raise ParametersFileError(
            f"weights size mismatch: got {arr.size}, expected {expected} "
            f"(f={f}, k={k}, n={n})"
        )
    return arr.reshape(f, f, k, n)


def hwio_to_flat(w: np.ndarray) -> np.ndarray:
    """Flatten an HWIO weight array back to the reference's order."""
    return np.asarray(w, dtype=np.float32).ravel()


def load_parameters_file(path: str, specs: Sequence[LayerSpec]) -> Tuple[Params, int]:
    """Load params for the given layer stack. Returns ``(params, epochs)``.

    Validates each layer's weight/bias sizes against the specs
    (LayerData.cpp:20-42); unknown keys are warned about and ignored
    (ConfigBasedDataPipeline.cpp:408-410).
    """
    with open(path, "r") as fh:
        try:
            raw = json.load(fh)
        except json.JSONDecodeError as e:
            raise ParametersFileError(f"could not parse '{path}': {e}") from e
    if not isinstance(raw, dict):
        raise ParametersFileError("parameters file root must be a JSON object")

    epochs = int(raw.get("epochs", 0))
    params: Params = []
    for i, spec in enumerate(specs):
        key = f"layer{i + 1}"
        if key not in raw:
            raise ParametersFileError(f"missing '{key}' in parameters file")
        node = raw[key]
        weights = node.get("weights")
        bias = node.get("bias")
        if weights is None or bias is None:
            raise ParametersFileError(f"'{key}' must contain 'weights' and 'bias'")
        w = flat_to_hwio(weights, spec.f, spec.n_in, spec.n_out)
        b = np.asarray(bias, dtype=np.float32)
        if b.size != spec.bias_size:
            raise ParametersFileError(
                f"'{key}' bias size mismatch: got {b.size}, expected {spec.bias_size}"
            )
        params.append({"w": w, "b": b})

    known = {"epochs"} | {f"layer{i + 1}" for i in range(len(specs))}
    for key in raw:
        if key not in known:
            print(f"[Warning] Unknown key '{key}' in parameters file")
    return params, epochs


def _fmt_floats(arr: np.ndarray) -> str:
    # round-trip-exact decimal per float32 value, comma-separated: the
    # native formatter ("%.9g") where the port's native library builds,
    # else repr(float(v)); both read back bit-exact
    values = np.asarray(arr, dtype=np.float32).ravel()
    from .. import native

    if native.available():
        return native.format_floats(values)
    return ", ".join(repr(float(v)) for v in values)


def save_parameters_file(path: str, params: Params, epochs: int = 0) -> None:
    """Write numpy params in the reference's file layout
    (ConfigBasedDataPipeline.cpp:432-465), byte for byte as the JAX
    package writes them."""
    chunks = ["{", f'  "epochs": {int(epochs)},', ""]
    for i, layer in enumerate(params):
        key = f"layer{i + 1}"
        chunks.append(f'  "{key}":{{')
        chunks.append(f'    "weights": [{_fmt_floats(hwio_to_flat(layer["w"]))}],')
        chunks.append(f'    "bias": [{_fmt_floats(layer["b"])}]')
        tail = "  }," if i + 1 < len(params) else "  }"
        chunks.append(tail)
    chunks.append("}")
    with open(path, "w") as fh:
        fh.write("\n".join(chunks))


def random_parameters(
    specs: Sequence[LayerSpec],
    distributions,
    seed: Optional[int] = None,
) -> Params:
    """Random-init weights/biases from per-layer normal distributions
    (fill_random_parameters, ConfigBasedDataPipeline.cpp:366-379). Draws
    the same numbers as the JAX package's ``random_parameters`` for the
    same seed."""
    rng = np.random.default_rng(seed)
    params: Params = []
    for spec, d in zip(specs, distributions):
        w = rng.normal(d.mean_w, d.sd_w, size=(spec.f, spec.f, spec.n_in, spec.n_out))
        if d.sd_b > 0:
            b = rng.normal(d.mean_b, d.sd_b, size=(spec.n_out,))
        else:
            b = np.full((spec.n_out,), d.mean_b)
        params.append({"w": w.astype(np.float32), "b": b.astype(np.float32)})
    return params


def init_params(cfg: Config, seed: Optional[int] = None) -> Tuple[Params, int]:
    """Load ``cfg.parameters_file`` if it exists, else random-init from
    ``seed`` (the parameter half of ``training.trainer.init_train_state``).
    Returns ``(params, epochs)``."""
    specs = cfg.layer_specs()
    if cfg.parameters_file and os.path.isfile(cfg.parameters_file):
        return load_parameters_file(cfg.parameters_file, specs)
    if cfg.parameters_file:
        print(f"[Warning] parameters file '{cfg.parameters_file}' not found, "
              "using random initialization")
    return random_parameters(specs, cfg.distributions, seed=seed), 0


def params_to_torch(params_np: Params, device) -> List[dict]:
    """``[{"w": (f,f,k,n), "b": (n,)}]`` numpy → the same list of f32,
    contiguous torch tensors on ``device``, still HWIO."""
    return [{k: torch.as_tensor(np.ascontiguousarray(layer[k], dtype=np.float32),
                                device=device).contiguous()
             for k in ("w", "b")}
            for layer in params_np]
