"""Render trained filters as greyscale tile sheets.

The port's counterpart of ``tools/weights_visualize.py`` (the reference's
weights_visualize.py:23-126): for each layer, lay out its ``n_out ×
n_in`` filters as a grid of f×f tiles, min-max-normalized per filter, and
write ``weights<L>.png``; print the Σw² per layer, the reference's quick
overfitting indicator (weights_visualize.py:56-62). Pure numpy and Pillow
over the port's ``utils.params_io``: the same files and lines as the JAX
tool.

    python -m cnn_sr_tpu_torch.tools.weights_visualize -c cfg.json -p params.json -o out_dir

``--device`` is taken for a uniform command line; nothing runs on it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from PIL import Image

from ..utils.config import read_config
from ..utils.params_io import load_parameters_file
from . import add_device_flag, check_device

CELL_PADDING = 2


def filter_tile(w: np.ndarray) -> np.ndarray:
    """Min-max normalize one f×f filter to 0..255 greyscale."""
    lo, hi = float(w.min()), float(w.max())
    if hi > lo:
        norm = (w - lo) / (hi - lo)
    else:
        norm = np.full_like(w, 0.5)
    return (norm * 255.0).astype(np.uint8)


def layer_sheet(w: np.ndarray, scale: int) -> np.ndarray:
    """(f, f, k, n) weights → tile grid image (rows = n_out, cols = n_in)."""
    f, _, k, n = w.shape
    cell = f * scale + CELL_PADDING
    sheet = np.full((n * cell + CELL_PADDING, k * cell + CELL_PADDING), 32, np.uint8)
    for ni in range(n):
        for ki in range(k):
            tile = filter_tile(w[:, :, ki, ni])
            tile = np.kron(tile, np.ones((scale, scale), np.uint8))
            y = CELL_PADDING + ni * cell
            x = CELL_PADDING + ki * cell
            sheet[y : y + f * scale, x : x + f * scale] = tile
    return sheet


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cnn_sr_tpu_torch.tools.weights_visualize",
                                description="Visualize trained conv filters.")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--params", "-p", default=None,
                   help="parameters file (default: config's parameters_file)")
    p.add_argument("--out-dir", "-o", default=".")
    p.add_argument("--scale", type=int, default=8, help="pixels per weight cell")
    add_device_flag(p)
    args = p.parse_args(argv)
    check_device(p, args.device)

    cfg = read_config(args.config)
    params_path = args.params or cfg.parameters_file
    if not params_path:
        print("no parameters file given (and none in the config)")
        return 1
    params, epochs = load_parameters_file(params_path, cfg.layer_specs())
    print(f"parameters from '{params_path}' (epochs: {epochs})")

    os.makedirs(args.out_dir, exist_ok=True)
    for i, layer in enumerate(params):
        w = np.asarray(layer["w"])
        sum_sq = float((w ** 2).sum())
        print(f"layer {i + 1}: filters {w.shape}, sum(w^2) = {sum_sq:.6f}")
        sheet = layer_sheet(w, args.scale)
        out_path = os.path.join(args.out_dir, f"weights{i + 1}.png")
        Image.fromarray(sheet, "L").save(out_path)
        print(f"  -> {out_path} ({sheet.shape[1]}x{sheet.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
