"""The user tools on the port, each a counterpart of a script under ``tools/``:

    python -m cnn_sr_tpu_torch.tools.weights_visualize -c cfg.json -p params.json -o dir
    python -m cnn_sr_tpu_torch.tools.evaluate -c cfg.json -i pairs_dir [--pallas]
    python -m cnn_sr_tpu_torch.tools.generate_training_samples -i raw -o samples -s 128
    python -m cnn_sr_tpu_torch.tools.schedule_training -c cfg.json -i samples -e 5000
    python -m cnn_sr_tpu_torch.tools.profile -c cfg.json -i samples -e 100 [stage]
    python -m cnn_sr_tpu_torch.tools.serve_latency [--n-seq 40] [--no-pallas]

Each keeps its JAX script's flags and adds ``--device cuda|cpu`` (default
``cuda``, an error without a card).
"""

from __future__ import annotations

import argparse
import os

# the repository's root, where cnn_torch.py and configs/ live
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs on the card (the CUDA kernels), cpu their plain "
                   "version")


def check_device(p: argparse.ArgumentParser, device: str) -> None:
    """argparse's error for ``--device cuda`` on a machine without a card."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is available")
