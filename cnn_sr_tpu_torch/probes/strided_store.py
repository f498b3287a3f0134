"""Strided loads and stores of the four parity quadrants, on the card.

Counterpart of ``tools/strided_store_probe.py``: for each parity quadrant
(p, q) of a (24, 256, 128) f32 block, ``out[p::2, q::2] = a[p::2, q::2] +
1``, four strided reads and four strided writes. On the TPU it asked
whether Mosaic lowers strided ref loads and stores, which decides whether
a Winograd layer can read and write the standard layout or needs the
parity planes. Here each quadrant is one launch of ``parity_copy``
(``csrc/parity_copy.cu``), whose strides are plain addresses.

    python -m cnn_sr_tpu_torch.probes.strided_store [--device cuda|cpu]

prints the probe's ``max_abs_err`` line and exits 0 only when the error
is exactly 0.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import layout

R, C, K = 24, 256, 128


def strided_roundtrip_plain(a: torch.Tensor) -> torch.Tensor:
    """``strided_roundtrip`` by the same four strided slices in PyTorch."""
    out = torch.empty_like(a)
    for p in range(2):
        for q in range(2):
            out[p::2, q::2] = a[p::2, q::2] + 1.0
    return out


def strided_roundtrip(a: torch.Tensor) -> torch.Tensor:
    """``out[p::2, q::2] = a[p::2, q::2] + 1`` for the four quadrants of a
    contiguous f32 or bf16 ``a`` of two or more dimensions: four
    ``parity_copy`` launches on CUDA tensors, its plain version on CPU
    tensors."""
    if a.dim() < 2 or not a.is_contiguous():
        raise ValueError(f"a must be contiguous with two or more dimensions, got "
                         f"{tuple(a.shape)}")
    out = torch.empty_like(a)
    for p in range(2):
        for q in range(2):
            layout.parity_copy(out[p::2, q::2], a[p::2, q::2], 1.0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.strided_store",
        description="Strided parity-quadrant loads and stores of a (24, 256, 128) f32 block.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    device = layout.device_of(args.device)
    a = np.random.default_rng(0).standard_normal((R, C, K)).astype(np.float32)
    out = strided_roundtrip(torch.from_numpy(a).to(device)).cpu().numpy()
    err = float(np.abs(out - (a + 1.0)).max())
    print(f"strided load+store roundtrip: max_abs_err={err}")
    return 0 if err == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
