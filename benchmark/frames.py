"""Seeded frames with image-like structure.

``make_image`` is a frozen copy of ``chip_smoke.make_image`` (numpy, one
frame). ``make_frames`` draws the same kind of frame for a whole pool on
the device in a few large calls: the same smooth structure, shifted by a
phase drawn for each frame, plus Gaussian noise from a ``torch.Generator``
on that device.
"""

from __future__ import annotations

import numpy as np
import torch


def make_image(h: int, w: int, seed: int) -> np.ndarray:
    """Seeded RGBA frame: smooth structure plus noise (no Pillow needed)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (128 + 70 * np.sin(yy / 23.0) * np.cos(xx / 31.0)
            + 40 * np.sin((xx + yy) / 57.0) + rng.normal(0, 10, (h, w)))
    rgb = np.stack([base, 0.8 * base + 30, 255 - 0.9 * base], axis=-1)
    rgba = np.concatenate([np.clip(rgb, 0, 255).astype(np.uint8),
                           np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return rgba


def seed64(seed: int) -> int:
    """Any whole number as a seed that numpy and torch both take."""
    return int(seed) % (1 << 63)


def sub_seed(seed: int, *keys: int) -> int:
    """A seed for part ``keys`` of the run of ``seed``, unrelated to the
    seeds of other runs' parts (``seed + i`` would share frames between
    the runs of neighbouring seeds)."""
    state = np.random.SeedSequence([seed64(seed), *keys]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def make_frames(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """uint8 RGBA (n, h, w, 4) on ``device``: ``make_image``'s structure,
    each frame shifted by its own seeded phase, with N(0, 10) noise."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed64(seed))
    phase = torch.rand((n, 3, 1, 1), generator=gen, device=device) * 360.0
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    base = (128 + 70 * torch.sin((yy + phase[:, 0]) / 23.0) * torch.cos((xx + phase[:, 1]) / 31.0)
            + 40 * torch.sin((xx + yy + phase[:, 2]) / 57.0)
            + 10 * torch.randn((n, h, w), generator=gen, device=device))
    rgb = torch.stack([base, 0.8 * base + 30, 255 - 0.9 * base], dim=-1)
    rgba = torch.cat([torch.clamp(rgb, 0, 255).to(torch.uint8),
                      torch.full((n, h, w, 1), 255, dtype=torch.uint8, device=device)], dim=-1)
    return rgba
