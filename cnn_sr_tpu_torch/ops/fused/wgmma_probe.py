"""One ``wgmma`` on the card by shared-memory matrix descriptors whose A
operand starts part way into a tile: ``wgmma_desc_probe`` in
``csrc/fused_wgmma.cu``.

The bf16 fused kernel reads every tap of a convolution as a descriptor
whose start is moved by ``dy·width + dx`` positions into an activation tile
(planes of 8 lanes, one 16-byte row a position: the no-swizzle core-matrix
layout). ``cases`` builds, for a start ``k``, the operand images of that
layout read as 64 raster rows and as an 8 x 8 patch of a tile row's width,
and of 128-byte swizzled rows (as a tensor copy writes them) read with the
matrix-base-offset field 0 and with it set to the start's row within the
swizzle's 1024-byte period; each with B K-major (the kernel's
``wgmma_kk``) and MN-major in the 64-byte swizzle
(``wgmma_m64n32k16_ss``). ``product`` runs one case on the card. The card
tests and ``chip_smoke.py`` hold each product against numpy's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import build

POSITIONS = 400  # of the A tile
WIDTH = 20  # a tile row, in positions: the 8 x 8 patch's row stride


class Case(NamedTuple):
    """One product: the A and B images (int16 bf16 bits, copied verbatim
    into shared memory), their descriptors (start in bytes from the
    image's base), B's major mode and the exact product (64 x 32)."""
    name: str
    a_img: np.ndarray
    b_img: np.ndarray
    desc_a: int
    desc_b: int
    b_kmajor: bool
    want: np.ndarray


def desc(off: int, lbo: int, sbo: int, swizzle: int = 0, base: int = 0) -> int:
    """A descriptor's fields: the start (bytes from the image's base), LBO,
    SBO, the matrix-base offset (bits 49-51) and the layout (bits 62-63: 0
    none, 1 the 128-byte swizzle, 2 the 64-byte)."""
    return (off >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32) | (base << 49) | (swizzle << 62)


def _bits(a) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).view(torch.int16).numpy()


def cases(k: int, seed: int = 0) -> list:
    """The cases at start ``k`` (positions into the tile), on small integer
    operands (exact in bf16 and in the f32 sums)."""
    rng = np.random.default_rng(seed + k)
    x = rng.integers(-3, 4, (POSITIONS, 16))
    bm = rng.integers(-3, 4, (16, 32))
    planes = _bits(x).reshape(POSITIONS, 2, 8).transpose(1, 0, 2)  # [plane][position][8]
    swizzled = np.zeros((POSITIONS, 8, 8), np.int16)  # [row][chunk ^ (row % 8)][8 lanes]
    lanes = _bits(np.pad(x, ((0, 0), (0, 48)))).reshape(POSITIONS, 8, 8)
    for r in range(POSITIONS):
        swizzled[r, np.arange(8) ^ (r % 8)] = lanes[r]
    b_k = _bits(bm).reshape(2, 8, 4, 8).transpose(0, 2, 3, 1)  # [kb][nb][n][k]
    b_m = np.zeros((16, 4, 8), np.int16)  # [k][chunk ^ (k / 2 % 4)][8 n]
    for r, row in enumerate(_bits(bm).reshape(16, 4, 8)):
        b_m[r, np.arange(4) ^ (r // 2 % 4)] = row
    raster = x[k:k + 64] @ bm
    patch = x[[k + m // 8 * WIDTH + m % 8 for m in range(64)]] @ bm
    out = []
    for b_name, b_img, desc_b, b_kmajor in (
            ("B K-major", b_k, desc(0, 4 * 128, 128), True),
            ("B MN-major 64-byte swizzle", b_m, desc(0, 0, 512, swizzle=2), False)):
        out += [
            Case(f"no swizzle, 64 raster rows, {b_name}", planes, b_img,
                 desc(16 * k, POSITIONS * 16, 128), desc_b, b_kmajor, raster),
            Case(f"no swizzle, 8x8 patch, {b_name}", planes, b_img,
                 desc(16 * k, POSITIONS * 16, WIDTH * 16), desc_b, b_kmajor, patch),
            Case(f"128-byte swizzle, base offset 0, {b_name}", swizzled, b_img,
                 desc(128 * k, 16, 1024, swizzle=1), desc_b, b_kmajor, raster),
            Case(f"128-byte swizzle, base offset {k % 8}, {b_name}", swizzled, b_img,
                 desc(128 * k, 16, 1024, swizzle=1, base=k % 8), desc_b, b_kmajor, raster)]
    return out


def product(case: Case, device) -> np.ndarray:
    """The case's 64 x 32 f32 product by one ``wgmma`` on ``device`` (a
    CUDA device). Raises RuntimeError where the launch is refused."""
    lib = build.load_library()
    a = torch.from_numpy(np.ascontiguousarray(case.a_img).view(np.uint8).reshape(-1)).to(device)
    b = torch.from_numpy(np.ascontiguousarray(case.b_img).view(np.uint8).reshape(-1)).to(device)
    d = torch.empty((64, 32), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.wgmma_desc_probe(a.data_ptr(), a.numel(), b.data_ptr(), b.numel(), case.desc_a,
                                   case.desc_b, int(case.b_kmajor), d.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("wgmma_desc_probe launch failed: "
                           + lib.cnn_sr_error_string(err).decode())
    return d.cpu().numpy()
