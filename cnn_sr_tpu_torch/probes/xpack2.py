"""Sep against row-group-packed dots with a kernel's operand reads, on the tensor cores.

Counterpart of ``tools/xpack_probe2.py``. Where ``xpack`` times bare dots,
this probe reads its operands as a layer kernel would, at the RGB model's
L2–L4 widths: each step computes 96 output rows x 256 columns x n from a
shared operand, in 4 chunks of 24 rows.

* ``sep*`` (the shipped form): 3 row-shifted dots (dy) of K = 3k over the
  (98, 264, 3k) dx-concatenated operand, into n lanes;
* ``xpk*``: G = 4 rows packed into each lane group, ``ref[g, x, p·k + c] =
  act[4g + p, x, c]``, so the dy taps sit inside the banded weight and the
  3 dx taps are column offsets; each 128-lane output chunk j reads its own
  lane window: ``xpk32t32`` one 192-lane contraction, ``xpk32t32s`` the same
  split 128 + 64 (its own (6·128, 128) weight), ``xpk32t64o`` windows at
  lanes 0 and 64, ``xpk32t64d`` at 0 and 128 on a duplicated-slot operand,
  ``xpk64t64`` 256-lane windows at 0 and 128. The weights stack per (dx,
  j) at a row stride of 256 (128 in ``xpk32t32s``).

Each is a tap list of ``xpack.tap_gemm`` (``csrc/xpack.cu``): the chunks of
24 rows only partition the output rows, so a step is one tap list over
all 96 (or 24 packed) rows. The weights are the probe's random draws, not
banded; like the probe, this one times a pattern of dots.

    python -m cnn_sr_tpu_torch.probes.xpack2 [--device cuda|cpu] [--steps N]
                                              [--check] [--reps N] [--rounds N]

``--steps`` defaults to 85 (⌈1080·1920 / 24576⌉); the rest as in ``xpack``.
"""

from __future__ import annotations

import sys

from .xpack import Tap, TapList, Variant, draw, probe_main

OW = 256       # output columns a step (the probe's production tile_w)
CH = 24        # output rows a chunk
NCHUNK = 4     # chunks a step: 96 output rows
G = 4          # rows packed in a lane group
F = 3
ROWS = NCHUNK * CH   # 96
GROWS = ROWS // G    # 24 packed rows
CW = OW + 8          # operand columns


def _sep(name, k, n):
    taps = tuple(Tap(dy, 0, 0, F * k, F * k * dy) for dy in range(F))
    return Variant(name, (k, n), (ROWS + F - 1, CW, F * k), ((F * F * k, n),), (ROWS, OW, n),
                   TapList(ROWS, OW, n, taps))


def _xpk(name, pair, lanes_in, jslices, w_rows):
    """One 128-lane output chunk j a lane window (l0, width); the weight of
    (dx, j) at rows (dx·len(jslices) + j)·256 (``xpk_body`` :93)."""
    nj = len(jslices)
    taps = tuple(Tap(0, dx, l0, lw, (dx * nj + j) * 256, j)
                 for j, (l0, lw) in enumerate(jslices) for dx in range(F))
    return Variant(name, pair, (GROWS + 1, CW, lanes_in), ((w_rows, 128),),
                   (GROWS, OW, 128 * nj), TapList(GROWS, OW, 128, taps))


def _xpk32t32s():
    """The 192-lane contraction as 128 + 64, both into the one chunk, the
    weight of (dx, part) at rows (2 dx + part)·128 (``xpk32t32s_body`` :147)."""
    taps = tuple(Tap(0, dx, l0, lw, (2 * dx + si) * 128)
                 for dx in range(F) for si, (l0, lw) in enumerate(((0, 128), (128, 64))))
    return Variant("xpk32t32s", (32, 32), (GROWS + 1, CW, 192), ((6 * 128, 128),),
                   (GROWS, OW, 128), TapList(GROWS, OW, 128, taps))


# the probe's table (:119-144) with variants[2] replaced as it replaces it (:164)
VARIANTS = (
    _sep("sep32t32", 32, 32),
    _xpk("xpk32t32", (32, 32), 192, ((0, 192),), 3 * 256),
    _xpk32t32s(),
    _sep("sep32t64", 32, 64),
    _xpk("xpk32t64o", (32, 64), 192, ((0, 128), (64, 128)), 6 * 256),
    _xpk("xpk32t64d", (32, 64), 256, ((0, 128), (128, 128)), 6 * 256),
    _sep("sep64t64", 64, 64),
    _xpk("xpk64t64", (64, 64), 384, ((0, 256), (128, 256)), 6 * 256),
)


def probe_inputs() -> dict:
    """This probe's operands, drawn as it draws them (:167-171): per
    variant the operand, then the one weight array."""
    return draw(VARIANTS)


def main(argv=None) -> int:
    return probe_main(argv, "python -m cnn_sr_tpu_torch.probes.xpack2", VARIANTS,
                      probe_inputs(), f"{ROWS} x {OW} output positions")


if __name__ == "__main__":
    sys.exit(main())
