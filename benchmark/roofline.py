"""Operations and bytes of a conv stack, and the card's published peaks.

``bound_ms`` is a frozen copy of ``chip_smoke.bound_ms``; ``stack_flops``
counts the same operations (2 x multiply-adds of the valid convolutions on
the unpadded image). They count a configuration whose reference module
defines no counts of its own: its ``layers`` as a stack of VALID
convolutions. A model of another shape (SAME padding, upsampling, dense
concatenations) counts its mathematics beside its plain statement, as
``flops(cfg, shape)`` and ``bound_ms(cfg, shape, precision)`` in its
``reference/<reference>.py`` (``core.Cell.flops``, ``core.Cell.bound_ms``),
which divides by the same peaks. Peaks: NVIDIA H100 SXM data sheet, dense.
"""

from __future__ import annotations

PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def stack_flops(layers, shape) -> int:
    """2 x multiply-adds of the stack on an (n, h, w, c) input; ``layers``
    is ``[(f, k, n_out), ...]``."""
    n, h, w, _ = shape
    flops = 0
    for f, k, m in layers:
        h, w = h - f + 1, w - f + 1
        flops += 2 * n * h * w * f * f * k * m
    return flops


def bound_ms(layers, shape, precision="f32", first=True, last=True) -> tuple:
    """The least time of the stack on this card: the larger of its
    operations over the peak of ``precision`` and its bytes over the
    memory rate. The bytes are the stack's input, weights, biases and
    output, each once, at their stored sizes: f32; in bf16, bf16 weights
    and f32 biases, and an input and output of f32 where the stack
    starts (``first``) or ends (``last``) the stream, else bf16."""
    n, h, w, c = shape
    flops = 0
    wb = 2 if precision == "bf16" else 4
    moved = (4 if precision == "f32" or first else 2) * n * h * w * c
    m = c
    for f, k, m in layers:
        h, w = h - f + 1, w - f + 1
        flops += 2 * n * h * w * f * f * k * m
        moved += wb * f * f * k * m + 4 * m
    moved += (4 if precision == "f32" or last else 2) * n * h * w * m
    t_ops, t_bytes = flops / PEAK_FLOPS[precision] * 1e3, moved / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
