"""``kaiming_normal``: PyTorch's ``kaiming_normal_`` (fan in, ReLU's gain
sqrt(2)) times ``scale``, biases zero: basicsr's
``default_init_weights(module_list, scale)``, which ESRGAN's and
Real-ESRGAN's RRDBNet applies to the convs of each dense block with scale
0.1. w is drawn from N(0, 2 / fan_in), fan_in = f·f·k.

``init_args``: ``scale`` (1 by default), one number or one a layer.
"""

from __future__ import annotations

import math

import numpy as np


def make(layers, seed: int, scale=1.0) -> list:
    rng = np.random.default_rng(seed)
    scales = scale if isinstance(scale, list) else [scale] * len(layers)
    if len(scales) != len(layers):
        raise ValueError(f"{len(scales)} scales for {len(layers)} layers")
    out = []
    for (f, k, n), s in zip(layers, scales):
        w = rng.standard_normal((f, f, k, n), dtype=np.float32)
        w *= np.float32(s * math.sqrt(2.0 / (f * f * k)))
        out.append((w, np.zeros(n, np.float32)))
    return out
