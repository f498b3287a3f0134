"""``rrdbnet_basicsr``: basicsr's initialisation of ``RRDBNet``, as
Real-ESRGAN x4plus is built before training.

* The convs of every dense block (all but the first five and the last five
  layers of ``layers``): ``default_init_weights(scale=0.1)``, PyTorch's
  ``kaiming_normal_`` (fan in, ReLU's gain sqrt(2)) times 0.1, biases 0;
  w drawn from N(0, 2 / fan_in).
* Every other conv (conv_first, conv_body, conv_up1, conv_up2, conv_hr,
  conv_last): PyTorch's ``Conv2d`` default, w and b each drawn from
  U(−1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = f·f·k.

Layer by layer from one generator: w, then b where it is drawn. No
``init_args``.
"""

from __future__ import annotations

import math

import numpy as np


def make(layers, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if len(layers) < 21 or (len(layers) - 6) % 15:
        raise ValueError(f"an RRDBNet has 6 + 15·num_block layers; got {len(layers)}")
    dense = range(1, len(layers) - 5)
    out = []
    for i, (f, k, n) in enumerate(layers):
        fan_in = f * f * k
        if i in dense:
            w = rng.standard_normal((f, f, k, n), dtype=np.float32)
            w *= np.float32(0.1 * math.sqrt(2.0 / fan_in))
            b = np.zeros(n, np.float32)
        else:
            bound = np.float32(1.0 / math.sqrt(fan_in))
            w = (2 * rng.random((f, f, k, n), dtype=np.float32) - 1) * bound
            b = (2 * rng.random(n, dtype=np.float32) - 1) * bound
        out.append((w, b))
    return out
