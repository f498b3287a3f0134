"""What every traffic loop shares, and the lookup of a mix's loop by name.

A mix (``traffic/<name>.json``) is data: its ``loop`` key names the module
``loops/<loop>.py`` that drives the program with it, and the rest are that
loop's parameters. A loop module defines ``Loop(mix, program)`` with
``setup(seed)``, which makes the inputs from the seed and warms every shape
the mix sends, and ``window(seconds)``, which measures and returns a
``Window``. A new loop (bursts, training) is a new file there.
"""

from __future__ import annotations

import importlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .frames import make_frames


@dataclass
class Window:
    """What one measured window did. Times are ``perf_counter`` seconds."""
    t0: float
    t_end: float
    attempted: int = 0
    failed: int = 0
    out_pixels: int = 0          # output pixels of every frame returned
    frames: list = field(default_factory=list)   # (h, w) of each input returned, pre-scaled
    samples: list = field(default_factory=list)  # (input uint8 (H, W, 4), output, pre-scale)
    latencies_s: list = field(default_factory=list)
    lateness_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    errors: list = field(default_factory=list)


class StampedEvent(threading.Event):
    """An Event that notes when it was set (the job's completion)."""

    t_set = None

    def set(self):
        self.t_set = time.perf_counter()
        super().set()


def host_frames(n, h, w, seed, device) -> np.ndarray:
    return make_frames(n, h, w, seed, device).cpu().numpy()


def loop_for(mix: dict, program):
    """The mix's loop, ``loops/<mix["loop"]>.py``'s ``Loop``, on ``program``."""
    return importlib.import_module(f"benchmark.loops.{mix['loop']}").Loop(mix, program)
