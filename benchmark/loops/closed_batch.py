"""``closed_batch``: one client calling ``api.upscale_batch`` back to back
on ``batch`` same-size ``h`` x ``w`` RGBA frames, each call on the next
batch of a pool of ``pool_batches`` batches made from the seed in set-up
and kept in host memory, as decoded frames are. ``sample_calls`` calls,
drawn from the seed, have their answers compared."""

from __future__ import annotations

import time

import numpy as np

from ..frames import seed64, sub_seed
from ..generators import Window, host_frames


class Loop:
    def __init__(self, mix: dict, program):
        self.mix, self.program = mix, program

    def setup(self, seed: int) -> None:
        m = self.mix
        self.batches = [host_frames(m["batch"], m["h"], m["w"], sub_seed(seed, 10, i),
                                    self.program.device)
                        for i in range(m["pool_batches"])]
        self.rng = np.random.default_rng([seed64(seed), 1])
        self.program.batch(self.batches[0])  # the mix's one shape
        self.program.sync()

    def window(self, seconds: float) -> Window:
        m, keep_n = self.mix, self.mix["sample_calls"]
        kept, ends = [], []
        win = Window(t0=time.perf_counter(), t_end=0.0)
        i = 0
        while time.perf_counter() - win.t0 < seconds:
            bi = i % len(self.batches)
            win.attempted += m["batch"]
            try:
                out = self.program.batch(self.batches[bi])
            except Exception as e:  # noqa: BLE001 — a failed call is a missing answer
                win.failed += m["batch"]
                win.errors.append(repr(e))
                i += 1
                continue
            ends.append(time.perf_counter())
            win.out_pixels += out.shape[0] * out.shape[1] * out.shape[2]
            win.frames.extend([(m["h"], m["w"])] * out.shape[0])
            # reservoir sample of the calls whose answers are compared
            if len(kept) < keep_n:
                kept.append((bi, out))
            else:
                j = int(self.rng.integers(0, i + 1))
                if j < keep_n:
                    kept[j] = (bi, out)
            i += 1
        win.t_end = time.perf_counter()
        thirds = [sum(1 for t in ends if win.t0 + k * seconds / 3 <= t < win.t0 + (k + 1) * seconds / 3)
                  for k in range(3)]
        win.counters = {"calls": i, "calls_by_third": thirds}
        for bi, out in kept:
            for s in range(out.shape[0]):
                win.samples.append((self.batches[bi][s], out[s], 1.0))
        return win
