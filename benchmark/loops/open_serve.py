"""``open_serve``: independent users. Requests are due at arrivals of
``rate_per_s`` to the server's ``DeviceWorker`` (no HTTP), each a photo of
one of ``sizes`` (equally often) from a pool of ``pool_per_size`` photos a
size, timed from its due time to its ``done`` event. Every seed gets the
same work: the same number of requests of each size and the same set of
gaps between arrivals, in another order; the photos' content differs."""

from __future__ import annotations

import math
import time

import numpy as np

from ..frames import seed64, sub_seed
from ..generators import StampedEvent, Window, host_frames


class Loop:
    def __init__(self, mix: dict, program):
        self.mix, self.program = mix, program

    def schedule(self, seed: int, seconds: float):
        """(due seconds, size index, pool index) of every request due in
        the window. The requests come in blocks of ``block``: each
        block's gaps are the exponential distribution's quantiles at
        (i + 0.5) / block over ``rate_per_s``, shuffled, and its sizes
        cycle through ``sizes``, shuffled, so every seed and every block
        gets the same work in another order."""
        m = self.mix
        n = max(1, int(round(m["rate_per_s"] * seconds)))
        block = m["block"]
        rng = np.random.default_rng([seed64(seed), 2])
        gaps, sizes = [], []
        for start in range(0, n, block):
            k = min(block, n - start)
            q = -np.log(1.0 - (np.arange(k) + 0.5) / k) / m["rate_per_s"]
            gaps.append(rng.permutation(q * (k / m["rate_per_s"]) / q.sum()))
            sizes.append(rng.permutation(np.arange(k) % len(m["sizes"])))
        gaps = np.concatenate(gaps) * (seconds / (n / m["rate_per_s"]))
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        picks = rng.integers(0, m["pool_per_size"], n)
        return due, np.concatenate(sizes), picks

    def setup(self, seed: int) -> None:
        m = self.mix
        self.pool = [host_frames(m["pool_per_size"], h, w, sub_seed(seed, 20, i),
                                 self.program.device)
                     for i, (h, w) in enumerate(m["sizes"])]
        self.seed = seed
        self.worker = self.program.worker(m)
        self.worker.start()
        # each size alone (bucketed), then in same-shape groups (batched)
        for k, imgs in enumerate(self.pool):
            for group in m["warm_groups"]:
                jobs = [self.program.job(imgs[g % len(imgs)]) for g in range(group)]
                for j in jobs:
                    self.worker.submit(j)
                for j in jobs:
                    j.done.wait()
                    if j.error is not None:
                        raise RuntimeError(f"warm-up of size {m['sizes'][k]}: {j.error!r}")
        self.program.sync()

    def window(self, seconds: float) -> Window:
        m = self.mix
        due, sizes, picks = self.schedule(self.seed, seconds)
        before = self.worker.snapshot()
        jobs = []
        win = Window(t0=time.perf_counter(), t_end=0.0)
        for d, k, p in zip(due, sizes, picks):
            t_due = win.t0 + d
            now = time.perf_counter()
            if t_due > now:
                time.sleep(t_due - now)
            job = self.program.job(self.pool[k][p])
            job.done = StampedEvent()
            try:
                self.worker.submit(job)
            except Exception as e:  # noqa: BLE001 — a refused request is a missing answer
                job.error = e
                job.done.set()
            win.lateness_s.append(time.perf_counter() - t_due)
            jobs.append((t_due, k, p, job))
        t_close = win.t0 + seconds
        for _, _, _, job in jobs:
            job.done.wait(timeout=max(0.0, t_close + m["grace_s"] - time.perf_counter()))
        after = self.worker.snapshot()
        self.worker.stop()
        self.worker.join(timeout=60)
        win.attempted = len(jobs)
        done_at = []
        for t_due, k, p, job in jobs:
            if job.done.is_set() and job.error is None and job.result is not None:
                win.latencies_s.append(job.done.t_set - t_due)
                done_at.append(job.done.t_set)
                h, w = job.result.shape[:2]
                win.out_pixels += h * w
                win.frames.append((h, w))
            else:
                win.failed += 1
                win.latencies_s.append(math.inf)
                if job.error is not None:
                    win.errors.append(repr(job.error))
        win.t_end = max(done_at) if len(done_at) == len(jobs) else time.perf_counter()
        win.counters = {key: after[key] - before[key] for key in ("ok", "rounds", "batched_jobs")}
        # the answers compared: a seeded sample, with a request of the
        # largest size in it
        rng = np.random.default_rng([seed64(self.seed), 3])
        chosen = set(rng.choice(len(jobs), size=min(m["sample_requests"], len(jobs)),
                                replace=False).tolist())
        largest = max(range(len(m["sizes"])), key=lambda i: m["sizes"][i][0] * m["sizes"][i][1])
        of_largest = [i for i, j in enumerate(jobs) if j[1] == largest]
        if of_largest and not any(jobs[i][1] == largest for i in chosen):
            chosen.add(of_largest[int(rng.integers(0, len(of_largest)))])
        for i in sorted(chosen):
            _, k, p, job = jobs[i]
            if job.result is not None:
                win.samples.append((self.pool[k][p], job.result, float(m["scale"])))
        return win
