"""Profiling: per-stage timing breakdown and an op-level device trace.

The port's counterpart of ``cnn_sr_tpu/profiling.py``, with its names,
signatures and printed format:

* ``StageProfiler`` times named pipeline stages (load, upscale, write,
  train loop, ...) on the host clock and prints a ranked percent
  breakdown. ``timed`` synchronises the device of a CUDA tensor output
  before it reads the clock (JAX's ``block_until_ready``).
  With ``profile_dir``, ``start_trace`` / ``stop_trace`` run a
  ``torch.profiler`` recording (CPU, and CUDA on a card) and write its
  Chrome trace there as ``<stamp>_<pid>.pt.trace.json.gz``, readable in
  Perfetto or ``chrome://tracing``.
* ``op_shares`` / ``report_op_shares`` rank device time by op from the
  newest such trace: on a card the device lanes, the events of ``cat``
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` (one lane a stream), so
  the hand-written kernels appear under their own names beside the
  copies; in a CPU-only trace the ``cpu_op`` events, as JAX takes the
  XLA CPU executor lanes on its CPU backend. Each op is charged its
  self time, so the shares add up to 100%.
* ``idle_share`` — the device's busy and idle time in a trace's window.
* ``print_device_memory`` — in-use, peak and limit of each CUDA device.
* ``span`` — the port's own spans at its layer boundaries (``api.*``,
  ``model.forward``, ``serve.*``; the stages above too): a
  ``torch.profiler.record_function`` while a ``torch.profiler`` records
  (the CLI's ``--profile``, a traced benchmark run), so they land in the
  same trace as the device's events, on its clock; otherwise a shared
  no-op that costs one flag read.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_SUFFIX = ".pt.trace.json.gz"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one layer's work, recorded as ``name`` in
    the trace of a ``torch.profiler`` that records now (on every thread
    it records); outside one, a shared no-op context that reads no clock
    and allocates nothing. ``name`` is a fixed string (no shape, no id), so
    a trace's readers sum the spans by name."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class StageProfiler:
    """Accumulates wall time per named stage; prints a ranked breakdown."""

    def __init__(self, enabled: bool = True, profile_dir: Optional[str] = None):
        self.enabled = enabled
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._trace_dir = profile_dir
        self._prof = None

    def start_trace(self):
        if self._trace_dir and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()

    def stop_trace(self):
        if self._prof is not None:
            import os

            prof, self._prof = self._prof, None
            prof.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            prof.export_chrome_trace(
                os.path.join(self._trace_dir, f"{stamp}_{os.getpid()}{TRACE_SUFFIX}"))

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Run ``fn`` and wait for its output under stage ``name``."""
        if not self.enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        with span(name):
            out = fn(*args, **kwargs)
            # a CUDA tensor may still be computing; numpy and CPU outputs are ready
            if getattr(out, "is_cuda", False):
                torch.cuda.synchronize(out.device)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        return out

    def report(self, log=print):
        """Ranked per-stage share, like profile.py's kernel breakdown."""
        if not self.enabled or not self.totals:
            return
        total = sum(self.totals.values())
        log("---- stage profile ----")
        for name, t in sorted(self.totals.items(), key=lambda kv: kv[1]):
            log(
                f"{t:8.4f}s ({t * 100 / total:5.2f}%) x{self.counts[name]:<5d} - {name}"
            )
        log(f"Total measured time: {total:.4f}s")


def _newest_trace(trace_dir: str):
    """The events of the newest trace ``stop_trace`` wrote under
    ``trace_dir``, or None."""
    import glob
    import gzip
    import json
    import os

    traces = glob.glob(os.path.join(trace_dir, "*" + TRACE_SUFFIX))
    if not traces:
        return None
    newest = max(traces, key=os.path.getmtime)
    with gzip.open(newest, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _device_lanes(events) -> dict:
    """{(pid, tid): [(ts, dur, name)]} of the device's op events: the
    CUDA lanes where the trace has any, else the CPU ops."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("dur")]
    cats = DEVICE_CATS if any(e.get("cat") in DEVICE_CATS for e in spans) else ("cpu_op",)
    lanes: dict = defaultdict(list)
    for e in spans:
        if e.get("cat") in cats:
            lanes[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["dur"]), e.get("name", "")))
    return lanes


def op_shares(trace_dir: str):
    """Aggregate per-op device time from the newest captured trace.

    The ranked per-kernel table of the reference (Kernel.cpp:108-116,
    profile.py:9-18) from the Chrome trace ``stop_trace`` wrote: "X"
    duration events on the device lanes (``_device_lanes``). Events on
    one lane may nest (CPU ops call CPU ops), so each op is charged its
    SELF time, with ``cnn_sr_tpu/profiling.py``'s stack walk, and the
    shares sum to 100%.

    Returns ``[(op_name, total_us, count)]`` ranked by time, or ``[]``
    if no trace file is found.
    """
    events = _newest_trace(trace_dir)
    if events is None:
        return []
    totals: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for lane_events in _device_lanes(events).values():
        lane_events.sort(key=lambda r: (r[0], -r[1]))
        self_time = [dur for _, dur, _ in lane_events]
        stack: list = []  # (end_ts, index), innermost open span last
        for i, (ts, dur, _name) in enumerate(lane_events):
            while stack and ts >= stack[-1][0] - 1e-9:
                stack.pop()
            if stack:
                self_time[stack[-1][1]] -= dur
            stack.append((ts + dur, i))
        for (_, _, name), st in zip(lane_events, self_time):
            totals[name] += max(st, 0.0)
            counts[name] += 1
    return sorted(
        ((n, t, counts[n]) for n, t in totals.items()),
        key=lambda row: -row[1])


def report_op_shares(trace_dir: str, log=print, top: int = 25):
    """Print the ranked per-op device-time table (reference profile.py UX)."""
    rows = op_shares(trace_dir)
    if not rows:
        log(f"(no profiler trace found under {trace_dir})")
        return
    total = sum(t for _, t, _ in rows)
    log("---- op profile (device time) ----")
    for name, t, cnt in rows[:top]:
        log(f"{t / 1e3:9.3f}ms ({t * 100 / total:5.2f}%) x{cnt:<6d} - {name}")
    rest = rows[top:]
    if rest:
        t = sum(r[1] for r in rest)
        log(f"{t / 1e3:9.3f}ms ({t * 100 / total:5.2f}%)         - "
            f"({len(rest)} more ops)")
    log(f"Total device op time: {total / 1e3:.3f}ms")


def idle_share(trace_dir: str) -> Optional[dict]:
    """The device's time in the newest trace, in µs: ``window`` (the
    profiler's whole recording), ``span`` (first device op's start to the
    last one's end), ``busy`` (the union of the device ops' intervals
    over every lane). Idle shares are ``1 - busy / window`` and
    ``1 - busy / span``. None without a trace or device ops."""
    events = _newest_trace(trace_dir)
    if events is None:
        return None
    spans = sorted((ts, ts + dur) for lane in _device_lanes(events).values()
                   for ts, dur, _ in lane)
    if not spans:
        return None
    busy, end = 0.0, -float("inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    window = [float(e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "Trace" and e.get("dur")]
    span = max(t1 for _, t1 in spans) - spans[0][0]
    return {"window": max(window) if window else span, "span": span, "busy": busy}


def print_device_memory(log=print, device="cuda"):
    """Per-device memory accounting — the counterpart of the reference's
    Context::print_app_memory_usage (Context.cpp:132-149): bytes in use
    and the peak (the caching allocator's tensors) and the card's total
    memory as the limit, for every CUDA device; the CPU (or a machine
    without a card) has no such accounting."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        log(f"[{torch.device(device)}] memory stats unavailable")
        return
    for i in range(torch.cuda.device_count()):
        in_use = torch.cuda.memory_allocated(i)
        peak = torch.cuda.max_memory_allocated(i)
        limit = torch.cuda.mem_get_info(i)[1]
        log(
            f"[cuda:{i}] device memory: {in_use / 1e6:.1f} MB in use, "
            f"peak {peak / 1e6:.1f} MB"
            + (f", limit {limit / 1e6:.1f} MB" if limit else "")
        )
