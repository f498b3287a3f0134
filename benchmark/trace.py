"""Reading a ``torch.profiler`` Chrome trace of the measured window.

``device_lanes``, ``self_times`` and ``busy`` are frozen copies of the
arithmetic of ``cnn_sr_tpu_torch/profiling.py`` (``_device_lanes``, the
self-time walk of ``op_shares``, ``idle_share``), taking events instead of
a directory. ``attribute`` charges each device event to the span the host
was in when it launched it: the benchmark's own ``bench.net`` span around
the model's forward call and ``bench.api`` span around the API call
(``spans.py``), joined through the launch's correlation id. All times are
in microseconds.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def check_card_trace(events, frames_done: bool) -> None:
    """Raise where a card's trace cannot give the device metrics: it holds
    no kernel, or work was answered while no ``bench.net`` span was
    recorded (the profiler missed the thread that launched it)."""
    if not any(e.get("cat") == "kernel" and e.get("dur") for e in events):
        raise RuntimeError("the trace holds no kernel events: CUPTI recorded no device work")
    if frames_done and not any(e.get("cat") == "user_annotation"
                               and e.get("name", "").startswith("bench.net") for e in events):
        raise RuntimeError("the trace holds no bench.net span: the launching thread went unrecorded")


def device_lanes(events, cats=DEVICE_CATS) -> dict:
    """{(pid, tid): [(ts, dur, name)]} of the events of ``cats``: the
    card's kernels, copies and memsets (a CPU rehearsal passes
    ``("cpu_op",)`` for its breakdown)."""
    lanes: dict = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("dur") and e.get("cat") in cats:
            lanes[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["dur"]), e.get("name", "")))
    return lanes


def self_times(events, cats=DEVICE_CATS) -> list:
    """``[(op name, self µs, count)]`` over the device lanes, ranked."""
    totals: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for lane_events in device_lanes(events, cats).values():
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
    return sorted(((n, t, counts[n]) for n, t in totals.items()), key=lambda row: -row[1])


def busy_intervals(events, cats=DEVICE_CATS) -> list:
    """The union of the device ops' intervals over every lane, merged."""
    spans = sorted((ts, ts + dur) for lane in device_lanes(events, cats).values()
                   for ts, dur, _ in lane)
    merged: list = []
    for t0, t1 in spans:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def busy(events):
    """``{"window", "span", "busy"}``: the profiler's recording, first
    device op to last, and the union of the device ops; None without
    device ops."""
    merged = busy_intervals(events)
    if not merged:
        return None
    total = sum(t1 - t0 for t0, t1 in merged)
    window = [float(e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "Trace" and e.get("dur")]
    span = merged[-1][1] - merged[0][0]
    return {"window": max(window) if window else span, "span": span, "busy": total}


def _spans_by_thread(events, prefix):
    out: dict = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix):
            out[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for v in out.values():
        v.sort()
    return out


def _enclosing(spans_of_tid, ts):
    i = bisect.bisect_right(spans_of_tid, (ts, float("inf"), "")) - 1
    if i >= 0 and spans_of_tid[i][0] <= ts <= spans_of_tid[i][1]:
        return spans_of_tid[i]
    return None


def attribute(events) -> dict:
    """Device time by where it was launched from:
    ``{"net_us", "net_calls": [(api span name, device µs)], "copy_us",
    "other_kernel_us", "memset_us"}``. ``net_us`` is every device event
    launched inside a ``bench.net`` span; ``net_calls`` gives each such
    span's device time beside the ``bench.api`` span that encloses it;
    ``copy_us`` is every memcpy; ``other_kernel_us`` every kernel and
    memset launched outside ``bench.net``."""
    nets = _spans_by_thread(events, "bench.net")
    apis = _spans_by_thread(events, "bench.api")
    where: dict = {}  # correlation -> (net span, api span name)
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            ts = float(e["ts"])
            net = _enclosing(nets.get(e.get("tid"), []), ts)
            if net is not None:
                api = _enclosing(apis.get(e.get("tid"), []), ts)
                where[e["args"]["correlation"]] = (net, api[2] if api else None)
    per_net: dict = defaultdict(float)
    net_api: dict = {}
    out = {"net_us": 0.0, "copy_us": 0.0, "other_kernel_us": 0.0}
    for e in events:
        cat = e.get("cat")
        if cat not in DEVICE_CATS or not e.get("dur"):
            continue
        dur = float(e["dur"])
        if cat == "gpu_memcpy":
            out["copy_us"] += dur
        hit = where.get(e.get("args", {}).get("correlation"))
        if hit is not None:
            out["net_us"] += dur
            per_net[hit[0]] += dur
            net_api[hit[0]] = hit[1]
        elif cat != "gpu_memcpy":
            out["other_kernel_us"] += dur
    out["net_calls"] = [(net_api[k], v) for k, v in per_net.items()]
    return out


def _innermost(host) -> list:
    """Nested host events of one thread, ``[(start, end, name)]`` sorted,
    flattened into segments each named by its innermost event."""
    host.sort(key=lambda h: (h[0], -h[1]))
    segs, stack, cur = [], [], None
    for s, e, name in host:
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            segs.append((cur, end, nm))
            cur = end
        if stack:
            segs.append((cur, s, stack[-1][1]))
        stack.append((e, name))
        cur = s
    while stack:
        end, nm = stack.pop()
        segs.append((cur, end, nm))
        cur = end
    return [sg for sg in segs if sg[1] > sg[0]]


def idle_gaps(events, top: int = 10, cats=DEVICE_CATS) -> list:
    """The idle time between device ops, summed by what the host was
    doing at each gap's middle (the innermost host event there on a thread
    that launched device work, a benchmark span without its shape, or
    ``host idle``): ``[(name, seconds)]``, the largest first."""
    merged = busy_intervals(events, cats)
    launching = {e.get("tid") for e in events if e.get("cat") in LAUNCH_CATS}
    threads: dict = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("dur")
                and e.get("tid") in launching):
            threads[e.get("tid")].append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
    segs = [_innermost(h) for h in threads.values()]
    starts = [[sg[0] for sg in ss] for ss in segs]
    by_name: dict = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        name = "host idle"
        for ss, st in zip(segs, starts):
            i = bisect.bisect_right(st, mid) - 1
            if i >= 0 and ss[i][1] >= mid:
                name = ss[i][2].split(":")[0] if ss[i][2].startswith("bench.") else ss[i][2]
                break
        by_name[name] += (b - a) / 1e6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
