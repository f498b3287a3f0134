"""Reading the program's own spans in a card's trace.

The port records ``profiling.span``s at its layer boundaries while a
``torch.profiler`` records: ``api.upscale_batch`` / ``api.upscale_image``
/ ``api.upscale_image_spatial`` around each public call, ``api.upload``,
``api.pixels``, ``model.forward`` and ``api.readback`` inside it, and in
the server's worker ``serve.wait``, ``serve.gather``, ``serve.dispatch``
and ``serve.pre_scale``. A tree without them (an older program) gives no
such span, and the readers here return None for it.

Idle time is taken as ``trace.idle_gaps`` takes it: the gaps between the
merged busy intervals of the device's ops, each gap charged where its
midpoint lies, looking only at the threads that launched device work.
All times are in microseconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import trace

API = "api.upscale_"
SERVE = "serve."
PRE_SCALE = "serve.pre_scale"
PREFIXES = ("api.", "model.", "serve.")


def launching_threads(events) -> set:
    return {e.get("tid") for e in events if e.get("cat") in trace.LAUNCH_CATS}


def spans(events, prefixes=PREFIXES) -> dict:
    """``{tid: [(start, end, name)]}`` of the program's spans whose names
    start with one of ``prefixes``, sorted by start (outer first)."""
    out: dict = defaultdict(list)
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("dur") is not None
                and e.get("name", "").startswith(prefixes)):
            ts = float(e["ts"])
            out[e.get("tid")].append((ts, ts + float(e["dur"]), e["name"]))
    for v in out.values():
        v.sort(key=lambda s: (s[0], -s[1]))
    return out


def gaps(events) -> list:
    """``[(midpoint, length)]`` of the idle gaps between device ops."""
    merged = trace.busy_intervals(events)
    return [(0.5 * (a + b), b - a) for (_, a), (b, _) in zip(merged, merged[1:])]


def _stacks(thread_spans, mids) -> list:
    """For each of the sorted ``mids``, the names of the spans of one
    thread open there, outermost first (spans of a thread nest)."""
    out, stack, i = [], [], 0
    for m in mids:
        while i < len(thread_spans) and thread_spans[i][0] <= m:
            s, e, name = thread_spans[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            i += 1
        while stack and stack[-1][0] < m:
            stack.pop()
        out.append([name for _, name in stack])
    return out


def gap_stacks(events) -> list:
    """``[(length, [stack of span names on each launching thread that has
    one there])]`` for every idle gap, taken at its midpoint."""
    gs = sorted(gaps(events))
    mids = [m for m, _ in gs]
    launching = launching_threads(events)
    per_thread = [_stacks(ss, mids) for tid, ss in spans(events).items() if tid in launching]
    return [(length, [st[k] for st in per_thread if st[k]]) for k, (_, length) in enumerate(gs)]


def has_spans(events, prefix: str) -> bool:
    return any(e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix)
               for e in events)


def api_idle_us(events) -> float:
    """Idle time whose midpoint lies inside an ``api.upscale_*`` span."""
    return sum(length for length, stacks in gap_stacks(events)
               if any(n.startswith(API) for st in stacks for n in st))


def server_idle_us(events) -> float:
    """Idle time whose midpoint lies inside a ``serve.*`` span and inside
    no ``api.upscale_*`` span."""
    total = 0.0
    for length, stacks in gap_stacks(events):
        names = [n for st in stacks for n in st]
        if any(n.startswith(SERVE) for n in names) and not any(n.startswith(API) for n in names):
            total += length
    return total


def idle_by_span(events) -> list:
    """``[(innermost span name or "outside", µs)]``, the largest first:
    each gap charged to the innermost of the program's spans open at its
    midpoint (a span's self time), on the first launching thread that has
    one open there."""
    by: dict = defaultdict(float)
    for length, stacks in gap_stacks(events):
        by[stacks[0][-1] if stacks else "outside"] += length
    return sorted(by.items(), key=lambda kv: -kv[1])


def launched_in_us(events, name: str) -> float:
    """Device time of the kernels, copies and memsets launched inside a
    span called ``name`` on the launching thread, joined through the
    launch's correlation id."""
    inside = spans(events, (name,))
    starts = {tid: [s for s, _, _ in ss] for tid, ss in inside.items()}
    corr = set()
    for e in events:
        if e.get("cat") in trace.LAUNCH_CATS and "correlation" in e.get("args", {}):
            tid, ts = e.get("tid"), float(e["ts"])
            ss = inside.get(tid)
            if not ss:
                continue
            i = bisect.bisect_right(starts[tid], ts) - 1
            # spans of one name do not nest, so the latest start is the one
            if i >= 0 and ss[i][0] <= ts <= ss[i][1]:
                corr.add(e["args"]["correlation"])
    return sum(float(e["dur"]) for e in events
               if e.get("cat") in trace.DEVICE_CATS and e.get("dur")
               and e.get("args", {}).get("correlation") in corr)
