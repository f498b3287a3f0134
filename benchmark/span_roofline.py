"""A part of the model against its least time: the roofline share of the
device work launched inside one of the program's spans.

The cell's reference module states the part's least time as a function
``<part>_bound_ms(cfg, shape, precision) -> (ms, "operations" | "bytes")``
(``reference/rrdbnet.py``: ``trunk_bound_ms``, ``head_bound_ms``). Each
span of the program called ``span`` is charged the device time of every
kernel, copy and memset launched inside it on its thread, joined through
the launch's correlation id (as ``program_spans.launched_in_us``); its
bound is taken at the shape of the ``bench.api`` span that encloses it (the
call's images, as ``conv_roofline`` takes them). The share is the bounds'
sum over the device time's, in percent. All times are in microseconds.
"""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

from . import program_spans, trace


def _enclosing(spans_of_tid, starts, ts):
    """The span of one thread open at ``ts`` (spans of one name do not
    nest, so it is the latest to start), or None."""
    i = bisect.bisect_right(starts, ts) - 1
    if i >= 0 and spans_of_tid[i][0] <= ts <= spans_of_tid[i][1]:
        return spans_of_tid[i]
    return None


def per_span_us(events, span: str) -> list:
    """``[((tid, start, end), device µs)]`` of every span called ``span``
    that launched device work."""
    inside = program_spans.spans(events, (span,))
    starts = {tid: [s for s, _, _ in ss] for tid, ss in inside.items()}
    where = {}
    for e in events:
        if e.get("cat") in trace.LAUNCH_CATS and "correlation" in e.get("args", {}):
            tid = e.get("tid")
            if tid not in inside:
                continue
            hit = _enclosing(inside[tid], starts[tid], float(e["ts"]))
            if hit is not None:
                where[e["args"]["correlation"]] = (tid, hit[0], hit[1])
    us: dict = defaultdict(float)
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS and e.get("dur"):
            key = where.get(e.get("args", {}).get("correlation"))
            if key is not None:
                us[key] += float(e["dur"])
    return list(us.items())


def read(ctx, span: str, part: str):
    """The share of the part ``part`` (its reference's ``<part>_bound_ms``)
    in the spans called ``span``; None in a CPU rehearsal, without such
    spans (a program that records none) or without such a bound."""
    if ctx.attributed is None or not program_spans.has_spans(ctx.events, span):
        return None
    ref = importlib.import_module(f"benchmark.reference.{ctx.cell.config['reference']}")
    bound = getattr(ref, f"{part}_bound_ms", None)
    if bound is None:
        return None
    apis = program_spans.spans(ctx.events, ("bench.api",))
    api_starts = {tid: [s for s, _, _ in ss] for tid, ss in apis.items()}
    c = ctx.cell.config["channels"]
    bound_ms = device_us = 0.0
    for (tid, start, _), us in per_span_us(ctx.events, span):
        api = _enclosing(apis.get(tid, []), api_starts.get(tid, []), start)
        if api is None:
            continue
        s, h, w = (int(v) for v in api[2].split(":", 1)[1].split("x"))
        bound_ms += bound(ctx.cell.config, (s, h, w, c), ctx.cell.precision)[0]
        device_us += us
    if device_us <= 0:
        return None
    return 100.0 * bound_ms * 1e3 / device_us
