"""``latency_p95_ms.serve`` (ms): the 95th percentile of the latency of
every request due in the traced window, from its due time to its answer, a
failed request counting as infinite (then nothing is returned). In a cell
above the server's capacity the queue grows through the window, so this
tail is recorded beside the rate and judged by no bound."""

import math


def read(ctx):
    lat = sorted(ctx.win.latencies_s)
    if not lat:
        return None
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return p95 * 1e3 if math.isfinite(p95) else None
