"""``idle_share`` (%): 1 - busy / window, busy the union of kernel,
memcpy and memset events over every device lane, window the profiler's
recording of the measured window (``trace.busy``)."""


def read(ctx):
    if not ctx.busy or ctx.busy["window"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy["busy"] / ctx.busy["window"])
