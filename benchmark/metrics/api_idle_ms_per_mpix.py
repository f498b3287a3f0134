"""``api_idle_ms_per_mpix`` (ms/MPix): the device's idle time whose
midpoint lies inside one of the program's ``api.upscale_*`` spans, at any
depth (``program_spans.api_idle_us``), per output MPix completed: the
time the device waits on the API's host work, its pageable copies and
its synchronising readback. None without those spans (a program that
records none) or in a CPU rehearsal."""

from benchmark import program_spans


def read(ctx):
    if ctx.busy is None or ctx.out_mpix <= 0 or not program_spans.has_spans(
            ctx.events, program_spans.API):
        return None
    return program_spans.api_idle_us(ctx.events) / 1e3 / ctx.out_mpix
