"""``server_idle_ms_per_mpix`` (ms/MPix): the device's idle time whose
midpoint lies inside one of the server worker's ``serve.*`` spans and
inside no ``api.upscale_*`` span (``program_spans.server_idle_us``): the
worker waiting for jobs, gathering a round, grouping and stacking, and
the pre-scale's round trip; per output MPix completed. None without
those spans or in a CPU rehearsal."""

from benchmark import program_spans


def read(ctx):
    if ctx.busy is None or ctx.out_mpix <= 0 or not program_spans.has_spans(
            ctx.events, program_spans.SERVE):
        return None
    return program_spans.server_idle_us(ctx.events) / 1e3 / ctx.out_mpix
