"""``prescale_ms_per_mpix`` (ms/MPix): device time of the kernels, copies
and memsets launched inside the server's ``serve.pre_scale`` spans (the
bicubic pre-scale's upload, resize and readback), joined through the
launch's correlation id (``program_spans.launched_in_us``), per output
MPix completed. None without those spans or in a CPU rehearsal."""

from benchmark import program_spans


def read(ctx):
    if ctx.attributed is None or ctx.out_mpix <= 0 or not program_spans.has_spans(
            ctx.events, program_spans.PRE_SCALE):
        return None
    return program_spans.launched_in_us(ctx.events, program_spans.PRE_SCALE) / 1e3 / ctx.out_mpix
