"""``copy_ms_per_mpix`` (ms/MPix): device memcpy time in the traced
window (the API's upload and readback, and in the server the pre-scale's
round trip) per output MPix completed."""


def read(ctx):
    if ctx.attributed is None or ctx.out_mpix <= 0 or ctx.attributed["copy_us"] <= 0:
        return None
    return ctx.attributed["copy_us"] / 1e3 / ctx.out_mpix
