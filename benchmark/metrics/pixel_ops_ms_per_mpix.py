"""``pixel_ops_ms_per_mpix`` (ms/MPix): device kernel and memset time
launched outside the model's forward call (colour ops, resize, the stack
and pad of the API), without copies, per output MPix completed."""


def read(ctx):
    if ctx.attributed is None or ctx.out_mpix <= 0 or ctx.attributed["other_kernel_us"] <= 0:
        return None
    return ctx.attributed["other_kernel_us"] / 1e3 / ctx.out_mpix
