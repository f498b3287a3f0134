"""``mfu`` (%): the model's operations for every frame completed in the
traced window (the cell's ``flops``, ``core.Cell``: 2 x the model's
multiply-adds on the unpadded image) over the window's seconds times the
peak of the cell's precision: the whole step's share of the card. Read
from a card's traced run only."""


def read(ctx):
    if ctx.busy is None or not ctx.win.frames or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.frames_flops() / (ctx.window_s * ctx.peak_flops)
