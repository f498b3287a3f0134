"""``rrdb_head_roofline`` (%): the RRDBNet head's least time (the
reference's ``head_bound_ms``: conv_up1 at twice the call's images, conv_up2,
conv_hr and conv_last at four times them) over the device time launched
inside the program's ``model.rrdb.head`` spans, its nearest upsamples
included (``span_roofline``). None without those spans or in a CPU
rehearsal."""

from benchmark import span_roofline


def read(ctx):
    return span_roofline.read(ctx, "model.rrdb.head", "head")
