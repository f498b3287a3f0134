"""``rrdb_trunk_roofline`` (%): the RRDBNet trunk's least time (the
reference's ``trunk_bound_ms``: conv_first, the dense blocks and conv_body
at the call's low-resolution images) over the device time launched inside
the program's ``model.rrdb.trunk`` spans (``span_roofline``). None without
those spans or in a CPU rehearsal."""

from benchmark import span_roofline


def read(ctx):
    return span_roofline.read(ctx, "model.rrdb.trunk", "trunk")
