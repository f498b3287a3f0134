"""``conv_roofline`` (%): the model's least time over its device time.
The least time is the cell's ``bound_ms`` (``core.Cell``: the
reference module's ``bound_ms``, or ``roofline.bound_ms`` of its conv stack)
on each call's unpadded images (the ``bench.api`` span's shape); the
device time is every device op launched inside the model's forward call
(the ``bench.net`` span), whatever kernel or library ran it."""


def read(ctx):
    if ctx.attributed is None:
        return None
    bound_ms = device_us = 0.0
    c = ctx.cell.config["channels"]
    for api_name, us in ctx.attributed["net_calls"]:
        if api_name is None:
            continue
        s, h, w = (int(v) for v in api_name.split(":", 1)[1].split("x"))
        bound_ms += ctx.cell.bound_ms((s, h, w, c))[0]
        device_us += us
    if device_us <= 0:
        return None
    return 100.0 * bound_ms * 1e3 / device_us
