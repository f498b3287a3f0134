"""Plain PyTorch references of the benchmark's configurations.

Each module is named in a configuration's ``reference`` key. It imports
torch alone: nothing of ``cnn_sr_tpu_torch``, of ``cnn_sr_tpu`` or of JAX.

A module may also count the model's mathematics, whatever kernel computes
it (``core.Cell.flops``, ``core.Cell.bound_ms``, read by ``mfu`` and
``conv_roofline``):

* ``flops(cfg, shape) -> int``: 2 x the multiply-adds of the model of
  configuration ``cfg`` on the API's input shape ``(n, h, w, c)``;
* ``bound_ms(cfg, shape, precision) -> (ms, "operations" | "bytes")``: the
  least time of the model on this card at that shape, the larger of its
  operations over ``roofline.PEAK_FLOPS[precision]`` and its bytes over
  ``roofline.PEAK_BYTES``, with which of the two bounds it.

Without them the configuration's ``layers`` are counted as a stack of
VALID convolutions (``roofline.stack_flops``, ``roofline.bound_ms``).
"""
