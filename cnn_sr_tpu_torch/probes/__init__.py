"""Counterparts on the card of the JAX package's TPU probes under ``tools/``.

Each probe measures one question of a kernel's design on the hardware it
runs on. Here the same question is asked of the H100:

* ``strided_store`` (``tools/strided_store_probe.py``): strided loads and
  stores of the four parity quadrants of an activation, through the
  ``csrc/parity_copy.cu`` kernel (``layout.parity_copy``);
* ``winograd`` (``tools/winograd_probe.py``): Winograd F(2x2,3x3) against
  the direct ("sep") form of a 3x3 ReLU layer at the RGB model's k=64/128
  widths, through the ``csrc/winograd.cu`` kernel and the shipped
  ``conv_layer_forward_bf16``.

``layout`` holds the parity layouts both use. Run a probe with
``python -m cnn_sr_tpu_torch.probes.<name>`` (``--device cpu`` for its
plain version).
"""
