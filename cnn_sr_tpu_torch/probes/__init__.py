"""Counterparts on the card of the JAX package's TPU probes under ``tools/``.

Each probe measures one question of a kernel's design on the hardware it
runs on. Here the same question is asked of the H100:

* ``strided_store`` (``tools/strided_store_probe.py``): strided loads and
  stores of the four parity quadrants of an activation, through the
  ``csrc/parity_copy.cu`` kernel (``layout.parity_copy``);
* ``winograd`` (``tools/winograd_probe.py``): Winograd F(2x2,3x3) against
  the direct ("sep") form of a 3x3 ReLU layer at the RGB model's k=64/128
  widths, through the ``csrc/winograd.cu`` kernel and the shipped direct
  layer (``conv_layer_forward_wgmma`` at n > 64);
* ``wino5`` (``tools/wino5_probe.py``): denser forms of the flagship's
  conv2 (f=5, 64→32) in the half-resolution quad domain, the dense quad
  dot in three tap groupings and a 1-D F(2,5) row Winograd, against the
  direct form, through the ``csrc/wino5.cu`` kernel and the shipped
  ``conv_layer_forward_bf16`` at f=5; ``wino5_parts`` times copies of that
  kernel with parts of its work taken out, to show where its time goes;
* ``rowpair`` (``tools/rowpair_probe.py``): a GEMM whose operand is read
  through a stride-2 leading dimension, the row-pair form of the parity
  exit, through the ``csrc/rowpair.cu`` kernel.
* ``xpack`` and ``xpack2`` (``tools/xpack_probe.py``,
  ``tools/xpack_probe2.py``): the separated dots of the RGB model's 32→32,
  32→64 and 64→64 layers against dots that pack positions or rows into
  128 lanes, as tap lists of one bf16 GEMM on the tensor cores
  (``mma.sync``), the ``csrc/xpack.cu`` kernel (``xpack.tap_gemm``).

``fused_wgmma_parts`` asks no TPU probe's question: it times copies of the
shipped bf16 fused kernel (``csrc/fused_wgmma.cu``) with the time of each
phase of a tile, to show where that kernel's time goes.

``layout`` holds the parity layouts they use. Run a probe with
``python -m cnn_sr_tpu_torch.probes.<name>`` (``--device cpu`` for its
plain version).
"""
