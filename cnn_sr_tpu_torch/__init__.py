"""cnn_sr_tpu_torch — the SRCNN super-resolution system on PyTorch and CUDA.

The port of ``cnn_sr_tpu`` (JAX/Pallas on a TPU) to an NVIDIA H100. It
imports torch and numpy, never JAX, and keeps the JAX package's module
names and public layouts: NHWC activations, HWIO ``(f, f, k, n)``
weights, uint8 (H, W, 4) RGBA in and uint8 (H, W, 3) RGB out.

Package layout:
  utils/     config + parameters-file codecs, the numpy → torch bridge, PSNR
  models/    the layer-list SRCNN model (plain f32 forward, training loss,
             nn.Module)
  optim/     the reference's exact SGD + momentum + weight-decay update
  training/  sample loading, the training loop, the full-state sidecar
  ops/       color ops, image IO, resize (bicubic, linear, nearest, lanczos),
             the conv-stack kernels (fused, chain; f32 and bf16)
  parallel/  the (data, spatial) device mesh, data-parallel gradients,
             halo-exchange spatial sharding, the multi-process group
  csrc/      CUDA sources of the hand-written kernels
  native.py  the port's build of the native image/sample library
  api.py     luma or RGB upscale of one image (exact, bucketed or spatially
             sharded) or a batch
  cli.py     the command line: forward and train modes
  serve.py   the HTTP upscaling service (python -m cnn_sr_tpu_torch.serve)
"""

__version__ = "0.1.0"
