"""Plain PyTorch references of the benchmark's configurations.

Each module is named in a configuration's ``reference`` key. It imports
torch alone: nothing of ``cnn_sr_tpu_torch``, of ``cnn_sr_tpu`` or of JAX.
"""
