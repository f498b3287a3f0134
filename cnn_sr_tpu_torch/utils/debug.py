"""Debug helpers: array dumps and blocking-transfer detection.

The port's copy of ``cnn_sr_tpu/utils/debug.py``:

* ``dump_vector`` / ``print_array`` — formatted float dumps with per-line
  counts and line numbers (the same strings as the JAX functions for the
  same values); ``print_array`` also takes a torch tensor on any device;
* ``warn_blocking_transfers`` — the counterpart of
  ``jax.transfer_guard("log")``: on a CUDA device it sets
  ``torch.cuda.set_sync_debug_mode("warn")``, which warns at every
  operation that makes the host wait for the card (a ``.cpu()``, an
  ``.item()``, a synchronizing copy), and restores the previous mode on
  exit. On the CPU there is no device↔host transfer to log, so it does
  nothing. The CLI's ``profile`` mode wraps the run in it.
"""

from __future__ import annotations

import contextlib

import numpy as np


def _to_numpy(data) -> np.ndarray:
    if hasattr(data, "detach"):  # a torch tensor, on any device
        import torch

        t = data.detach().cpu()
        # numpy has no bfloat16: show its values as f32, exactly
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(data)


def dump_vector(data, per_line: int = 8, line_numbers: bool = True,
                prefix: str = "") -> str:
    """Format a float array as comma-separated lines."""
    arr = _to_numpy(data).ravel()
    lines = []
    for start in range(0, arr.size, per_line):
        chunk = arr[start : start + per_line]
        head = f"{prefix}[{start // per_line}] " if line_numbers else prefix
        lines.append(head + ", ".join(f"{float(v):.6g}" for v in chunk))
    return "\n".join(lines)


def print_array(name: str, arr, log=print, sample: int = 16) -> None:
    """Shape/stats summary + a value sample for a device or host array."""
    a = _to_numpy(arr)
    log(
        f"{name}: shape={tuple(a.shape)} dtype={a.dtype} "
        f"min={a.min():.6g} max={a.max():.6g} mean={a.mean():.6g} "
        f"finite={np.isfinite(a).all()}"
    )
    log(dump_vector(a.ravel()[:sample], prefix="  "))


@contextlib.contextmanager
def warn_blocking_transfers(enabled: bool = True, device="cuda"):
    """Warn at every host-blocking device operation inside the scope, on
    ``device``'s kind: CUDA warns, the CPU has nothing to warn about."""
    import torch

    if not enabled or torch.device(device).type != "cuda":
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)
