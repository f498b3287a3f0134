"""Build and load the fused kernel's shared library.

The CUDA sources under ``cnn_sr_tpu_torch/csrc/`` compile with ``nvcc`` into
a plain C shared library (no PyTorch headers, so the build takes seconds)
that ``ctypes`` loads. The build happens at first use, into
``build/cnn_sr_tpu_torch/`` at the checkout's root, under a name keyed on
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cnn_sr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the sources."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(f"nvcc not found (tried {cands})")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcnn_sr_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the sources unless the library for their hash exists.
    Returns ``{"path", "seconds", "log"}``; ``log`` is the compiler's
    ptxas report (registers, shared memory, spills), empty on reuse."""
    path = library_path()
    if path.is_file():
        return {"path": str(path), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    return {"path": str(path), "seconds": seconds, "log": proc.stderr}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' signatures (every pointer and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_srcnn_forward.argtypes = [p] * 8 + [i] * 14 + [p]
    lib.fused_srcnn_forward.restype = i
    lib.fused_srcnn_error_string.argtypes = [i]
    lib.fused_srcnn_error_string.restype = ctypes.c_char_p
    return lib
