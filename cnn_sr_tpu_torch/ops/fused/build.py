"""Build and load the CUDA kernels' shared library.

The CUDA sources under ``cnn_sr_tpu_torch/csrc/`` compile with ``nvcc`` into
a plain C shared library (no PyTorch headers, so the build takes seconds)
that ``ctypes`` loads. Each ``.cu`` file compiles in its own ``nvcc``
process, all started together, and one more links the objects. The build
happens at first use, into ``build/cnn_sr_tpu_torch/`` at the checkout's
root, under a name keyed on a hash of every file in ``csrc/`` (the ``.cu``
sources and the ``.cuh`` headers they share) and the flags, so an edited
source or header rebuilds and an unchanged tree is reused.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    """The translation units: every ``.cu`` file (headers are included)."""
    return sorted(CSRC.glob("*.cu"))


def _hashed_files():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _hashed_files():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcnn_sr_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    return proc


def build() -> dict:
    """Compile the sources unless the library for their hash exists.
    Returns ``{"path", "seconds", "logs"}``; ``logs`` maps each source's
    name to its ptxas report (registers, shared memory, spills), and is
    empty on reuse."""
    path = library_path()
    if path.is_file():
        return {"path": str(path), "seconds": 0.0, "logs": {}}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = {}
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmp, src.stem + ".o"), str(src)]
            jobs[src.name] = (cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        logs, failed = {}, []
        for name, (cmd, proc) in jobs.items():
            _, err = proc.communicate()
            logs[name] = err
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise KernelBuildError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        _run([nvcc, "-shared", "-o", lib,
              *(os.path.join(tmp, src.stem + ".o") for src in _sources())])
        os.replace(lib, path)  # atomic: a concurrent build sees all or nothing
    return {"path": str(path), "seconds": time.perf_counter() - t0, "logs": logs}


def ptxas_entries(log: str, name: str) -> list:
    """``(mangled name, registers, spill line)`` of every kernel whose
    mangled name holds ``name`` in a ptxas ``-v`` report
    (``build()["logs"]``), in the report's order."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = None
            if name in ln:
                cur = [ln.split("'")[1] if "'" in ln else ln.strip(), None, None]
                out.append(cur)
        elif cur is not None and "spill" in ln:
            cur[2] = ln.strip()
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur[1] = int(ln.split("Used")[1].split("registers")[0])
    return [tuple(e) for e in out if e[1] is not None]


def ptxas_entry(log: str, name: str):
    """``(registers, spill line)`` of the first kernel whose mangled name
    holds ``name`` in a ptxas ``-v`` report, or None."""
    entries = ptxas_entries(log, name)
    return entries[0][1:] if entries else None


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' signatures (every pointer and the stream as ``c_void_p``)."""
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_srcnn_forward.argtypes = [p] * 8 + [i] * 12 + [p]
    lib.fused_srcnn_forward.restype = i
    lib.fused_srcnn_forward_bf16.argtypes = [p] * 8 + [i] * 11 + [p]
    lib.fused_srcnn_forward_bf16.restype = i
    lib.conv_layer_forward.argtypes = [p] * 4 + [i] * 11 + [p]
    lib.conv_layer_forward.restype = i
    lib.conv_first_forward_wgmma.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.conv_first_forward_wgmma.restype = i
    lib.conv_layer_forward_wgmma.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.conv_layer_forward_wgmma.restype = i
    lib.conv_last_forward_wgmma.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.conv_last_forward_wgmma.restype = i
    lib.conv_first_forward_wgmma_same.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.conv_first_forward_wgmma_same.restype = i
    f = ctypes.c_float
    lib.conv_layer_forward_wgmma_same.argtypes = ([p, i, p, p, p] + [i] * 8
                                                  + [p, i, f, p, i, f, p, i] + [i] * 2 + [p])
    lib.conv_layer_forward_wgmma_same.restype = i
    lib.conv_last_forward_wgmma_same.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.conv_last_forward_wgmma_same.restype = i
    lib.winograd_f2x3_forward.argtypes = [p] * 3 + [i] * 7 + [p]
    lib.winograd_f2x3_forward.restype = i
    lib.winograd_input_transform.argtypes = [p] * 2 + [i] * 6 + [p]
    lib.winograd_input_transform.restype = i
    lib.parity_copy.argtypes = [p, p, i] + [ctypes.c_longlong] * 15 + [ctypes.c_float, p]
    lib.parity_copy.restype = i
    lib.wino5_forward.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.wino5_forward.restype = i
    ll = ctypes.c_longlong
    lib.rowpair_gemm.argtypes = [p, p, p, i, i, ll, i, ll, p]
    lib.rowpair_gemm.restype = i
    lib.tap_gemm_bf16.argtypes = [p] * 3 + [i] * 8 + [ctypes.POINTER(i), i, i, p]
    lib.tap_gemm_bf16.restype = i
    ull = ctypes.c_ulonglong
    lib.wgmma_desc_probe.argtypes = [p, i, p, i, ull, ull, i, p, p]
    lib.wgmma_desc_probe.restype = i
    lib.cnn_sr_error_string.argtypes = [i]
    lib.cnn_sr_error_string.restype = ctypes.c_char_p
    return lib
