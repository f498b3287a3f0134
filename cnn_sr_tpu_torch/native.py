"""ctypes binding of the port's own build of the native runtime library.

Counterpart of ``cnn_sr_tpu/native.py``: JPEG/PNG decode to RGBA8 and
encode (libjpeg, libpng), Rec.601 luma extraction, the pthread-pooled
batch sample loader of training, and the float-list codec of the
parameters file, from the same source, ``native/cnnsr_native.cpp``, with
the same C signatures.

The port builds its own copy with ``g++`` at first use, into
``build/cnn_sr_tpu_torch/`` at the checkout's root, under a name keyed on
a hash of the source, the flags, the compiler (``$CXX``, else ``g++``,
and its ``--version``) and the machine's architecture, and keeps the
compiler's log beside it (``ops/fused/build.py`` does the same for the
CUDA kernels). It never loads, makes or overwrites
``native/libcnnsr_native.so``, which the JAX package loads and rebuilds
in place with ``-march=native``. This build takes no ``-march``: the
AVX2 luma path carries its own target attribute.

A library found in the build directory that does not load (one copied
from another machine, linked against libraries this one lacks) is built
again once before the failure counts. A failed build is not silent:
``available()`` is False, ``build_error()`` holds the compiler's message,
and ``ops.image.codec()`` names the codec that serves instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "cnnsr_native.cpp"
BUILD_DIR = _ROOT / "build" / "cnn_sr_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]
LDLIBS = ["-ljpeg", "-lpng", "-lz", "-lpthread"]


class NativeBuildError(RuntimeError):
    """``g++`` is missing or refused the source (for example without the
    libjpeg or libpng headers)."""


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def _compiler_id(cxx: str) -> str:
    try:
        version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        version = "(no compiler)"
    return f"{cxx}\n{version}\n{platform.machine()}"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LDLIBS).encode())
    h.update(_compiler_id(_cxx()).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcnnsr_native_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library unless the one for this source's hash exists.
    Returns ``{"path", "seconds", "log"}``: ``seconds`` is 0.0 on reuse,
    and ``log`` the compiler's output, also kept in ``<library>.log``."""
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return {"path": str(path), "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _cxx()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, "-o", lib, str(SOURCE), *LDLIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        log_path.write_text(log)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed ({proc.returncode}): {log}")
        os.replace(lib, path)  # atomic: a concurrent build sees all or nothing
    return {"path": str(path), "seconds": time.perf_counter() - t0, "log": log}


_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' signatures (those of ``cnn_sr_tpu/native.py``). A reused
    library that does not load is removed and built again, once. A failed
    build or load raises ``NativeBuildError`` now and on every later call,
    without building again."""
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _BUILD_ERROR is not None:
            raise NativeBuildError(_BUILD_ERROR)
        try:
            info = build()
            try:
                lib = ctypes.CDLL(info["path"])
            except OSError:
                if info["seconds"] != 0.0:
                    raise
                os.remove(info["path"])
                lib = ctypes.CDLL(build()["path"])
        except (NativeBuildError, OSError) as e:
            _BUILD_ERROR = str(e)
            raise NativeBuildError(_BUILD_ERROR) from e
        p, i, i64, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_char_p
        pi = ctypes.POINTER(ctypes.c_int)
        for name, args, res in (
                ("cnnsr_image_size", [s, pi, pi], i),
                ("cnnsr_decode_rgba", [s, p, i, i], i),
                ("cnnsr_encode_png", [s, p, i, i], i),
                ("cnnsr_encode_jpeg", [s, p, i, i, i], i),
                ("cnnsr_extract_luma", [p, p, i64, i, i], None),
                ("cnnsr_load_sample_batch", [s, i, i, i, p, i, i, i], i),
                ("cnnsr_format_floats", [p, i64, p, i64], i64),
                ("cnnsr_parse_floats", [s, p, i64], i64)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here; the reason it does not
    is ``build_error()``."""
    try:
        load_library()
    except NativeBuildError:
        return False
    return True


def build_error() -> Optional[str]:
    """The message of the failed build or load, or None."""
    available()
    return _BUILD_ERROR


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) of an image file."""
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = load_library().cnnsr_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"cannot decode '{path}' (rc={rc})")
    return w.value, h.value


def decode_rgba(path: str) -> np.ndarray:
    """Decode JPEG/PNG to uint8 RGBA (H, W, 4)."""
    w, h = image_size(path)
    out = np.empty((h, w, 4), dtype=np.uint8)
    rc = load_library().cnnsr_decode_rgba(path.encode(), out.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"cannot decode '{path}' (rc={rc})")
    return out


def encode_png(path: str, rgb: np.ndarray) -> None:
    """Encode uint8 RGB (H, W, 3) as PNG."""
    arr = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = arr.shape[:2]
    rc = load_library().cnnsr_encode_png(path.encode(), arr.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"cannot write '{path}' (rc={rc})")


def encode_jpeg(path: str, rgb: np.ndarray, quality: int = 92) -> None:
    """Encode uint8 RGB (H, W, 3) as JPEG at the given quality."""
    arr = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = arr.shape[:2]
    rc = load_library().cnnsr_encode_jpeg(path.encode(), arr.ctypes.data, w, h, quality)
    if rc != 0:
        raise IOError(f"cannot write '{path}' (rc={rc})")


def extract_luma(rgba: np.ndarray, normalize: bool = True,
                 subtract_mean: bool = False) -> np.ndarray:
    """Rec.601 luma (optionally /255 and mean-subtracted) from uint8 RGBA."""
    arr = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = arr.shape[:2]
    out = np.empty((h, w), dtype=np.float32)
    load_library().cnnsr_extract_luma(arr.ctypes.data, out.ctypes.data, h * w,
                                      int(normalize), int(subtract_mean))
    return out


def load_sample_batch(paths: Sequence[str], width: int, height: int,
                      normalize: bool = True, subtract_mean: bool = False,
                      n_threads: int = 0) -> np.ndarray:
    """Threaded decode + luma of many same-sized images into one packed
    (S, H, W) float32 array: the training sample loader."""
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    out = np.empty((len(paths), height, width), dtype=np.float32)
    rc = load_library().cnnsr_load_sample_batch(
        blob, len(paths), width, height, out.ctypes.data,
        int(normalize), int(subtract_mean), n_threads)
    if rc != 0:
        raise IOError(f"native sample batch load failed (rc={rc})")
    return out


def format_floats(vals: np.ndarray) -> str:
    """Serialize a float32 array as 'v, v, v' with round-trip precision."""
    arr = np.ascontiguousarray(vals, dtype=np.float32).ravel()
    cap = arr.size * 24 + 16
    buf = ctypes.create_string_buffer(cap)
    n = load_library().cnnsr_format_floats(arr.ctypes.data, arr.size, buf, cap)
    if n < 0:
        raise ValueError("format_floats buffer overflow")
    return buf.raw[:n].decode()


def parse_floats(text: str, count: int) -> np.ndarray:
    """Parse ``count`` comma-separated floats."""
    out = np.empty(count, dtype=np.float32)
    n = load_library().cnnsr_parse_floats(text.encode(), out.ctypes.data, count)
    if n != count:
        raise ValueError(f"expected {count} floats, parsed {n}")
    return out
