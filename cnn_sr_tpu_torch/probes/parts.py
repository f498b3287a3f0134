"""Copies of a kernel's source with parts of its work taken out, built side
by side: what ``wino5_parts`` and ``rowpair_parts`` share.

A probe names its kernel's ``source`` (a file of ``csrc/``), a table of
edits, part -> [(text of the source, its replacement, times the text
occurs)], and its copies, name -> the parts taken out. ``patched`` makes a
copy's text, ``build_variants`` builds every copy with ``nvcc`` (the flags
of ``ops/fused/build.py``) into ``build/cnn_sr_tpu_torch/parts/`` at the
checkout's root, one library each, never replacing the port's own.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from ..ops.fused import build

PARTS_DIR = build.BUILD_DIR / "parts"


def patched(source: Path, table: dict, parts, text: str | None = None) -> str:
    """The text of ``source`` (or ``text``) with ``parts`` taken out by the
    edits of ``table``; raises if an edit's text does not occur as often as
    the table says (the kernel has changed under its probe)."""
    text = source.read_text() if text is None else text
    for part in parts:
        for old, new, count in table[part]:
            if text.count(old) != count:
                raise RuntimeError(f"{source.stem}_parts: {part!r} expects {count} of {old!r} "
                                   f"in {source.name}, found {text.count(old)}")
            text = text.replace(old, new)
    return text


def build_variants(source: Path, table: dict, variants: dict, entry: str, argtypes) -> dict:
    """Each of ``variants`` built from ``source``, all ``nvcc`` processes at
    once: {name: the loaded library, its C function ``entry`` declared with
    ``argtypes``, returning an int}."""
    nvcc = build.find_nvcc()
    PARTS_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, parts) in enumerate(variants.items()):
        src = PARTS_DIR / f"{source.stem}_{i}.cu"
        lib = PARTS_DIR / f"lib{source.stem}_{i}.so"
        src.write_text(patched(source, table, parts))
        cmd = [nvcc, *build.NVCC_FLAGS, f"-I{build.CSRC}", "-shared", "-o", str(lib), str(src)]
        procs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, cmd, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        lib = ctypes.CDLL(str(path))
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def captured(fn, reps: int) -> torch.cuda.CUDAGraph:
    """``reps`` calls of ``fn`` captured in a CUDA graph, after one call
    outside it: replaying it times their device work alone."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return graph
