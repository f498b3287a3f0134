"""Parity layouts of an NHWC activation, and the strided copy that makes them.

The TPU probes keep a 3x3 layer's activations split by the parity of
their row and column, so that each stride-2 Winograd tap is a contiguous
read (``tools/winograd_probe.py:15-21``):

* ``pack_rows_cols(act)``: ``(R, C, k)`` to the Winograd input
  ``(2, ⌈R/2⌉, CWP, 2k)``, ``a[rp, i, j, cp·k + c] = act[2i+rp, 2j+cp, c]``;
  cells whose source lies past the image (odd R or C) and columns from
  ⌈C/2⌉ up to ``CWP`` are zero;
* ``pack_quad(act)``: ``(R, C, k)`` to the quad image ``(⌈R/2⌉, CWP, 4k)``,
  ``a[i, j, (2rp+cp)·k + c] = act[2i+rp, 2j+cp, c]``, the f=5 probe's
  layout (``tools/wino5_probe.py:240-244, 270-274``), zeros as above;
* ``split_quadrants(y)``: ``(R, C, n)`` to ``(2, 2, R/2, C/2, n)``,
  ``q[p, q', i, j] = y[2i+p, 2j+q']``; ``merge_quadrants`` is its inverse.

All four are exact copies. On the card they are ``parity_copy`` launches
(``csrc/parity_copy.cu``): one for the split and the merge, one per parity
quadrant for either pack, which zeroes only the cells no source reaches.
``parity_copy(dst, src, add)`` is that kernel's wrapper:
``dst = src + add`` elementwise over two strided views of up to five
dimensions. On CPU tensors every function here runs its plain version
(``*_plain``: PyTorch slicing); on CUDA tensors the kernel, or it raises.
"""

from __future__ import annotations

import ctypes

import torch

# parity_copy launches in this process; the smoke run reads it to show
# that a path went through the kernel
LAUNCHES = 0

MAX_DIMS = 5
DTYPES = (torch.float32, torch.bfloat16)


def device_of(name: str) -> torch.device:
    """A probe's device: "cuda" without a card raises, never falls back."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this probe runs on an NVIDIA card "
                           "(--device cpu runs its plain version)")
    return torch.device(name)


def _check_copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    if dst.shape != src.shape:
        raise ValueError(f"parity_copy: shapes differ, {tuple(dst.shape)} vs {tuple(src.shape)}")
    if dst.dtype != src.dtype or dst.dtype not in DTYPES:
        raise ValueError(f"parity_copy takes float32 or bfloat16 of one type, got "
                         f"{src.dtype} -> {dst.dtype}")
    if dst.device != src.device:
        raise ValueError(f"parity_copy: devices differ, {src.device} -> {dst.device}")
    if dst.dim() > MAX_DIMS:
        raise ValueError(f"parity_copy takes up to {MAX_DIMS} dimensions, got {dst.dim()}")
    if dst.numel() >= 2 ** 31:
        raise ValueError(f"parity_copy takes fewer than 2^31 elements, got {dst.numel()}")


def parity_copy_plain(dst: torch.Tensor, src: torch.Tensor, add: float = 0.0) -> None:
    """The kernel's plain version: ``dst[...] = src + add``, the sum in f32
    and rounded once to the type (no add when ``add`` is 0, so that a
    copy keeps every bit, −0 included)."""
    _check_copy(dst, src)
    dst.copy_(src if add == 0.0 else (src.float() + add).to(dst.dtype))


def parity_copy(dst: torch.Tensor, src: torch.Tensor, add: float = 0.0) -> None:
    """``dst[...] = src + add`` over two views of one shape (up to five
    dimensions, any strides, f32 or bf16): one launch of
    ``csrc/parity_copy.cu`` on CUDA tensors, the plain version on CPU
    tensors. ``dst`` must not overlap ``src``."""
    global LAUNCHES
    _check_copy(dst, src)
    if src.device.type == "cpu":
        parity_copy_plain(dst, src, add)
        return
    if src.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {src.device}")
    if dst.numel() == 0:
        return
    from ..ops.fused.build import load_library

    lib = load_library()
    pad = MAX_DIMS - dst.dim()
    ext = [1] * pad + list(dst.shape)
    s_str = [0] * pad + list(src.stride())
    d_str = [0] * pad + list(dst.stride())
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.parity_copy(src.data_ptr(), dst.data_ptr(), int(dst.dtype == torch.bfloat16),
                              *ext, *s_str, *d_str, ctypes.c_float(add), stream)
    if err:
        raise RuntimeError("parity_copy launch failed: " + lib.cnn_sr_error_string(err).decode())
    LAUNCHES += 1


def _check_act(x: torch.Tensor, name: str, dims: int = 3) -> None:
    if x.dim() != dims:
        raise ValueError(f"{name}: expected {dims} dimensions, got shape {tuple(x.shape)}")
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous float32 or bfloat16, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")


def _pack_shape(act: torch.Tensor, cwp, name: str):
    r, c, k = act.shape
    half_c = (c + 1) // 2
    cwp = half_c if cwp is None else cwp
    if cwp < half_c:
        raise ValueError(f"{name}: cwp {cwp} < ⌈C/2⌉ = {half_c}")
    return (r + 1) // 2, cwp, k


def _packed(act: torch.Tensor, cwp, quad: bool, alloc):
    """A pack's buffer from ``alloc`` and, per parity quadrant (rp, cp),
    (dst, src): ``dst`` its (RH, CWP, k) plane, ``src`` the strided view
    of ``act`` that fills the plane's top-left corner. The buffer is
    (RH, CWP, 2, 2, k) for the quad image, else (2, RH, CWP, 2, k)."""
    name = "pack_quad" if quad else "pack_rows_cols"
    _check_act(act, name)
    rh, cwp, k = _pack_shape(act, cwp, name)
    out = alloc((rh, cwp, 2, 2, k) if quad else (2, rh, cwp, 2, k), dtype=act.dtype,
                device=act.device)
    views = [(out[:, :, rp, cp] if quad else out[rp, :, :, cp], act[rp::2, cp::2])
             for rp in range(2) for cp in range(2)]
    return out, views


def _pack_plain(act: torch.Tensor, cwp, quad: bool) -> torch.Tensor:
    out, views = _packed(act, cwp, quad, torch.zeros)
    for dst, src in views:
        dst[:src.shape[0], :src.shape[1]].copy_(src)
    return out


def _pack(act: torch.Tensor, cwp, quad: bool) -> torch.Tensor:
    if act.device.type == "cpu":
        return _pack_plain(act, cwp, quad)
    out, views = _packed(act, cwp, quad, torch.empty)
    for dst, src in views:
        sr, sc = src.shape[:2]
        parity_copy(dst[:sr, :sc], src)
        dst[sr:].zero_()        # the last row of an odd R
        dst[:sr, sc:].zero_()   # an odd C's last column and the padded columns
    return out


def pack_rows_cols_plain(act: torch.Tensor, cwp: int | None = None) -> torch.Tensor:
    """``pack_rows_cols`` by four strided slices in PyTorch."""
    out = _pack_plain(act, cwp, quad=False)
    return out.view(*out.shape[:3], -1)


def pack_rows_cols(act: torch.Tensor, cwp: int | None = None) -> torch.Tensor:
    """``(R, C, k)`` → ``(2, ⌈R/2⌉, cwp, 2k)`` (``cwp`` ≥ ⌈C/2⌉, default
    ⌈C/2⌉), the Winograd probe's parity input; see the module's docstring."""
    out = _pack(act, cwp, quad=False)
    return out.view(*out.shape[:3], -1)


def pack_quad_plain(act: torch.Tensor, cwp: int | None = None) -> torch.Tensor:
    """``pack_quad`` by four strided slices in PyTorch."""
    out = _pack_plain(act, cwp, quad=True)
    return out.view(*out.shape[:2], -1)


def pack_quad(act: torch.Tensor, cwp: int | None = None) -> torch.Tensor:
    """``(R, C, k)`` → ``(⌈R/2⌉, cwp, 4k)`` (``cwp`` ≥ ⌈C/2⌉, default
    ⌈C/2⌉), the f=5 probe's quad image; see the module's docstring."""
    out = _pack(act, cwp, quad=True)
    return out.view(*out.shape[:2], -1)


def _quadrants_of(y: torch.Tensor) -> torch.Tensor:
    """The view (2, 2, R/2, C/2, n) of a contiguous (R, C, n) ``y``."""
    r, c, n = y.shape
    if r % 2 or c % 2:
        raise ValueError(f"quadrants need even rows and columns, got {r}x{c}")
    return y.view(r // 2, 2, c // 2, 2, n).permute(1, 3, 0, 2, 4)


def split_quadrants_plain(y: torch.Tensor) -> torch.Tensor:
    """``split_quadrants`` in PyTorch."""
    _check_act(y, "split_quadrants")
    return _quadrants_of(y).contiguous()


def split_quadrants(y: torch.Tensor) -> torch.Tensor:
    """``(R, C, n)`` → ``(2, 2, R/2, C/2, n)`` with ``out[p, q, i, j] =
    y[2i+p, 2j+q]``; R and C even."""
    _check_act(y, "split_quadrants")
    src = _quadrants_of(y)
    if y.device.type == "cpu":
        return split_quadrants_plain(y)
    out = torch.empty(src.shape, dtype=y.dtype, device=y.device)
    parity_copy(out, src)
    return out


def _merged_empty(q: torch.Tensor) -> torch.Tensor:
    _check_act(q, "merge_quadrants", 5)
    two, two2, h, w, n = q.shape
    if (two, two2) != (2, 2):
        raise ValueError(f"merge_quadrants takes (2, 2, R/2, C/2, n), got {tuple(q.shape)}")
    return torch.empty((2 * h, 2 * w, n), dtype=q.dtype, device=q.device)


def merge_quadrants_plain(q: torch.Tensor) -> torch.Tensor:
    """``merge_quadrants`` in PyTorch."""
    out = _merged_empty(q)
    _quadrants_of(out).copy_(q)
    return out


def merge_quadrants(q: torch.Tensor) -> torch.Tensor:
    """``(2, 2, R/2, C/2, n)`` → ``(R, C, n)``, the inverse of
    ``split_quadrants``."""
    if q.device.type == "cpu":
        return merge_quadrants_plain(q)
    out = _merged_empty(q)
    parity_copy(_quadrants_of(out), q)
    return out
