"""A GEMM over a stride-2 leading-dim read, the row-pair exit's operand, on the card.

Counterpart of ``tools/rowpair_probe.py``. The row-pair form of the
flagship's parity exit reads, for each row parity rt, the rows ``a[rt :
rt + 2m : 2]`` of the (H/2, W, 4k) exit source and multiplies them, rounded
to bf16, by an (L, L) bf16 matrix into f32. On the TPU the probe asked
whether Mosaic lowers that strided read; here a strided row is an address,
and the question is what the stride costs against a contiguous read.

``rowpair_gemm(a, w, m, rt, step)`` is the wrapper of the ``csrc/rowpair.cu``
kernel: the ``m`` rows ``a[rt], a[rt + step], ...`` of a (rows, W, L)
operand whose rows are contiguous (f32 or bf16), read through their
leading stride (2 W L for ``step=2``, W L for ``step=1``), times ``w`` (L,
L) bf16 into (m, W, L) f32. ``rowpair_gemm_plain`` is its plain version:
the same operand rounded to bf16, a strict-f32 matmul. On CPU tensors the
wrapper runs the plain version, on CUDA tensors the kernel, or it raises.

    python -m cnn_sr_tpu_torch.probes.rowpair [--device cuda|cpu]

runs the probe's four cases (L ∈ {128, 64} × {bf16, f32}) at its shape,
(64, 128, L) with m = 16 for both parities, against a float64 product, and
prints the probe's ``stride-2 leading-dim read, ...`` lines; it exits 1
past the probe's relative 2e-2. ``routes`` gives the ways timed at the
flagship's 1080p exit (an operand of 534 x 954 x L): the strided read; the
same kernel on a contiguous copy of the rows, alone and after the
``parity_copy`` of each row parity that makes the copy; and, on that copy,
``torch.mm(x, w, out_dtype=torch.float32)`` (bf16 in, f32 out: the same
function, the yardstick) and ``torch.matmul`` in bf16 (bf16 out: half the
bytes written), timed only.

``plan`` mirrors the kernel's tile and shared-memory plan,
``csrc/rowpair_plan.cuh``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.srcnn import strict_f32
from . import layout

H, W = 64, 128          # the probe's operand (tools/rowpair_probe.py:29)
M_ROWS = 16             # its rows a parity
LANES = (128, 64)
REL_LIMIT = 2e-2        # the probe's own
EXIT_1080P = (534, 954)  # conv2's output at 1080p as a half-res quad image
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# launches in this process of csrc/rowpair.cu; the copy route's copies
# count in layout.LAUNCHES
LAUNCHES = 0

# csrc/rowpair_plan.cuh: positions a tile, ring stages, the shared bytes a
# block may opt into, the bytes of a ring stage (128 bytes of lanes a
# position) and past the buffers (1024-byte alignment, the mbarriers)
BM, STAGES, SMEM_LIMIT = 128, 2, 232448
STAGE = BM * 128
SLACK = 1024 + 8 * (2 * STAGES + 1)


def plan(lanes: int) -> dict:
    """``RowpairPlan(L)`` of ``csrc/rowpair_plan.cuh``: for lanes L, a
    ring stage's bytes (``stage``: 128 positions x 128 bytes of lanes), the
    ring's ``stages``, the bytes of W (``w``, L x L bf16), of the f32
    staging of a tile (``ys``) and of the block (``smem``)."""
    w, ys = lanes * lanes * 2, BM * lanes * 4
    return {"stage": STAGE, "stages": STAGES, "w": w, "ys": ys,
            "smem": SLACK + w + STAGES * STAGE + ys}


def map_check(base: int, w_base: int, row_bytes: int) -> None:
    """What the kernel's tensor maps need of a launch's addresses, raised
    as a ValueError where they do not have it: the rows read (from
    ``base``) and w (``w_base``) start 16-byte aligned, and the rows lie
    ``row_bytes`` apart, a multiple of 16."""
    if base % 16 or w_base % 16:
        raise ValueError("the rows read and w must start 16-byte aligned")
    if row_bytes % 16:
        raise ValueError(f"the rows read must lie a multiple of 16 bytes apart, got {row_bytes}")


def _operand(a: torch.Tensor, w: torch.Tensor, m: int, rt: int, step: int) -> torch.Tensor:
    """Check the operands against what the kernel takes: a (rows, W, L) f32
    or bf16 with each row W x L contiguous, L 64 or 128; w contiguous bf16
    (L, L) on a's device; on CUDA tensors also ``map_check`` of the rows
    read and w. Returns the view of the m rows read, (m, W, L)."""
    if a.dim() != 3 or a.dtype not in DTYPES.values():
        raise ValueError(f"a must be (rows, W, L) f32 or bf16, got {tuple(a.shape)} {a.dtype}")
    lanes = a.shape[2]
    if a.stride(2) != 1 or a.stride(1) != lanes:
        raise ValueError(f"each row of a must be contiguous, got strides {a.stride()}")
    if lanes not in LANES:
        raise NotImplementedError(f"the rowpair kernel takes L in {LANES}, got {lanes}")
    if (tuple(w.shape) != (lanes, lanes) or w.dtype != torch.bfloat16 or not w.is_contiguous()
            or w.device != a.device):
        raise ValueError(f"w must be contiguous bf16 ({lanes}, {lanes}) on {a.device}, got "
                         f"{tuple(w.shape)} {w.dtype} {w.device}")
    if m <= 0 or step <= 0 or rt < 0 or rt + step * (m - 1) >= a.shape[0]:
        raise ValueError(f"rows {rt}, {rt} + {step}, ... ({m} of them) are not all in a's "
                         f"{a.shape[0]}")
    v = a[rt:rt + step * (m - 1) + 1:step]
    if a.is_cuda:
        map_check(v.data_ptr(), w.data_ptr(), v.stride(0) * v.element_size())
    return v


def rowpair_gemm_plain(a: torch.Tensor, w: torch.Tensor, m: int, rt: int,
                       step: int = 2) -> torch.Tensor:
    """``rowpair_gemm`` in PyTorch: the rows rounded to bf16, a strict-f32
    matmul with the bf16 ``w`` (each product exact, f32 sums)."""
    v = _operand(a, w, m, rt, step)
    lanes = a.shape[2]
    with strict_f32():
        y = v.to(torch.bfloat16).float().reshape(-1, lanes) @ w.float()
    return y.view(m, a.shape[1], lanes)


def rowpair_gemm(a: torch.Tensor, w: torch.Tensor, m: int, rt: int,
                 step: int = 2) -> torch.Tensor:
    """``a[rt : rt + step·m : step]`` (m rows of the (rows, W, L) ``a``, f32
    or bf16, rows contiguous, L 64 or 128) rounded to bf16, times ``w`` (L,
    L) bf16, into (m, W, L) f32. A launch of ``csrc/rowpair.cu`` on CUDA
    tensors, the plain version on CPU tensors."""
    global LAUNCHES
    v = _operand(a, w, m, rt, step)
    if a.device.type == "cpu":
        return rowpair_gemm_plain(a, w, m, rt, step)
    from ..ops.fused.build import load_library

    lib = load_library()
    lanes = a.shape[2]
    y = torch.empty((m, a.shape[1], lanes), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rowpair_gemm(v.data_ptr(), w.data_ptr(), y.data_ptr(),
                               int(a.dtype == torch.bfloat16), lanes, m, a.shape[1],
                               v.stride(0), stream)
    if err:
        raise RuntimeError("rowpair_gemm launch failed: " + lib.cnn_sr_error_string(err).decode())
    LAUNCHES += 1
    return y


def probe_inputs(lanes: int):
    """The probe's seeded operand (64, 128, L) and matrix (L, L), f32
    standard normal (``_case`` :53-55)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((H, W, lanes)).astype(np.float32)
    wm = rng.standard_normal((lanes, lanes)).astype(np.float32)
    return a, wm


def case(lanes: int, dtype: str, device, m: int = M_ROWS) -> float:
    """The probe's ``_case``: both row parities of its operand in
    ``dtype`` through ``rowpair_gemm``; returns the relative error against
    the float64 product of the bf16-rounded operands."""
    a, wm = probe_inputs(lanes)
    at = torch.from_numpy(a).to(device=device, dtype=DTYPES[dtype])
    wt = torch.from_numpy(wm).to(device=device, dtype=torch.bfloat16)
    out = torch.cat([rowpair_gemm(at, wt, m, rt) for rt in range(2)]).cpu().double().numpy()
    a16 = torch.from_numpy(a).to(torch.bfloat16).double().numpy()
    ref = np.concatenate([a16[rt:rt + 2 * m:2] for rt in range(2)]) @ wt.cpu().double().numpy()
    return float(np.abs(out - ref).max() / max(1e-6, np.abs(ref).max()))


def routes(lanes: int, dtype: str, device, shape=EXIT_1080P, seed: int = 0):
    """The ways to the product of both row parities of a seeded operand of
    ``shape`` (rows, W) x ``lanes`` in ``dtype``, each a function returning
    its two outputs: {"strided": two ``rowpair_gemm`` launches on the
    stride-2 rows; "contiguous": the same on a contiguous (2, rows/2, W, L)
    copy made beforehand; "copy": two ``parity_copy`` launches into that
    buffer, then the two launches on it; "library": ``torch.mm`` with
    ``out_dtype=torch.float32`` on the copy, bf16 in and f32 out, the same
    function (a torch without ``aten::mm.dtype`` for the device raises);
    "bf16_out": ``torch.matmul`` in bf16 on the copy, which writes half the
    bytes}, the plain version of the strided route, the operand and the
    matrix."""
    rows, cols = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((rows, cols, lanes), generator=gen, device=device).to(DTYPES[dtype])
    w = (torch.randn((lanes, lanes), generator=gen, device=device) / lanes ** 0.5).to(
        torch.bfloat16)
    m = rows // 2
    # the contiguous copy, made here by torch; "copy" makes it again
    buf = torch.stack([a[rt:rt + 2 * m:2] for rt in range(2)])
    buf16 = buf.to(torch.bfloat16)

    def strided():
        return [rowpair_gemm(a, w, m, rt) for rt in range(2)]

    def contiguous():
        return [rowpair_gemm(buf[rt], w, m, 0, 1) for rt in range(2)]

    def copy():
        for rt in range(2):
            layout.parity_copy(buf[rt], a[rt:rt + 2 * m:2])
        return contiguous()

    def library():
        return [torch.mm(buf16[rt].view(-1, lanes), w, out_dtype=torch.float32)
                for rt in range(2)]

    def bf16_out():
        return [torch.matmul(buf16[rt].view(-1, lanes), w) for rt in range(2)]

    def plain():
        return [rowpair_gemm_plain(a, w, m, rt) for rt in range(2)]

    ways = {"strided": strided, "contiguous": contiguous, "copy": copy, "library": library,
            "bf16_out": bf16_out}
    return ways, plain, a, w


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.rowpair",
        description="A GEMM over stride-2 leading-dim reads of a (64, 128, L) operand.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    device = layout.device_of(args.device)
    ok = True
    for lanes in LANES:
        for dtype in DTYPES:
            err = case(lanes, dtype, device)
            good = err < REL_LIMIT
            ok &= good
            verdict = "OK" if good else f"WRONG ({err:.2e})"
            print(f"stride-2 leading-dim read, {dtype} {lanes}-lane: {verdict} "
                  f"(rel {err:.2e})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
