"""Sep against position-packed dots at the RGB model's L2–L4 widths, on the tensor cores.

Counterpart of ``tools/xpack_probe.py``. The RGB model's small-n middle
layers (L2 32→32, L3 32→64, L4 64→64) run separated-phase dots: f=3 dots
of (M, 3k) @ (3k, n), n/128 of the TPU's 128 MXU lanes. The probe asks
whether packing P = 128/n positions into each lane group, (M/P, 128) @
(128, 128) dots at full lanes with 1.33–2.67x the multiply-adds, is
faster. On the H100 the question is how full a ``wgmma`` m64nNk16 runs
at N = 32 and 64, and whether packing buys anything there.

Every variant (``VARIANTS``, the probe's table at :88-105) computes, per
step, the same 6,144 output positions from operands that every step
shares: a sum of dots, bf16 × bf16 with f32 sums, then ReLU and one
rounding to bf16. Each is a tap list (``TapList``) of ``tap_gemm``, the
wrapper of the ``csrc/xpack.cu`` kernel (``wgmma``; its tile and
shared-memory plan, ``csrc/xpack_plan.cuh``, is ``plan`` here): for each
output chunk j,

    out[s, r, x, jN:(j+1)N] = bf16(relu(Σ_t a[r+dr, x+dc, l0:l0+K] @ w[w0:w0+K]))

over the taps t of chunk j in their order, for every step s. Probe 1's
operand is (M, L) as (M, 1, L), every offset 0, and its dots differ only
in the weight rows (its separate weight arrays are stacked).
``tap_gemm_plain`` is its plain version: the same dots in strict f32 on
the bf16 values, summed in tap order, ReLU, ``.to(bfloat16)``; it
computes the step once and writes it to every slab. On CPU tensors the
wrapper runs the plain version, on CUDA tensors the kernel, or it raises.

    python -m cnn_sr_tpu_torch.probes.xpack [--device cuda|cpu] [--steps N]
                                             [--check] [--reps N] [--rounds N]

``--steps`` defaults to 338, a 1080p layer's positions (⌈1080·1920 /
6144⌉ steps a launch). ``--check`` holds each variant's every slab
against its plain version (``agree``) and exits 1 past it. Without it
each variant is timed (CUDA events; the host clock on the CPU, where the
plain versions run: CPU times, not the card's) and printed as the probe
prints it, µs a step, with its best of rounds and ms per 1080p layer.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import math
import sys

import numpy as np
import torch

from ..models.srcnn import strict_f32
from . import layout
from .winograd import timer

M = 6144                 # output positions a step (tools/xpack_probe.py:40)
FRAME = 1080 * 1920
# the RGB 7-layer model's layer each (k, n) pair stands for, and its output
# at 1080x1920 (each f=3 layer trims 2 rows and 2 columns)
LAYERS = {(32, 32): ("L2", (1076, 1916)), (32, 64): ("L3", (1074, 1914)),
          (64, 64): ("L4", (1072, 1912))}
WIDTHS = (32, 64, 128)   # the kernel's N
KSTEP = 32               # contraction lanes a k-step of the kernel
MAX_KSTEPS = 128         # k-steps a launch, over all chunks
MAX_CHUNKS = 8
MAX_STEPS = 65535
ULP_FLOOR = 2.0 ** -14   # agree: the absolute limit near 0
MIN_EQUAL = 0.999        # agree: the bit-equal share

# launches in this process of csrc/xpack.cu, from this probe and xpack2
LAUNCHES = 0

# csrc/xpack_plan.cuh: output positions a tile, output lanes a consumer
# warpgroup computes at once (LANES / N steps), ring stages at most, the
# shared bytes a block may opt into, an A box's bytes (64 positions x 128
# bytes of lanes) and the bytes past the buffers (1024-byte alignment, the
# mbarriers)
ROWS, LANES, MAX_RING, SMEM_LIMIT = 64, 256, 16, 232448
BOX = ROWS * 128
SLACK = 1024 + 8 * (2 * MAX_RING + 4)


@dataclasses.dataclass(frozen=True)
class Tap:
    """One dot: a[dr + r, dc + x, l0 : l0 + k] @ w[w0 : w0 + k] into
    output chunk ``chunk``."""
    dr: int
    dc: int
    l0: int
    k: int
    w0: int
    chunk: int = 0


@dataclasses.dataclass(frozen=True)
class TapList:
    """A ``tap_gemm``: (rows, cols) output positions, ``n`` lanes a chunk,
    and the taps, each chunk's summed in their order here."""
    rows: int
    cols: int
    n: int
    taps: tuple

    @property
    def chunks(self) -> int:
        return 1 + max(t.chunk for t in self.taps)

    @property
    def mac(self) -> int:
        """Multiply-adds a step."""
        return self.rows * self.cols * self.n * sum(t.k for t in self.taps)


@dataclasses.dataclass(frozen=True)
class Variant:
    """One of a probe's variants: its operand and weight shapes in the
    probe's draw order (the weights stacked by rows into one w), its
    output shape, and the RGB layer (k, n) it stands for."""
    name: str
    pair: tuple
    a_shape: tuple
    w_shapes: tuple
    out_shape: tuple
    taps: TapList

    @property
    def positions(self) -> int:
        """Output positions (x n channels) a step."""
        return math.prod(self.out_shape) // self.pair[1]

    @property
    def sep(self) -> bool:
        return self.name.startswith("sep")


def _sep(name, k, n):
    """(M, 3k) @ (3k, n) three times, one weight array a dy."""
    taps = tuple(Tap(0, 0, 0, 3 * k, 3 * k * dy) for dy in range(3))
    return Variant(name, (k, n), (M, 3 * k), ((3 * k, n),) * 3, (M, n),
                   TapList(M, 1, n, taps))


def _xpack(name, pair, rows, ndots):
    """(rows, 128) @ (128, 128) ``ndots`` times."""
    taps = tuple(Tap(0, 0, 0, 128, 128 * d) for d in range(ndots))
    return Variant(name, pair, (rows, 128), ((128, 128),) * ndots, (rows, 128),
                   TapList(rows, 1, 128, taps))


VARIANTS = (
    _sep("sep_32to32", 32, 32),
    _xpack("xpack_32to32", (32, 32), M // 4, 6),   # 3 dy x 2 groups
    _sep("sep_32to64", 32, 64),
    _xpack("xpack_32to64", (32, 64), M // 2, 3),   # 1 overlap group a dy
    _sep("sep_64to64", 64, 64),
    _xpack("xpack_64to64", (64, 64), M // 2, 6),   # 3 dy x 2 column chunks
)


def steps_1080p(variants) -> int:
    """Steps a launch that cover one 1080p frame's positions."""
    return -(-FRAME // variants[0].positions)


def _check(a: torch.Tensor, w: torch.Tensor, taps: TapList, steps: int) -> None:
    """Refuse, on every device alike, what the kernel does not take."""
    if a.dim() != 3 or a.dtype != torch.bfloat16 or not a.is_contiguous() or a.shape[2] % 8:
        raise ValueError(f"tap_gemm: a must be contiguous bf16 (R, C, L), L a multiple of 8, "
                         f"got {tuple(a.shape)} {a.dtype}")
    if taps.n not in WIDTHS:
        raise ValueError(f"tap_gemm: N must be one of {WIDTHS}, got {taps.n}")
    if (w.dim() != 2 or w.shape[1] != taps.n or w.dtype != torch.bfloat16
            or not w.is_contiguous() or w.device != a.device):
        raise ValueError(f"tap_gemm: w must be contiguous bf16 (rows, {taps.n}) on {a.device}, "
                         f"got {tuple(w.shape)} {w.dtype} {w.device}")
    if taps.rows <= 0 or taps.cols <= 0 or not taps.taps:
        raise ValueError(f"tap_gemm: no output or no taps: {taps.rows}x{taps.cols}, "
                         f"{len(taps.taps)} taps")
    if not 1 <= steps <= MAX_STEPS:
        raise ValueError(f"tap_gemm: steps must be in 1..{MAX_STEPS}, got {steps}")
    R, C, L = a.shape
    for i, t in enumerate(taps.taps):
        if t.k <= 0 or t.k % 16:
            raise ValueError(f"tap_gemm: tap {i}: K = {t.k} is not a positive multiple of 16")
        if t.l0 % 8:
            raise ValueError(f"tap_gemm: tap {i}: lane offset {t.l0} is not a multiple of 8 "
                             f"(16 bytes)")
        if (min(t.dr, t.dc, t.l0, t.w0) < 0 or t.dr + taps.rows > R or t.dc + taps.cols > C
                or t.l0 + t.k > L):
            raise ValueError(f"tap_gemm: tap {i} {t} reads outside a {tuple(a.shape)} for a "
                             f"{taps.rows}x{taps.cols} output")
        if t.w0 + t.k > w.shape[0]:
            raise ValueError(f"tap_gemm: tap {i} {t} reads outside w {tuple(w.shape)}")
        if not 0 <= t.chunk < MAX_CHUNKS:
            raise ValueError(f"tap_gemm: tap {i}: chunk {t.chunk} not in 0..{MAX_CHUNKS - 1}")
    empty = set(range(taps.chunks)) - {t.chunk for t in taps.taps}
    if empty:
        raise ValueError(f"tap_gemm: output chunks {sorted(empty)} have no taps")
    ksteps = sum(-(-t.k // KSTEP) for t in taps.taps)
    if ksteps > MAX_KSTEPS:
        raise ValueError(f"tap_gemm: {ksteps} k-steps of {KSTEP} lanes, the kernel takes "
                         f"{MAX_KSTEPS}")
    if a.is_cuda and (a.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("tap_gemm: the kernel needs 16-byte aligned a and w")


def tables(taps: TapList):
    """The boxes and slices of ``xpack_plan`` (``csrc/xpack_plan.cuh``), per
    chunk in order: each tap's lanes in boxes of 64 and slices of 32, a
    slice ``(box, half, w_row, k16)`` reading half ``half`` of box ``box``
    of its chunk's distinct boxes ``(dr, dc, lane)`` over k16 = 1 or 2
    steps of 16 lanes. Returns ``(boxes, slices)``, one list a chunk
    each."""
    boxes, slices = [], []
    for j in range(taps.chunks):
        bj, sj = [], []
        for t in taps.taps:
            if t.chunk != j:
                continue
            for k in range(0, t.k, KSTEP):
                key = (t.dr, t.dc, t.l0 + k // 64 * 64)
                if key not in bj:
                    bj.append(key)
                sj.append((bj.index(key), k // 32 % 2, t.w0 + k, min(32, t.k - k) // 16))
        boxes.append(bj)
        slices.append(sj)
    return boxes, slices


def plan(taps: TapList) -> dict:
    """``xpack_plan`` of ``csrc/xpack_plan.cuh`` for a launch of ``taps``:
    the tile (``tc`` columns x ``tr`` rows, 64 positions; ``tiles_c`` a
    row of tiles, ``tiles`` in all), the most
    boxes and slices of a chunk, whether A (a tile's boxes) and W (a
    chunk's weight slices) stay resident or stream through a ring of
    ``ring`` stages of ``stage`` bytes, the output stages a warpgroup, and
    the bytes of each shared buffer (``zero_bytes``: 16 rows of zero
    weights) and of the block (``smem``)."""
    n = taps.n
    tc = 1
    while tc < taps.cols and tc < ROWS:
        tc *= 2
    boxes, slices = tables(taps)
    tiles_c = -(-taps.cols // tc)
    p = {"n": n, "tc": tc, "tr": ROWS // tc, "tiles_c": tiles_c,
         "tiles": tiles_c * -(-taps.rows // (ROWS // tc)), "chunks": taps.chunks,
         "boxes": max(map(len, boxes)), "slices": max(map(len, slices)),
         "wslice": KSTEP * n * 2, "zero_bytes": max(1024, 16 * n * 2)}
    a, w = p["boxes"] * BOX, p["slices"] * p["wslice"]
    out = 2 * LANES * ROWS * 2  # an output stage of both warpgroups
    budget = SMEM_LIMIT - SLACK - p["zero_bytes"]
    p.update(a_res=1, w_res=1, ring=0, stage=0, out_stages=1)
    if a + w + 2 * out <= budget:
        p["out_stages"] = 2
    elif a + w + out > budget:
        p["w_res"] = 0
        if a + out + 2 * p["wslice"] > budget:
            p["a_res"] = 0
        p["stage"] = (0 if p["a_res"] else BOX) + p["wslice"]
        p["ring"] = min(MAX_RING, (budget - (a if p["a_res"] else 0) - out) // p["stage"])
    p.update(a_bytes=a if p["a_res"] else 0, w_bytes=w if p["w_res"] else 0,
             ring_bytes=p["ring"] * p["stage"], out_bytes=p["out_stages"] * out)
    p["smem"] = (SLACK + p["a_bytes"] + p["w_bytes"] + p["ring_bytes"] + p["out_bytes"]
                 + p["zero_bytes"])
    return p


def tap_gemm_plain(a: torch.Tensor, w: torch.Tensor, taps: TapList, steps: int = 1) -> torch.Tensor:
    """``tap_gemm`` in PyTorch: each chunk's dots in strict f32 on the bf16
    values (every product exact), summed in tap order, ReLU, one rounding
    to bf16; the step computed once and written to each of ``steps`` slabs."""
    _check(a, w, taps, steps)
    rows, cols = taps.rows, taps.cols
    with strict_f32():
        af, wf = a.float(), w.float()
        parts = []
        for j in range(taps.chunks):
            acc = None
            for t in taps.taps:
                if t.chunk != j:
                    continue
                op = af[t.dr:t.dr + rows, t.dc:t.dc + cols, t.l0:t.l0 + t.k].reshape(-1, t.k)
                y = op @ wf[t.w0:t.w0 + t.k]
                acc = y if acc is None else acc + y
            parts.append(torch.relu(acc))
        y = torch.cat(parts, dim=1).to(torch.bfloat16)
    return y.view(1, rows, cols, -1).expand(steps, -1, -1, -1).contiguous()


def tap_gemm(a: torch.Tensor, w: torch.Tensor, taps: TapList, steps: int = 1) -> torch.Tensor:
    """The taps of ``taps`` over ``a`` (R, C, L) and ``w`` (rows, N), both
    bf16, into (steps, rows, cols, chunks·N) bf16, every step the same
    block (see the module's docstring). A launch of ``csrc/xpack.cu`` on
    CUDA tensors, the plain version on CPU tensors."""
    global LAUNCHES
    _check(a, w, taps, steps)
    if a.device.type == "cpu":
        return tap_gemm_plain(a, w, taps, steps)
    from ..ops.fused.build import load_library

    lib = load_library()
    out = torch.empty((steps, taps.rows, taps.cols, taps.chunks * taps.n), dtype=torch.bfloat16,
                      device=a.device)
    err = launch(lib, a, w, out, taps, steps)
    if err:
        raise RuntimeError("tap_gemm launch failed: " + lib.cnn_sr_error_string(err).decode())
    LAUNCHES += 1
    return out


def launch(lib, a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, taps: TapList,
           steps: int) -> int:
    """One call of ``lib``'s ``tap_gemm_bf16`` on the current stream of
    ``a``'s device, operands as ``_check`` passed them; returns its error
    code (the build's library, or a copy of ``xpack_parts``)."""
    flat = [v for t in taps.taps for v in (t.dr, t.dc, t.l0, t.k, t.w0, t.chunk)]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        return lib.tap_gemm_bf16(a.data_ptr(), w.data_ptr(), out.data_ptr(), *a.shape,
                                 w.shape[0], taps.n, taps.rows, taps.cols, taps.chunks,
                                 (ctypes.c_int * len(flat))(*flat), len(taps.taps), steps, stream)


def agree(got: torch.Tensor, ref: torch.Tensor):
    """A kernel's bf16 output against its plain version: (max abs
    difference, bit-equal share, ok). ok: every element within one bf16
    ulp of the larger of the two (or ``ULP_FLOOR`` near 0) and at least
    ``MIN_EQUAL`` of them bit-equal; the products are exact in both, the
    f32 sums taken in another order can round to the neighbouring value."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return math.inf, 0.0, False
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp_min(ULP_FLOOR)
    equal = float((got == ref).float().mean())
    return float(diff.max()), equal, bool((diff <= ulp).all()) and equal >= MIN_EQUAL


def draw(variants, seed: int = 0) -> dict:
    """The probes' seeded operands: for each variant in order, the operand
    then each weight array, ``rng.random(shape, float32) - 0.5`` of one
    generator; {name: (a, [w, ...])}, f32 numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in variants:
        a = rng.random(v.a_shape, np.float32) - 0.5
        out[v.name] = (a, [rng.random(s, np.float32) - 0.5 for s in v.w_shapes])
    return out


def probe_inputs() -> dict:
    """This probe's operands, drawn as it draws them (:107-112)."""
    return draw(VARIANTS)


def operands(v: Variant, a: np.ndarray, ws, device="cpu"):
    """A variant's numpy operands as ``tap_gemm`` takes them: ``a`` as
    bf16 (R, C, L) (probe 1's (M, L) as (M, 1, L)) and the weight arrays
    stacked by rows in bf16."""
    at = torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)
    wt = torch.from_numpy(np.concatenate(ws)).to(device=device, dtype=torch.bfloat16)
    return at.view(a.shape[0], -1, a.shape[-1]), wt


def ragged(n: int, device="cpu", seed: int = 0):
    """A case off the probes' shapes: a (9, 41, 72) operand, 7x37 outputs
    (259 rows, a part block at every N), two chunks, row and column
    offsets, lane offsets 8 to 40 and K = 48 and 16 (a 16-lane k-step).
    Returns (a, w, taps)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.random((9, 41, 72), np.float32) - 0.5)
    w = torch.from_numpy(rng.random((192, n), np.float32) - 0.5)
    taps = TapList(7, 37, n, (Tap(0, 0, 8, 48, 0), Tap(2, 1, 24, 32, 48), Tap(1, 4, 0, 64, 80),
                              Tap(1, 1, 40, 32, 144, 1), Tap(0, 3, 16, 16, 176, 1)))
    return a.to(device, torch.bfloat16), w.to(device, torch.bfloat16), taps


def streamed(n: int, device="cpu", seed: int = 0):
    """A case whose boxes do not fit a block beside its output staging, so
    that both A and W stream: a (12, 40, 64) operand, 5x33 outputs, one
    chunk of 28 taps at distinct row and column offsets (K = 64, 32 at lane
    32, 16 at lane 48). Returns (a, w, taps)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.random((12, 40, 64), np.float32) - 0.5)
    tap, w0 = [], 0
    for i in range(28):
        l0, k = ((0, 64), (32, 32), (48, 16))[i % 3]
        tap.append(Tap(i % 7, i // 7, l0, k, w0))
        w0 += k
    w = torch.from_numpy(rng.random((w0, n), np.float32) - 0.5)
    return a.to(device, torch.bfloat16), w.to(device, torch.bfloat16), TapList(5, 33, n, tuple(tap))


def check(variants, inputs, device, steps: int) -> bool:
    """Each variant's every slab against its plain version; prints a line
    each, returns whether all agree."""
    ok = True
    for v in variants:
        a, w = operands(v, *inputs[v.name], device)
        err, equal, good = agree(tap_gemm(a, w, v.taps, steps), tap_gemm_plain(a, w, v.taps, steps))
        ok &= good
        print(f"{v.name:<14} kernel vs plain, {steps} steps: max|diff| {err:.3e}, bit-equal "
              f"{100 * equal:.4f}%: {'OK' if good else 'WRONG'}")
    return ok


def probe_main(argv, prog: str, variants, inputs, unit: str) -> int:
    """A probe's entry point over its ``variants`` and their numpy
    ``inputs`` (``draw``); ``unit`` names what a step computes."""
    steps_default = steps_1080p(variants)
    p = argparse.ArgumentParser(prog=prog, description=f"sep vs packed dots, {unit} a step.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--steps", type=int, default=steps_default,
                   help=f"steps a launch (default {steps_default}: one 1080p layer's positions)")
    p.add_argument("--check", action="store_true", help="each variant against its plain version")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant and round")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    device = layout.device_of(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU (plain)"
    if args.check:
        ok = check(variants, inputs, device, args.steps)
        if not ok:
            print("check failed: a variant is past one bf16 ulp or 99.9% bit-equal")
        return 0 if ok else 1
    run = timer(device)
    ops = {v.name: operands(v, *inputs[v.name], device) for v in variants}
    results = {v.name: [] for v in variants}
    for rep in range(args.rounds):
        for v in variants:
            a, w = ops[v.name]
            ms = run(lambda: tap_gemm(a, w, v.taps, args.steps), args.reps)
            results[v.name].append(ms * 1e3 / args.steps)
            print(f"rep {rep} {v.name:<14} {results[v.name][-1]:8.3f} us/step", flush=True)
    print(f"\nbest-of-rounds on {name} (us/step, {unit}; {args.steps} steps a launch) and ms "
          f"per 1080p layer:")
    best = {v.name: min(results[v.name]) for v in variants}
    for v in variants:
        layer, (oh, ow) = LAYERS[v.pair]
        per_layer = best[v.name] * oh * ow / v.positions / 1e3
        print(f"  {v.name:<14} {best[v.name]:8.3f}  {per_layer:8.3f} ms ({layer}, {oh}x{ow}x"
              f"{v.pair[1]} out)")
    for v in variants:
        if v.sep:
            seps = v
        else:
            print(f"  {v.name} / {seps.name} {best[v.name] / best[seps.name]:.2f}x")
    return 0


def main(argv=None) -> int:
    return probe_main(argv, "python -m cnn_sr_tpu_torch.probes.xpack", VARIANTS, probe_inputs(),
                      f"{M} output positions")


if __name__ == "__main__":
    sys.exit(main())
