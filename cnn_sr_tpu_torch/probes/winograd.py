"""Winograd F(2x2,3x3) against the direct form of a 3x3 ReLU layer, on the card.

Counterpart of ``tools/winograd_probe.py``, which asks whether Winograd
F(2x2,3x3) (16 multiplies per 2x2 output tile instead of 36) beats the
direct ("sep") form at the RGB model's big layers, 64→128, 128→128 and
128→64. The variants, all bf16 operands with f32 sums and a bf16 ReLU
output:

* ``sep``: the shipped direct kernel through ``chain.layer_forward``:
  at n > 64 (64→128, 128→128) ``conv_layer_forward_wgmma``
  (``csrc/conv_wgmma.cu``, TMA-fed ``wgmma``), at 128→64
  ``conv_layer_forward_bf16`` (the ``mma.sync`` implicit GEMM of
  ``csrc/tc_stage.cuh``), NHWC out; it takes any odd f
  (``probes/wino5.py`` runs it at f=5);
* ``wino`` / ``winoF``: ``winograd_f2x3`` in mode "direct" / "factored"
  (``csrc/winograd.cu``: the 16 position GEMMs on the tensor cores) on the
  parity input ``layout.pack_rows_cols``, with the input transform in the
  kernel, parity output (2, 2, TR, TC, n);
* ``winoD``: mode "pre", on a V made beforehand (``input_transform``);
* ``repack``: ``sep`` then ``layout.split_quadrants``, the cost of handing
  a direct layer's output to a Winograd consumer.

Each kernel wrapper runs its plain version (``*_plain``, PyTorch) on CPU
tensors and its kernel on CUDA tensors, or raises. The plain Winograd
rounds V to bf16 after every add in the mode's order, as the probe's
interpret run does, and takes the products in strict f32.

    python -m cnn_sr_tpu_torch.probes.winograd [--check] [--reps N] [--rounds N]
                                                [--device cuda|cpu]

``--check`` holds every variant against a float64 direct convolution at
the probe's chunk shapes (24x256 outputs) and prints the probe's lines;
it exits 1 if a relative error passes 1e-2. Without it, each variant is
timed at the RGB model's 1080p layer shapes (CUDA events) and printed as
ms per layer and µs per 24x256 chunk, the probe's own unit. ``--device
cpu`` runs the plain versions, and times them at a reduced size with the
host clock: those are CPU times, not the card's.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..models.srcnn import conv_layer, strict_f32
from ..ops.fused import chain, entry
from . import layout

OW, CH = 256, 24                   # the probe's chunk: 24 x 256 outputs
CHUNK_RH, CHUNK_CWP = 13, 144      # its parity input: 26 rows, 258 cols padded to 144
PAIRS = ((64, 128), (128, 128), (128, 64))
# output (rows, cols) of each pair in the RGB 7-layer model at 1080x1920:
# L5 (64→128) and L6 (128→128); 128→64 is the probe's third pair at L6's shape
OUT_1080P = {(64, 128): (1070, 1910), (128, 128): (1068, 1908), (128, 64): (1068, 1908)}
OUT_CPU = (24, 64)                 # the reduced output of --device cpu timing
MODES = ("direct", "factored", "pre")
REL_LIMIT = 1e-2                   # --check, against the float64 direct conv
# the most input channels a layer: kWinoMaxK of csrc/winograd_plan.cuh, the
# kernel's block plan (at 160 U streams in three stages a position beside
# the window, V and the output staging)
MAX_K = 160

# copies of the probe's matrices (tools/winograd_probe.py:59-68)
BT = np.array([[1, 0, -1, 0],
               [0, 1, 1, 0],
               [0, -1, 1, 0],
               [0, 1, 0, -1]], np.float32)
G = np.array([[1, 0, 0],
              [.5, .5, .5],
              [.5, -.5, .5],
              [0, 0, 1]], np.float32)
AT = np.array([[1, 1, 1, 0],
               [0, 1, -1, -1]], np.float32)

_MODE_CODE = {"direct": 0, "factored": 1, "pre": 2}

# launches in this process of csrc/winograd.cu (layer and input transform);
# the direct form's launches count in chain.LAUNCHES_BF16 and the splits'
# in layout.LAUNCHES
LAUNCHES = 0


def transform_weights(g, dtype):
    """g: (3, 3, k, n) -> (16, k, n): U = G g G^T per (cin, cout)
    (the probe's own code, ``tools/winograd_probe.py:71``)."""
    u = np.einsum("ai,bj,ijkn->abkn", G, G, g.astype(np.float32))
    return u.reshape(16, *g.shape[2:]).astype(dtype)


def weights_u(g: np.ndarray, device="cpu") -> torch.Tensor:
    """U of the numpy weights ``g`` (3, 3, k, n) as the layer takes it:
    ``transform_weights`` in f32 on the host, rounded once to bf16,
    (16k, n), row ``pos·k + c``."""
    _, _, k, n = g.shape
    u = transform_weights(g, np.float32).reshape(16 * k, n)
    return torch.from_numpy(u).to(device=device, dtype=torch.bfloat16)


def _geometry(x: torch.Tensor, out_hw, mode: str):
    """Check a layer's input ``x`` for ``mode`` and the output ``out_hw``,
    on every device alike; returns (k, TR, TC). Raises ValueError for a
    malformed or odd-sized layer and NotImplementedError past the
    kernel's width."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    oh, ow = out_hw
    if oh <= 0 or ow <= 0 or oh % 2 or ow % 2:
        raise ValueError(f"F(2x2,3x3) tiles an even output, got {oh}x{ow}")
    tr, tc = oh // 2, ow // 2
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"the layer takes contiguous bf16, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    if mode == "pre":
        k = x.shape[-1]
        if x.dim() != 3 or tuple(x.shape[:2]) != (16, tr * tc):
            raise ValueError(f"V must be (16, {tr * tc}, k), got {tuple(x.shape)}")
    else:
        k = x.shape[-1] // 2
        if (x.dim() != 4 or x.shape[0] != 2 or x.shape[3] % 2 or x.shape[1] < tr + 1
                or x.shape[2] < tc + 1):
            raise ValueError(f"the parity input must be (2, >={tr + 1}, >={tc + 1}, 2k), "
                             f"got {tuple(x.shape)}")
    if k <= 0 or k % 8:
        raise ValueError(f"input channels must be a positive multiple of 8, got {k}")
    if k > MAX_K:
        raise NotImplementedError(f"the Winograd kernel takes up to {MAX_K} input channels, "
                                  f"got {k}")
    if x.is_cuda and x.data_ptr() % 16:
        raise ValueError("the kernel needs 16-byte aligned tensors")
    return k, tr, tc


def _check_layer(x: torch.Tensor, u: torch.Tensor, out_hw, mode: str):
    """``_geometry`` and the weights ``u``; returns (k, n, TR, TC)."""
    k, tr, tc = _geometry(x, out_hw, mode)
    if (u.dim() != 2 or u.shape[0] != 16 * k or u.dtype != torch.bfloat16
            or not u.is_contiguous() or u.device != x.device):
        raise ValueError(f"U must be contiguous bf16 ({16 * k}, n) on {x.device}, got "
                         f"{tuple(u.shape)} {u.dtype} {u.device}")
    n = u.shape[1]
    if n <= 0 or n % 8:
        raise ValueError(f"output channels must be a positive multiple of 8, got {n}")
    if u.is_cuda and u.data_ptr() % 16:
        raise ValueError("the kernel needs 16-byte aligned tensors")
    return k, n, tr, tc


def _v_positions(x: torch.Tensor, k: int, tr: int, tc: int, mode: str):
    """(pos, V[pos] as (tr, tc, k) bf16) in position order: from the parity
    input by the mode's transform, each add rounded to bf16 as the probe's
    bodies take it (``wino_body`` :164-177, ``winoF_body`` :199-213), or
    read from ``x`` (pre)."""
    if mode == "pre":
        for pos in range(16):
            yield pos, x[pos].view(tr, tc, k)
        return

    def tap(i, j):
        return x[i % 2, i // 2:i // 2 + tr, j // 2:j // 2 + tc, (j % 2) * k:(j % 2 + 1) * k]

    if mode == "direct":
        for pos in range(16):
            pa, pb = divmod(pos, 4)
            v = None
            for i in range(4):
                if BT[pa, i] == 0:
                    continue
                for j in range(4):
                    c = BT[pa, i] * BT[pb, j]
                    if c == 0:
                        continue
                    t = tap(i, j) if c > 0 else -tap(i, j)
                    v = t if v is None else v + t
            yield pos, v
        return
    for pa in range(4):
        i1, i2 = [i for i in range(4) if BT[pa, i] != 0]
        rs = []
        for jb in range(4):
            d1 = tap(i1, jb) if BT[pa, i1] > 0 else -tap(i1, jb)
            d2 = tap(i2, jb)
            rs.append(d1 + d2 if BT[pa, i2] > 0 else d1 - d2)
        for pb in range(4):
            j1, j2 = [j for j in range(4) if BT[pb, j] != 0]
            v = rs[j1] if BT[pb, j1] > 0 else -rs[j1]
            v = v + rs[j2] if BT[pb, j2] > 0 else v - rs[j2]
            yield pa * 4 + pb, v


def input_transform_plain(a_par: torch.Tensor, out_hw, mode: str = "direct") -> torch.Tensor:
    """``input_transform`` in PyTorch."""
    if mode == "pre":
        raise ValueError("the input transform is mode 'direct' or 'factored'")
    k, tr, tc = _geometry(a_par, out_hw, mode)
    return torch.stack([v.reshape(tr * tc, k) for _, v in _v_positions(a_par, k, tr, tc, mode)])


def input_transform(a_par: torch.Tensor, out_hw, mode: str = "direct") -> torch.Tensor:
    """V = BᵀdB of every tile of the parity input ``a_par``, (16, TR·TC, k)
    bf16, the values the layer forms in ``mode`` ("direct" or "factored"):
    the pre mode's input. A launch of ``csrc/winograd.cu`` on CUDA tensors,
    the plain version on CPU tensors."""
    global LAUNCHES
    if mode == "pre":
        raise ValueError("the input transform is mode 'direct' or 'factored'")
    k, tr, tc = _geometry(a_par, out_hw, mode)
    if a_par.device.type == "cpu":
        return input_transform_plain(a_par, out_hw, mode)
    from ..ops.fused.build import load_library

    lib = load_library()
    v = torch.empty((16, tr * tc, k), dtype=torch.bfloat16, device=a_par.device)
    with torch.cuda.device(a_par.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.winograd_input_transform(a_par.data_ptr(), v.data_ptr(), a_par.shape[1],
                                           a_par.shape[2], k, tr, tc, _MODE_CODE[mode], stream)
    if err:
        raise RuntimeError("winograd_input_transform launch failed: "
                           + lib.cnn_sr_error_string(err).decode())
    LAUNCHES += 1
    return v


def _accum_y(ys, a, b, m):
    """Y[p,q] += Aᵀ[p,a] Aᵀ[q,b] M (coefficients 0 or ±1), the probe's
    ``accum_y`` (:113-119)."""
    for pq in range(4):
        c = float(AT[pq // 2, a] * AT[pq % 2, b])
        if c != 0.0:
            ys[pq] = m * c if ys[pq] is None else ys[pq] + m * c
    return ys


def winograd_f2x3_plain(x: torch.Tensor, u: torch.Tensor, out_hw,
                        mode: str = "direct") -> torch.Tensor:
    """``winograd_f2x3`` in PyTorch: V per position with the kernel's
    roundings, M = V U in strict f32 (the bf16 products are exact), Y in
    f32 in position order, ReLU, bf16."""
    k, n, tr, tc = _check_layer(x, u, out_hw, mode)
    ys = [None] * 4
    with strict_f32():
        for pos, v in _v_positions(x, k, tr, tc, mode):
            m = v.reshape(tr * tc, k).float() @ u[pos * k:(pos + 1) * k].float()
            ys = _accum_y(ys, pos // 4, pos % 4, m)
    return torch.stack([torch.relu(y) for y in ys]).to(torch.bfloat16).view(2, 2, tr, tc, n)


def winograd_f2x3(x: torch.Tensor, u: torch.Tensor, out_hw,
                  mode: str = "direct") -> torch.Tensor:
    """One 3x3 ReLU layer by Winograd F(2x2,3x3) into the parity output
    (2, 2, TR, TC, n) bf16, ``out[p, q, i, j] = y[2i+p, 2j+q]`` for the
    (rows, cols) = ``out_hw`` output (both even). ``x`` is the parity input
    (2, ≥TR+1, ≥TC+1, 2k) of ``layout.pack_rows_cols`` in modes "direct"
    and "factored", V (16, TR·TC, k) of ``input_transform`` in mode
    "pre"; ``u`` (16k, n) from ``weights_u``; all bf16, k and n multiples
    of 8. A launch of ``csrc/winograd.cu`` on CUDA tensors, the plain
    version on CPU tensors."""
    global LAUNCHES
    k, n, tr, tc = _check_layer(x, u, out_hw, mode)
    if x.device.type == "cpu":
        return winograd_f2x3_plain(x, u, out_hw, mode)
    from ..ops.fused.build import load_library

    lib = load_library()
    y = torch.empty((2, 2, tr, tc, n), dtype=torch.bfloat16, device=x.device)
    rh, cwp = (0, 0) if mode == "pre" else (x.shape[1], x.shape[2])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.winograd_f2x3_forward(x.data_ptr(), u.data_ptr(), y.data_ptr(), rh, cwp, k, n,
                                        tr, tc, _MODE_CODE[mode], stream)
    if err:
        raise RuntimeError("winograd_f2x3 launch failed: " + lib.cnn_sr_error_string(err).decode())
    LAUNCHES += 1
    return y


def _check_sep(act: torch.Tensor, g: torch.Tensor) -> int:
    """Check ``sep``'s operands; returns the window f (odd, from ``g``)."""
    if act.dim() != 3 or act.dtype != torch.bfloat16 or not act.is_contiguous():
        raise ValueError(f"sep takes a contiguous bf16 (R, C, k), got {tuple(act.shape)} "
                         f"{act.dtype}")
    f = g.shape[0] if g.dim() == 4 else 0
    if (f % 2 == 0 or tuple(g.shape[1:3]) != (f, act.shape[2]) or g.dtype != torch.bfloat16
            or not g.is_contiguous() or g.device != act.device):
        raise ValueError(f"sep takes bf16 weights (f, f, {act.shape[2]}, n), f odd, on "
                         f"{act.device}, got {tuple(g.shape)} {g.dtype} {g.device}")
    if act.shape[0] < f or act.shape[1] < f:
        raise ValueError(f"the input {tuple(act.shape)} is smaller than the {f}x{f} window")
    return f


def sep_plain(act: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``sep`` in PyTorch: one middle layer of the bf16 stream
    (``ops/fused/reference.py``): a strict-f32 convolution of the bf16
    values with a zero bias, ReLU, rounded to bf16."""
    _check_sep(act, g)
    bias = torch.zeros(g.shape[3], dtype=torch.float32, device=act.device)
    with strict_f32():
        y = conv_layer(act.float()[None], g.float(), bias, relu=True)
    return y[0].to(torch.bfloat16).contiguous()


def sep(act: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The direct form: ``act`` (R, C, k) bf16 through the f×f bf16 weights
    ``g`` (f, f, k, n), f odd, with a zero bias and ReLU into (R−f+1,
    C−f+1, n) bf16. On CUDA tensors one launch of the shipped tensor-core
    layer as a middle layer of the stream (``entry.bf16_layer_plan``: the
    wgmma stage at n > 64, else ``conv_layer_forward_bf16``), over ``g``
    packed once (``entry.packed_bf16``; counted in ``chain.LAUNCHES_BF16``);
    on CPU tensors its plain version."""
    f = _check_sep(act, g)
    if act.device.type == "cpu":
        return sep_plain(act, g)
    from ..ops.fused.build import load_library

    r, c, k = act.shape
    n = g.shape[3]
    dst = torch.empty((1, r - f + 1, c - f + 1, n), dtype=torch.bfloat16, device=act.device)
    bias = getattr(g, "_sep_bias", None)
    if bias is None:
        bias = g._sep_bias = torch.zeros(n, dtype=torch.float32, device=act.device)
    wp, bp = entry.packed_bf16(g, bias, first=False)
    plan = entry.bf16_layer_plan(f, k, n)
    with torch.cuda.device(act.device):
        stream = torch.cuda.current_stream().cuda_stream
        chain.layer_forward(load_library(), act[None], wp, bp, dst, plan, first=False,
                            last=False, bf16=True, stream=stream)
    return dst[0]


def repack_plain(act: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``repack`` in PyTorch."""
    return layout.split_quadrants_plain(sep_plain(act, g))


def repack(act: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``sep`` into the parity output (2, 2, (R−2)/2, (C−2)/2, n): the
    direct layer, then a ``parity_copy`` split (the probe's ``repack``)."""
    return layout.split_quadrants(sep(act, g))


def direct_conv_f64(act: np.ndarray, g: np.ndarray) -> np.ndarray:
    """The oracle: VALID f×f cross-correlation of ``act`` (R, C, k) with
    ``g`` (f, f, k, n) in float64, ReLU."""
    r, c, _ = act.shape
    f = g.shape[0]
    a64 = act.astype(np.float64)
    ref = np.zeros((r - f + 1, c - f + 1, g.shape[3]))
    for dy in range(f):
        for dx in range(f):
            ref += a64[dy:dy + r - f + 1, dx:dx + c - f + 1] @ g[dy, dx].astype(np.float64)
    return np.maximum(ref, 0.0)


def check(device, pairs=PAIRS, seed: int = 0) -> dict:
    """Every variant at the probe's chunk shapes (24x256 outputs from a
    26x258 block, parity input padded to 144 columns) against the float64
    direct conv of the f32 activations, as the probe's ``_check`` does.
    Prints the probe's lines; returns {"<variant><k>.<n>": (max_abs, rel)}."""
    rng = np.random.default_rng(seed)
    results = {}
    for k, n in pairs:
        act = (rng.random((CH + 2, OW + 2, k), np.float32) - 0.5).astype(np.float32)
        g = (rng.random((3, 3, k, n), np.float32) - 0.5).astype(np.float32)
        ref = direct_conv_f64(act, g)
        refmax = float(np.abs(ref).max())
        act_t = torch.from_numpy(act).to(device=device, dtype=torch.bfloat16)
        a_par = layout.pack_rows_cols(act_t, CHUNK_CWP)
        u = weights_u(g, device)
        outs = {
            "wino": winograd_f2x3(a_par, u, (CH, OW), "direct"),
            "winoF": winograd_f2x3(a_par, u, (CH, OW), "factored"),
            "winoD": winograd_f2x3(input_transform(a_par, (CH, OW)), u, (CH, OW), "pre"),
            "repack": repack(act_t, torch.from_numpy(g).to(device=device, dtype=torch.bfloat16)),
        }
        for kind, out in outs.items():
            y = layout.merge_quadrants(out).double().cpu().numpy()
            err = float(np.abs(y - ref).max())
            rel = err / max(refmax, 1e-9)
            print(f"{kind}{k}.{n} check: max_abs={err:.4f} rel={rel:.4f} "
                  f"(bf16 dots; ref_max={refmax:.2f})")
            results[f"{kind}{k}.{n}"] = (err, rel)
    return results


def timer(device: torch.device):
    """``fn, reps -> ms per call`` after one untimed call: CUDA events on
    the card, the host clock on the CPU."""
    def run(fn, reps: int) -> float:
        fn()
        if device.type == "cuda":
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    return run


def layer_inputs(k: int, n: int, out_hw, device, seed: int = 0):
    """Seeded inputs of one layer with output ``out_hw``: the activation
    (R+2, C+2, k) bf16 uniform in [−0.5, 0.5) and weights (3, 3, k, n) f32
    (numpy) of scale 1/√(9k), made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    oh, ow = out_hw
    act = (torch.rand((oh + 2, ow + 2, k), generator=gen, device=device) - 0.5)
    g = (torch.rand((3, 3, k, n), generator=gen, device=device) - 0.5) * (12.0 / (9 * k)) ** 0.5
    return act.to(torch.bfloat16), g.cpu().numpy()


def layer_variants(k: int, n: int, out_hw, device, seed: int = 0):
    """The variants of one layer with output ``out_hw`` on the seeded inputs
    of ``layer_inputs``, each as (kernel, plain): {kind: (fn, fn)}, and the
    inputs they read, made beforehand: {"act", "gb", "u", "a_par", "v",
    "y"}, the activation and bf16 weights for sep/repack/pack, U, the
    parity input for wino/winoF, V for winoD and a layer output for
    split."""
    act, g = layer_inputs(k, n, out_hw, device, seed)
    gb = torch.from_numpy(g).to(device=device, dtype=torch.bfloat16)
    u = weights_u(g, device)
    a_par = layout.pack_rows_cols(act)
    v = input_transform(a_par, out_hw)
    y = sep(act, gb)
    variants = {
        "sep": (lambda: sep(act, gb), lambda: sep_plain(act, gb)),
        "winoD": (lambda: winograd_f2x3(v, u, out_hw, "pre"),
                  lambda: winograd_f2x3_plain(v, u, out_hw, "pre")),
        "wino": (lambda: winograd_f2x3(a_par, u, out_hw, "direct"),
                 lambda: winograd_f2x3_plain(a_par, u, out_hw, "direct")),
        "winoF": (lambda: winograd_f2x3(a_par, u, out_hw, "factored"),
                  lambda: winograd_f2x3_plain(a_par, u, out_hw, "factored")),
        "repack": (lambda: repack(act, gb), lambda: repack_plain(act, gb)),
        "pack": (lambda: layout.pack_rows_cols(act), lambda: layout.pack_rows_cols_plain(act)),
        "split": (lambda: layout.split_quadrants(y), lambda: layout.split_quadrants_plain(y)),
    }
    return variants, {"act": act, "gb": gb, "u": u, "a_par": a_par, "v": v, "y": y}


def time_layers(device, reps: int, rounds: int, pairs=PAIRS) -> dict:
    """ms per layer of each variant's kernel (``layer_variants``) at the
    1080p shapes (``OUT_1080P``), or at ``OUT_CPU`` on the CPU, in
    ``rounds`` interleaved rounds of ``reps`` calls; {(variant, k, n): [ms
    per round]}."""
    run = timer(device)
    results = {}
    for k, n in pairs:
        out_hw = OUT_1080P[(k, n)] if device.type == "cuda" else OUT_CPU
        variants, _ = layer_variants(k, n, out_hw, device)
        for _ in range(rounds):
            for kind, (fn, _) in variants.items():
                results.setdefault((kind, k, n), []).append(run(fn, reps))
        del variants
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.winograd",
        description="Winograd F(2x2,3x3) vs the direct 3x3 layer at the RGB model's "
                    "k=64/128 widths.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--check", action="store_true",
                   help="each variant once against a float64 direct conv at the chunk shapes")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant and round")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    device = layout.device_of(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU (plain)"
    if args.check:
        bad = [k for k, (_, rel) in check(device).items() if not rel <= REL_LIMIT]
        if bad:
            print(f"check failed (rel > {REL_LIMIT}): {', '.join(bad)}")
        return 1 if bad else 0
    times = time_layers(device, args.reps, args.rounds)
    print(f"ms per layer on {name}, best of {args.rounds} rounds of {args.reps} calls, "
          f"and µs per {CH}x{OW} output chunk:")
    for (kind, k, n), ms in times.items():
        oh, ow = OUT_1080P[(k, n)] if device.type == "cuda" else OUT_CPU
        best = min(ms)
        print(f"{f'{kind}{k}.{n}':<14} {best:9.3f} ms ({oh}x{ow} out)  "
              f"{best * 1e3 * CH * OW / (oh * ow):8.3f} µs/chunk  rounds "
              + " ".join(f"{t:.3f}" for t in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
