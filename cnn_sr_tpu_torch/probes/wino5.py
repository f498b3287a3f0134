"""Denser forms of the flagship's conv2 (f=5, 64→32) against the direct one, on the card.

Counterpart of ``tools/wino5_probe.py``. The flagship's conv2 runs in the
half-resolution quad domain: the quad image ``a[i, j, (2rp+cp)·k + c] =
act[2i+rp, 2j+cp, c]`` (``layout.pack_quad``) goes through nine 3x3 taps of
(4k → 4n) weights into the four parity planes of the output. Its weight
layout is (5/6)² ≈ 69% filled. The probe asks whether a denser form beats
it. The variants, all with bf16 operands, f32 sums and a bf16 ReLU output
in the parity layout (2, 2, TR, TC, n):

* ``quad``, ``quadp``, ``quad1``: the dense quad dot, structural zeros
  included, with the taps' partial sums taken in groups of 1, 2 and 9
  (the probe's ``quad_body`` at group_k 1, 2, 9; ``quad_weights``);
* ``w55f``: a 1-D F(2,5) Winograd over rows (``B6``, ``G25``, ``AT25``)
  with the columns folded into the weights (``w55f_body``,
  ``w55f_weights``): 0.72x the direct form's multiply-adds;
* ``sep``: the direct form, the shipped ``conv_layer_forward_bf16`` at
  f=5 (``winograd.sep``), NHWC out.

``wino5`` is the wrapper of the ``csrc/wino5.cu`` kernel (all four modes,
on the tensor cores);
``wino5_plain`` its plain version, which follows each body's order of
rounding: in the quad modes every operand is rounded from f32 to bf16 at
its read, each group's dot is summed in strict f32 and the groups' partial
sums are added in tap order; in ``w55f`` V is made from the f32 quad image
by B6's row combinations in the body's order (zero coefficients skipped,
``tap * c``, added in f32), rounded once to bf16, then three K-slice dots
per row combination and the AT25 sums in f32. On CPU tensors the wrapper
runs the plain version, on CUDA tensors the kernel, or it raises.

    python -m cnn_sr_tpu_torch.probes.wino5 [--check] [--reps N] [--rounds N]
                                             [--device cuda|cpu]

``--check`` holds every mode at the probe's chunk (12x128 quad outputs,
k=64, n=32) against a float64 direct 5x5 convolution of the same block,
prints the probe's ``max|err|`` lines and exits 1 past ``REL_LIMIT``.
Without it each variant is timed at the flagship's 1080p conv2 (input
1072x1912x64, output 1068x1908x32; CUDA events). ``--device cpu`` runs the
plain versions and times them at a reduced size with the host clock:
those are CPU times, not the card's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.srcnn import strict_f32
from . import layout
from .winograd import direct_conv_f64, sep, sep_plain, timer

# the probe's shapes (tools/wino5_probe.py:55-62)
K, N = 64, 32           # conv2: 64 -> 32
F = 5
TG = (F + 1) // 2       # 3 half-res taps per axis
K4, N4 = 4 * K, 4 * N   # quad lanes
TR, TC = 12, 128        # output half-res rows x cols per chunk
TCP = 136               # input col sublanes (TC + 2, padded to 8)
OUT_1080P = (1068, 1908)  # the flagship's conv2 output at 1080x1920
OUT_CPU = (24, 64)        # the reduced output of --device cpu timing
MODES = ("quad", "quadp", "quad1", "w55f")
GROUP = {"quad": 1, "quadp": 2, "quad1": 9}
# --check, against the float64 direct conv: the quad modes sit at 3.5e-3
# (bf16 operands), w55f at 1.2e-2, in the probe's interpret run and here
# alike: its V, up to 10x an input in magnitude, is rounded once to bf16
REL_LIMIT = 2e-2
# the kernel's widths: 32 output channels, input channels a multiple of 16
# up to MAX_K, csrc/wino5_plan.cuh's kWino5MaxK (the quad modes' resident
# bf16 window and three weight stages take 212,160 bytes at k = 64)
KERNEL_N = 32
MAX_K = 64

_MODE_CODE = {"quad": 0, "quadp": 1, "quad1": 2, "w55f": 3}

# launches in this process of csrc/wino5.cu; the direct form's launches
# count in chain.LAUNCHES_BF16 and the pack's in layout.LAUNCHES
LAUNCHES = 0

# ---- copies of the probe's F(2,5) matrices (tools/wino5_probe.py:64-94) ----
B6 = np.array([
    [4, 0, -5, 0, 1, 0],
    [0, -4, -4, 1, 1, 0],
    [0, 4, -4, -1, 1, 0],
    [0, -2, -1, 2, 1, 0],
    [0, 2, -1, -2, 1, 0],
    [0, 4, 0, -5, 0, 1]], np.float64)
_PTS = [0.0, 1.0, -1.0, 2.0, -2.0]
_NRM = [0.25, -1 / 6, -1 / 6, 1 / 24, 1 / 24]
G25 = np.zeros((6, 5))
for _i, (_a, _n) in enumerate(zip(_PTS, _NRM)):
    G25[_i] = _n * np.asarray([_a ** j for j in range(5)])
G25[5, 4] = 1.0
AT25 = np.array([[1, 1, 1, 1, 1, 0],
                 [0, 1, -1, 2, -2, 1]], np.float64)


def _matrices_check():
    rng = np.random.default_rng(0)
    w = rng.standard_normal(5)
    d = rng.standard_normal(6)
    got = AT25 @ ((G25 @ w) * (B6 @ d))
    want = np.asarray([np.dot(d[j:j + 5], w) for j in range(2)])
    err = np.abs(got - want).max()
    assert err < 1e-9, f"F(2,5) matrices wrong: {err}"


def quad_weights(g):
    """g: (5, 5, k, n) -> (9*4k, 4n) shipping quad layout: block for tap
    (ro, co) maps input parity (rp, cp) to output parity (p, q) with
    w[2ro+rp-p, 2co+cp-q] (zero outside the footprint). The probe's
    ``quad_weights`` (:97), its widths read from ``g``."""
    _, _, k, n = g.shape
    wq = np.zeros((TG * TG, 4, k, 4, n), np.float32)
    for ro in range(TG):
        for co in range(TG):
            for rp in range(2):
                for cp in range(2):
                    for p in range(2):
                        for q in range(2):
                            dy = 2 * ro + rp - p
                            dx = 2 * co + cp - q
                            if 0 <= dy < F and 0 <= dx < F:
                                wq[ro * TG + co, 2 * rp + cp, :,
                                   2 * p + q, :] = g[dy, dx]
    return wq.reshape(TG * TG * 4 * k, 4 * n)


def w55f_weights(g):
    """g: (5, 5, k, n) -> (6, 6*k, 2*n): per row-combo a, the col-direct
    weights of the row-transformed filter u_a = G25 @ g over dy. K rows
    are (co, cp, c) raw half-res col taps; N cols are (q, n) output col
    parity x channel; entry u_a[2co+cp-q] with the (5/6)-fill col zeros.
    The probe's ``w55f_weights`` (:116), its widths read from ``g``."""
    _, _, k, n = g.shape
    u = np.einsum("ad,dxkn->axkn", G25, g.astype(np.float64))  # (6,5,k,n)
    w = np.zeros((6, TG, 2, k, 2, n), np.float64)
    for a in range(6):
        for co in range(TG):
            for cp in range(2):
                for q in range(2):
                    dx = 2 * co + cp - q
                    if 0 <= dx < F:
                        w[a, co, cp, :, q, :] = u[a, dx]
    return w.reshape(6, TG * 2 * k, 2 * n).astype(np.float32)


def weights(g: np.ndarray, mode: str, device="cpu") -> torch.Tensor:
    """The numpy weights ``g`` (5, 5, k, n) as ``mode`` takes them, made
    in numpy as the probe makes them and rounded once to bf16: (9·4k, 4n)
    for the quad modes, (6·3·2k, 2n) for ``w55f``."""
    _, _, k, n = g.shape
    w = quad_weights(g) if mode in GROUP else w55f_weights(g).reshape(6 * TG * 2 * k, 2 * n)
    return torch.from_numpy(w).to(device=device, dtype=torch.bfloat16)


def _geometry(x: torch.Tensor, w: torch.Tensor, out_hw, mode: str):
    """Check ``wino5``'s operands on every device alike; returns (k, n,
    TR, TC). ValueError for malformed ones, NotImplementedError past the
    kernel's widths."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    oh, ow = out_hw
    if oh <= 0 or ow <= 0 or oh % 2 or ow % 2:
        raise ValueError(f"the parity output needs an even output, got {oh}x{ow}")
    tr, tc = oh // 2, ow // 2
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous() or x.shape[2] % 4:
        raise ValueError(f"the quad image must be contiguous f32 (RH, CWP, 4k), got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] < tr + 2 or x.shape[1] < tc + 2:
        raise ValueError(f"the quad image must be at least ({tr + 2}, {tc + 2}, 4k) for a "
                         f"{oh}x{ow} output, got {tuple(x.shape)}")
    k = x.shape[2] // 4
    rows, lanes = (9 * 4 * k, 4) if mode in GROUP else (6 * TG * 2 * k, 2)
    if (w.dim() != 2 or w.shape[0] != rows or w.shape[1] % lanes or w.dtype != torch.bfloat16
            or not w.is_contiguous() or w.device != x.device):
        raise ValueError(f"{mode} weights must be contiguous bf16 ({rows}, {lanes}n) on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype} {w.device}")
    n = w.shape[1] // lanes
    if k <= 0 or k % 8 or n <= 0 or n % 8:
        raise ValueError(f"channels must be positive multiples of 8, got k={k}, n={n}")
    if n != KERNEL_N or k % 16 or k > MAX_K:
        raise NotImplementedError(f"the wino5 kernel takes n = {KERNEL_N} and k a multiple "
                                  f"of 16 up to {MAX_K}, got k={k}, n={n}")
    if x.is_cuda and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the kernel needs 16-byte aligned tensors")
    return k, n, tr, tc


def _planes(ys, tr: int, tc: int, n: int) -> torch.Tensor:
    """ReLU, bf16, the four (TR·TC, n) sums in plane order p·2 + q."""
    return torch.stack([torch.relu(y) for y in ys]).to(torch.bfloat16).view(2, 2, tr, tc, n)


def _quad_plain(x, w, k, n, tr, tc, group):
    ops = [x[ro:ro + tr, co:co + tc].to(torch.bfloat16).float().reshape(tr * tc, 4 * k)
           for ro in range(TG) for co in range(TG)]
    s = None
    for g0 in range(0, TG * TG, group):
        grp = ops[g0:g0 + group]
        op = grp[0] if len(grp) == 1 else torch.cat(grp, dim=1)
        m = op @ w[g0 * 4 * k:(g0 + len(grp)) * 4 * k].float()
        s = m if s is None else s + m
    return [s[:, pq * n:(pq + 1) * n] for pq in range(4)]


def _w55f_plain(x, w, k, n, tr, tc):
    ys = [None] * 4
    for a in range(6):
        v = None
        for ti in range(6):
            c = float(B6[a, ti])
            if c == 0.0:
                continue
            rp = ti % 2
            tap = x[ti // 2:ti // 2 + tr, 0:tc + 2, 2 * rp * k:2 * (rp + 1) * k]
            tap = tap if c == 1.0 else tap * c
            v = tap if v is None else v + tap
        v = v.to(torch.bfloat16).float()
        mdot = None
        for co in range(TG):
            op = v[:, co:co + tc].reshape(tr * tc, 2 * k)
            d = op @ w[(a * TG + co) * 2 * k:(a * TG + co + 1) * 2 * k].float()
            mdot = d if mdot is None else mdot + d
        for pz in range(2):
            c = float(AT25[pz, a])
            if c == 0.0:
                continue
            for q in range(2):
                m = mdot[:, q * n:(q + 1) * n]
                m = m if c == 1.0 else m * c
                i = 2 * pz + q
                ys[i] = m if ys[i] is None else ys[i] + m
    return ys


def wino5_plain(x: torch.Tensor, w: torch.Tensor, out_hw, mode: str = "quad") -> torch.Tensor:
    """``wino5`` in PyTorch, in each body's order of rounding (see the
    module's docstring)."""
    k, n, tr, tc = _geometry(x, w, out_hw, mode)
    with strict_f32():
        if mode in GROUP:
            ys = _quad_plain(x, w, k, n, tr, tc, GROUP[mode])
        else:
            ys = _w55f_plain(x, w, k, n, tr, tc)
    return _planes(ys, tr, tc, n)


def wino5(x: torch.Tensor, w: torch.Tensor, out_hw, mode: str = "quad") -> torch.Tensor:
    """The flagship's conv2 from the quad image ``x`` (RH, CWP, 4k) f32
    (``layout.pack_quad``; RH ≥ TR+2, CWP ≥ TC+2) with the bf16 weights
    ``w`` of ``weights(g, mode)`` into the ReLU'd parity output (2, 2, TR,
    TC, n) bf16, ``out[p, q, i, j] = y[2i+p, 2j+q]`` for the (rows, cols) =
    ``out_hw`` output (both even). ``mode`` is "quad", "quadp", "quad1" or
    "w55f". A launch of ``csrc/wino5.cu`` on CUDA tensors, the plain
    version on CPU tensors."""
    global LAUNCHES
    k, n, tr, tc = _geometry(x, w, out_hw, mode)
    if x.device.type == "cpu":
        return wino5_plain(x, w, out_hw, mode)
    from ..ops.fused.build import load_library

    lib = load_library()
    y = torch.empty((2, 2, tr, tc, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.wino5_forward(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0],
                                x.shape[1], k, tr, tc, _MODE_CODE[mode], stream)
    if err:
        raise RuntimeError("wino5 launch failed: " + lib.cnn_sr_error_string(err).decode())
    LAUNCHES += 1
    return y


def unpack_quad(a: np.ndarray) -> np.ndarray:
    """The full-resolution block of a quad image (RH, CWP, 4k), as the
    probe's ``--check`` rebuilds it (:270-274)."""
    rh, cwp, k4 = a.shape
    k = k4 // 4
    full = np.zeros((2 * rh, 2 * cwp, k), a.dtype)
    for rp in range(2):
        for cp in range(2):
            full[rp::2, cp::2] = a[:, :, (2 * rp + cp) * k:(2 * rp + cp + 1) * k]
    return full


def probe_inputs():
    """The probe's seeded inputs (:238-243): weights g (5, 5, 64, 32) and
    the quad image (14, 136, 256), f32, uniform in [−0.5, 0.5)."""
    rng = np.random.default_rng(0)
    g = (rng.random((F, F, K, N), np.float32) - 0.5).astype(np.float32)
    a = (rng.random((TR + 2, TCP, K4), np.float32) - 0.5)
    return g, a


def check(device) -> dict:
    """Every mode at the probe's chunk against the float64 direct 5x5
    convolution of the full-resolution block, as the probe's ``--check``
    does; the quad image is ``layout.pack_quad`` of that block. Prints the
    probe's lines; returns {mode: (max_abs, rel)}."""
    _matrices_check()
    g, a = probe_inputs()
    full = unpack_quad(a)
    x = layout.pack_quad(torch.from_numpy(full).to(device), TCP)
    if not torch.equal(x.cpu(), torch.from_numpy(a)):
        raise RuntimeError("pack_quad differs from the probe's quad image")
    ref = direct_conv_f64(full[:2 * TR + F - 1, :2 * TC + F - 1], g)
    want = ref.reshape(TR, 2, TC, 2, N).transpose(1, 3, 0, 2, 4)
    results = {}
    for mode in MODES:
        got = wino5(x, weights(g, mode, device), (2 * TR, 2 * TC), mode)
        err = float(np.abs(got.double().cpu().numpy() - want).max())
        rel = err / float(np.abs(want).max())
        print(f"{mode:6s} max|err| {err:.3e}  (rel {rel:.2e})")
        results[mode] = (err, rel)
    return results


def layer_inputs(out_hw, device, seed: int = 0):
    """Seeded inputs of conv2 with output ``out_hw``: the activation (R+4,
    C+4, 64) f32 uniform in [−0.5, 0.5) and weights (5, 5, 64, 32) f32
    (numpy) of scale 1/√(25k), made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    oh, ow = out_hw
    act = torch.rand((oh + F - 1, ow + F - 1, K), generator=gen, device=device) - 0.5
    g = (torch.rand((F, F, K, N), generator=gen, device=device) - 0.5) * (12.0 / (25 * K)) ** 0.5
    return act, g.cpu().numpy()


def layer_variants(out_hw, device, seed: int = 0):
    """The variants of conv2 with output ``out_hw`` on the seeded inputs of
    ``layer_inputs``, each as (kernel, plain): {kind: (fn, fn)}, and the
    inputs they read, made beforehand: {"act" (f32), "act_bf16", "gb" (bf16
    weights of ``sep``), "x" (the quad image), "w" ({mode: weights})}.
    ``pack`` is ``layout.pack_quad`` of the f32 activation."""
    act, g = layer_inputs(out_hw, device, seed)
    act_bf16 = act.to(torch.bfloat16)
    gb = torch.from_numpy(g).to(device=device, dtype=torch.bfloat16)
    x = layout.pack_quad(act)
    w = {mode: weights(g, mode, device) for mode in MODES}
    variants = {"sep": (lambda: sep(act_bf16, gb), lambda: sep_plain(act_bf16, gb))}
    for mode in MODES:
        variants[mode] = (lambda m=mode: wino5(x, w[m], out_hw, m),
                          lambda m=mode: wino5_plain(x, w[m], out_hw, m))
    variants["pack"] = (lambda: layout.pack_quad(act), lambda: layout.pack_quad_plain(act))
    return variants, {"act": act, "act_bf16": act_bf16, "gb": gb, "x": x, "w": w}


def time_layers(device, reps: int, rounds: int) -> dict:
    """ms of each variant's kernel (``layer_variants``) at ``OUT_1080P``,
    or ``OUT_CPU`` on the CPU, in ``rounds`` interleaved rounds of
    ``reps`` calls; {variant: [ms per round]}."""
    run = timer(device)
    out_hw = OUT_1080P if device.type == "cuda" else OUT_CPU
    variants, _ = layer_variants(out_hw, device)
    results = {}
    for _ in range(rounds):
        for kind, (fn, _) in variants.items():
            results.setdefault(kind, []).append(run(fn, reps))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.probes.wino5",
        description="F(2,5) and quad forms of the flagship's conv2 (f=5, 64→32) against "
                    "the direct layer.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--check", action="store_true",
                   help="each mode once against a float64 direct conv at the chunk shape")
    p.add_argument("--reps", type=int, default=10, help="timed calls per variant and round")
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    device = layout.device_of(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU (plain)"
    if args.check:
        bad = [m for m, (_, rel) in check(device).items() if not rel <= REL_LIMIT]
        if bad:
            print(f"check failed (rel > {REL_LIMIT}): {', '.join(bad)}")
        return 1 if bad else 0
    times = time_layers(device, args.reps, args.rounds)
    oh, ow = OUT_1080P if device.type == "cuda" else OUT_CPU
    print(f"ms of conv2 ({oh + F - 1}x{ow + F - 1}x{K} in, {oh}x{ow}x{N} out) on {name}, "
          f"best of {args.rounds} rounds of {args.reps} calls:")
    for kind, ms in times.items():
        print(f"{kind:<6} {min(ms):9.3f} ms  rounds " + " ".join(f"{t:.3f}" for t in ms))
    best = {kind: min(ms) for kind, ms in times.items()}
    print("sep / " + ", sep / ".join(f"{m} {best['sep'] / best[m]:.2f}x" for m in MODES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
