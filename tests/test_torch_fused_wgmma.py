"""The bf16 fused kernel on ``wgmma`` (``csrc/fused_wgmma.cu``,
``fused_srcnn_forward_bf16``): the 3-layer luma stacks of the bf16 stream in
one launch.

The kernel runs only on a card (the ``cuda`` tests below skip without one).
What a card run cannot show is held here on the CPU: that its plan
(``csrc/fused_wgmma_plan.cuh``, compiled with ``g++``) is
``entry.fused_wgmma_plan`` and fits a block, which stacks the route sends
to it and which it leaves to the chain, that the weights' shared-memory
images unpack to the packed weights, and that the kernel's decomposition of
the stack (output tiles, conv1's raster chunks over the window, conv2's 8 x
8 patches with each tap a start offset, the w2 slices in ring order, conv3's
raster chunks, the ragged edge; every operand read as its no-swizzle
descriptor reads it) is the bf16 stream of ``reference.fused_forward`` and
of the JAX package's Pallas kernel in interpret mode. This module imports
JAX only inside the test that needs it; on a card its tests run with

    python -m pytest tests/test_torch_fused_wgmma.py -m cuda --noconftest
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch import api
from cnn_sr_tpu_torch.ops.fused import build, chain, entry, fused_forward, reference, wgmma_probe
from cnn_sr_tpu_torch.probes import fused_wgmma_parts
from cnn_sr_tpu_torch.utils.config import read_config
from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]
C915 = [(9, 1, 64), (1, 64, 32), (5, 32, 1)]
NARROW_955 = [(9, 1, 8), (5, 8, 8), (5, 8, 1)]
RGB3 = [(3, 3, 16), (3, 16, 8), (3, 8, 3)]
WIDE_955 = [(9, 1, 128), (5, 128, 64), (5, 64, 1)]
# (stack, input channels): the stacks the route sends to the fused kernel,
# and stacks that reach its other instances: conv1 at N = 128, conv3's dx
# taps at N = 32 (n3 = 4), conv2 at N = 16 over two input channels
FUSED = {"flagship": (FLAGSHIP, 1), "9-1-5": (C915, 1), "narrow_955": (NARROW_955, 1),
         "rgb_3layer": (RGB3, 3), "n2_64": ([(9, 1, 64), (5, 64, 64), (5, 64, 1)], 1),
         "n1_128_f2_1": ([(9, 1, 128), (1, 128, 8), (5, 8, 1)], 1),
         "n3_4": ([(9, 1, 8), (5, 8, 8), (5, 8, 4)], 1),
         "n16_c2": ([(5, 2, 16), (3, 16, 16), (3, 16, 2)], 2)}
# stacks that took the mma.sync fused kernel and take the chain now: n2
# padded past 64 (three 8 x 8 patches of 64 sums each a warpgroup at the
# least conv2 tile, 24 x 24) or an a1 tile of 128-lane rows that does not
# fit beside the window, w3 and two w2 slots; and the wide 9-5-5, on the
# chain before too
TO_CHAIN = {"n2_128_f2_1": ([(9, 1, 32), (1, 32, 128), (5, 128, 1)], 1),
            "n2_128_f3": ([(9, 1, 16), (3, 16, 128), (3, 128, 1)], 1),
            "n1_128": ([(9, 1, 128), (3, 128, 32), (3, 32, 1)], 1),
            "wide_955": (WIDE_955, 1)}
PLAN_FIELDS = entry.FusedWgmmaPlan._fields


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``fused_wgmma_plan`` of ``csrc/fused_wgmma_plan.cuh``, compiled with
    the host's C++ compiler: plan(c, layers) -> the fields, or None where it
    refuses the stack."""
    tmp = tmp_path_factory.mktemp("fused_wgmma_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "fused_wgmma_plan.cuh"\nint main() {\n'
        '  int c, f1, n1, f2, n2, f3, n3;\n'
        '  scanf("%d %d %d %d %d %d %d", &c, &f1, &n1, &f2, &n2, &f3, &n3);\n'
        '  FusedWgmmaPlan p;\n'
        '  if (fused_wgmma_plan(p, c, f1, n1, f2, n2, f3, n3)) {\n'
        '    printf("refused\\n");\n    return 0;\n  }\n'
        f'  printf("{" ".join(["%d"] * len(PLAN_FIELDS))}\\n", '
        + ", ".join(f"p.{k}" for k in PLAN_FIELDS) + ");\n}\n")
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)

    def plan(c, layers):
        (f1, _, n1), (f2, _, n2), (f3, _, n3) = layers
        out = subprocess.run([str(exe)], input=f"{c} {f1} {n1} {f2} {n2} {f3} {n3}\n",
                             check=True, capture_output=True, text=True, timeout=60).stdout
        out = out.strip()
        return None if out == "refused" else dict(zip(PLAN_FIELDS, map(int, out.split())))

    return plan


# refused by the plan itself: c = 5, f3·n3 = 45 > 32, n1 padded to 256
REFUSED = {"c5": ([(3, 5, 8), (3, 8, 8), (3, 8, 1)], 5),
           "f3n3_45": ([(9, 1, 8), (5, 8, 8), (5, 8, 9)], 1),
           "n1_256": ([(9, 1, 256), (1, 256, 8), (5, 8, 1)], 1)}


@pytest.mark.parametrize("name", list(FUSED) + list(TO_CHAIN) + list(REFUSED))
def test_plan_matches_the_c_header(c_plan, name):
    specs, c = FUSED.get(name) or TO_CHAIN.get(name) or REFUSED[name]
    got = c_plan(c, specs)
    want = entry.fused_wgmma_plan(c, specs)
    assert (got is None) == (want is None) == (name not in FUSED)
    if want is not None:
        assert got == want._asdict()


@pytest.mark.parametrize("name", list(FUSED))
def test_plan_fits_a_block(name):
    """Shared bytes within ``SMEM_LIMIT`` and their sum; a2 a multiple of 8
    of at least 24 around the output tile; a warpgroup's conv2 sums within
    96 floats a thread; the chunks' reach inside the window's and a2's
    positions; every buffer 16-byte aligned; two ring slots or more (one at
    f2 = 1)."""
    specs, c = FUSED[name]
    (f1, _, n1), (f2, _, n2), (f3, _, n3) = specs
    p = entry.fused_wgmma_plan(c, specs)
    assert p.smem <= entry.SMEM_LIMIT
    assert p.smem == (p.r0 + p.w1_bytes + p.r1 + p.w3_bytes + p.raw_bytes + p.ring * p.slice
                      + entry.FW_BAR_BYTES)
    assert p.a2 % 8 == 0 and 24 <= p.a2 <= 32 and p.tile == p.a2 - f3 + 1
    assert (p.a1, p.ih) == (p.a2 + f2 - 1, p.a2 + f2 + f1 - 2)
    assert p.patches == (p.a2 // 8) ** 2 and p.per_wg == -(-p.patches // 3)
    assert p.per_wg * p.n2p // 2 <= entry.FW_ACC_FLOATS
    assert p.chunks1 * 64 >= p.a1 ** 2 and p.chunks3 * 64 >= p.tile * p.a2
    assert p.win_pos >= p.chunks1 * 64 + (f1 - 1) * p.a1 and p.win_pos >= p.ih * p.a1
    assert p.a2_pos >= p.chunks3 * 64 + (f3 - 1) * p.a2 and p.a2_pos >= p.a2 ** 2
    assert p.r0 == max(p.win_bytes, p.a2_bytes)
    assert p.r1 == max(p.a1_bytes, p.e_bytes) and p.e_bytes == p.chunks3 * 64 * p.n3p * 4
    assert p.raw_bytes == -(-p.ih * (p.a1 + f1 - 1) * c * 4 // 16) * 16  # the pixels, f32
    for size in (p.win_bytes, p.w1_bytes, p.r0, p.r1, p.w3_bytes, p.raw_bytes, p.slice):
        assert size % 16 == 0
    assert (p.kx, p.n1p, p.k2, p.n2p, p.k3, p.n3p) == (
        entry.kx_lanes(f1, c), entry.n_pad(n1), entry.k_pad(n1), entry.n_pad(n2), entry.k_pad(n2),
        entry.n_pad(f3 * n3))
    assert min(2, f2 * f2) <= p.ring <= entry.FW_MAX_RING


def test_flagship_plan_matches_the_design():
    """The flagship: a 20x20 output tile, conv2 over 24x24 (nine patches,
    three a warpgroup), conv1 over 28x28 in 13 chunks, conv3 in 8 with its
    five dx taps in N = 8; the window 1,056 positions x 16 lanes in the
    bytes that a2, 608 positions x 32 lanes, later takes; w1 9·16·64; a1
    784 x 64 lanes (later conv3's 512 x 8 f32 sums); w3 5·32·8; the next
    tile's 36 x 36 pixels in f32; eight w2 slices of 64·32 and the
    mbarriers."""
    p = entry.fused_wgmma_plan(1, FLAGSHIP)
    assert (p.tile, p.a2, p.a1, p.ih) == (20, 24, 28, 36)
    assert (p.chunks1, p.patches, p.per_wg, p.chunks3, p.n3p) == (13, 9, 3, 8, 8)
    assert (p.win_pos, p.a2_pos) == (1056, 608)
    assert p.r0 == 2 * 608 * 32 == 38_912 > 2 * 1056 * 16 and p.w1_bytes == 2 * 9 * 16 * 64
    assert (p.a1_bytes, p.e_bytes, p.r1) == (2 * 784 * 64, 512 * 8 * 4, 100_352)
    assert (p.w3_bytes, p.raw_bytes, p.slice, p.ring) == (2 * 5 * 32 * 8, 4 * 36 * 36, 4096, 8)
    assert p.smem == 38_912 + 18_432 + 100_352 + 2_560 + 5_184 + 8 * 4096 + 152 == 198_360
    assert entry.route(1, FLAGSHIP, 2) == ("fused", p)
    # the 9-1-5 takes the largest tile: conv2 over 32x32, 16 patches
    p = entry.fused_wgmma_plan(1, C915)
    assert (p.tile, p.a2, p.per_wg, p.ring) == (28, 32, 6, 1)


@pytest.mark.parametrize("name", list(FUSED) + list(TO_CHAIN))
def test_route_of_each_stack(name):
    """Every stack runs in bf16: the fused kernel where its plan fits, else
    the chain (whose plans are ``bf16_layer_plan``'s)."""
    specs, c = FUSED.get(name) or TO_CHAIN[name]
    kind, plan = entry.route(c, specs, 2)
    if name in FUSED:
        assert kind == "fused" and plan == entry.fused_wgmma_plan(c, specs)
        return
    assert kind == "chain" and entry.fused_wgmma_plan(c, specs) is None
    assert [p.smem <= entry.SMEM_LIMIT for p in plan] == [True] * 3
    assert isinstance(plan[0], entry.FirstPlan) and isinstance(plan[-1], entry.LastPlan)


def _bf16_weights(params):
    """``entry.packed_bf16`` of every layer, as the kernels' plain version
    (``reference.tap_layer``) takes them: the first layer dx-expanded and
    folded, every other one tap-major."""
    return [entry.packed_bf16(layer["w"], layer["b"], i == 0) for i, layer in enumerate(params)]


def _params(specs, seed, device="cpu"):
    """He-scaled weights, so that activations stay O(1) through the stack."""
    rng = np.random.default_rng(seed)
    return params_to_torch(
        [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k))).astype(np.float32),
          "b": (rng.standard_normal((n,)) * 0.05).astype(np.float32)} for f, k, n in specs],
        device)


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)


@pytest.mark.parametrize("name", list(FUSED))
def test_weight_images_unpack_to_the_packed_weights(name):
    """Each tap of the weight images read as the kernel's K-major
    descriptor reads it (core matrix (kb, nb) at (kb·N/8 + nb)·128 bytes,
    its row n the 8 lanes of K): conv1's and conv2's are the taps of
    ``pack_bf16``, conv3's tap dy holds ``w3[dy, dx, ci, c]`` in row ci,
    column dx·n3 + c, bit for bit, zero elsewhere; made once per weight
    tensor, with ``pack_bf16``'s biases."""
    specs, _ = FUSED[name]
    params = _params(specs, 1)
    images = entry.fused_weights(params)
    packed = _bf16_weights(params)
    for i, ((img, bp), (wp, bq)) in enumerate(zip(images, packed)):
        if i == 2:
            f, _, k, n = params[2]["w"].shape
            wp = torch.zeros((f, entry.k_pad(k), entry.n_pad(f * n)), dtype=torch.bfloat16)
            for dx in range(f):
                wp[:, :k, dx * n:(dx + 1) * n] = params[2]["w"][:, dx].to(torch.bfloat16)
        taps, k, n = wp.shape
        assert img.shape == (taps, k // 8, n // 8, 8, 8) and img.dtype == torch.bfloat16
        flat = img.reshape(taps, -1)
        for kk in (0, k - 1):
            for nn in (0, n - 1, n // 2):
                off = ((kk // 8) * (n // 8) + nn // 8) * 64 + (nn % 8) * 8 + kk % 8
                assert torch.equal(flat[:, off].view(torch.int16), wp[:, kk, nn].view(torch.int16))
        assert torch.equal(_read_b(img, 0, k), wp.float())  # bf16 values, exact in f32
        assert bp is bq
    assert all(a[0] is b[0] for a, b in zip(images, entry.fused_weights(params)))


def _planes(t):
    """(positions, lanes) -> the kernel's planes of 8 lanes (lanes / 8,
    positions, 8)."""
    return t.view(t.shape[0], -1, 8).permute(1, 0, 2)


def _read_a(planes, start, sbo, ks):
    """The 64 x 16 A operand a no-swizzle K-major descriptor reads at
    ``start`` positions with its 8-row groups ``sbo`` positions apart:
    row m is position start + (m / 8)·sbo + m % 8, lanes 16 ks ..
    16 ks + 15 (planes 2 ks and 2 ks + 1)."""
    rows = start + torch.arange(64) // 8 * sbo + torch.arange(64) % 8
    return torch.cat([planes[2 * ks, rows], planes[2 * ks + 1, rows]], dim=1)


def _read_b(img, ks, kk=16):
    """K rows 16 ks .. 16 ks + kk − 1 of K-major images (..., K / 8, N / 8,
    8, 8) as (..., kk, N)."""
    part = img[..., 2 * ks:2 * ks + kk // 8, :, :, :].float()
    return part.transpose(-1, -2).transpose(-3, -2).reshape(*img.shape[:-4], kk, -1)


def _emulate(params, x, plan):
    """The kernel's decomposition in PyTorch, f32 sums over bf16 values. Per
    image and output tile: the quantised, dx-expanded window (zeros outside
    the image and at its positions past ih x a1); conv1 per raster chunk of
    64 a1 positions, tap dy a start dy·a1 into the window, stored where the
    position is inside a1; conv2 per 8 x 8 patch, tap (dy, dx) a start dy·a1
    + dx from the patch's corner, SBO one a1 row, the w2 slices in the
    ring's order; a2's positions past a2 x a2 hold NaN (in the kernel, what
    the window and w1 left there), so that a stored output that read one
    shows; conv3 per raster chunk of the output rows a2 wide, its dy taps a
    start dy·a2, its dx taps the columns dx·n3 + c of one product, their
    f32 sums then shifted by dx and added, inside the tile and the
    image."""
    (w1i, b1), (w2i, b2), (w3i, b3) = entry.fused_weights(params)
    nimg, h, w, c = x.shape
    p = plan
    s = p.f1 + p.f2 + p.f3 - 3
    oh, ow = h - s, w - s
    q = reference.quantize(x)
    y = torch.full((nimg, oh, ow, p.n3), float("nan"))
    m = torch.arange(64)
    for img in range(nimg):
        for oy0 in range(0, oh, p.tile):
            for ox0 in range(0, ow, p.tile):
                win = torch.zeros((p.win_pos, p.kx))
                rows = min(p.ih, h - oy0)
                for dx in range(p.f1):
                    cols = max(0, min(p.a1, w - ox0 - dx))
                    part = torch.zeros((p.ih, p.a1, c))
                    part[:rows, :cols] = q[img, oy0:oy0 + rows, ox0 + dx:ox0 + dx + cols]
                    win[:p.ih * p.a1, dx * c:(dx + 1) * c] = part.reshape(-1, c)
                wpl = _planes(win)
                a1 = torch.zeros((p.a1 * p.a1, p.k2))
                for ch in range(p.chunks1):
                    acc = torch.zeros((64, p.n1p))
                    for dy in range(p.f1):
                        for ks in range(p.kx // 16):
                            acc += _read_a(wpl, ch * 64 + dy * p.a1, 8, ks) @ _read_b(w1i[dy], ks)
                    out = reference.round_bf16(torch.relu(acc + b1))
                    pos = ch * 64 + m
                    keep = pos < p.a1 * p.a1
                    a1[pos[keep], :p.n1p] = out[keep]
                a1p = _planes(a1)
                a2 = torch.zeros((p.a2_pos, p.k3))
                a2[p.a2 * p.a2:, :p.n2p] = float("nan")
                side = p.a2 // 8
                for patch in range(p.patches):
                    py, px = divmod(patch, side)
                    corner = py * 8 * p.a1 + px * 8
                    acc = torch.zeros((64, p.n2p))
                    for t in range(p.f2 * p.f2):  # the ring's order: slot t % ring
                        dy, dx = divmod(t, p.f2)
                        for ks in range(p.k2 // 16):
                            acc += (_read_a(a1p, corner + dy * p.a1 + dx, p.a1, ks)
                                    @ _read_b(w2i[t], ks))
                    out = reference.round_bf16(torch.relu(acc + b2))
                    a2[(py * 8 + m // 8) * p.a2 + px * 8 + m % 8, :p.n2p] = out
                a2p = _planes(a2)
                e = torch.zeros((p.chunks3 * 64, p.n3p))
                for ch in range(p.chunks3):
                    for dy in range(p.f3):
                        for ks in range(p.k3 // 16):
                            e[ch * 64:ch * 64 + 64] += (
                                _read_a(a2p, ch * 64 + dy * p.a2, 8, ks) @ _read_b(w3i[dy], ks))
                for ty in range(min(p.tile, oh - oy0)):
                    for tx in range(min(p.tile, ow - ox0)):
                        r = ty * p.a2 + tx
                        out = b3[:p.n3].clone()
                        for dx in range(p.f3):
                            out += e[r + dx, dx * p.n3:(dx + 1) * p.n3]
                        y[img, oy0 + ty, ox0 + tx] = out
    return y


# (stack, input channels, input shape): ragged tile grids, a batch
EMULATED = {"flagship": (FLAGSHIP, 1, (1, 41, 47)),
            "flagship_ragged_batch": (FLAGSHIP, 1, (2, 37, 29)),
            "9-1-5": (C915, 1, (1, 45, 33)), "narrow_955": (NARROW_955, 1, (1, 40, 70)),
            "rgb_3layer": (RGB3, 3, (1, 40, 70)), "n2_64": (FUSED["n2_64"][0], 1, (1, 30, 31)),
            "n1_128_f2_1": (FUSED["n1_128_f2_1"][0], 1, (1, 32, 25)),
            "n3_4": (FUSED["n3_4"][0], 1, (2, 30, 27)),
            "n16_c2": (FUSED["n16_c2"][0], 2, (1, 40, 37))}


@pytest.mark.parametrize("name", list(EMULATED))
def test_decomposition_matches_the_stream(name):
    """The decomposition against ``reference.fused_forward(..., "bf16")`` on
    seeded inputs: the same bf16 products summed in another order, so an
    activation can round to the neighbouring bf16 value: within 2^-7 of
    the output's largest magnitude. Every output is written once and none
    read a position past a2's tile (no NaN)."""
    specs, c, shape = EMULATED[name]
    params = _params(specs, 2)
    x = torch.from_numpy(_x((*shape, c), 3))
    got = _emulate(params, x, entry.fused_wgmma_plan(c, specs))
    ref = reference.fused_forward(params, x, "bf16")
    assert got.shape == ref.shape and not torch.isnan(got).any()
    assert float((got - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())
    assert float(ref.abs().max()) > 0


@pytest.mark.parametrize("name", ["narrow_955", "rgb_3layer"])
def test_decomposition_matches_jax_pallas_interpret(name):
    """Against the JAX package's Pallas kernel in interpret mode
    (``fused_forward(..., input_int8=True)`` at its bf16 default), with the
    gate of ``tests/test_torch_bf16.py`` for the plain bf16 stream (max
    1e-2, mean 1e-3: the interpret mode keeps the last layer's weights in
    f32 and sums some taps in bf16)."""
    from cnn_sr_tpu.ops.pallas_fused import fused_forward as jfused_forward

    specs, c, shape = EMULATED[name]
    rng = np.random.default_rng(4)
    params = [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k)))
               .astype(np.float32), "b": (rng.standard_normal(n) * 0.05).astype(np.float32)}
              for f, k, n in specs]
    x = _x((*shape, c), 5)
    want = np.asarray(jfused_forward(params, x, tile_h=16, tile_w=128, input_int8=True))
    got = _emulate(params_to_torch(params, "cpu"), torch.from_numpy(x),
                   entry.fused_wgmma_plan(c, specs)).numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1e-2 and d.mean() <= 1e-3, (d.max(), d.mean())


@pytest.mark.parametrize("variant", list(fused_wgmma_parts.VARIANTS))
def test_parts_copies_are_the_kernel_with_their_edits(variant):
    """Each copy ``probes/fused_wgmma_parts`` builds is the kernel's source
    with its parts' edits, every edit found as often as its table says: the
    six phase timers, the tile count and the C function that reads them; in
    ``zeroed sums`` the sums of conv1, conv2 and conv3 zeroed and no first
    product left."""
    text = fused_wgmma_parts.SOURCE.read_text()
    parts = fused_wgmma_parts.VARIANTS[variant]
    out = fused_wgmma_parts.patched(parts, text)
    assert text.count("wgmma_kk_first<N>(") == 3
    assert out.count("FW_PHASE(") == 7 and "fw_phases_read" in out
    assert out.count("wgmma_kk_first<N>(") == (0 if "zeroed sums" in parts else 3)
    assert out.count("] = 0.f;\n") == (3 if "zeroed sums" in parts else 0)


# -- the descriptor probe, and on the card ------------------------------------

def _decode(case):
    """A and B of a descriptor-probe case read back from its images as the
    descriptors address them (the swizzled A with the chunk of row r at c ^
    (r % 8) in 128-byte rows, c ^ (r / 2 % 4) in 64-byte rows, by absolute
    row, the base-offset field unused), and their product."""
    start = (case.desc_a & 0x3fff) * 16
    sbo = ((case.desc_a >> 32) & 0x3fff) * 16
    img = torch.from_numpy(np.ascontiguousarray(case.a_img)).view(torch.bfloat16).float()
    if case.desc_a >> 62 == 1:  # 128-byte rows, 16-byte chunks swizzled by the row
        r0 = start // 128
        rows = [img[r, np.arange(8) ^ (r % 8)].reshape(-1)[:16] for r in range(r0, r0 + 64)]
        a = torch.stack(rows)
    elif case.desc_a >> 62 == 2:  # 64-byte rows of 32 lanes, chunks swizzled by row / 2
        r0, lane0 = start // 64, start % 64 // 2
        rows = [img[r, np.arange(4) ^ (r // 2 % 4)].reshape(-1)[lane0:lane0 + 16]
                for r in range(r0, r0 + 64)]
        a = torch.stack(rows)
    else:  # planes of 8 lanes, a position a 16-byte row; 8-row groups sbo apart
        pos = [start // 16 + m // 8 * (sbo // 16) + m % 8 for m in range(64)]
        a = torch.cat([img[0, pos], img[1, pos]], dim=1)
    bimg = torch.from_numpy(np.ascontiguousarray(case.b_img)).view(torch.bfloat16).float()
    if case.b_kmajor:  # [kb][nb][n][k]
        b = bimg.permute(0, 3, 1, 2).reshape(16, 32)
    else:  # [k][chunk ^ (k / 2 % 4)][8 n]
        b = torch.stack([bimg[r, np.arange(4) ^ (r // 2 % 4)].reshape(-1) for r in range(16)])
    return (a @ b).numpy()


@pytest.mark.parametrize("k", [0, 1, 7, 23])
def test_descriptor_probe_cases_decode_to_their_products(k):
    """The probe's operand images, read back as their descriptors address
    them, multiply to the product each case expects."""
    for case in wgmma_probe.cases(k):
        np.testing.assert_array_equal(_decode(case), case.want, err_msg=case.name)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 7, 23])
def test_shifted_descriptor_product_on_card(cuda_device, k):
    """One wgmma m64n32k16 whose A starts k positions into a tile of 400
    positions x 16 lanes (k = 23: one 20-wide tile row and 3), against the
    same rows' product in numpy (small integers: exact). The no-swizzle
    planes the fused kernel reads, as 64 raster rows (SBO 128 bytes) and as
    an 8 x 8 patch (SBO one tile row), 128-byte swizzled rows with the
    matrix-base offset 0, and 64-byte swizzled rows of 32 lanes from their
    second 16 lanes (the chain's wgmma stage at K <= 32) read right, with B
    K-major (``wgmma_kk``) and
    MN-major in the 64-byte swizzle (``wgmma_m64n32k16_ss``). The swizzle
    is the address's own: with the base offset set to the start's row
    within the 1024-byte period the same rows read wrong."""
    for case in wgmma_probe.cases(k):
        got = wgmma_probe.product(case, cuda_device)
        if case.name.startswith("128-byte swizzle, base offset") and "offset 0" not in case.name:
            assert not np.array_equal(got, case.want), case.name
        else:
            np.testing.assert_array_equal(got, case.want, err_msg=case.name)


# (stack, input (N, H, W, C)): the flagship, a ragged batch, a 17x33 output
# (one partial tile), the 9-1-5, the narrow 9-5-5 in a batch of three, the
# 3-layer RGB stack, and the stacks that reach the other instances
CARD = {"flagship": (FLAGSHIP, (1, 80, 272, 1)),
        "flagship_ragged_batch": (FLAGSHIP, (2, 97, 131, 1)),
        "flagship_17x33": (FLAGSHIP, (1, 16 + 17, 16 + 33, 1)), "9-1-5": (C915, (1, 80, 272, 1)),
        "narrow_955": (NARROW_955, (3, 45, 70, 1)), "rgb_3layer": (RGB3, (2, 50, 77, 3)),
        "n2_64": (FUSED["n2_64"][0], (1, 61, 70, 1)),
        "n1_128_f2_1": (FUSED["n1_128_f2_1"][0], (1, 61, 70, 1)),
        "n3_4": (FUSED["n3_4"][0], (2, 53, 66, 1)), "n16_c2": (FUSED["n16_c2"][0], (1, 50, 77, 2))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD))
def test_kernel_matches_plain_on_card(cuda_device, name):
    """One launch of the kernel against ``reference.fused_forward(...,
    "bf16")`` on the card: within 2^-7 of the output's largest magnitude
    (the same bf16 products, summed in another order), counted once in
    ``entry.LAUNCHES_BF16`` and nowhere else."""
    specs, shape = CARD[name]
    params = _params(specs, 7, cuda_device)
    x = torch.from_numpy(_x(shape, 8)).to(cuda_device)
    before = (entry.LAUNCHES, chain.LAUNCHES, entry.LAUNCHES_BF16, chain.LAUNCHES_BF16)
    y = fused_forward(params, x, "bf16")
    ref = reference.fused_forward(params, x, "bf16")
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip(
        (entry.LAUNCHES, chain.LAUNCHES, entry.LAUNCHES_BF16, chain.LAUNCHES_BF16), before))
    assert made == (0, 0, 1, 0)
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_one_launch_a_request_on_card(cuda_device):
    """A 1080p bf16 request of the pretrained flagship through
    ``api.upscale_image``: exactly one fused bf16 launch, within ±1 uint8 of
    the same pipeline over the plain bf16 version."""
    cfg = read_config(os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json"))
    params = params_to_torch(init_params(cfg)[0], cuda_device)
    rgba = np.random.default_rng(0).integers(0, 256, (1080, 1920, 4), dtype=np.uint8)
    before = (entry.LAUNCHES_BF16, chain.LAUNCHES_BF16, entry.LAUNCHES, chain.LAUNCHES)
    out = api.upscale_image(cfg, params, rgba, precision="bf16")
    assert (entry.LAUNCHES_BF16, chain.LAUNCHES_BF16, entry.LAUNCHES, chain.LAUNCHES) == (
        before[0] + 1,) + before[1:]
    plain = api._upscale_luma(lambda x: reference.fused_forward(params, x, "bf16"),
                              torch.from_numpy(rgba).to(cuda_device),
                              add_mean=cfg.zero_mean_target,
                              squared_mean=cfg.subtract_squared_mean).cpu().numpy()
    assert out.shape == (1080, 1920, 3)
    assert int(np.abs(out.astype(np.int16) - plain.astype(np.int16)).max()) <= 1
