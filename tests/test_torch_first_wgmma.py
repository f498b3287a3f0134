"""The bf16 chain's first layer (``csrc/conv_first_wgmma.cu``,
``conv_first_forward_wgmma``): every first layer of the bf16 chain.

The kernel runs only on a card (the ``cuda`` tests below skip without
one). What a card run cannot show is held here on the CPU: that its plan
(``csrc/conv_first_plan.cuh``, compiled with ``g++``) is
``entry.first_layer_plan`` and fits a block, that it takes every first layer
the ``mma.sync`` stage it replaces took, that the route sends every first
layer to it, that ``entry.pack_bf16(first=True)`` unpacks to the folded
weights, and that the kernel's decomposition of the layer (per tile of
``cols`` columns x tile_rows rows, the raw f32 pixels of its window rows x
cols + f − 1 columns with zeros outside the image, quantised and
dx-expanded into kx lanes, each dy tap a start cols positions on, the
consumer warpgroups' m64 slabs over N in chunks of bn columns, the stores clipped
to the output) is ``reference.tap_layer(..., first=True)`` bit for bit, and
within the bf16 gate of ``tests/test_torch_bf16.py`` of the JAX package's
first layer. This module imports no JAX at its top; on a card its tests run
with

    python -m pytest tests/test_torch_first_wgmma.py -m cuda --noconftest
"""

import subprocess

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import build, chain, entry, fused_forward, reference
from cnn_sr_tpu_torch.probes import first_wgmma_parts
from cnn_sr_tpu_torch.utils.params_io import params_to_torch

RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128), (3, 128, 128),
        (3, 128, 3)]
PLAN_FIELDS = entry.FirstPlan._fields
# (f, c, n): RGB L1; the flagship's conv1 (on the chain in the three-launch
# form) and the wide 9-5-5's; n = 8, 16, 128 and 256 (two chunks of N) and
# 384; c = 2 and 4; the widest f the mma.sync stage took at each c (c = 1:
# 66 at n = 8, 64 at 128; c = 2: 48; c = 3: 37 at n = 32, 32 at 128; c = 4:
# 28 at 128 and 256); layers whose plans take each narrower tile width
# (32, 16, 8 and 4 columns)
LAYERS = {"rgb_l1": (3, 3, 32), "flagship_conv1": (9, 1, 64), "wide_955_conv1": (9, 1, 128),
          "f9_c1_n8": (9, 1, 8), "f3_c3_n8": (3, 3, 8), "f3_c3_n16": (3, 3, 16),
          "f3_c3_n128": (3, 3, 128), "f3_c3_n256": (3, 3, 256), "f5_c1_n384": (5, 1, 384),
          "f5_c2_n32": (5, 2, 32), "f3_c4_n64": (3, 4, 64), "f1_c4_n8": (1, 4, 8),
          "f66_c1_n8": (66, 1, 8), "f64_c1_n128": (64, 1, 128), "f48_c2_n32": (48, 2, 32),
          "f40_c2_n128": (40, 2, 128), "f37_c3_n32": (37, 3, 32), "f32_c3_n128": (32, 3, 128),
          "f32_c4_n8": (32, 4, 8), "f28_c4_n128": (28, 4, 128), "f28_c4_n256": (28, 4, 256),
          "f13_c1_n32": (13, 1, 32), "f17_c1_n128": (17, 1, 128), "f29_c3_n8": (29, 3, 8),
          "f34_c1_n64": (34, 1, 64)}
REFUSED = {"f0": (0, 1, 8), "c0": (3, 0, 8), "n_not_8": (3, 3, 12), "f90_c1": (90, 1, 8),
           "f34_c4": (34, 4, 8)}
# (layer (f, c, n), input (N, H, W), its span): each instance of the kernel
# (bn, slabs), W resident and streamed, one and two output buffers, N in
# one and two chunks, each tile width, ragged tiles, batches, a case with
# more tiles than a card has SMs, and inputs in (−1.3, 1.3), past the int8
# plane's clip at ±1, where the others stay in (−0.6, 0.6)
CASES = {"rgb_l1": ((3, 3, 32), (2, 21, 70), 1.3),
         "rgb_l1_many_tiles": ((3, 3, 32), (2, 130, 300), 0.6),
         "flagship_conv1": ((9, 1, 64), (1, 30, 41), 1.3),
         "wide_955_conv1": ((9, 1, 128), (2, 20, 75), 0.6),
         "f3_c3_n8": ((3, 3, 8), (1, 12, 70), 0.6),
         "f3_c3_n16": ((3, 3, 16), (2, 11, 40), 0.6),
         "f3_c3_n256": ((3, 3, 256), (1, 9, 70), 0.6),
         "f5_c2_n32": ((5, 2, 32), (1, 18, 80), 0.6),
         "f3_c4_n64": ((3, 4, 64), (1, 10, 66), 0.6),
         "f29_c3_n8": ((29, 3, 8), (1, 40, 45), 0.6),
         "f22_c4_n16": ((22, 4, 16), (1, 30, 40), 0.6),
         "f21_c4_n32": ((21, 4, 32), (1, 30, 40), 0.6),
         "f28_c4_n64": ((28, 4, 64), (1, 36, 40), 0.6),
         "f17_c1_n128": ((17, 1, 128), (1, 30, 40), 0.6),
         "f13_c4_n128": ((13, 4, 128), (1, 24, 40), 0.6),
         "f49_c1_n32": ((49, 1, 32), (1, 70, 56), 0.6),
         "f34_c1_n64": ((34, 1, 64), (1, 40, 44), 1.3),
         "f38_c3_n32": ((38, 3, 32), (1, 45, 45), 0.6),
         "f65_c1_n8": ((65, 1, 8), (1, 70, 70), 1.3)}
# the JAX package's first layer against the decomposition, at small sizes
JAX_CASES = {"rgb_l1": ((3, 3, 32), (1, 21, 37)),
             "flagship_conv1": ((9, 1, 64), (1, 30, 41))}


def _mma_sync_took(f, c, n):
    """Whether the ``mma.sync`` stage this kernel replaces took the layer:
    its window (the 16x16 tile and f − 1 halo rows, rows of kx + 8 lanes)
    and two stages of one tap's weights (rows of ``bn`` columns, 16 bytes
    more where bn / 8 is even) within ``SMEM_LIMIT``."""
    bn = min(entry.n_pad(n), 128)
    ws = bn if (bn // 8) % 2 else bn + 8
    kx = entry.kx_lanes(f, c)
    return 2 * (16 + f - 1) * 16 * (kx + 8) + 2 * 2 * kx * ws <= entry.SMEM_LIMIT


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``first_plan`` of ``csrc/conv_first_plan.cuh``, compiled with the
    host's C++ compiler: plan(f, c, n) -> the fields, or None where it
    refuses the layer."""
    tmp = tmp_path_factory.mktemp("conv_first_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "conv_first_plan.cuh"\nint main() {\n'
        '  int f, c, n;\n  scanf("%d %d %d", &f, &c, &n);\n'
        '  FirstPlan p;\n  if (first_plan(p, f, c, n)) {\n    printf("refused\\n");\n'
        '    return 0;\n  }\n'
        f'  printf("{" ".join(["%d"] * len(PLAN_FIELDS))}\\n", '
        + ", ".join(f"p.{k}" for k in PLAN_FIELDS) + ");\n}\n")
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)

    def plan(f, c, n):
        out = subprocess.run([str(exe)], input=f"{f} {c} {n}\n", check=True,
                             capture_output=True, text=True, timeout=60).stdout.strip()
        return None if out == "refused" else dict(zip(PLAN_FIELDS, map(int, out.split())))

    return plan


@pytest.mark.parametrize("name", list(LAYERS) + list(REFUSED))
def test_plan_matches_the_c_header(c_plan, name):
    layer = LAYERS.get(name) or REFUSED[name]
    got = c_plan(*layer)
    if name in REFUSED:
        assert got is None
        with pytest.raises(NotImplementedError, match="first"):
            entry.first_layer_plan(*layer)
        return
    assert got == entry.first_layer_plan(*layer)._asdict()


@pytest.mark.parametrize("name", list(LAYERS))
def test_plan_fits_a_block(name):
    """Shared bytes within ``SMEM_LIMIT``, summed from the buffers; the
    tile's four warpgroups' m64 slabs cover its rows x cols positions; a
    window holds its rows and f − 1 more, kx lanes of bf16 (planes of 8
    lanes, whose LBO a descriptor holds in 14 bits of 16-byte units); a raw
    stage holds those rows x cols + f − 1 pixels of c f32, each row to 4
    floats; tensor-copy boxes
    of at most 256 elements a dimension and swizzled rows of at most 128
    bytes, whose buffers keep the swizzle's 1024-byte alignment; W resident
    beside the deepest raw ring that fits (at most ``FIRST_MAX_RAW``), or
    streamed through two slices or more beside two raw stages; N's chunks
    cover its padded columns."""
    f, c, n = LAYERS[name]
    p = entry.first_layer_plan(f, c, n)
    assert p.smem <= entry.SMEM_LIMIT
    slack = 1024 + 8 * 2 * (entry.FIRST_MAX_RAW + entry.WG_MAX_RING)
    assert p.smem == slack + p.w_bytes + p.out_bytes + p.win_bytes + p.raw_ring * p.raw_bytes
    assert p.kx == entry.kx_lanes(f, c) and p.kx % 16 == 0 and p.kx >= f * c
    assert p.npad == entry.n_pad(n) and p.bn in (8, 16, 32, 64) and p.bn <= p.npad
    assert p.nchunks * p.bn == p.npad
    assert p.cols in entry.FIRST_COLS
    assert p.slabs in (entry.first_slabs(p.bn), 1)
    assert p.tile_rows * p.cols == entry.FIRST_WGS * p.slabs * 64
    assert p.win_rows == p.tile_rows + f - 1 and p.iw == p.cols + f - 1
    assert p.win_bufs in (1, 2) and (p.win_bufs, p.out_bufs) != (2, 1)
    assert p.win_bytes == p.win_bufs * p.win_rows * p.cols * p.kx * 2
    assert p.win_rows * p.cols * 16 < 16384 * 16
    assert p.raw_bytes == p.win_rows * -(-p.iw * c // 4) * 16
    lanes = min(p.bn, 64)
    out_box = (lanes, p.cols, p.slabs * 64 // p.cols, 1)
    w_box = (lanes, 16, 1)
    for box in (out_box, w_box):
        assert max(box) <= 256 and box[0] * 2 <= 128 and box[0] * 2 % 16 == 0
    assert p.w_slice == p.kx * p.bn * 2 and p.w_bytes % 1024 == 0
    assert p.out_bufs in (1, 2)
    assert p.out_bytes == p.out_bufs * entry.FIRST_WGS * p.slabs * 64 * p.bn * 2
    assert p.out_bytes % (entry.FIRST_WGS * p.out_bufs * 1024) == 0
    if p.w_res:
        assert p.w_ring == 0 and 2 <= p.raw_ring <= entry.FIRST_MAX_RAW
        assert 0 <= p.w_bytes - p.nchunks * f * p.w_slice < 1024
        assert p.raw_ring == entry.FIRST_MAX_RAW or p.smem + p.raw_bytes > entry.SMEM_LIMIT
    else:
        assert p.raw_ring == 2 and 2 <= p.w_ring <= entry.WG_MAX_RING
        assert 0 <= p.w_bytes - p.w_ring * p.w_slice < 1024


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_no_first_layer_the_mma_sync_stage_took_is_refused(c):
    """Every first layer over c ≤ 4 channels (the bf16 route's: its
    envelope) that the ``mma.sync`` stage took, f up to 80 and n up to 384,
    has a plan; and the widest of them at each c are among ``LAYERS``."""
    widths = (8, 16, 24, 32, 40, 64, 72, 128, 136, 256, 384)
    took = [(f, c, n) for f in range(1, 81) for n in widths if _mma_sync_took(f, c, n)]
    assert took
    for layer in took:
        assert entry.first_layer_plan(*layer).smem <= entry.SMEM_LIMIT
    widest = max(f for f, _, _ in took)
    assert any(layer[:2] == (widest, c) for layer in LAYERS.values())


def test_route_sends_every_first_layer_to_the_first_layer_kernel():
    """The chain's first layer takes ``conv_first_wgmma.cu`` at every shape
    (the RGB model's L1 in a tile of 64 x 8, its 3 KB of weights resident),
    the middles the wgmma stage and the last the last-layer kernel; no
    plan of the chain names the ``mma.sync`` stage."""
    kind, plans = entry.route(3, RGB7, 2)
    assert kind == "chain" and isinstance(plans[0], entry.FirstPlan)
    assert plans[0] == entry.first_layer_plan(3, 3, 32) == entry.bf16_layer_plan(3, 3, 32,
                                                                                   first=True)
    assert (plans[0].cols, plans[0].tile_rows, plans[0].w_res, plans[0].w_bytes) == (64, 8, 1,
                                                                                      3072)
    assert [type(p).__name__ for p in plans] == ["FirstPlan"] + ["WgmmaPlan"] * 5 + ["LastPlan"]
    for f, c, n in LAYERS.values():
        assert isinstance(entry.bf16_layer_plan(f, c, n, first=True), entry.FirstPlan)
    assert not hasattr(entry, "TcPlan") and not hasattr(entry, "tc_layer_plan")
    x = torch.zeros((1, 40, 40, 1))
    specs = [(9, 1, 128), (5, 128, 64), (5, 64, 1)]
    params = [{"w": torch.zeros((f, f, k, n)), "b": torch.zeros(n)} for f, k, n in specs]
    precision, kind, plans = entry._check(params, x, "bf16")
    assert (precision, kind) == ("bf16", "chain")
    assert plans[0] == entry.first_layer_plan(9, 1, 128)


@pytest.mark.parametrize("name", list(LAYERS))
def test_packed_first_weights_unpack_bit_for_bit(name):
    """``pack_bf16(first=True)``: tap dy, row dx·c + ci, column co holds
    ``fold_first(w)[dy, dx, ci, co]``; zero past f·c rows and n columns; the
    bias f32 and zero past n; made once per weight tensor."""
    f, c, n = LAYERS[name]
    w, b = _weights((f, c, n), 21)
    wp, bp = entry.pack_bf16(w, b, first=True)
    assert wp.dtype == torch.bfloat16 and wp.shape == (f, entry.kx_lanes(f, c), entry.n_pad(n))
    assert bp.dtype == torch.float32 and bp.shape == (entry.n_pad(n),)
    want = reference.fold_first(w)
    assert torch.equal(wp[:, :f * c, :n].reshape(f, f, c, n).view(torch.int16),
                       want.view(torch.int16))
    pad = wp.clone()
    pad[:, :f * c, :n] = 0
    assert not pad.view(torch.int16).any()
    assert torch.equal(bp[:n], b) and not bp[n:].any()
    assert entry.packed_bf16(w, b, True) is entry.packed_bf16(w, b, True)


def _weights(layer, seed):
    f, c, n = layer
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((f, f, c, n)) * np.sqrt(2.0 / (f * f * c)))
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32))
    return w, b


def _x(shape, c, seed, span=0.6):
    """A seeded centred input (N, H, W, c) in (−span, span); past ±1 where
    span is, so that the int8 plane's clip holds those pixels at ±127."""
    return np.random.default_rng(seed).uniform(-span, span, (*shape, c)).astype(np.float32)


def _emulate(x, wp, bp, plan):
    """The kernel's decomposition in PyTorch, f32: for each image and tile
    of tile_rows x cols outputs, its raw stage (win_rows rows x iw columns
    x c channels of f32 at the tile's corner, zeros outside the image), the
    window quantised from it (lane dx·c + ci of position (r, col) the raw
    row r's float col·c + lane, zeros past f·c lanes), flattened to
    win_rows·cols positions; for each chunk of bn columns and each of the
    four warpgroups' slabs (64 positions, (g·slabs + s)·64 on) the sum over
    dy of 64 window positions dy·cols further on @ W[dy]'s chunk, then the
    bias, ReLU, one rounding to bf16, stored only inside the output and
    below n."""
    nimg, h, w, c = x.shape
    f, n, cols, rows = plan.f, plan.n, plan.cols, plan.tile_rows
    oh, ow = h - f + 1, w - f + 1
    ty, tx = -(-oh // rows), -(-ow // cols)
    fc = f * c
    xz = torch.zeros((nimg, ty * rows + plan.win_rows, tx * cols + plan.iw, c))
    xz[:, :h, :w] = x
    q = reference.quantize(xz).reshape(nimg, xz.shape[1], xz.shape[2] * c)
    wf = wp.float()
    y = torch.zeros((nimg, ty * rows, tx * cols, plan.npad))
    for img in range(nimg):
        for oy0 in range(0, ty * rows, rows):
            for ox0 in range(0, tx * cols, cols):
                raw = q[img, oy0:oy0 + plan.win_rows, ox0 * c:(ox0 + plan.iw) * c]
                win = torch.zeros((plan.win_rows, cols, plan.kx))
                for col in range(cols):
                    win[:, col, :fc] = raw[:, col * c:col * c + fc]
                win = win.reshape(plan.win_rows * cols, plan.kx)
                for nc in range(plan.nchunks):
                    cs = slice(nc * plan.bn, (nc + 1) * plan.bn)
                    out = torch.zeros((entry.FIRST_WGS, plan.slabs, 64, plan.bn))
                    for g in range(entry.FIRST_WGS):
                        for m in range(plan.slabs):
                            for dy in range(f):
                                r0 = (g * plan.slabs + m) * 64 + dy * cols
                                out[g, m] += win[r0:r0 + 64] @ wf[dy, :, cs]
                    out = reference.round_bf16(torch.relu(out + bp[cs]))
                    y[img, oy0:oy0 + rows, ox0:ox0 + cols, cs] = out.reshape(rows, cols, plan.bn)
    return y[:, :oh, :ow, :n].contiguous()


def _case(name):
    (f, c, n), shape, span = CASES[name]
    plan = entry.first_layer_plan(f, c, n)
    x = torch.from_numpy(_x(shape, c, 11, span))
    w, b = _weights((f, c, n), 12)
    return x, entry.pack_bf16(w, b, first=True), plan


@pytest.mark.parametrize("name", [c for c in CASES if "many_tiles" not in c])
def test_decomposition_matches_tap_layer(name):
    """The tile, raw window, quantisation, dx-expansion, dy-offset, slab,
    chunk and clipped-store index math of the kernel against the plain
    version of the layer on seeded inputs: the same products summed in the
    same order (over the kx lanes, then dy), so bit for bit."""
    x, (wp, bp), plan = _case(name)
    got = _emulate(x, wp, bp, plan)
    ref = reference.tap_layer(x, wp, bp, plan.f, plan.n, first=True, last=False)
    assert got.shape == ref.shape == (x.shape[0], x.shape[1] - plan.f + 1,
                                      x.shape[2] - plan.f + 1, plan.n)
    assert torch.equal(got, ref)
    assert float(ref.abs().max()) > 0


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_decomposition_matches_jax_first_layer(name):
    """Against the JAX package's first layer of its bf16 stream: the int8
    plane (``weights._quantize_planes``) as patches
    (``weights._im2col_patches(..., int8=True)``) times w1 / 127 in bf16
    (the fold of ``weights.py:283``), f32 sums, the bias, ReLU and bf16. The
    gate of ``tests/test_torch_bf16.py`` for the plain bf16 stream: max 1e-2,
    mean 1e-3 (JAX sums the f²·c lanes in another order, and a sum at a
    bf16 tie may round the other way)."""
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.pallas_fused import weights as jweights

    (f, c, n), shape = JAX_CASES[name]
    x = _x(shape, c, 5)
    w, b = _weights((f, c, n), 6)
    patches = jweights._im2col_patches(jnp.asarray(x), f, jnp.bfloat16, int8=True)
    assert patches.dtype == jnp.int8
    w1 = (jnp.asarray(w.numpy()) / 127.0).astype(jnp.bfloat16).reshape(f * f * c, n)
    acc = jnp.einsum("nhwk,ko->nhwo", patches.astype(jnp.bfloat16), w1,
                     preferred_element_type=jnp.float32)
    want = np.asarray(jnp.maximum(acc + jnp.asarray(b.numpy()), 0.0)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    wp, bp = entry.pack_bf16(w, b, first=True)
    got = _emulate(torch.from_numpy(x), wp, bp, entry.first_layer_plan(f, c, n)).numpy()
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1e-2 and d.mean() <= 1e-3, (d.max(), d.mean())
    assert np.abs(want).max() > 0.1


def test_cases_cover_every_instance():
    """The card cases launch every instance of the kernel (bn, slabs), W
    resident and streamed, one and two windows and output buffers a
    warpgroup, N in two chunks, each tile width (each layer at its plan's
    own), a batch, more tiles than a card has SMs, and pixels past the
    clip."""
    plans = [entry.first_layer_plan(*layer) for layer, _, _ in CASES.values()]
    assert {(p.bn, p.slabs) for p in plans} == set(entry.first_instances())
    assert {p.w_res for p in plans} == {0, 1} and {p.out_bufs for p in plans} == {1, 2}
    assert {p.win_bufs for p in plans} == {1, 2}
    assert any(p.nchunks > 1 for p in plans)
    assert {p.cols for p in plans} == set(entry.FIRST_COLS)
    assert any(shape[0] > 1 for _, shape, _ in CASES.values())
    assert any(span > 1 for _, _, span in CASES.values())
    layer, shape, _ = CASES["rgb_l1_many_tiles"]
    p = entry.first_layer_plan(*layer)
    assert shape[0] * -(-(shape[1] - 2) // p.tile_rows) * -(-(shape[2] - 2) // p.cols) > 132


@pytest.mark.parametrize("variant", list(first_wgmma_parts.VARIANTS))
def test_parts_copies_are_the_kernel_without_their_parts(variant):
    """Each copy ``probes/first_wgmma_parts`` builds is the kernel's source
    with its parts' edits, every edit found once: no pixel copy, no
    16-byte pixel copy, no expansion store, no product, no staging store or no tensor-copy store
    where its part is out, and the plan's header inlined at two warpgroups
    with their registers where four warpgroups are out; the kernel's text
    elsewhere."""
    text = first_wgmma_parts.SOURCE.read_text()
    parts = first_wgmma_parts.VARIANTS[variant]
    out = first_wgmma_parts.shared.patched(first_wgmma_parts.SOURCE, first_wgmma_parts.PARTS,
                                           parts, text)
    gone = {"raw loads": ("cp_async16_n(dst", "cp_async4(dst"),
            "16-byte copies": ("% 16 == 0 && W * p.k % 4 == 0;",),
            "expand": ("pos < win_pos;",), "products": ("tap(ad, nc, 0,",),
            "staging": ("c8 < BN / 8; ++c8) {\n        const int col",),
            "stores": ("tma_store_4d(&to",),
            "four warpgroups": ('#include "conv_first_plan.cuh"', "kFirstConsumerRegs = 104")}
    for part, texts in gone.items():
        for t in texts:
            assert t in text
            assert (t in out) == (part not in parts), (part, t)
    assert ("constexpr int kFirstWgs = 2;" in out) == ("four warpgroups" in parts)
    assert "constexpr int kFirstWgs = 4;" not in out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_first_layer_matches_tap_layer_on_card(cuda_device, name):
    """One launch of ``conv_first_forward_wgmma`` through
    ``chain.layer_forward`` against ``reference.tap_layer(..., first=True)``
    on the card: within 2^-7 of the output's magnitude (the same bf16
    products, summed in another order, and a sum at a bf16 tie may round
    the other way), counted as a first-layer launch and a bf16 chain launch,
    not a wgmma-stage or last-layer one."""
    x, (wp, bp), plan = _case(name)
    x, wp, bp = x.to(cuda_device), wp.to(cuda_device), bp.to(cuda_device)
    y = torch.empty((x.shape[0], x.shape[1] - plan.f + 1, x.shape[2] - plan.f + 1, plan.n),
                    dtype=torch.bfloat16, device=cuda_device)
    before = (chain.LAUNCHES_BF16, chain.LAUNCHES_FIRST, chain.LAUNCHES_WGMMA,
              chain.LAUNCHES_LAST)
    chain.layer_forward(build.load_library(), x, wp, bp, y, plan, True, False, True,
                        torch.cuda.current_stream().cuda_stream)
    ref = reference.tap_layer(x, wp, bp, plan.f, plan.n, first=True, last=False)
    torch.cuda.synchronize()
    assert (chain.LAUNCHES_BF16, chain.LAUNCHES_FIRST, chain.LAUNCHES_WGMMA,
            chain.LAUNCHES_LAST) == (before[0] + 1, before[1] + 1, before[2], before[3])
    assert bool(torch.isfinite(y).all())
    assert float((y.float() - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_rgb_request_takes_one_first_layer_launch_on_card(cuda_device):
    """An RGB bf16 stack: one launch of the first-layer kernel (L1), five of
    the wgmma stage (L2-L6) and one of the last-layer kernel (L7), and no
    other, within 2^-7 of the plain bf16 stream."""
    rng = np.random.default_rng(13)
    params = params_to_torch(
        [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k))).astype(np.float32),
          "b": (rng.standard_normal(n) * 0.05).astype(np.float32)} for f, k, n in RGB7],
        cuda_device)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 45, 70, 3)).astype(np.float32)).to(cuda_device)
    counters = ("LAUNCHES_BF16", "LAUNCHES_FIRST", "LAUNCHES_WGMMA", "LAUNCHES_LAST")
    before = [getattr(chain, k) for k in counters]
    y = fused_forward(params, x, "bf16")
    ref = reference.fused_forward(params, x, "bf16")
    torch.cuda.synchronize()
    made = [getattr(chain, k) - b for k, b in zip(counters, before)]
    assert made == [7, 1, 5, 1]
    assert float((y - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_misaligned_tensor_is_refused_on_card(cuda_device):
    x, (wp, bp), plan = _case("rgb_l1")
    wp, bp = wp.to(cuda_device), bp.to(cuda_device)
    n, h, w, c = x.shape
    flat = torch.empty(x.numel() + 1, dtype=torch.float32, device=cuda_device)
    xm = flat[1:].view(n, h, w, c)  # 4 bytes past a 16-byte boundary
    xm.copy_(x)
    y = torch.empty((n, h - 2, w - 2, plan.n), dtype=torch.bfloat16, device=cuda_device)
    before = chain.LAUNCHES_FIRST
    with pytest.raises(ValueError, match="16-byte aligned"):
        chain.layer_forward(build.load_library(), xm, wp, bp, y, plan, True, False, True,
                            torch.cuda.current_stream().cuda_stream)
    assert chain.LAUNCHES_FIRST == before
