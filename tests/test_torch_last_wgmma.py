"""The bf16 chain's last layer (``csrc/conv_last_wgmma.cu``,
``conv_last_forward_wgmma``): every last layer of the bf16 chain.

The kernel runs only on a card (the ``cuda`` tests below skip without
one). What a card run cannot show is held here on the CPU: that its plan
(``csrc/conv_last_plan.cuh``, compiled with ``g++``) is
``entry.last_layer_plan`` and fits a block, that the route sends every last
layer to it, that ``entry.pack_last`` unpacks to the layer's weights, and
that the kernel's decomposition of the layer (per tile of tile_rows rows x
64 input columns, one tensor-copy box per chunk of 32 or 64 lanes
of K and group of dy taps with the copies' zero fill, each dy tap a row
offset into its box, one product per dy tap with the dx taps side by side
in N, column (dx − d0)·n + c, then the dx shift-add of the staged sums) is
``reference.tap_layer(..., last=True)``. This module imports no JAX; on a
card its tests run with

    python -m pytest tests/test_torch_last_wgmma.py -m cuda --noconftest
"""

import subprocess

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import build, chain, entry, fused_forward, reference
from cnn_sr_tpu_torch.utils.params_io import params_to_torch

RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128), (3, 128, 128),
        (3, 128, 3)]
# a 4-layer stack whose last layer has an even f
EVEN_LAST = [(3, 3, 32), (3, 32, 32), (3, 32, 32), (4, 32, 1)]
PLAN_FIELDS = entry.LastPlan._fields
# (f, k, n): RGB L7; the 3-layer luma stacks' conv3 on the chain (f = 5
# over 32 lanes); f = 9 into one output over 32 and 256 channels (W
# streamed, four chunks of K); eight outputs at f = 3; f = 17 at eight
# outputs (136 columns: two dx groups); K = 16 (32-lane boxes); an f = 1
# layer; f = 53 (dy taps in six boxes); f = 5 at 64 columns, f = 15 at 120;
# even f: 4 over 32 lanes into one output, 2 at RGB L7's width, 6 into four
# outputs, 8 into 12, 12 into 16 (two dx groups), 32 into 2, 54 (the widest
# the mma.sync stage took, at K = 8) and 63, the widest a tile of 64 columns
# takes
LAYERS = {"rgb_l7": (3, 128, 3), "f5_k32_n1": (5, 32, 1), "f9_k32_n1": (9, 32, 1),
          "f9_k256_n1": (9, 256, 1), "f3_k128_n8": (3, 128, 8), "f17_k32_n8": (17, 32, 8),
          "f3_k16_n3": (3, 16, 3), "f1_k64_n4": (1, 64, 4), "f53_k64_n1": (53, 64, 1),
          "f5_k64_n12": (5, 64, 12), "f15_k72_n8": (15, 72, 8), "f4_k32_n1": (4, 32, 1),
          "f2_k128_n3": (2, 128, 3), "f6_k64_n4": (6, 64, 4), "f12_k32_n16": (12, 32, 16),
          "f8_k16_n12": (8, 16, 12), "f32_k64_n2": (32, 64, 2), "f54_k8_n1": (54, 8, 1),
          "f63_k16_n1": (63, 16, 1)}
REFUSED = {"f0": (0, 32, 1), "f64": (64, 16, 1), "f_past_63": (65, 16, 1),
           "k_odd": (3, 12, 3), "n_past_128": (3, 128, 129)}
# (layer, input (N, H, W)): a ragged batch where the card test time allows;
# each instance of the kernel (npad, lanes, slabs), and a case with more
# tiles than a card has SMs
CASES = {"rgb_l7": ((3, 128, 3), (2, 11, 70)),
         "rgb_l7_many_tiles": ((3, 128, 3), (4, 130, 200)),
         "f5_k32_n1": ((5, 32, 1), (2, 23, 70)),
         "f9_k32_n1": ((9, 32, 1), (1, 27, 75)),
         "f9_k256_n1": ((9, 256, 1), (1, 20, 70)),
         "f3_k128_n8": ((3, 128, 8), (2, 18, 35)),
         "f17_k32_n8": ((17, 32, 8), (1, 25, 70)),
         "f3_k16_n3": ((3, 16, 3), (1, 20, 37)),
         "f1_k64_n4": ((1, 64, 4), (2, 9, 40)),
         "f5_k64_n12": ((5, 64, 12), (1, 14, 70)),
         "f15_k72_n8": ((15, 72, 8), (1, 18, 80)),
         "f5_k16_n12": ((5, 16, 12), (1, 12, 68)),
         "f3_k32_n8": ((3, 32, 8), (1, 12, 35)),
         "f3_k16_n40": ((3, 16, 40), (1, 10, 33)),
         "f1_k16_n128": ((1, 16, 128), (1, 5, 34)),
         "f9_k32_n8": ((9, 32, 8), (1, 14, 70)),
         "f4_k32_n1": ((4, 32, 1), (2, 23, 70)),
         "f2_k128_n3": ((2, 128, 3), (1, 15, 66)),
         "f6_k64_n4": ((6, 64, 4), (1, 14, 70)),
         "f12_k32_n16": ((12, 32, 16), (1, 20, 75)),
         "f54_k8_n1": ((54, 8, 1), (1, 60, 70))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``last_plan`` of ``csrc/conv_last_plan.cuh``, compiled with the
    host's C++ compiler: plan(f, k, n) -> the fields, or None where it
    refuses the layer."""
    tmp = tmp_path_factory.mktemp("conv_last_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "conv_last_plan.cuh"\nint main() {\n'
        '  int f, k, n;\n  scanf("%d %d %d", &f, &k, &n);\n'
        '  LastPlan p;\n  if (last_plan(p, f, k, n)) {\n    printf("refused\\n");\n'
        '    return 0;\n  }\n'
        f'  printf("{" ".join(["%d"] * len(PLAN_FIELDS))}\\n", '
        + ", ".join(f"p.{k}" for k in PLAN_FIELDS) + ");\n}\n")
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)

    def plan(f, k, n):
        out = subprocess.run([str(exe)], input=f"{f} {k} {n}\n", check=True,
                             capture_output=True, text=True, timeout=60).stdout.strip()
        return None if out == "refused" else dict(zip(PLAN_FIELDS, map(int, out.split())))

    return plan


@pytest.mark.parametrize("name", list(LAYERS) + list(REFUSED))
def test_plan_matches_the_c_header(c_plan, name):
    layer = LAYERS.get(name) or REFUSED[name]
    got = c_plan(*layer)
    if name in REFUSED:
        assert got is None
        with pytest.raises(NotImplementedError, match="last-layer kernel"):
            entry.last_layer_plan(*layer)
        return
    assert got == entry.last_layer_plan(*layer)._asdict()


@pytest.mark.parametrize("name", list(LAYERS))
def test_plan_fits_a_block(name):
    """Shared bytes within ``SMEM_LIMIT``, summed from the buffers;
    tensor-copy boxes of at most 256 elements a dimension and swizzled rows
    of at most 128 bytes; a dy shift of whole swizzle atoms; the dx groups
    of at most 128 columns covering the f dx taps; the tile's output
    columns at least one; W resident beside the deepest A ring that fits
    (at most ``WG_MAX_RING``), or streamed through two stages or more beside
    two A stages, its bytes to a multiple of 1024; the groups cover the f dy
    taps; K's chunks cover its lanes."""
    f, k, n = LAYERS[name]
    p = entry.last_layer_plan(f, k, n)
    cols = entry.LAST_COLS
    assert p.smem <= entry.SMEM_LIMIT
    assert p.smem == entry.WG_SLACK + p.a_ring * p.a_box + p.w_bytes + p.e_bytes
    assert p.w_bytes % 1024 == 0 and p.a_box % 1024 == 0
    assert p.kp == entry.k_pad(k) and p.lanes == (32 if p.kp <= 32 else 64)
    assert p.chunks * p.lanes >= k
    assert p.gdx * (p.dgroups - 1) < f <= p.gdx * p.dgroups and p.gdx * n <= p.npad <= 128
    assert p.npad == entry.n_pad(p.gdx * n) and (p.dgroups == 1) == (f * n <= 128)
    assert p.out_cols == cols - f + 1 >= 1
    assert p.slabs == entry.last_slabs(p.npad)
    assert p.tile_rows * cols == 2 * p.slabs * 64
    a_box = (p.lanes, cols, p.box_rows, 1)
    w_box = (min(p.npad, 64), p.lanes, 1)
    for box in (a_box, w_box):
        assert max(box) <= 256 and box[0] * 2 <= 128 and box[0] * 2 % 16 == 0
    atom = 8 * p.lanes * 2  # the swizzle's period: 8 rows
    assert cols * p.lanes * 2 % atom == 0 and 64 * p.lanes * 2 % atom == 0
    assert p.a_box == p.box_rows * cols * p.lanes * 2
    assert p.w_slice == p.lanes * p.npad * 2
    assert p.e_bytes == 2 * p.slabs * 64 * (p.npad + entry.LAST_PAD) * 4
    if p.w_res:
        assert p.w_ring == 0 and 2 <= p.a_ring <= entry.WG_MAX_RING
        assert p.a_ring == entry.WG_MAX_RING or p.smem + p.a_box > entry.SMEM_LIMIT
        assert 0 <= p.w_bytes - p.chunks * p.dgroups * f * p.w_slice < 1024
    else:
        assert p.a_ring == 2
        assert p.w_ring >= 2 and 0 <= p.w_bytes - p.w_ring * p.w_slice < 1024
    assert p.box_rows == p.tile_rows + p.gy - 1
    assert p.gy * (p.groups - 1) < f <= p.gy * p.groups


def test_route_sends_every_last_layer_to_the_last_layer_kernel():
    """The chain's last layer takes ``conv_last_wgmma.cu`` at every shape
    the ``mma.sync`` stage took (n ≤ 8, K a multiple of 8, f odd or even up
    to 54) and on to f = 63; the first takes the first-layer kernel. A
    stack whose last layer has an even f runs on the chain in bf16."""
    kind, plans = entry.route(3, RGB7, 2)
    assert kind == "chain" and isinstance(plans[-1], entry.LastPlan)
    assert plans[-1] == entry.last_layer_plan(3, 128, 3)
    assert (plans[-1].npad, plans[-1].w_res, plans[-1].a_ring) == (16, 1, 3)
    assert (plans[-1].tile_rows, plans[-1].out_cols) == (4, 62)
    assert isinstance(plans[0], entry.FirstPlan)
    for f in range(1, 64):
        for k, n in ((8, 1), (32, 3), (128, 8), (256, 4)):
            assert isinstance(entry.bf16_layer_plan(f, k, n, last=True), entry.LastPlan)
    x = torch.zeros((1, 20, 20, 3))
    params = [{"w": torch.zeros((f, f, k, n)), "b": torch.zeros(n)} for f, k, n in EVEN_LAST]
    precision, kind, plans = entry._check(params, x, "bf16")
    assert (precision, kind) == ("bf16", "chain")
    assert [type(p).__name__ for p in plans] == ["FirstPlan", "WgmmaPlan", "WgmmaPlan",
                                                 "LastPlan"]
    assert plans[-1] == entry.last_layer_plan(4, 32, 1)


@pytest.mark.parametrize("name", list(LAYERS))
def test_packed_last_weights_unpack_bit_for_bit(name):
    """``pack_last``: slice dg·f + dy, column (dx − d0)·n + c, row ci holds
    ``w[dy, dx, ci, c]`` in bf16 for the group's taps; zero elsewhere; the
    bias f32 and zero past n; made once per weight tensor."""
    f, k, n = LAYERS[name]
    w, b = _weights((f, k, n), 21)
    plan = entry.last_layer_plan(f, k, n)
    wl, bl = entry.pack_last(w, b, plan)
    assert wl.dtype == torch.bfloat16 and wl.shape == (plan.dgroups * f, plan.kp, plan.npad)
    assert bl.dtype == torch.float32 and bl.shape == (entry.n_pad(n),)
    got = torch.zeros((f, f, k, n), dtype=torch.bfloat16)
    seen = torch.zeros_like(wl, dtype=torch.bool)
    for dx in range(f):
        dg, t = divmod(dx, plan.gdx)
        got[:, dx] = wl[dg * f:(dg + 1) * f, :k, t * n:(t + 1) * n]
        seen[dg * f:(dg + 1) * f, :k, t * n:(t + 1) * n] = True
    assert torch.equal(got.view(torch.int16), w.to(torch.bfloat16).view(torch.int16))
    assert not wl[~seen].view(torch.int16).any()
    assert torch.equal(bl[:n], b) and not bl[n:].any()
    assert entry.packed_last(w, b, plan) is entry.packed_last(w, b, plan)


def _weights(layer, seed):
    f, k, n = layer
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k)))
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32))
    return w, b


def _layer(layer, shape, seed, device="cpu"):
    """A seeded bf16 input (N, H, W, k) in [0, 1) (a ReLU'd activation),
    the layer's He-scaled weights and bias packed for the kernel
    (``pack_last``) and for its plain version (``pack_bf16``)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((*shape, layer[1]), np.float32)).to(device, torch.bfloat16)
    w, b = (t.to(device) for t in _weights(layer, seed + 1))
    plan = entry.last_layer_plan(*layer)
    return x, entry.pack_last(w, b, plan), entry.pack_bf16(w, b, first=False)


def _emulate(x, wl, bl, plan):
    """The kernel's decomposition in PyTorch, f32: for each image, tile of
    tile_rows output rows x out_cols output columns (``LAST_COLS`` input
    columns at its corner) and dx group dg, for each chunk of ``lanes``
    lanes of K and group of dy taps one box of A (box_rows x LAST_COLS
    positions x lanes, zeros outside the image and past K), flattened to
    rows; each dy tap a row offset (dy − g0)·LAST_COLS into it; the two
    warpgroups' 2·slabs m64 slabs 64 rows apart; W slice dg·f + dy of the
    chunk's lanes (zeros past K_pad) x npad columns. Then the staged sums
    e[position][(dx − d0)·n + c], shifted by dx and added to the bias (the
    first group) or to the group before's output, stored only inside the
    output."""
    nimg, h, w, k = x.shape
    f, n, tc, oc, rows, lanes = (plan.f, plan.n, entry.LAST_COLS, plan.out_cols, plan.tile_rows,
                                 plan.lanes)
    oh, ow = h - f + 1, w - f + 1
    ty, tx = -(-oh // rows), -(-ow // oc)
    xz = torch.zeros((nimg, ty * rows + plan.groups * plan.gy + rows, tx * oc + tc,
                      plan.chunks * lanes))
    xz[:, :h, :w, :k] = x.float()
    wz = torch.zeros((plan.dgroups * f, max(plan.kp, plan.chunks * lanes), plan.npad))
    wz[:, :plan.kp] = wl.float()
    y = torch.zeros((nimg, ty * rows, tx * oc, n))
    for img in range(nimg):
        for oy0 in range(0, ty * rows, rows):
            for ox0 in range(0, tx * oc, oc):
                for dg in range(plan.dgroups):
                    acc = torch.zeros((2 * plan.slabs, 64, plan.npad))
                    for c in range(plan.chunks):
                        for g0 in range(0, f, plan.gy):
                            box = xz[img, oy0 + g0:oy0 + g0 + plan.box_rows, ox0:ox0 + tc,
                                     c * lanes:(c + 1) * lanes]
                            box = box.reshape(plan.box_rows * tc, lanes)
                            for dy in range(g0, min(f, g0 + plan.gy)):
                                wsl = wz[dg * f + dy, c * lanes:(c + 1) * lanes]
                                for q in range(2 * plan.slabs):
                                    r0 = (dy - g0) * tc + 64 * q
                                    acc[q] += box[r0:r0 + 64] @ wsl
                    e = acc.reshape(rows, tc, plan.npad)
                    d0 = dg * plan.gdx
                    out = y[img, oy0:oy0 + rows, ox0:ox0 + oc] if dg else bl[:n].expand(rows, oc, n)
                    y[img, oy0:oy0 + rows, ox0:ox0 + oc] = out + sum(
                        e[:, d0 + t:d0 + t + oc, t * n:(t + 1) * n]
                        for t in range(min(f, d0 + plan.gdx) - d0))
    return y[:, :oh, :ow].contiguous()


@pytest.mark.parametrize("name", [c for c in CASES if "many_tiles" not in c])
def test_decomposition_matches_tap_layer(name):
    """The tile, box, slab, dx-column and shift-add index math of the kernel
    against the plain version of the layer on seeded inputs: the same bf16
    products in f32, summed in another order, so within 1e-5 of the
    output's magnitude."""
    layer, shape = CASES[name]
    f, _, n = layer
    x, (wl, bl), (wp, bp) = _layer(layer, shape, seed=11)
    got = _emulate(x, wl, bl, entry.last_layer_plan(*layer))
    ref = reference.tap_layer(x, wp, bp, f, n, first=False, last=True)
    assert got.shape == ref.shape == (shape[0], shape[1] - f + 1, shape[2] - f + 1, n)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert float(ref.abs().max()) > 0


def test_cases_cover_every_instance():
    """The card cases launch every instance of the kernel (npad, box lanes,
    slabs), one with two dx groups, one with W streamed, and even and odd
    f."""
    plans = [entry.last_layer_plan(*layer) for layer, _ in CASES.values()]
    assert {(p.npad, p.lanes, p.slabs) for p in plans} == set(entry.last_instances())
    assert any(p.dgroups > 1 for p in plans) and any(not p.w_res for p in plans)
    assert {p.f % 2 for p in plans} == {0, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_last_layer_matches_tap_layer_on_card(cuda_device, name):
    """One launch of ``conv_last_forward_wgmma`` through
    ``chain.layer_forward`` against ``reference.tap_layer(..., last=True)``
    on the card: within 2^-7 of the output's magnitude (the same bf16
    products, summed in another order), counted as a last-layer launch and
    a bf16 chain launch, not a wgmma-stage one."""
    layer, shape = CASES[name]
    f, _, n = layer
    x, (wl, bl), (wp, bp) = _layer(layer, shape, seed=12, device=cuda_device)
    plan = entry.bf16_layer_plan(*layer, last=True)
    assert plan == entry.last_layer_plan(*layer)
    y = torch.empty((shape[0], shape[1] - f + 1, shape[2] - f + 1, n), dtype=torch.float32,
                    device=cuda_device)
    before = (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA, chain.LAUNCHES_LAST)
    chain.layer_forward(build.load_library(), x, wl, bl, y, plan, False, True, True,
                        torch.cuda.current_stream().cuda_stream)
    ref = reference.tap_layer(x, wp, bp, f, n, first=False, last=True)
    torch.cuda.synchronize()
    assert (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA, chain.LAUNCHES_LAST) == (
        before[0] + 1, before[1], before[2] + 1)
    assert bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_rgb_request_takes_one_last_layer_launch_on_card(cuda_device):
    """An RGB bf16 stack: one launch of the first-layer kernel (L1), five
    of the wgmma stage (L2-L6) and one of the last-layer kernel (L7),
    within 2^-7 of the plain bf16 stream."""
    rng = np.random.default_rng(13)
    params = params_to_torch(
        [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k))).astype(np.float32),
          "b": (rng.standard_normal(n) * 0.05).astype(np.float32)} for f, k, n in RGB7],
        cuda_device)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 45, 70, 3)).astype(np.float32)).to(cuda_device)
    before = (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA, chain.LAUNCHES_LAST)
    y = fused_forward(params, x, "bf16")
    ref = reference.fused_forward(params, x, "bf16")
    torch.cuda.synchronize()
    made = tuple(a - b for a, b in zip((chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA,
                                        chain.LAUNCHES_LAST), before))
    assert (made[0] - made[1] - made[2], made[1], made[2]) == (1, 5, 1)
    assert float((y - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_misaligned_tensor_is_refused_on_card(cuda_device):
    layer = LAYERS["rgb_l7"]
    _, (wl, bl), _ = _layer(layer, (1, 20, 20), seed=14, device=cuda_device)
    flat = torch.empty(20 * 20 * 128 + 1, dtype=torch.bfloat16, device=cuda_device)
    x = flat[1:].view(1, 20, 20, 128)  # 2 bytes past a 16-byte boundary
    y = torch.empty((1, 18, 18, 3), dtype=torch.float32, device=cuda_device)
    before = chain.LAUNCHES_LAST
    with pytest.raises(ValueError, match="16-byte aligned"):
        chain.layer_forward(build.load_library(), x, wl, bl, y, entry.bf16_layer_plan(
            *layer, last=True), False, True, True, torch.cuda.current_stream().cuda_stream)
    assert chain.LAUNCHES_LAST == before
