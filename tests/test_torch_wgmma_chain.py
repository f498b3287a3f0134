"""The bf16 chain's wgmma stage (``csrc/conv_wgmma.cu``,
``conv_layer_forward_wgmma``): the middle layers at n > 64.

The kernel runs only on a card (the ``cuda`` tests below skip without
one). What a card run cannot show is held here on the CPU: that its plan
(``csrc/conv_wgmma_plan.cuh``, compiled with ``g++``) is
``entry.wgmma_layer_plan`` and fits a block, that the route sends exactly
the middle layers at n > 64 to it, and that the kernel's decomposition of
the layer (per 16x16 tile and 128-column chunk, one tensor-copy box per
64-lane chunk of K, dx and group of dy taps with the copies' zero fill,
each dy tap a row offset into its box, two m64 slabs a warpgroup) is
``reference.tap_layer``. The bf16 stream against the JAX package's
Pallas kernel in interpret mode stays in ``tests/test_torch_bf16.py``
(``test_plain_bf16_matches_jax_pallas_interpret``). This module imports
no JAX; on a card its tests run with

    python -m pytest tests/test_torch_wgmma_chain.py -m cuda --noconftest
"""

import subprocess

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import build, chain, entry, fused_forward, reference
from cnn_sr_tpu_torch.utils.params_io import params_to_torch

RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128), (3, 128, 128),
        (3, 128, 3)]
FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]
C915 = [(9, 1, 64), (1, 64, 32), (5, 32, 1)]
PLAN_FIELDS = ("f", "k", "n", "kp", "npad", "chunks", "gy", "groups", "box_rows", "a_box",
               "a_ring", "w_ring", "smem")
# (f, k, n): RGB L5 and L6, two N chunks, K = 16, the wide f's, a K and an
# n that pad (72 -> 128 lanes, 136 -> 256 columns), f = 19 and 53 (dy
# taps in two and four boxes)
LAYERS = {"L5": (3, 64, 128), "L6": (3, 128, 128), "n256": (3, 128, 256), "k16": (3, 16, 128),
          "f5": (5, 128, 128), "f9": (9, 128, 128), "k72_n136": (3, 72, 136),
          "f19": (19, 64, 128), "f53": (53, 64, 128)}
REFUSED = {"f_even": (4, 64, 128), "n64": (3, 64, 64), "k_odd": (3, 12, 128)}
# (layer, input (N, H, W)): a ragged batch of two where the card test time allows
CASES = {"L5": (LAYERS["L5"], (2, 21, 37)), "L6": (LAYERS["L6"], (2, 19, 42)),
         "n256": (LAYERS["n256"], (1, 20, 35)), "k16": (LAYERS["k16"], (2, 18, 18)),
         "f5": ((5, 64, 128), (1, 23, 40)), "f9": ((9, 64, 128), (2, 27, 26)),
         "k72_n136": (LAYERS["k72_n136"], (1, 20, 19)), "f19": (LAYERS["f19"], (1, 40, 36))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``wgmma_plan`` of ``csrc/conv_wgmma_plan.cuh``, compiled with the
    host's C++ compiler: plan(f, k, n) -> the fields, or None where it
    refuses the layer."""
    tmp = tmp_path_factory.mktemp("conv_wgmma_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "conv_wgmma_plan.cuh"\nint main() {\n'
        '  int f, k, n;\n  scanf("%d %d %d", &f, &k, &n);\n  WgmmaPlan p;\n'
        '  if (wgmma_plan(p, f, k, n)) {\n    printf("refused\\n");\n    return 0;\n  }\n'
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
        with pytest.raises(NotImplementedError, match="wgmma stage takes"):
            entry.wgmma_layer_plan(*layer)
        return
    assert got == {k: getattr(entry.wgmma_layer_plan(*layer), k) for k in PLAN_FIELDS}


@pytest.mark.parametrize("name", list(LAYERS))
def test_plan_fits_a_block(name):
    """Shared bytes within ``SMEM_LIMIT``; tensor-copy boxes of at most 256
    elements a dimension and swizzled rows of at most 128 bytes; a tile
    whose dy shift is whole 1024-byte swizzle atoms (16 columns, a multiple
    of 8); two stages or more in each ring; the groups cover the f dy
    taps; K's chunks cover its lanes and the packing's N."""
    f, k, n = LAYERS[name]
    p = entry.wgmma_layer_plan(f, k, n)
    assert p.smem <= entry.SMEM_LIMIT
    assert p.smem == (entry.WG_SLACK + p.a_ring * p.a_box + p.w_ring * entry.WG_W_SLICE
                      + entry.WG_OUT)
    a_box = (entry.WG_LANES, entry.WG_TILE, p.box_rows, 1)
    w_box = (entry.WG_LANES, entry.WG_LANES, 1)
    out_box = (entry.WG_LANES, entry.WG_TILE, entry.WG_TILE // 2, 1)
    for box in (a_box, w_box, out_box):
        assert max(box) <= 256 and box[0] * 2 <= 128
    assert entry.WG_TILE % 8 == 0 and entry.WG_TILE * 128 % 1024 == 0
    assert p.a_box == p.box_rows * entry.WG_TILE * 128 and p.a_box % 1024 == 0
    assert p.a_ring >= 2 and p.w_ring >= 2
    assert p.box_rows == entry.WG_TILE + p.gy - 1
    assert p.gy * (p.groups - 1) < f <= p.gy * p.groups
    assert p.chunks * entry.WG_LANES >= k and (p.kp, p.npad) == (entry.k_pad(k), entry.n_pad(n))
    assert p.npad % entry.WG_N == 0


def test_route_sends_the_wide_middle_layers_to_wgmma(monkeypatch):
    kind, plans = entry.route(3, RGB7, 2)
    assert kind == "chain"
    stages = [type(p).__name__ for p in plans]
    assert stages == ["TcPlan"] * 4 + ["WgmmaPlan"] * 2 + ["TcPlan"]
    assert plans[4] == entry.wgmma_layer_plan(3, 64, 128)
    assert plans[5] == entry.wgmma_layer_plan(3, 128, 128)
    assert not any(p.first or p.last for p in plans[4:6])
    assert entry.route(1, FLAGSHIP, 2)[0] == "fused" and entry.route(1, C915, 2)[0] == "fused"
    # the plan, not a launch, decides: the mma.sync stage has no middle
    # layer at n > 64 left, first layers at n > 64 stay on it
    with pytest.raises(NotImplementedError, match="wgmma stage"):
        entry.tc_layer_plan(3, 64, 128)
    assert type(entry.bf16_layer_plan(3, 3, 128, first=True)).__name__ == "TcPlan"
    # a layer the plan refuses raises before any launch, on every device
    monkeypatch.setattr(entry, "SMEM_LIMIT", 100_000)
    with pytest.raises(NotImplementedError, match="do not fit"):
        entry.route(3, RGB7, 2)


def _emulate(x, wp, bp, plan):
    """The kernel's decomposition in PyTorch, f32: for each image, 16x16
    tile and 128-column chunk, for each 64-lane chunk of K, dx and group of
    dy taps one box of A (box_rows x 16 positions x 64 lanes at the tile's
    corner + (g0, dx), zeros outside the image and past K), flattened to
    rows; each dy tap of the group a row offset (dy − g0)·16 into it; each
    warpgroup g its slabs 2g, 2g + 1 (rows 64·(2g + s) on); W slices of
    the tap's 64 rows (zeros past K_pad) x the chunk's 128 columns. Then
    bias, ReLU, bf16, stored only inside the output."""
    nimg, h, w, k = x.shape
    f, t, lanes = plan.f, entry.WG_TILE, entry.WG_LANES
    oh, ow = h - f + 1, w - f + 1
    ty, tx = -(-oh // t), -(-ow // t)
    xz = torch.zeros((nimg, ty * t + plan.groups * plan.gy + t, tx * t + f + t,
                      plan.chunks * lanes))
    xz[:, :h, :w, :k] = x.float()
    wz = torch.zeros((f * f, max(plan.kp, plan.chunks * lanes), plan.npad))
    wz[:, :plan.kp] = wp.float()
    y = torch.zeros((nimg, ty * t, tx * t, plan.npad))
    for img in range(nimg):
        for oy0 in range(0, ty * t, t):
            for ox0 in range(0, tx * t, t):
                for n0 in range(0, plan.npad, entry.WG_N):
                    acc = torch.zeros((4, 64, entry.WG_N))
                    for c in range(plan.chunks):
                        for dx in range(f):
                            for g0 in range(0, f, plan.gy):
                                box = xz[img, oy0 + g0:oy0 + g0 + plan.box_rows,
                                         ox0 + dx:ox0 + dx + t, c * lanes:(c + 1) * lanes]
                                box = box.reshape(plan.box_rows * t, lanes)
                                for dy in range(g0, min(f, g0 + plan.gy)):
                                    wsl = wz[dy * f + dx, c * lanes:(c + 1) * lanes,
                                             n0:n0 + entry.WG_N]
                                    for g in range(2):
                                        for s in range(2):
                                            r0 = (dy - g0) * t + 64 * (2 * g + s)
                                            acc[2 * g + s] += box[r0:r0 + 64] @ wsl
                    out = torch.relu(acc.reshape(t * t, entry.WG_N) + bp[n0:n0 + entry.WG_N])
                    y[img, oy0:oy0 + t, ox0:ox0 + t, n0:n0 + entry.WG_N] = (
                        reference.round_bf16(out).reshape(t, t, entry.WG_N))
    return y[:, :oh, :ow, :plan.n].contiguous()


def _layer(layer, shape, seed, device="cpu"):
    """A seeded bf16 input (N, H, W, k) in [0, 1) (a ReLU'd activation)
    and the layer's He-scaled weights and bias, packed."""
    f, k, n = layer
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((*shape, k), np.float32)).to(device, torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k)))
                         .astype(np.float32)).to(device)
    b = torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32)).to(device)
    wp, bp = entry.pack_bf16(w, b, first=False)
    return x, wp, bp


@pytest.mark.parametrize("name", list(CASES))
def test_decomposition_matches_tap_layer(name):
    """The tile, box, slab and slice index math of the kernel against the
    plain version of the layer on seeded inputs: the same bf16 products in
    f32, summed in another order, so each output is bit-equal or one bf16
    rounding apart (within 2^-7 of the output's magnitude; ≥ 99.9% of the
    elements bit-equal)."""
    layer, shape = CASES[name]
    x, wp, bp = _layer(layer, shape, seed=11)
    plan = entry.wgmma_layer_plan(*layer)
    got = _emulate(x, wp, bp, plan)
    ref = reference.tap_layer(x, wp, bp, layer[0], layer[2], first=False, last=False)
    assert got.shape == ref.shape == (shape[0], shape[1] - layer[0] + 1,
                                      shape[2] - layer[0] + 1, layer[2])
    assert float((got - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())
    assert float((got == ref).float().mean()) >= 0.999
    assert float(ref.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_wgmma_layer_matches_tap_layer_on_card(cuda_device, name):
    """One launch of ``conv_layer_forward_wgmma`` through
    ``chain.layer_forward`` against ``reference.tap_layer`` on the card:
    within 2^-7 of the output's magnitude (the same bf16 products, summed
    in another order), counted as a wgmma launch and a bf16 chain launch."""
    layer, shape = CASES[name]
    f, _, n = layer
    x, wp, bp = _layer(layer, shape, seed=12, device=cuda_device)
    plan = entry.bf16_layer_plan(*layer)
    assert isinstance(plan, entry.WgmmaPlan)
    y = torch.empty((shape[0], shape[1] - f + 1, shape[2] - f + 1, n), dtype=torch.bfloat16,
                    device=cuda_device)
    before = (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA)
    chain.layer_forward(build.load_library(), x, wp, bp, y, plan, False, False, True,
                        torch.cuda.current_stream().cuda_stream)
    ref = reference.tap_layer(x, wp, bp, f, n, first=False, last=False)
    torch.cuda.synchronize()
    assert (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA) == (before[0] + 1, before[1] + 1)
    assert bool(torch.isfinite(y.float()).all())
    assert float((y.float() - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_rgb_stack_takes_two_wgmma_launches_on_card(cuda_device):
    rng = np.random.default_rng(13)
    params = params_to_torch(
        [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k))).astype(np.float32),
          "b": (rng.standard_normal(n) * 0.05).astype(np.float32)} for f, k, n in RGB7],
        cuda_device)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 45, 70, 3)).astype(np.float32)).to(cuda_device)
    before = (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA)
    y = fused_forward(params, x, "bf16")
    ref = reference.fused_forward(params, x, "bf16")
    torch.cuda.synchronize()
    assert (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA) == (before[0] + 7, before[1] + 2)
    assert float((y - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())


@pytest.mark.cuda
def test_misaligned_tensor_is_refused_on_card(cuda_device):
    layer = LAYERS["L5"]
    x, wp, bp = _layer(layer, (1, 20, 20), seed=14, device=cuda_device)
    flat = torch.empty(18 * 18 * 128 + 1, dtype=torch.bfloat16, device=cuda_device)
    y = flat[1:].view(1, 18, 18, 128)  # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        chain.layer_forward(build.load_library(), x, wp, bp, y, entry.bf16_layer_plan(*layer),
                            False, False, True, torch.cuda.current_stream().cuda_stream)
