"""The bf16 chain's wgmma stage (``csrc/conv_wgmma.cu``,
``conv_layer_forward_wgmma``): every middle layer.

The kernel runs only on a card (the ``cuda`` tests below skip without
one). What a card run cannot show is held here on the CPU: that its plan
(``csrc/conv_wgmma_plan.cuh``, compiled with ``g++``) is
``entry.wgmma_layer_plan`` and fits a block, that the route sends exactly
the middle layers to it, and that the kernel's decomposition of the layer
(per tile of 8·slabs rows x 16 columns and block of bn columns, one
tensor-copy box per chunk of 32 or 64 lanes of K, dx and group of dy taps
with the copies' zero fill, each dy tap a row offset into its box, slabs
m64 slabs a warpgroup, W slices of a tap's lanes x bn columns) is
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

from cnn_sr_tpu_torch.ops.fused import build, chain, entry, fused_forward, reference, tune
from cnn_sr_tpu_torch.utils.params_io import params_to_torch

RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128), (3, 128, 128),
        (3, 128, 3)]
FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]
C915 = [(9, 1, 64), (1, 64, 32), (5, 32, 1)]
PLAN_FIELDS = tuple(f for f in entry.WgmmaPlan._fields if f not in ("first", "last"))
# (f, k, n): RGB L2-L6, two N chunks, K = 16, the wide f's, a K and an n
# that pad (72 -> 128 lanes, 136 -> 256 columns), f = 19 and 53 (dy taps
# in two and four boxes); at n <= 64 (32-lane boxes where K pads to 32 or
# less): L6's shape into 64 columns (W streamed), f = 9 over 128 channels
# into 16, K = 16 and K = 72 middles, 8 columns, 8 columns from K = 64,
# 32 columns from K = 64, and an f = 1 layer
LAYERS = {"L2": (3, 32, 32), "L3": (3, 32, 64), "n64": (3, 64, 64), "L5": (3, 64, 128),
          "L6": (3, 128, 128), "n256": (3, 128, 256), "k16": (3, 16, 128),
          "f5": (5, 128, 128), "f9": (9, 128, 128), "k72_n136": (3, 72, 136),
          "f19": (19, 64, 128), "f53": (53, 64, 128), "k128_n64": (3, 128, 64),
          "f9_k128_n16": (9, 128, 16), "k16_n64": (3, 16, 64), "k72_n64": (3, 72, 64),
          "k16_n8": (3, 16, 8), "k64_n8": (3, 64, 8), "f5_k64_n32": (5, 64, 32),
          "f1_k64_n32": (1, 64, 32)}
# (f, k, n, a_ring): plans at A stages chosen by the caller, as the tuner
# (ops/fused/tune.py) times them
CHOSEN = {"L2_a_ring2": (3, 32, 32, 2), "L3_a_ring4": (3, 32, 64, 4),
          "k128_n64_a_ring4": (3, 128, 64, 4), "L5_a_ring3": (3, 64, 128, 3)}
REFUSED = {"f_even": (4, 64, 128, 0), "k_odd": (3, 12, 128, 0), "n_odd": (3, 64, 60, 0),
           "a_ring1": (3, 32, 32, 1), "a_ring_past_fit": (3, 64, 64, 9)}
# (layer and chosen A stages, input (N, H, W)): a ragged batch of two where
# the card test time allows; each instance of the kernel (bn, lanes,
# slabs), and two cases with more tiles than a card has SMs
CASES = {"L2": ((3, 32, 32, 0), (2, 21, 37)), "L2_a_ring2": (CHOSEN["L2_a_ring2"], (2, 19, 35)),
         "L2_many_tiles": ((3, 32, 32, 0), (8, 130, 130)),
         "L3": ((3, 32, 64, 0), (2, 40, 21)), "L3_a_ring4": (CHOSEN["L3_a_ring4"], (1, 21, 40)),
         "n64": ((3, 64, 64, 0), (2, 21, 37)),
         "k128_n64": ((3, 128, 64, 0), (2, 19, 42)),
         "k128_n64_many_tiles": ((3, 128, 64, 0), (6, 70, 130)),
         "f9_k128_n16": ((9, 128, 16, 0), (1, 41, 27)),
         "k16_n8": ((3, 16, 8, 0), (2, 18, 18)), "k64_n8": ((3, 64, 8, 0), (1, 20, 19)),
         "k16_n16": ((3, 16, 16, 0), (1, 36, 20)),
         "f5_k64_n32": ((5, 64, 32, 0), (1, 23, 40)),
         "k72_n64": ((3, 72, 64, 0), (1, 20, 19)),
         "L5": ((3, 64, 128, 0), (2, 21, 37)), "L6": ((3, 128, 128, 0), (2, 19, 42)),
         "n256": ((3, 128, 256, 0), (1, 20, 35)), "k16": ((3, 16, 128, 0), (2, 18, 18)),
         "f5": ((5, 64, 128, 0), (1, 23, 40)), "f9": ((9, 64, 128, 0), (2, 27, 26)),
         "k72_n136": ((3, 72, 136, 0), (1, 20, 19)), "f19": ((19, 64, 128, 0), (1, 40, 36))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``wgmma_plan`` of ``csrc/conv_wgmma_plan.cuh``, compiled with the
    host's C++ compiler: plan(f, k, n, a_ring) -> the fields, or None where
    it refuses the layer or the choice."""
    tmp = tmp_path_factory.mktemp("conv_wgmma_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "conv_wgmma_plan.cuh"\nint main() {\n'
        '  int f, k, n, a;\n  scanf("%d %d %d %d", &f, &k, &n, &a);\n'
        '  WgmmaPlan p;\n  if (wgmma_plan(p, f, k, n, a)) {\n    printf("refused\\n");\n'
        '    return 0;\n  }\n'
        f'  printf("{" ".join(["%d"] * len(PLAN_FIELDS))}\\n", '
        + ", ".join(f"p.{k}" for k in PLAN_FIELDS) + ");\n}\n")
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)

    def plan(f, k, n, a_ring=0):
        out = subprocess.run([str(exe)], input=f"{f} {k} {n} {a_ring}\n", check=True,
                             capture_output=True, text=True, timeout=60).stdout.strip()
        return None if out == "refused" else dict(zip(PLAN_FIELDS, map(int, out.split())))

    return plan


@pytest.mark.parametrize("name", list(LAYERS) + list(CHOSEN) + list(REFUSED))
def test_plan_matches_the_c_header(c_plan, name):
    layer = LAYERS[name] + (0,) if name in LAYERS else CHOSEN.get(name) or REFUSED[name]
    got = c_plan(*layer)
    if name in REFUSED:
        assert got is None
        with pytest.raises(NotImplementedError, match="wgmma stage|A stages"):
            entry.wgmma_layer_plan(*layer)
        return
    assert got == {k: getattr(entry.wgmma_layer_plan(*layer), k) for k in PLAN_FIELDS}


@pytest.mark.parametrize("name", list(LAYERS) + list(CHOSEN))
def test_plan_fits_a_block(name):
    """Shared bytes within ``SMEM_LIMIT``, summed from the buffers;
    tensor-copy boxes of at most 256 elements a dimension and swizzled rows
    of at most 128 bytes; a tile whose dy shift is whole swizzle atoms (16
    columns of 32 or 64 lanes); 32-lane boxes exactly where K pads to 32 or
    less below 128 columns; W resident (all its slices, one column chunk)
    or streamed through two stages or more, its bytes to a multiple of
    1024 (the staging after them keeps the swizzle's alignment); two A
    stages or more; the
    groups cover the f dy taps; K's chunks cover its lanes and the
    packing's N; the slabs the block width fixes."""
    layer = LAYERS[name] + (0,) if name in LAYERS else CHOSEN[name]
    f, k, n = layer[:3]
    p = entry.wgmma_layer_plan(*layer)
    assert p.smem <= entry.SMEM_LIMIT
    assert p.smem == entry.WG_SLACK + p.a_ring * p.a_box + p.w_bytes + p.out_bytes
    assert p.w_bytes % 1024 == 0
    assert (p.kp, p.npad, p.bn) == (entry.k_pad(k), entry.n_pad(n), min(entry.n_pad(n), 128))
    assert p.slabs == (4 if p.bn <= 32 else 2) and p.tile_rows == 8 * p.slabs
    assert p.lanes == (32 if p.bn <= 64 and p.kp <= 32 else 64)
    cols = min(p.bn, 64)
    a_box = (p.lanes, entry.WG_TILE_COLS, p.box_rows, 1)
    w_box = (cols, p.lanes, 1)
    out_box = (cols, entry.WG_TILE_COLS, 4 * p.slabs, 1)
    for box in (a_box, w_box, out_box):
        assert max(box) <= 256 and box[0] * 2 <= 128 and box[0] * 2 % 16 == 0
    atom = 8 * p.lanes * 2  # the swizzle's period: 8 rows
    assert entry.WG_TILE_COLS * p.lanes * 2 % atom == 0
    assert p.a_box == p.box_rows * entry.WG_TILE_COLS * p.lanes * 2 and p.a_box % 1024 == 0
    assert p.out_bytes == 2 * p.slabs * 64 * p.bn * 2 and p.out_bytes % 1024 == 0
    assert p.w_slice == p.lanes * p.bn * 2
    assert p.a_ring >= 2
    if p.w_res:
        assert p.npad == p.bn <= 64 and p.w_ring == 0
        assert 0 <= p.w_bytes - p.chunks * f * f * p.w_slice < 1024
    else:
        assert p.w_ring >= 2 and 0 <= p.w_bytes - p.w_ring * p.w_slice < 1024
    assert p.box_rows == p.tile_rows + p.gy - 1
    assert p.gy * (p.groups - 1) < f <= p.gy * p.groups
    assert p.chunks * p.lanes >= k and p.npad % p.bn == 0


def test_route_sends_the_wide_middle_layers_to_wgmma(monkeypatch):
    """Every middle layer takes the wgmma stage, whatever its width; the
    first takes the first-layer kernel (tests/test_torch_first_wgmma.py)
    and the last the last-layer kernel (tests/test_torch_last_wgmma.py)."""
    kind, plans = entry.route(3, RGB7, 2)
    assert kind == "chain"
    stages = [type(p).__name__ for p in plans]
    assert stages == ["FirstPlan"] + ["WgmmaPlan"] * 5 + ["LastPlan"]
    for p, layer in zip(plans[1:6], RGB7[1:6]):
        assert p == entry.wgmma_layer_plan(*layer)
    # L2-L4 keep their weights resident; L5 and L6 stream them
    assert [p.w_res for p in plans[1:6]] == [1, 1, 1, 0, 0]
    assert [p.lanes for p in plans[1:6]] == [32, 32, 64, 64, 64]
    assert entry.route(1, FLAGSHIP, 2)[0] == "fused" and entry.route(1, C915, 2)[0] == "fused"
    # the plan, not a launch, decides: each layer names its kernel
    for layer in ((3, 64, 128), (3, 32, 32), (3, 64, 64)):
        assert entry.bf16_layer_plan(*layer) == entry.wgmma_layer_plan(*layer)
    assert type(entry.bf16_layer_plan(3, 3, 128, first=True)).__name__ == "FirstPlan"
    assert type(entry.bf16_layer_plan(3, 128, 3, last=True)).__name__ == "LastPlan"
    # a layer the plan refuses raises before any launch, on every device
    monkeypatch.setattr(entry, "SMEM_LIMIT", 100_000)
    with pytest.raises(NotImplementedError, match="do not fit"):
        entry.route(3, RGB7, 2)


def _emulate(x, wp, bp, plan):
    """The kernel's decomposition in PyTorch, f32: for each image, tile of
    tile_rows x 16 positions and block of bn columns, for each chunk of
    ``lanes`` lanes of K, dx and group of dy taps one box of A (box_rows x
    16 positions x lanes at the tile's corner + (g0, dx), zeros outside the
    image and past K), flattened to rows; each dy tap of the group a row
    offset (dy − g0)·16 into it; each warpgroup g its slabs g·slabs ..
    (rows 64·(g·slabs + s) on); W slices of the tap's lanes rows of its
    chunk (zeros past K_pad) x the block's bn columns. Then bias, ReLU,
    bf16, stored only inside the output."""
    nimg, h, w, k = x.shape
    f, rows, cols, lanes, bn = plan.f, plan.tile_rows, entry.WG_TILE_COLS, plan.lanes, plan.bn
    oh, ow = h - f + 1, w - f + 1
    ty, tx = -(-oh // rows), -(-ow // cols)
    xz = torch.zeros((nimg, ty * rows + plan.groups * plan.gy + rows, tx * cols + f + cols,
                      plan.chunks * lanes))
    xz[:, :h, :w, :k] = x.float()
    wz = torch.zeros((f * f, max(plan.kp, plan.chunks * lanes), plan.npad))
    wz[:, :plan.kp] = wp.float()
    y = torch.zeros((nimg, ty * rows, tx * cols, plan.npad))
    slabs = 2 * plan.slabs
    for img in range(nimg):
        for oy0 in range(0, ty * rows, rows):
            for ox0 in range(0, tx * cols, cols):
                for n0 in range(0, plan.npad, bn):
                    acc = torch.zeros((slabs, 64, bn))
                    for c in range(plan.chunks):
                        for dx in range(f):
                            for g0 in range(0, f, plan.gy):
                                box = xz[img, oy0 + g0:oy0 + g0 + plan.box_rows,
                                         ox0 + dx:ox0 + dx + cols, c * lanes:(c + 1) * lanes]
                                box = box.reshape(plan.box_rows * cols, lanes)
                                for dy in range(g0, min(f, g0 + plan.gy)):
                                    wsl = wz[dy * f + dx, c * lanes:(c + 1) * lanes, n0:n0 + bn]
                                    for g in range(2):
                                        for s in range(plan.slabs):
                                            slab = g * plan.slabs + s
                                            r0 = (dy - g0) * cols + 64 * slab
                                            acc[slab] += box[r0:r0 + 64] @ wsl
                    out = torch.relu(acc.reshape(rows * cols, bn) + bp[n0:n0 + bn])
                    y[img, oy0:oy0 + rows, ox0:ox0 + cols, n0:n0 + bn] = (
                        reference.round_bf16(out).reshape(rows, cols, bn))
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


@pytest.mark.parametrize("name", [c for c in CASES if "many_tiles" not in c])
def test_decomposition_matches_tap_layer(name):
    """The tile, box, slab and slice index math of the kernel against the
    plain version of the layer on seeded inputs: the same bf16 products in
    f32, summed in another order, so each output is bit-equal or one bf16
    rounding apart (within 2^-7 of the output's magnitude; ≥ 99.9% of the
    elements bit-equal)."""
    layer, shape = CASES[name]
    x, wp, bp = _layer(layer[:3], shape, seed=11)
    plan = entry.wgmma_layer_plan(*layer)
    got = _emulate(x, wp, bp, plan)
    ref = reference.tap_layer(x, wp, bp, layer[0], layer[2], first=False, last=False)
    assert got.shape == ref.shape == (shape[0], shape[1] - layer[0] + 1,
                                      shape[2] - layer[0] + 1, layer[2])
    assert float((got - ref).abs().max()) <= 2 ** -7 * float(ref.abs().max())
    assert float((got == ref).float().mean()) >= 0.999
    assert float(ref.abs().max()) > 0


def test_cases_cover_every_instance():
    """The card cases launch every instance of the kernel (bn, box lanes,
    slabs)."""
    seen = set()
    for layer, _ in CASES.values():
        p = entry.wgmma_layer_plan(*layer)
        seen.add((p.bn, p.lanes, p.slabs))
    assert seen == set(entry.wgmma_instances())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_wgmma_layer_matches_tap_layer_on_card(cuda_device, name):
    """One launch of ``conv_layer_forward_wgmma`` through
    ``chain.layer_forward`` against ``reference.tap_layer`` on the card:
    within 2^-7 of the output's magnitude (the same bf16 products, summed
    in another order), counted as a wgmma launch and a bf16 chain launch."""
    layer, shape = CASES[name]
    f, _, n = layer[:3]
    x, wp, bp = _layer(layer[:3], shape, seed=12, device=cuda_device)
    plan = entry.wgmma_layer_plan(*layer)
    if layer[3] == 0:
        assert plan == entry.bf16_layer_plan(*layer[:3])
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
def test_rgb_stack_takes_five_wgmma_launches_on_card(cuda_device):
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
    assert (chain.LAUNCHES_BF16, chain.LAUNCHES_WGMMA) == (before[0] + 7, before[1] + 5)
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


@pytest.mark.parametrize("name", list(tune.WGMMA_LAYERS))
def test_tune_wgmma_candidates_match_the_c_header(c_plan, name):
    """Each candidate plan the tuner launches (``tune.wgmma_candidates``)
    is the C header's at the same A stages, so the kernel takes
    it as given; the plan's own choice comes first."""
    (f, k, n), _ = tune.WGMMA_LAYERS[name]
    plans = tune.wgmma_candidates(f, k, n)
    assert plans[0] == entry.wgmma_layer_plan(f, k, n) and len(plans) >= 2
    for p in plans:
        assert c_plan(f, k, n, p.a_ring) == {key: getattr(p, key) for key in PLAN_FIELDS}
