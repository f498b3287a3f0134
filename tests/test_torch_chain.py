"""The port's layer chain (``csrc/conv_layer.cu``) and the routing between
it and the fused kernel (``cnn_sr_tpu_torch.ops.fused``).

On the CPU the chain's plain version is held against the JAX package's
Pallas kernel in interpret mode, through each of the branches that kernel
takes for L-layer f=3 stacks. The CUDA kernel runs only on a card: those
tests carry the ``cuda`` marker and skip without one. A machine with a
card may have no JAX, so this module imports JAX only inside the tests
that need it; there the card tests run with

    python -m pytest tests/test_torch_fused.py tests/test_torch_chain.py -m cuda --noconftest
"""

import os

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch import api
from cnn_sr_tpu_torch.ops.fused import chain, entry, fused_forward, reference, tune
from cnn_sr_tpu_torch.utils.config import parse_config, read_config
from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RGB_CFG = os.path.join(ROOT, "configs", "waifu2x_7layer_rgb_pretrained.json")
# the 7-layer RGB model's widths (configs/waifu2x_7layer_rgb*.json)
RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128),
        (3, 128, 128), (3, 128, 3)]
NARROW7 = [(3, 3, 8), (3, 8, 8), (3, 8, 16), (3, 16, 16), (3, 16, 16),
           (3, 16, 16), (3, 16, 3)]
FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]
WIDE_955 = [(9, 1, 128), (5, 128, 64), (5, 64, 1)]
FOUR = [(9, 1, 8), (5, 8, 8), (1, 8, 8), (5, 8, 1)]
# f32 layers whose input window (16x16 tile plus halo, all channels)
# exceeds a block's shared memory: the chain streams it in channel chunks
# (f25_n128: one channel's window and weights at 128 columns a block too,
# so a block takes 32 of its 128 columns)
WIDE_F9 = [(3, 1, 128), (9, 128, 8), (3, 8, 1)]
WIDE_F25 = [(3, 1, 8), (25, 8, 128), (3, 128, 1)]
WIDE_WINDOWS = {
    "f9_k128": (1, WIDE_F9),
    "f9_k256": (1, [(3, 1, 256), (9, 256, 8), (3, 8, 1)]),
    "f7_k128": (3, [(3, 3, 128), (7, 128, 16), (3, 16, 3)]),
    "f25_n128": (1, WIDE_F25),
}
# the RGB model's layers and the wide stacks', each planned alone
PLANNED = sorted({layer for specs in [RGB7, WIDE_955, FOUR, NARROW7]
                  + [v[1] for v in WIDE_WINDOWS.values()] for layer in specs})


def _params(specs, seed):
    """He-scaled weights, so that activations stay O(1) through deep stacks."""
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k)))
             .astype(np.float32),
             "b": (rng.standard_normal((n,)) * 0.05).astype(np.float32)}
            for f, k, n in specs]


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


# (a) and (b): JAX's interpret-mode routing for narrow stacks (sep middles,
# packed-dx or mm_last last layer); (c): the RGB widths through the
# Winograd branches (quad, j-paired, unpaired, parity exit). JAX's Winograd
# differs from its own XLA path by about 1.1e-5 at these widths, so (c)
# is held at atol 1e-4; the direct branches at 1e-5.
@pytest.mark.parametrize("specs,jax_kw,tol", [
    (NARROW7, {}, 1e-5),
    (NARROW7, {"mm_last": True}, 1e-5),
    (RGB7, {"wino": True}, 1e-4),
], ids=["narrow_sep", "narrow_mm_last", "rgb_wino"])
def test_chain_cpu_matches_jax_pallas_interpret(specs, jax_kw, tol):
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.pallas_fused import fused_forward as jfused_forward

    params = _params(specs, 0)
    x = _x((1, 40, 140, 3), 1)
    want = np.asarray(jfused_forward(params, x, tile_h=16, tile_w=128,
                                     dtype=jnp.float32, **jax_kw))
    before = (entry.LAUNCHES, chain.LAUNCHES)
    got = fused_forward(params_to_torch(params, "cpu"), torch.from_numpy(x))
    assert (entry.LAUNCHES, chain.LAUNCHES) == before  # the CPU launches nothing
    assert tuple(got.shape) == want.shape == (1, 26, 126, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("c,specs,kind", [
    (1, FLAGSHIP, "fused"),
    (1, [(9, 1, 64), (1, 64, 32), (5, 32, 1)], "fused"),
    (3, [(3, 3, 16), (3, 16, 8), (3, 8, 3)], "fused"),
    (3, RGB7, "chain"),
    (1, [(9, 1, 8), (5, 8, 1)], "chain"),
    (1, FOUR, "chain"),
    (3, [(3, 3, 8), (3, 8, 8), (3, 8, 5)], "chain"),
    (5, [(3, 5, 8), (3, 8, 8), (3, 8, 1)], "chain"),
    (1, WIDE_955, "chain"),
], ids=["flagship", "9-1-5", "rgb_3layer", "rgb_7layer", "2-layer", "4-layer",
        "n_out_5", "c_in_5", "wide_9-5-5"])
def test_route_by_shape(c, specs, kind):
    """3-layer stacks inside the fused kernel's envelope (c_in ≤ 4,
    n_out ≤ 4, tiles within a block's shared memory) keep their one
    launch; every other stack takes the chain, one plan per layer."""
    got, plan = entry.route(c, specs)
    assert got == kind
    if kind == "chain":
        assert len(plan) == len(specs)
        assert all(p.smem <= entry.SMEM_LIMIT for p in plan)


def test_chain_plan_matches_the_design():
    # RGB layer 6 (128 -> 128): the wide class, NB = 16, PX = 4; 8 groups
    # of 16 columns x 4 row blocks x 16 columns = 512 items on a 16x16
    # tile; stages of 16 input channels, each its 18x18 window (column
    # stride 19, channel stride 18·19 + 1 = 343) and 9·128 weights
    plan = entry.layer_plan(3, 128, 128)
    assert (plan.nb, plan.px, plan.tile_h, plan.tile_w) == (16, 4, 16, 16)
    assert (plan.items, plan.nblk, plan.kc, plan.stages) == (512, 128, 16, 2)
    assert plan.smem == 4 * 2 * 16 * (9 * 128 + 343) == 191_360 <= entry.SMEM_LIMIT
    # RGB layer 7 (128 -> 3): the narrow class, NB = 4, PX = 2; one group
    # of 4 columns x 16 row blocks x 32 columns = 512 items on a 32x32
    # tile, one block an SM: 6 chunks of 22 channels (at most 32), each its
    # 34x34 window (column stride 35, channel stride 34·35 + 1) and 9·4
    # weights (22·1,227 = 26,994 floats a stage, rounded up to 16 bytes)
    plan = entry.layer_plan(3, 128, 3)
    assert (plan.nb, plan.px, plan.tile_h, plan.tile_w, plan.items) == (4, 2, 32, 32, 512)
    assert (plan.nblk, plan.kc, plan.stages) == (4, 22, 2)
    assert 22 * (36 + 34 * 35 + 1) == 26_994
    assert plan.smem == 4 * 2 * 26_996 == 215_968 <= entry.SMEM_LIMIT
    # RGB layer 4 (64 -> 64): the mid class, NB = 8, PX = 4, 256 threads
    # (two blocks an SM): 8 groups x 2 row blocks x 16 columns on an 8x16
    # tile, stages of 16 channels of a 10x18 window (column stride 11)
    plan = entry.layer_plan(3, 64, 64)
    assert (plan.nb, plan.px, plan.tile_h, plan.tile_w, plan.items) == (8, 4, 8, 16, 256)
    assert (plan.kc, plan.stages) == (16, 2)
    assert plan.smem == 4 * 2 * 16 * (9 * 64 + 18 * 11 + 1) == 99_200 <= entry.SM_SMEM // 2 - 1024
    # a narrow first layer keeps all its channels in one stage
    plan = entry.layer_plan(3, 3, 32)
    assert (plan.tile_h, plan.tile_w, plan.items, plan.kc, plan.stages) == (16, 16, 256, 3, 1)
    assert plan.smem == 4 * (-(-3 * (9 * 32 + 18 * 19 + 1) // 4) * 4)
    # n = 256 splits N over two blocks of 128 columns
    plan = entry.layer_plan(3, 128, 256)
    assert (plan.nblk, plan.items, plan.tile_h) == (128, 512, 16)
    # f = 25 to 128 columns: one channel's 625·128 weights alone exceed a
    # block, so a block takes 2 groups (32 columns, N over 4 blocks) on a
    # 32x16 tile, 1 of its 8 input channels a stage: 625·32 weights and a
    # 56x40 window (column stride 57), 22,281 floats rounded up to 16 bytes
    plan = entry.layer_plan(25, 8, 128)
    assert (plan.nblk, plan.tile_h, plan.tile_w, plan.items, plan.kc) == (32, 32, 16, 256, 1)
    assert 625 * 32 + 40 * 57 + 1 == 22_281
    assert plan.smem == 4 * 2 * 22_284 <= entry.SMEM_LIMIT


def _c_plans(tmp_path, layers, csrc=None):
    """``ChainPlan`` of ``csrc/ffma_plan.cuh`` (or of the header in
    ``csrc``) for each (f, k, n), compiled with the host's C++ compiler:
    the arithmetic the CUDA launch runs."""
    import subprocess

    from cnn_sr_tpu_torch.ops.fused import build

    src = tmp_path / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "ffma_plan.cuh"\nint main() {\n'
        '  int f, k, n;\n  while (scanf("%d %d %d", &f, &k, &n) == 3) {\n'
        '    const ChainPlan p(f, k, n);\n'
        '    printf("%d %d %d %d %d %d %d %d %d\\n", p.nb, p.px, p.tile_h, p.tile_w, p.items,\n'
        '           p.nblk, p.kc, p.stages, p.smem);\n  }\n}\n')
    exe = tmp_path / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{csrc or build.CSRC}", str(src),
                    "-o", str(exe)], check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], input="".join(f"{f} {k} {n}\n" for f, k, n in layers),
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return [entry.LayerPlan(*map(int, line.split())) for line in out.splitlines()]


@pytest.mark.parametrize("layer", PLANNED, ids=lambda l: "f{}_k{}_n{}".format(*l))
def test_chain_plan_fills_the_block_and_fits(layer, tmp_path):
    """Every block's items fill its threads in one pass (one item a
    thread: the tile's row blocks x columns x the block's NB groups), the
    shared bytes stay within the limit, the stages cover every input
    channel, and Python's plan equals the C side's (``ChainPlan``)."""
    f, k, n = layer
    plan = entry.layer_plan(f, k, n)
    nb, px, threads, _, kcmax = entry.CHAIN_SHAPE[entry.chain_class(n)]
    assert (plan.nb, plan.px) == (nb, px)
    assert plan.tile_h % px == 0 and plan.nblk % nb == 0 and plan.nblk <= 8 * nb
    assert plan.items == (plan.tile_h // px) * plan.tile_w * (plan.nblk // nb) <= threads
    assert entry.n_pad_f32(n, nb) % plan.nblk == 0
    assert 1 <= plan.kc <= min(k, kcmax) and plan.stages == (2 if plan.kc < k else 1)
    assert plan.smem <= entry.SMEM_LIMIT and plan.smem % 16 == 0
    if layer in RGB7:  # the RGB model's layers fill their class's threads
        assert plan.items == threads
    assert _c_plans(tmp_path, [layer]) == [plan]


@pytest.mark.parametrize("name", sorted(tune.CHAIN_VARIANTS))
def test_tune_chain_variant_plans_match_the_c_side(name, tmp_path):
    """Each chain variant of ``ops/fused/tune.py`` launches its library
    (``ffma_plan.cuh`` with the variant's classes) with Python's plans: the
    two agree on every layer the tuner runs."""
    from cnn_sr_tpu_torch.ops.fused import build

    shapes = tune.chain_shapes(name)
    (tmp_path / "ffma_plan.cuh").write_text(
        tune.chain_variant_source((build.CSRC / "ffma_plan.cuh").read_text(), shapes))
    layers = sorted({layer for specs in [tune.RGB7] + tune.CHAIN_CHECKED for layer in specs})
    assert _c_plans(tmp_path, layers, tmp_path) == [
        tune.chain_plan(shapes, *layer) for layer in layers]


def test_layer_too_wide_for_shared_memory_raises(tmp_path):
    # what is left to refuse: one input channel's window and weights
    # beyond a block's shared memory even at one group of NB columns a
    # block (f = 55 to 128 columns: a 86x86 window and 3,025·16 weights),
    # on every device, naming the bytes
    with pytest.raises(NotImplementedError,
                       match=r"f=55 layer to 128 channels needs \d+ shared bytes .* at 16 output"):
        entry.layer_plan(55, 8, 128)
    with pytest.raises(NotImplementedError, match="shared bytes"):
        entry.route(1, [(3, 1, 8), (55, 8, 128), (3, 128, 1)])
    # the C side finds no stage for it either
    assert _c_plans(tmp_path, [(55, 8, 128)])[0].kc == 0


@pytest.mark.parametrize("name", sorted(WIDE_WINDOWS))
def test_wide_window_layers_route_to_the_chain_and_match_jax(name):
    """Layers whose whole input window exceeds shared memory take the
    chain, streamed in channel chunks, and on the CPU ``fused_forward``
    and ``api.upscale_image`` match the JAX package's XLA f32 forward
    (``use_pallas=False``): the same f32 convolutions, summed in another
    order, so 1e-5 on the stack and ±1 uint8 end to end (an f32 output at
    a rounding boundary can go either way)."""
    from cnn_sr_tpu import api as japi
    from cnn_sr_tpu.models import forward as jforward
    from cnn_sr_tpu.utils.config import parse_config as jparse_config

    c, specs = WIDE_WINDOWS[name]
    kind, plans = entry.route(c, specs)
    assert kind == "chain" and [p.stages for p in plans][1] == 2
    params = _params(specs, 21)
    x = _x((2, 33, 40, c), 22)
    got = fused_forward(params_to_torch(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jforward(params, x)),
                               rtol=1e-5, atol=1e-5)

    raw = {"channels": c, "layers": [{"n": n, "f": f} for f, _, n in specs],
           "momentum": 0.9, "weight_decay_parameter": 0.0001,
           "learning_rates": [1e-4] * len(specs),
           "parameters_distribution": {"mean_w": 0.0, "mean_b": 0.0,
                                       "std_deviation_w": 0.01, "std_deviation_b": 0.0}}
    cfg, jcfg = parse_config(raw), jparse_config(raw)
    rgba = np.random.default_rng(23).integers(0, 256, (36, 44, 4), dtype=np.uint8)
    out = api.upscale_image(cfg, params_to_torch(params, "cpu"), rgba)
    want = japi.upscale_image(jcfg, params, rgba, use_pallas=False)
    assert out.shape == want.shape == (36, 44, 3)
    assert int(np.abs(out.astype(np.int16) - want.astype(np.int16)).max()) <= 1


def test_chain_launcher_takes_only_cuda_tensors():
    params = params_to_torch(_params(NARROW7, 2), "cpu")
    x = torch.from_numpy(_x((1, 30, 30, 3), 3))
    _, plans = entry.route(3, NARROW7)
    before = chain.LAUNCHES
    with pytest.raises(NotImplementedError, match="CUDA tensors"):
        chain.chain_forward(params, x, plans)
    assert chain.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("specs,shape", [
    (RGB7, (1, 80, 272, 3)),
    (RGB7, (2, 97, 131, 3)),
    (FOUR, (1, 45, 70, 1)),
    (WIDE_955, (1, 50, 70, 1)),
    ([(3, 1, 128), (9, 128, 16), (3, 16, 8), (3, 8, 1)], (1, 60, 70, 1)),
    (RGB7, (3, 6 + 17, 6 + 33, 3)),
    (WIDE_F25, (1, 60, 70, 1)),
], ids=["rgb_7layer", "rgb_ragged", "4-layer", "wide_9-5-5", "wide_f9_k128", "rgb_batch3_17x33",
        "wide_f25_n128"])
def test_chain_matches_plain_on_card(cuda_device, specs, shape):
    # f32 sums of up to 5,000 terms per layer, in another order than
    # cuDNN's: 1e-4 of the output's largest magnitude
    params = params_to_torch(_params(specs, 7), cuda_device)
    x = torch.from_numpy(_x(shape, 8)).to(cuda_device)
    before = (entry.LAUNCHES, chain.LAUNCHES)
    y = fused_forward(params, x)
    ref = reference.fused_forward(params, x)
    torch.cuda.synchronize()
    assert (entry.LAUNCHES, chain.LAUNCHES) == (before[0], before[1] + len(specs))
    assert y.shape == ref.shape and bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_rgb_upscale_on_card_runs_the_chain(cuda_device):
    cfg = read_config(RGB_CFG)
    params = params_to_torch(init_params(cfg)[0], cuda_device)
    rgba = np.random.default_rng(9).integers(0, 256, (64, 96, 4), dtype=np.uint8)
    before = (entry.LAUNCHES, chain.LAUNCHES)
    out = api.upscale_image(cfg, params, rgba)
    assert (entry.LAUNCHES, chain.LAUNCHES) == (before[0], before[1] + 7)
    plain = api._upscale_rgb(lambda x: reference.fused_forward(params, x),
                             torch.from_numpy(rgba).to(cuda_device),
                             add_mean=cfg.zero_mean_target).cpu().numpy()
    assert out.shape == (64, 96, 3) and out.dtype == np.uint8
    assert int(np.abs(out.astype(np.int16) - plain.astype(np.int16)).max()) <= 1
