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
from cnn_sr_tpu_torch.ops.fused import chain, entry, fused_forward, reference
from cnn_sr_tpu_torch.utils.config import read_config
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
    # RGB layer 6 (128 -> 128) at a 16x16 tile: an 18x18x128 window, and
    # 14 input channels of weights (3·3·128 floats each) in the rest
    assert entry.window_bytes(3, 128) == 18 * 18 * 128 * 4 == 165_888
    plan = entry.layer_plan(3, 128, 128)
    assert (plan.tile_h, plan.tile_w) == (16, 16)
    assert plan.smem - 4 * plan.chunk == 165_888
    assert plan.chunk // (9 * 128) == 14 and plan.smem <= entry.SMEM_LIMIT
    # a narrow layer takes all its weights at once, and no more than they need
    plan = entry.layer_plan(3, 3, 32)
    assert plan.chunk == 9 * 3 * 32 and plan.smem == 4 * (18 * 18 * 3 + 9 * 3 * 32)


def test_layer_too_wide_for_shared_memory_raises():
    # f=9 over 128 channels: a (16+8)²·128·4 = 294,912-byte window
    with pytest.raises(NotImplementedError, match="294912 shared bytes"):
        entry.layer_plan(9, 128, 8)
    with pytest.raises(NotImplementedError, match="Queue 2 #1"):
        entry.route(1, [(3, 1, 128), (9, 128, 8), (3, 8, 1)])


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
], ids=["rgb_7layer", "rgb_ragged", "4-layer", "wide_9-5-5"])
def test_chain_matches_plain_on_card(cuda_device, specs, shape):
    # f32 sums of up to 3,200 terms per layer, in another order than
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
