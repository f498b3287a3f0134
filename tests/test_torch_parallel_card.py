"""Parallelism on the card (``cuda:0`` named several times): the kernel
route per spatial band against its plain version, and a data-parallel
training step against the single-device step. The CPU side is held
against the JAX package by ``test_torch_parallel.py``.

These tests need a card and carry the ``cuda`` marker; a machine with a
card may have no JAX, so this module imports none:

    python -m pytest tests/test_torch_parallel_card.py -m cuda --noconftest
"""

import os

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch import api
from cnn_sr_tpu_torch.models.srcnn import SRCNN
from cnn_sr_tpu_torch.ops.fused import chain, entry, reference
from cnn_sr_tpu_torch.parallel import make_mesh, sharded_forward
from cnn_sr_tpu_torch.training import trainer
from cnn_sr_tpu_torch.utils.config import read_config
from cnn_sr_tpu_torch.utils.params_io import params_to_torch, random_parameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = 2e-4  # tests/test_torch_train_card.py's card gate, of each tensor's largest entry
CONFIGS = {"flagship": "srcnn_9-5-5.json", "rgb": "waifu2x_7layer_rgb_pretrained.json"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _model(name, dev, seed=0):
    cfg = read_config(os.path.join(ROOT, "configs", CONFIGS[name]))
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=seed)
    return cfg, params_to_torch(params, dev)


def _launches():
    return entry.LAUNCHES, chain.LAUNCHES, entry.LAUNCHES_BF16, chain.LAUNCHES_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name,shards", [("flagship", 4), ("rgb", 2)])
def test_kernel_route_per_band_matches_plain(cuda_device, name, shards, precision):
    """Each band through ``SRCNN`` (one fused launch, or one chain launch a
    layer) against the plain version over the whole input: f32 within
    1e-4 absolute, bf16 within 2^-7 of the output's largest magnitude
    (chip_smoke.py's kernel gates)."""
    cfg, params = _model(name, cuda_device)
    c = cfg.channels
    x = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, (1, 200, 131, c))
                         .astype(np.float32)).to(cuda_device)
    mesh = make_mesh(1, shards, devices=[cuda_device] * shards)
    before = _launches()
    y = sharded_forward(mesh, params, x, forward_fn=lambda p, band: SRCNN(p, precision)(band))
    torch.cuda.synchronize()
    made = [a - b for a, b in zip(_launches(), before)]
    per_band = 1 if name == "flagship" else len(params)
    assert sum(made) == shards * per_band
    ref = reference.fused_forward(params, x, precision)
    assert y.shape == ref.shape
    err, scale = float((y - ref).abs().max()), float(ref.abs().max())
    assert err <= (1e-4 if precision == "f32" else 2.0 ** -7 * scale), (err, scale)


@pytest.mark.cuda
def test_upscale_image_spatial_matches_single_on_card(cuda_device):
    cfg, params = _model("flagship", cuda_device)
    rgba = np.random.default_rng(2).integers(0, 256, (150, 97, 4), dtype=np.uint8)
    for precision in ("f32", "bf16"):
        got = api.upscale_image_spatial(cfg, params, rgba, 3, precision=precision,
                                        devices=[cuda_device] * 3)
        want = api.upscale_image(cfg, params, rgba, precision=precision)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2])
def test_data_parallel_step_on_card_matches_single(cuda_device, chunks):
    """``n_data = 2`` on ``[cuda:0, cuda:0]`` against one device, TF32 off:
    the parameters and the momentum within ``GATE``."""
    cfg, _ = _model("flagship", cuda_device)
    state = trainer.init_train_state(cfg, seed=0)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (8, 48, 48, 1)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, (8, 48, 48, 1)).astype(np.float32))
    out = {}
    for label, mesh in (("single", None), ("mesh", make_mesh(2, devices=[cuda_device] * 2))):
        p = params_to_torch(state.params, cuda_device)
        d = params_to_torch(state.prev_delta, cuda_device)
        trainer.make_train_step(cfg, chunks, mesh=mesh)(p, d, x.to(cuda_device),
                                                         t.to(cuda_device))
        out[label] = [{k: v.cpu().numpy() for k, v in layer.items()} for layer in p + d]
    for a, b in zip(out["mesh"], out["single"]):
        for k in ("w", "b"):
            scale = float(np.abs(b[k]).max())
            assert float(np.abs(a[k] - b[k]).max()) <= GATE * scale, k
