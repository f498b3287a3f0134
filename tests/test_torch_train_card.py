"""Training on the card against training on the CPU (cuDNN's convolutions
and their autograd against PyTorch's CPU ones), with TF32 off. The CPU
side is held against the JAX package by ``test_torch_training.py``.

These tests need a card and carry the ``cuda`` marker; a machine with a
card may have no JAX, so this module imports none:

    python -m pytest tests/test_torch_train_card.py -m cuda --noconftest
"""

import os

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.training import trainer
from cnn_sr_tpu_torch.training.samples import SampleSet
from cnn_sr_tpu_torch.utils.config import read_config
from cnn_sr_tpu_torch.utils.params_io import params_to_torch, random_parameters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = 2e-4  # tests/test_backprop_parity.py's rtol = atol, per tensor's largest entry


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _flagship(seed=0):
    cfg = read_config(os.path.join(ROOT, "configs", "srcnn_9-5-5.json"))
    return cfg, random_parameters(cfg.layer_specs(), cfg.distributions, seed=seed)


def _data(n, hw, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (n, hw, hw, 1)).astype(np.float32),
            rng.uniform(0, 1, (n, hw, hw, 1)).astype(np.float32))


def _close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=GATE, atol=GATE, err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2])
def test_card_gradient_matches_cpu(cuda_device, chunks):
    cfg, params = _flagship()
    x, t = _data(4, 48, seed=1)
    grads = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda_device)):
        g = trainer._grads(params_to_torch(params, dev), torch.from_numpy(x).to(dev),
                           torch.from_numpy(t).to(dev), chunks)
        grads[name] = [{k: v.cpu().numpy() for k, v in layer.items()} for layer in g]
    for i, (a, b) in enumerate(zip(grads["card"], grads["cpu"])):
        for k in ("w", "b"):
            _close(a[k], b[k], f"layer {i + 1} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_train_loop_on_card_matches_cpu(cuda_device, k):
    cfg, _ = _flagship()
    x, t = _data(10, 40, seed=2)
    states, errs = {}, {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda_device)):
        states[name] = trainer.init_train_state(cfg, seed=0)
        errs[name] = []
        assert not trainer.train_loop(cfg, SampleSet(x, t, 40, 40), states[name], 4,
                                      mini_batch_count=2, validation_cadence=1,
                                      epochs_per_dispatch=k, seed=0, device=dev,
                                      log=lambda *a: None,
                                      on_epoch=lambda e, v, n=name: errs[n].append(v))
    assert states["card"].epochs == states["cpu"].epochs == 4
    np.testing.assert_allclose(errs["card"], errs["cpu"], rtol=GATE)
    for a, b in zip(states["card"].params + states["card"].prev_delta,
                    states["cpu"].params + states["cpu"].prev_delta):
        for key in ("w", "b"):
            _close(a[key], b[key], key)
