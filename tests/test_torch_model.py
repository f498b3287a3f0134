"""Port parity: the config and params codecs and the plain f32 model of
``cnn_sr_tpu_torch`` against ``cnn_sr_tpu``, on the CPU."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from cnn_sr_tpu.models import forward as jforward
from cnn_sr_tpu.utils import config as jconfig
from cnn_sr_tpu.utils import params_io as jparams
from cnn_sr_tpu_torch.models import SRCNN, forward
from cnn_sr_tpu_torch.models.srcnn import strict_f32
from cnn_sr_tpu_torch.utils import config as tconfig
from cnn_sr_tpu_torch.utils import params_io as tparams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))
PRETRAINED_CONFIGS = [c for c in CONFIGS if c.endswith("_pretrained.json")]


def _params(specs, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((f, f, k, n)) * scale).astype(np.float32),
             "b": (rng.standard_normal((n,)) * 0.05).astype(np.float32)}
            for f, k, n in specs]


STACKS = {
    "narrow_9-5-5": ([(9, 1, 8), (5, 8, 8), (5, 8, 1)], (1, 30, 37, 1)),
    "narrow_9-1-5": ([(9, 1, 8), (1, 8, 8), (5, 8, 1)], (2, 25, 31, 1)),
    "flagship_9-5-5": ([(9, 1, 64), (5, 64, 32), (5, 32, 1)], (1, 40, 48, 1)),
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_forward_matches_jax(name):
    specs, shape = STACKS[name]
    params = _params(specs, seed=len(name), scale=0.05)
    x = np.random.default_rng(7).uniform(-0.5, 0.5, shape).astype(np.float32)
    want = np.asarray(jforward(params, x))
    got = forward(tparams.params_to_torch(params, "cpu"), torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_strict_f32_turns_off_tf32_and_keeps_cudnn():
    """The plain version runs cuDNN in full f32: TF32 off for convolutions
    and matmuls, cuDNN itself still enabled, the flags restored after."""
    before = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with strict_f32():
        assert torch.backends.cudnn.enabled == before[0]
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_srcnn_module_is_the_fused_stack():
    specs, shape = STACKS["narrow_9-5-5"]
    params = tparams.params_to_torch(_params(specs, seed=3), "cpu")
    x = torch.from_numpy(np.random.default_rng(8).uniform(-0.5, 0.5, shape)
                         .astype(np.float32))
    net = SRCNN(params)
    assert net.w2.data_ptr() == params[1]["w"].data_ptr()  # shared, not copied
    torch.testing.assert_close(net(x), forward(params, x), rtol=0, atol=0)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_read_config_matches_jax(path):
    got = dataclasses.asdict(tconfig.read_config(path))
    want = dataclasses.asdict(jconfig.read_config(path))
    assert got == want


def test_config_validation_matches_jax():
    raw = {"n1": 8, "n2": 4, "f1": 4, "f2": 1, "f3": 5,
           "learning_rates": [1e-3] * 3,
           **{f"parameters_distribution_{i}": {"std_deviation_w": 0.1}
              for i in (1, 2, 3)}}
    with pytest.raises(tconfig.ConfigValidationError, match="f should be odd"):
        tconfig.parse_config(raw)
    with pytest.raises(jconfig.ConfigValidationError, match="f should be odd"):
        jconfig.parse_config(raw)


@pytest.mark.parametrize("path", PRETRAINED_CONFIGS, ids=os.path.basename)
def test_load_parameters_file_bit_equal(path):
    cfg = tconfig.read_config(path)
    assert cfg.parameters_file and os.path.isfile(cfg.parameters_file)
    got, got_epochs = tparams.load_parameters_file(cfg.parameters_file, cfg.layer_specs())
    want, want_epochs = jparams.load_parameters_file(
        cfg.parameters_file, jconfig.read_config(path).layer_specs())
    assert got_epochs == want_epochs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            assert g[k].dtype == np.float32 and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


def test_random_parameters_same_draws():
    cfg = tconfig.read_config(os.path.join(ROOT, "configs", "srcnn_9-1-5.json"))
    got = tparams.random_parameters(cfg.layer_specs(), cfg.distributions, seed=0)
    want = jparams.random_parameters(cfg.layer_specs(), cfg.distributions, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["w"], w["w"])
        np.testing.assert_array_equal(g["b"], w["b"])


def test_init_params_loads_or_seeds(tmp_path):
    cfg = tconfig.read_config(os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json"))
    loaded, _ = tparams.init_params(cfg)
    want, _ = jparams.load_parameters_file(cfg.parameters_file, cfg.layer_specs())
    np.testing.assert_array_equal(loaded[0]["w"], want[0]["w"])
    cfg.parameters_file = str(tmp_path / "missing.json")
    seeded, epochs = tparams.init_params(cfg, seed=5)
    again, _ = tparams.init_params(cfg, seed=5)
    assert epochs == 0
    np.testing.assert_array_equal(seeded[1]["w"], again[1]["w"])


def test_params_to_torch_layout():
    params = _params([(9, 1, 8), (5, 8, 4), (5, 4, 1)], seed=1)
    params[0]["w"] = np.asfortranarray(params[0]["w"])  # not C-contiguous
    got = tparams.params_to_torch(params, "cpu")
    for g, p in zip(got, params):
        for k in ("w", "b"):
            assert g[k].dtype == torch.float32 and g[k].is_contiguous()
            assert tuple(g[k].shape) == p[k].shape  # still HWIO
            np.testing.assert_array_equal(g[k].numpy(), p[k])


def test_params_file_errors():
    specs = tconfig.read_config(os.path.join(ROOT, "configs", "srcnn_9-1-5.json")).layer_specs()
    with pytest.raises(tparams.ParametersFileError, match="size mismatch"):
        tparams.flat_to_hwio([0.0] * 10, 3, 1, 2)
    with pytest.raises(tparams.ParametersFileError, match="missing 'layer1'"):
        tparams.load_parameters_file(os.path.join(ROOT, "configs", "srcnn_9-1-5.json"), specs)
