"""The API layer's page-locked copies on the card: ``upscale_batch`` and
``upscale_image`` stage each frame through page-locked host memory
(``api._upload``, ``api._readback``), and their answers equal, bit for
bit, the same calls made with pageable copies (``torch.as_tensor(...)
.cuda()`` and ``.cpu()``), in both precisions and for the luma and the
RGB model. ``api.TRANSFERS`` counts 7 page-locked bytes an output pixel
(4 of RGBA in, 3 of RGB out) and no pageable ones; an answer stays as it
was through later calls; a channel-planar input answers as its
contiguous copy; the net runs once a call. The CPU side is in
``test_torch_api.py``.

These tests need a card and carry the ``cuda`` marker; a machine with a
card may have no JAX, so this module imports none:

    python -m pytest tests/test_torch_api_card.py -m cuda --noconftest
"""

import os

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch import api
from cnn_sr_tpu_torch.models.srcnn import SRCNN
from cnn_sr_tpu_torch.utils.config import read_config
from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"luma": "srcnn_9-5-5_pretrained.json", "rgb": "waifu2x_7layer_rgb_pretrained.json"}
PRECISIONS = ("f32", "bf16")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: page-locked memory and the kernels")
    return torch.device("cuda", 0)


def _model(name, device):
    cfg = read_config(os.path.join(ROOT, "configs", CONFIGS[name]))
    return cfg, params_to_torch(init_params(cfg)[0], device)


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _planar(frames):
    """The same pixels with each image's channels planar (strides W, 1,
    H·W), as the server's pre-scaled images come."""
    planes = np.ascontiguousarray(np.moveaxis(frames, -1, -3))
    return np.moveaxis(planes, -3, -1)


def _pageable(cfg, params, rgbas, precision, bucket=0):
    """The API's answer with pageable copies: the upload by
    ``torch.as_tensor(...).cuda()``, the readback by ``.cpu()``."""
    imgs = torch.as_tensor(rgbas).cuda(params[0]["w"].device)
    net = SRCNN(params, precision)
    if bucket:
        return api._upscale_bucketed(cfg, net, imgs, bucket).cpu().numpy()
    single = imgs.dim() == 3
    if single:
        imgs = imgs[None]
    if cfg.channels == 3:
        outs = api._upscale_rgb_batch(net, imgs, add_mean=cfg.zero_mean_target)
    else:
        outs = api._upscale_luma_batch(net, imgs, add_mean=cfg.zero_mean_target,
                                       squared_mean=cfg.subtract_squared_mean)
    out = torch.stack(outs).cpu().numpy()
    return out[0] if single else out


# call -> (input shape, keyword arguments of the call)
CALLS = {
    "batch": ((3, 120, 200, 4), {}),
    "image": ((130, 210, 4), {}),
    "image_bucket64": ((130, 210, 4), {"bucket": 64}),
}


def _call(kind, cfg, params, rgbas, precision):
    kwargs = CALLS[kind][1]
    if kind == "batch":
        return api.upscale_batch(cfg, params, rgbas, precision=precision)
    return api.upscale_image(cfg, params, rgbas, precision=precision, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kind", list(CALLS))
def test_page_locked_path_equals_the_pageable_one(cuda_device, kind, precision, name):
    cfg, params = _model(name, cuda_device)
    shape = CALLS[kind][0]
    rgbas = _frames(1, shape)
    before = dict(api.TRANSFERS)
    got = _call(kind, cfg, params, rgbas, precision)
    moved = {k: api.TRANSFERS[k] - before[k] for k in before}
    want = _pageable(cfg, params, rgbas, precision, CALLS[kind][1].get("bucket", 0))
    assert got.shape == (*shape[:-1], 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    pixels = int(np.prod(shape[:-1]))
    assert moved == {"pinned_in": 4 * pixels, "pinned_out": 3 * pixels,
                     "pageable_in": 0, "pageable_out": 0}
    assert moved["pinned_in"] + moved["pinned_out"] == 7 * pixels


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kind", ["batch", "image"])
def test_an_answer_stays_as_it_was_through_three_later_calls(cuda_device, kind, precision,
                                                            name):
    cfg, params = _model(name, cuda_device)
    shape = CALLS[kind][0]
    first = _call(kind, cfg, params, _frames(2, shape), precision)
    kept = first.copy()
    for seed in (3, 4, 5):
        later = _call(kind, cfg, params, _frames(seed, shape), precision)
        assert not np.shares_memory(later, first)
    np.testing.assert_array_equal(first, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kind", ["batch", "image"])
def test_a_channel_planar_input_answers_as_its_contiguous_copy(cuda_device, kind, precision,
                                                              name):
    cfg, params = _model(name, cuda_device)
    rgbas = _frames(6, CALLS[kind][0])
    planar = _planar(rgbas)
    assert not planar.flags.c_contiguous and planar.strides[-1] == rgbas.shape[-3] * rgbas.shape[-2]
    np.testing.assert_array_equal(_call(kind, cfg, params, planar, precision),
                                  _call(kind, cfg, params, rgbas, precision))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kind", ["batch", "image"])
def test_the_net_runs_once_a_call(cuda_device, kind, precision, name):
    cfg, params = _model(name, cuda_device)
    calls = []

    def hook(module, inputs, output):
        if isinstance(module, SRCNN):
            calls.append(inputs[0].shape[0])

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        _call(kind, cfg, params, _frames(7, CALLS[kind][0]), precision)
    finally:
        handle.remove()
    assert calls == [CALLS[kind][0][0] if kind == "batch" else 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_without_page_locked_memory_the_call_copies_pageable(cuda_device, monkeypatch, name):
    cfg, params = _model(name, cuda_device)
    rgbas = _frames(8, CALLS["batch"][0])
    want = api.upscale_batch(cfg, params, rgbas, precision="bf16")
    monkeypatch.setattr(api, "_pinned", lambda shape: None)
    before = dict(api.TRANSFERS)
    got = api.upscale_batch(cfg, params, rgbas, precision="bf16")
    moved = {k: api.TRANSFERS[k] - before[k] for k in before}
    np.testing.assert_array_equal(got, want)
    assert moved == {"pinned_in": 0, "pinned_out": 0,
                     "pageable_in": rgbas.nbytes, "pageable_out": got.nbytes}
