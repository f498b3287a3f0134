"""The benchmark's ``bench.net`` span on the CPU: one a call of the
outermost module of the port's model package, whatever its class, none for
its nested port modules and none for a module from elsewhere."""

import os

import numpy as np
import pytest
import torch

from benchmark import core, spans, trace, weights as weights_io


class Inner(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv(x))


class Outer(torch.nn.Module):
    """A model built of child modules, as RRDBNet is."""

    def __init__(self):
        super().__init__()
        self.blocks = torch.nn.ModuleList([Inner(), Inner()])

    def forward(self, x):
        for b in self.blocks:
            x = x + b(x)
        return x


class Elsewhere(torch.nn.Module):
    """A module from outside the port's model package."""

    def __init__(self, child=None):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 3, 1)
        self.child = child

    def forward(self, x):
        x = self.conv(x)
        return x if self.child is None else self.child(x)


# the classes under test stand in for modules of the port's model package
Inner.__module__ = Outer.__module__ = "cnn_sr_tpu_torch.models.fake"


class FakeApi:
    """``api.upscale_batch`` and ``upscale_image``, as the wrapper needs them."""

    @staticmethod
    def upscale_batch(cfg, params, images, *a, **k):
        return images

    upscale_image = upscale_batch


def _net_spans(tmp_path, calls):
    s = spans.Spans(FakeApi)
    s.install()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for module, x in calls:
                module(x)
    finally:
        s.remove()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    return sorted(e["name"] for e in trace.load(path)
                  if e.get("cat") == "user_annotation" and e["name"].startswith("bench.net"))


def test_port_model_package_is_matched_by_module_name():
    assert spans.is_port_model(Outer()) and spans.is_port_model(Inner())
    assert not spans.is_port_model(Elsewhere()) and not spans.is_port_model(torch.nn.Conv2d(1, 1, 1))


def test_one_span_a_call_of_the_outermost_port_module(tmp_path):
    x, y = torch.zeros(1, 3, 8, 8), torch.zeros(2, 3, 6, 4)
    with torch.no_grad():
        names = _net_spans(tmp_path, [(Outer(), x), (Outer(), y), (Elsewhere(), x)])
    assert names == ["bench.net:1x3x8x8", "bench.net:2x3x6x4"]


def test_a_port_module_inside_another_module_opens_its_span(tmp_path):
    with torch.no_grad():
        names = _net_spans(tmp_path, [(Elsewhere(Outer()), torch.zeros(1, 3, 4, 4))])
    assert names == ["bench.net:1x3x4x4"]


def test_a_port_module_called_alone_opens_its_own_span(tmp_path):
    with torch.no_grad():
        names = _net_spans(tmp_path, [(Inner(), torch.zeros(1, 3, 5, 7))])
    assert names == ["bench.net:1x3x5x7"]


def test_srcnn_opens_one_span_a_call(tmp_path):
    from cnn_sr_tpu_torch.models.srcnn import SRCNN

    cell = core.load_cell("srcnn955-bf16-frames1080-b8")
    params = [{"w": torch.as_tensor(w), "b": torch.as_tensor(b)}
              for w, b in weights_io.load(core.ROOT, cell.config)]
    x = torch.as_tensor(np.random.default_rng(1).random((1, 24, 20, 1), dtype=np.float32))
    net = SRCNN(params)
    with torch.no_grad():
        names = _net_spans(tmp_path, [(net, x), (net, x)])
    assert names == ["bench.net:1x24x20x1"] * 2


def test_the_api_wrapper_names_the_call_shape(tmp_path):
    s = spans.Spans(FakeApi)
    s.install()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            FakeApi.upscale_batch(None, None, np.zeros((3, 10, 12, 4), np.uint8))
            FakeApi.upscale_image(None, None, np.zeros((10, 12, 4), np.uint8))
    finally:
        s.remove()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    names = sorted(e["name"] for e in trace.load(path) if e["name"].startswith("bench.api"))
    assert names == ["bench.api:1x10x12", "bench.api:3x10x12"]
    assert FakeApi.upscale_batch.__name__ == "upscale_batch"  # restored


@pytest.fixture(autouse=True)
def _no_hooks_left():
    yield
    assert not torch.nn.modules.module._global_forward_pre_hooks
    assert not torch.nn.modules.module._global_forward_hooks
