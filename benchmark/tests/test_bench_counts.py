"""The frozen operation and byte counts against hand counts, and the
cell's counts: its conv stack's, or its reference module's own."""

import dataclasses
import importlib
import sys
import types

import pytest

from benchmark import core, generators, roofline, trace


def _layers(name):
    return core.load_cell(name).layers


def test_flagship_macs_at_1080p():
    # 9x9x1x64 over 1072x1912, 5x5x64x32 over 1068x1908, 5x5x32x1 over 1064x1904
    macs = 1072 * 1912 * 81 * 64 + 1068 * 1908 * 25 * 64 * 32 + 1064 * 1904 * 25 * 32
    assert round(macs / 1e9, 1) == 116.6
    flops = roofline.stack_flops(_layers("srcnn955-bf16-frames1080-b8"), (1, 1080, 1920, 1))
    assert flops == 2 * macs


def test_rgb_macs_at_1080p():
    chans = [3, 32, 32, 64, 64, 128, 128, 3]
    macs = sum((1080 - 2 * (i + 1)) * (1920 - 2 * (i + 1)) * 9 * k * n
               for i, (k, n) in enumerate(zip(chans, chans[1:])))
    assert round(macs / 1e9, 1) == 592.4
    flops = roofline.stack_flops(_layers("vgg7rgb-bf16-frames1080-b8"), (1, 1080, 1920, 3))
    assert flops == 2 * macs


@pytest.mark.parametrize("name, precision, ms, bound_by", [
    ("srcnn955-bf16-frames1080-b8", "f32", 3.48, "operations"),
    ("srcnn955-bf16-frames1080-b8", "bf16", 0.236, "operations"),
    ("vgg7rgb-bf16-frames1080-b8", "f32", 17.68, "operations"),
    ("vgg7rgb-bf16-frames1080-b8", "bf16", 1.198, "operations"),
])
def test_bounds_match_the_kernel_table(name, precision, ms, bound_by):
    c = 1 if name.startswith("srcnn") else 3
    t, by = roofline.bound_ms(_layers(name), (1, 1080, 1920, c), precision)
    assert round(t, 3 if ms < 1.5 else 2) == ms and by == bound_by


def test_bound_bytes_term():
    # a 1x1 conv 1 -> 1 is bound by bytes: input and output f32, weights and bias
    t, by = roofline.bound_ms([(1, 1, 1)], (1, 100, 100, 1), "f32")
    assert by == "bytes"
    assert t == pytest.approx((4 * 10000 * 2 + 4 + 4) / roofline.PEAK_BYTES * 1e3)


CELLS = ["srcnn955-bf16-frames1080-b8", "vgg7rgb-bf16-frames1080-b8",
         "srcnn955-f32-serve-photos-x2", "vgg7rgb-f32-frames1080-b8"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("n, h, w", [(1, 1080, 1920), (8, 1080, 1920), (4, 30, 44), (1, 28, 36)])
def test_a_cell_without_counts_counts_its_conv_stack(name, n, h, w):
    """1080p and the CPU rehearsal's sizes: the cell's counts are
    ``roofline``'s over its layers, bit for bit."""
    cell = core.load_cell(name)
    ref = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    assert not hasattr(ref, "flops") and not hasattr(ref, "bound_ms")
    shape = (n, h, w, cell.config["channels"])
    assert cell.flops(shape) == roofline.stack_flops(cell.layers, shape)
    assert cell.bound_ms(shape) == roofline.bound_ms(cell.layers, shape, cell.precision)


def _x(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one API call of two 10 x 20 images; 400 µs of device time launched
# inside the model's span
EVENTS = [
    _x("Trace", "PyTorch Profiler (0)", 0, 1000, tid=0),
    _x("user_annotation", "bench.api:2x10x20", 10, 500),
    _x("user_annotation", "bench.net:2x10x20x3", 100, 200),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=1),
    _x("kernel", "model_kernel", 200, 400, tid=7, pid=0, corr=1),
]


def test_the_reference_modules_counts_are_what_the_metrics_read(monkeypatch):
    seen = []

    def flops(cfg, shape):
        seen.append(("flops", cfg["reference"], shape))
        return 3_000_000_000 * shape[0]

    def bound_ms(cfg, shape, precision):
        seen.append(("bound_ms", cfg["reference"], shape, precision))
        return 0.1 * shape[0], "operations"

    monkeypatch.setitem(sys.modules, "benchmark.reference._fake",
                        types.SimpleNamespace(flops=flops, bound_ms=bound_ms))
    cell = core.load_cell("vgg7rgb-bf16-frames1080-b8")
    cell = dataclasses.replace(cell, config={**cell.config, "reference": "_fake"})
    win = generators.Window(t0=0.0, t_end=2.0, out_pixels=400, frames=[(10, 20)] * 2)
    ctx = core.Context(cell, win, EVENTS, trace.attribute(EVENTS), trace.busy(EVENTS))
    assert core.read_metric("conv_roofline", ctx) == pytest.approx(100 * 0.2e3 / 400)
    assert core.read_metric("mfu", ctx) == pytest.approx(100 * 6e9 / (2.0 * roofline.PEAK_FLOPS["bf16"]))
    assert seen == [("bound_ms", "_fake", (2, 10, 20, 3), "bf16"),
                    ("flops", "_fake", (1, 10, 20, 3)), ("flops", "_fake", (1, 10, 20, 3))]
