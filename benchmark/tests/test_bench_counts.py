"""The frozen operation and byte counts against hand counts."""

import pytest

from benchmark import core, roofline


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
