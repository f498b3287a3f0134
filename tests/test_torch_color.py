"""Port parity: ``cnn_sr_tpu_torch.ops.color`` against ``cnn_sr_tpu.ops.color``
on the same seeded numpy images, on the CPU."""

import numpy as np
import pytest
import torch

from cnn_sr_tpu.ops import color as jcolor
from cnn_sr_tpu_torch.ops import color as tcolor

SHAPES = [(33, 57, 4), (64, 64, 4), (40, 21, 3)]


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_extract_luma_bit_equal(shape, normalize):
    img = _image(shape, 0)
    got = tcolor.extract_luma(torch.from_numpy(img), normalize=normalize).numpy()
    want = np.asarray(jcolor.extract_luma(img, normalize=normalize))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("squared", [False, True])
def test_subtract_mean_matches(squared):
    # the same luma goes into both; the means are f32 sums taken in
    # another order (XLA's reduction tree vs torch's), so they may differ
    # in the last bits: atol 1e-6 on values in [-1, 1]
    luma = np.asarray(jcolor.extract_luma(_image((48, 80, 4), 1)))
    got, got_mean = tcolor.subtract_mean(torch.from_numpy(luma), squared=squared)
    want, want_mean = jcolor.subtract_mean(luma, squared=squared)
    np.testing.assert_allclose(float(got_mean), float(want_mean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if squared:  # E[luma²], not the mean: the reference binary's quirk
        assert float(got_mean) == pytest.approx(float((luma.astype(np.float64) ** 2).mean()),
                                                abs=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_swap_luma_bit_equal(shape):
    img = _image(shape, 2)
    s = 16  # the flagship's valid-conv shrink
    # values outside 0..1 exercise the clamp
    new = np.random.default_rng(3).uniform(-0.1, 1.1, (shape[0] - s, shape[1] - s))
    new = new.astype(np.float32)
    got = tcolor.swap_luma(torch.from_numpy(img), torch.from_numpy(new)).numpy()
    want = np.asarray(jcolor.swap_luma(img, new))
    assert got.dtype == np.uint8 and got.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)
    # border passthrough
    np.testing.assert_array_equal(got[: s // 2], img[: s // 2, :, :3])
    np.testing.assert_array_equal(got[:, -(s // 2):], img[:, -(s // 2):, :3])


@pytest.mark.parametrize("shape", SHAPES)
def test_swap_rgb_bit_equal(shape):
    img = _image(shape, 6)
    s = 14  # the 7-layer RGB model's valid-conv shrink
    # values below 0 and above 1 exercise the clamp; the rest the truncation
    new = np.random.default_rng(7).uniform(-0.2, 1.2, (shape[0] - s, shape[1] - s, 3))
    new = new.astype(np.float32)
    got = tcolor.swap_rgb(torch.from_numpy(img), torch.from_numpy(new)).numpy()
    want = np.asarray(jcolor.swap_rgb(img, new))
    assert got.dtype == np.uint8 and got.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(got, want)
    assert (new < 0).any() and (new > 1).any()
    # border passthrough
    np.testing.assert_array_equal(got[: s // 2], img[: s // 2, :, :3])
    np.testing.assert_array_equal(got[:, -(s // 2):], img[:, -(s // 2):, :3])


def test_swap_rgb_width_derived_pad():
    """An RGB window whose height shrink differs from its width shrink:
    the offset comes from the width on both axes, and the write start
    clamps like lax.dynamic_update_slice."""
    img = _image((30, 40, 4), 8)
    new = np.random.default_rng(9).uniform(0, 1, (28, 30, 3)).astype(np.float32)
    got = tcolor.swap_rgb(torch.from_numpy(img), torch.from_numpy(new)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcolor.swap_rgb(img, new)))


def test_swap_luma_width_derived_pad():
    """A luma window whose height shrink differs from its width shrink:
    the offset comes from the width on both axes (swap_luma.cl:24), and
    the write start clamps like lax.dynamic_update_slice."""
    img = _image((30, 40, 4), 4)
    new = np.random.default_rng(5).uniform(0, 1, (28, 30)).astype(np.float32)
    got = tcolor.swap_luma(torch.from_numpy(img), torch.from_numpy(new)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcolor.swap_luma(img, new)))
