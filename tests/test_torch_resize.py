"""The port's resize (``cnn_sr_tpu_torch.ops.resize``), every method,
against the JAX package's ``cnn_sr_tpu.ops.resize`` (``jax.image.resize``),
on the CPU."""

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops import resize


@pytest.mark.parametrize("c", [0, 3])
@pytest.mark.parametrize("out_hw", [(74, 106), (18, 26), (50, 70)], ids=["2x_up", "2x_down",
                                                                        "uneven"])
def test_resize_plane_matches_jax(out_hw, c):
    # unit-scale values: torch's antialiased bicubic is JAX's cubic to
    # about 3e-7 (measured: 0.0 at 2x up, 3.0e-7 at 2x down)
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.resize import resize_plane as jresize_plane

    shape = (37, 53, c) if c else (37, 53)
    img = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jresize_plane(jnp.asarray(img), *out_hw))
    got = resize.resize_plane(torch.from_numpy(img), *out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("factor", [2.0, 1.5])
def test_upscale_rgba_matches_jax(factor):
    """uint8 within ±1: a value that lands within 1e-5 of a .5 can round
    the other way. Measured: 0 of the 28,416 (2x) and 0 of the 16,128
    (1.5x) bytes differ."""
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.resize import upscale_rgba as jupscale_rgba

    rgba = np.random.default_rng(1).integers(0, 256, (37, 48, 4), dtype=np.uint8)
    want = np.asarray(jupscale_rgba(jnp.asarray(rgba), factor))
    got = resize.upscale_rgba(torch.from_numpy(rgba), factor).numpy()
    assert got.shape == want.shape == (round(37 * factor), round(48 * factor), 4)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff != 0).sum() <= want.size // 1000, (diff != 0).sum()


def test_degrade_matches_jax():
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.resize import degrade as jdegrade

    img = np.random.default_rng(2).uniform(0, 1, (40, 36)).astype(np.float32)
    want = np.asarray(jdegrade(jnp.asarray(img), 2.0))
    got = resize.degrade(torch.from_numpy(img), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _resample(img: np.ndarray, out_hw, method: str) -> np.ndarray:
    """``jax.image.resize`` written anew in numpy from
    ``jax._src.image.scale``: per axis (an unchanged one skipped) the
    ``compute_weight_mat`` weights in float32, as JAX and the port take
    them, applied in float64; nearest: ``floor((i + 0.5) · in / out)``.
    The value that a float32 implementation of JAX's formulas should give
    up to the rounding of its sums."""
    f32 = np.float32
    x = img.astype(np.float64)
    for axis, n in enumerate(out_hw):
        m = x.shape[axis]
        if m == n:
            continue
        if method == "nearest":
            idx = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m) / f32(n)).astype(int)
            x = np.take(x, idx, axis=axis)
            continue
        inv = 1.0 / (n / m)
        sample = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.5)
        d = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None]) / f32(max(inv, 1.0))
        if method == "linear":
            w = np.maximum(f32(0), f32(1) - d)
        else:
            pi = f32(np.pi)
            y = f32(3) * np.sin(pi * d) * np.sin(pi * d / f32(3))
            lz = y / np.where(d != 0, f32(np.pi ** 2) * (d * d), f32(1))
            w = np.where(d > 3, f32(0), np.where(d > f32(1e-3), lz, f32(1)))
        total = w.sum(axis=0, keepdims=True, dtype=f32)
        w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps, w / total, f32(0))
        w[:, (sample < -0.5) | (sample > m - 0.5)] = 0
        x = np.moveaxis(np.tensordot(w.T.astype(np.float64), np.moveaxis(x, axis, 0), axes=1),
                        0, axis)
    return x


@pytest.mark.parametrize("c", [0, 3])
@pytest.mark.parametrize("out_hw", [(74, 106), (18, 26), (26, 37)],
                         ids=["2x_up", "2x_down", "0.7x"])
@pytest.mark.parametrize("method", ["linear", "nearest", "lanczos"])
def test_other_methods_match_jax(method, out_hw, c):
    """``linear``, ``nearest`` and ``lanczos`` (lanczos3): within 3e-7 of
    ``_resample``, and within 3e-7 of ``jax.image.resize`` beyond JAX's
    own distance from ``_resample`` (measured at these sizes: the port at
    most 2.7e-7 from it, JAX 3.0e-7, the two 3.6e-7 apart in lanczos; at
    37 → 50 rows JAX's jitted lanczos3 weights stray 2.6e-6, where the
    same weights outside ``jit`` match the port's to an ulp). ``nearest``
    picks the same pixels: equal."""
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.resize import resize_plane as jresize_plane

    shape = (37, 53, c) if c else (37, 53)
    img = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jresize_plane(jnp.asarray(img), *out_hw, method=method))
    got = resize.resize_plane(torch.from_numpy(img), *out_hw, method).numpy()
    exact = _resample(img, out_hw, method)
    assert got.shape == want.shape == exact.shape
    assert got.dtype == np.float32
    assert np.abs(got - exact).max() <= 3e-7
    assert (np.abs(got - want) <= 3e-7 + np.abs(want - exact)).all()
    if method == "nearest":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["linear", "nearest", "lanczos"])
def test_other_methods_upscale_rgba_and_degrade_match_jax(method):
    """``upscale_rgba`` by 2 (uint8: equal to JAX's) and ``degrade`` by 2
    (within 3e-7 beyond JAX's distance from the float64 value, as above)."""
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.resize import degrade as jdegrade
    from cnn_sr_tpu.ops.resize import upscale_rgba as jupscale_rgba

    rgba = np.random.default_rng(1).integers(0, 256, (37, 48, 4), dtype=np.uint8)
    want = np.asarray(jupscale_rgba(jnp.asarray(rgba), 2.0, method))
    got = resize.upscale_rgba(torch.from_numpy(rgba), 2.0, method).numpy()
    assert got.dtype == np.uint8 and got.shape == (74, 96, 4)
    np.testing.assert_array_equal(got, want)

    img = np.random.default_rng(2).uniform(0, 1, (40, 36)).astype(np.float32)
    want = np.asarray(jdegrade(jnp.asarray(img), 2.0, method))
    got = resize.degrade(torch.from_numpy(img), 2.0, method).numpy()
    exact = _resample(_resample(img, (20, 18), method).astype(np.float32), (40, 36),
                      method)
    assert (np.abs(got - want) <= 3e-7 + np.abs(want - exact)).all()


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown resize method"):
        resize.resize_plane(torch.zeros((8, 8)), 16, 16, "lanczos5")
