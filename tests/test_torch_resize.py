"""The port's bicubic resize (``cnn_sr_tpu_torch.ops.resize``) against the
JAX package's ``cnn_sr_tpu.ops.resize`` (``jax.image.resize(…, "cubic")``),
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


@pytest.mark.parametrize("method", ["lanczos", "linear", "nearest"])
def test_other_methods_are_not_ported(method):
    img = torch.zeros((8, 8))
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        resize.resize_plane(img, 16, 16, method)
    with pytest.raises(NotImplementedError, match="bicubic"):
        resize.upscale_rgba(torch.zeros((8, 8, 4), dtype=torch.uint8), 2.0, method)
