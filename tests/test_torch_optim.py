"""Port parity: ``cnn_sr_tpu_torch.optim`` against ``cnn_sr_tpu.optim``
and the reference's update rule, exactly, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnn_sr_tpu.optim import update_parameters as jupdate
from cnn_sr_tpu_torch.optim import init_optimizer_state, update_parameters

import oracles

SHAPES = [((9, 9, 1, 8), (8,)), ((5, 5, 8, 4), (4,)), ((5, 5, 4, 1), (1,))]


def _layers(rng, scale=1.0):
    return [{"w": (rng.standard_normal(sw) * scale).astype(np.float32),
             "b": (rng.standard_normal(sb) * scale).astype(np.float32)} for sw, sb in SHAPES]


def _torch(layers):
    return [{k: torch.from_numpy(v.copy()) for k, v in layer.items()} for layer in layers]


@pytest.mark.parametrize("momentum,wd,batch", [(0.9, 1e-4, 37), (0.0, 0.0, 1), (0.5, 0.3, 8)])
def test_three_steps_bit_equal_to_jax(momentum, wd, batch):
    """Three steps with momentum and weight decay: parameters and the
    undivided ``prev_delta`` equal JAX's bit for bit."""
    rng = np.random.default_rng(0)
    params = _layers(rng)
    lrs = [1e-3, 2e-3, 3e-4]
    jp = jax.tree.map(jnp.asarray, params)
    jprev = jax.tree.map(jnp.zeros_like, jp)
    tp = _torch(params)
    tprev = init_optimizer_state(tp)
    for _ in range(3):
        grads = _layers(rng, scale=10.0)
        jp, jprev = jupdate(jp, jprev, jax.tree.map(jnp.asarray, grads), lrs, momentum, wd,
                            batch)
        update_parameters(tp, tprev, _torch(grads), lrs, momentum, wd, batch)
    for a, b, c, d in zip(jp, tp, jprev, tprev):
        for k in ("w", "b"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(c[k]))


def test_matches_the_reference_oracle_bias_undecayed_prev_undivided():
    rng = np.random.default_rng(42)
    momentum, wd, lr, bs = 0.9, 0.001, 1e-3, 17
    w, b, gw, gb, pw, pb = (rng.standard_normal(n).astype(np.float32)
                            for n in (2000, 64, 2000, 64, 2000, 64))
    params = [{"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy())}]
    prev = [{"w": torch.from_numpy(pw.copy()), "b": torch.from_numpy(pb.copy())}]
    update_parameters(params, prev, [{"w": torch.from_numpy(gw), "b": torch.from_numpy(gb)}],
                      [lr], momentum, wd, bs)
    ew, eb, epw, epb = oracles.update_params(w, b, gw, gb, pw, pb, momentum, wd, lr, bs)
    np.testing.assert_allclose(params[0]["w"].numpy(), ew, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(params[0]["b"].numpy(), eb, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(prev[0]["w"].numpy(), epw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(prev[0]["b"].numpy(), epb, rtol=1e-6, atol=1e-7)

    # weight decay on the weights only: w - 0.5 w; the bias untouched
    params = [{"w": torch.ones(4), "b": torch.ones(2)}]
    prev = init_optimizer_state(params)
    update_parameters(params, prev, [{"w": torch.zeros(4), "b": torch.zeros(2)}], [1.0],
                      momentum=0.0, weight_decay=0.5, batch_size=1)
    assert params[0]["w"].tolist() == [0.5] * 4 and params[0]["b"].tolist() == [1.0] * 2
    # prev_delta keeps the delta before the division by the batch size
    params = [{"w": torch.zeros(1), "b": torch.zeros(1)}]
    prev = init_optimizer_state(params)
    for _ in range(2):
        update_parameters(params, prev, [{"w": torch.ones(1), "b": torch.zeros(1)}], [1.0],
                          0.5, 0.0, 4)
    assert prev[0]["w"].item() == 1.5 and params[0]["w"].item() == -(1.0 + 1.5) / 4


def test_updates_in_place_without_autograd():
    params = [{"w": torch.ones(3, requires_grad=True), "b": torch.zeros(1)}]
    prev = init_optimizer_state(params)
    ptr = params[0]["w"].data_ptr()
    update_parameters(params, prev, [{"w": torch.ones(3), "b": torch.ones(1)}], [0.1],
                      0.9, 0.0, 1)
    assert params[0]["w"].data_ptr() == ptr and params[0]["w"].grad_fn is None
    torch.testing.assert_close(params[0]["w"].detach(), torch.full((3,), 0.9))
