"""The bf16 stream on the tensor cores: its plans, its packed weights and
the plain version of one tensor-core layer.

The kernels themselves run only on a card (``tests/test_torch_bf16.py``,
``cuda`` marker). What a card run cannot show is held here on the CPU:
that every bf16 plan fits a block and routes each stack where it is
pinned, that the tap-major packing unpacks bit for bit to the weights the
stream uses with zero padding, that ``reference.tap_layer`` (one kernel
launch in PyTorch, over the packed operands) chained over a stack is the
stream's ``reference.fused_forward``, and that the packer runs once per
parameter set.
"""

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.models.srcnn import conv_layer, strict_f32
from cnn_sr_tpu_torch.ops.fused import entry, reference
from cnn_sr_tpu_torch.utils.params_io import params_to_torch

FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]
C915 = [(9, 1, 64), (1, 64, 32), (5, 32, 1)]
NARROW_955 = [(9, 1, 8), (5, 8, 8), (5, 8, 1)]
RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128), (3, 128, 128),
        (3, 128, 3)]
NARROW7 = [(3, 3, 8), (3, 8, 8), (3, 8, 16), (3, 16, 16), (3, 16, 16), (3, 16, 16), (3, 16, 3)]
WIDE_F9 = [(3, 1, 128), (9, 128, 16), (3, 16, 8), (3, 8, 1)]
WIDE_955 = [(9, 1, 128), (5, 128, 64), (5, 64, 1)]
RGB3 = [(3, 3, 16), (3, 16, 8), (3, 8, 3)]

# (stack, input channels, bf16 kind, the image its tap_layer chain runs on)
STACKS = {
    "flagship": (FLAGSHIP, 1, "fused", (1, 34, 41, 1)),
    "9-1-5": (C915, 1, "fused", (1, 30, 37, 1)),
    "narrow_955": (NARROW_955, 1, "fused", (2, 30, 33, 1)),
    "rgb_7layer": (RGB7, 3, "chain", (1, 24, 29, 3)),
    "narrow_7layer": (NARROW7, 3, "chain", (2, 24, 29, 3)),
    "wide_f9_k128": (WIDE_F9, 1, "chain", (1, 30, 33, 1)),
}


def _bf16_weights(params):
    """``entry.packed_bf16`` of every layer, as the kernels' plain version
    (``reference.tap_layer``) takes them: the first layer dx-expanded and
    folded, every other one tap-major."""
    return [entry.packed_bf16(layer["w"], layer["b"], i == 0) for i, layer in enumerate(params)]


def _params(specs, seed):
    """He-scaled weights, so that activations stay O(1) through deep stacks."""
    rng = np.random.default_rng(seed)
    return params_to_torch(
        [{"w": (rng.standard_normal((f, f, k, n)) * np.sqrt(2.0 / (f * f * k))).astype(np.float32),
          "b": (rng.standard_normal((n,)) * 0.05).astype(np.float32)} for f, k, n in specs],
        "cpu")


@pytest.mark.parametrize("name", list(STACKS))
def test_bf16_plans_fit_and_route(name):
    specs, c, kind, _ = STACKS[name]
    got, plan = entry.route(c, specs, 2)
    assert got == kind
    if kind == "fused":
        assert plan == entry.fused_wgmma_plan(c, specs) and plan.smem <= entry.SMEM_LIMIT
        return
    assert len(plan) == len(specs)
    for i, (p, (f, k, n)) in enumerate(zip(plan, specs)):
        assert (p.f, p.k, p.n) == (f, k, n) and p.smem <= entry.SMEM_LIMIT
        # a middle layer takes the wgmma stage (its plan:
        # tests/test_torch_wgmma_chain.py), the last the last-layer kernel
        # (tests/test_torch_last_wgmma.py), the first the first-layer
        # kernel (tests/test_torch_first_wgmma.py)
        if 0 < i < len(specs) - 1:
            assert p == entry.wgmma_layer_plan(f, k, n)
        elif i == len(specs) - 1:
            assert p == entry.last_layer_plan(f, k, n)
        else:
            assert p == entry.first_layer_plan(f, k, n)
            assert p.kx % 16 == 0 and f * k <= p.kx < f * k + 16


@pytest.mark.parametrize("specs,c,kind", [
    (WIDE_955, 1, "chain"),
    (RGB3, 3, "fused"),
], ids=["wide_9-5-5", "rgb_3layer"])
def test_three_layer_stacks_in_bf16(specs, c, kind):
    """Every stack the bf16 route took before still runs in bf16. The wide
    9-5-5 moved from the fused kernel to the chain: its CUDA-core bf16
    tiles took 200,704 shared bytes; on wgmma its conv2 tile's least side,
    24, makes an a1 tile of 28²·128·2 = 200,704 bytes, which does not fit
    beside the window, w3 and two w2 slices."""
    assert entry.route(c, specs, 2)[0] == kind
    if kind == "chain":
        assert entry.fused_wgmma_plan(c, specs) is None
        assert all(p.smem <= entry.SMEM_LIMIT for p in entry.route(c, specs, 2)[1])


@pytest.mark.parametrize("name", list(STACKS))
def test_packed_weights_unpack_bit_for_bit(name):
    specs, _, _, _ = STACKS[name]
    params = _params(specs, 1)
    for i, ((wp, bp), (f, k, n), layer) in enumerate(
            zip(_bf16_weights(params), specs, params)):
        first = i == 0
        taps, kp = (f, entry.kx_lanes(f, k)) if first else (f * f, entry.k_pad(k))
        assert wp.dtype == torch.bfloat16 and wp.shape == (taps, kp, entry.n_pad(n))
        assert bp.dtype == torch.float32 and bp.shape == (entry.n_pad(n),)
        real = f * k if first else k
        want = reference.fold_first(layer["w"]) if first else layer["w"].to(torch.bfloat16)
        got = wp[:, :real, :n].reshape(f, f, k, n)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        pad = wp.clone()
        pad[:, :real, :n] = 0
        assert not pad.view(torch.int16).any()
        assert torch.equal(bp[:n], layer["b"]) and not bp[n:].any()


@pytest.mark.parametrize("name", list(STACKS))
def test_tap_layer_chain_matches_the_stream(name):
    """One tensor-core layer at a time in PyTorch, over the packed operands,
    against the stream's plain version: the same bf16 products summed in
    another order. Each layer, from the chain's own input: its bf16 output
    bit-equal to the stream's layer on ≥ 99.9% of the elements (a sum can
    round to the neighbouring bf16 value), the last layer's f32 within
    1e-5 of its magnitude; the whole chain within 2^-7 of the output's
    magnitude of ``reference.fused_forward``."""
    specs, _, _, shape = STACKS[name]
    params = _params(specs, 2)
    x = torch.from_numpy(np.random.default_rng(3).uniform(-0.5, 0.5, shape).astype(np.float32))
    y = x
    last = len(specs) - 1
    for i, ((wp, bp), (f, _, n)) in enumerate(zip(_bf16_weights(params), specs)):
        layer = params[i]
        w = reference.fold_first(layer["w"]) if i == 0 else layer["w"].to(torch.bfloat16)
        with strict_f32():
            want = conv_layer(reference.quantize(y) if i == 0 else y, w.float(), layer["b"],
                              relu=i != last)
        y = reference.tap_layer(y, wp, bp, f, n, i == 0, i == last)
        assert y.shape == want.shape and y.dtype == torch.float32
        if i == last:
            assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
        else:
            assert float((y == reference.round_bf16(want)).float().mean()) >= 0.999
    ref = reference.fused_forward(params, x, "bf16")
    assert y.shape == ref.shape
    err = float((y - ref).abs().max())
    assert err <= 2 ** -7 * float(ref.abs().max()), err


@pytest.mark.parametrize("name", list(STACKS))
def test_packer_runs_once_per_parameter_set(name, monkeypatch):
    specs, _, _, _ = STACKS[name]
    params = _params(specs, 4)
    calls = []
    pack = entry.pack_bf16
    monkeypatch.setattr(entry, "pack_bf16", lambda *a: calls.append(a[2]) or pack(*a))
    first = _bf16_weights(params)
    assert calls == [True] + [False] * (len(specs) - 1)
    again = _bf16_weights(params)
    assert len(calls) == len(specs) and all(a is b for a, b in zip(first, again))
    params[-1]["b"].add_(1.0)  # a bias changed in place: that layer alone anew
    _bf16_weights(params)
    assert len(calls) == len(specs) + 1
