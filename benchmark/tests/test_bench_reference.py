"""The plain reference against the port's CPU path at a tiny size, for
each configuration and mix, and its lower-precision controls."""

import numpy as np
import pytest
import torch

from benchmark import compare, core, frames, weights as weights_io
from benchmark.reference import srcnn as ref

CELLS = ["srcnn955-bf16-frames1080-b8", "vgg7rgb-bf16-frames1080-b8",
         "srcnn955-f32-serve-photos-x2", "vgg7rgb-f32-frames1080-b8"]


def _setup(name):
    cell = core.load_cell(name)
    w = weights_io.load(core.ROOT, cell.config)
    return cell, w, core.Program(cell, w, "cpu")


def _ref_weights(w):
    return [(torch.as_tensor(a), torch.as_tensor(b)) for a, b in w]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    cell, w, prog = _setup(name)
    rgba = frames.make_frames(1, 34, 46, 2**31 + 3, "cpu")[0]
    if cell.mix["loop"] == "open_serve":
        from cnn_sr_tpu_torch.ops.resize import upscale_rgba

        got = prog.api.upscale_image(prog.cfg, prog.params,
                                     upscale_rgba(rgba, 2.0).numpy(), bucket=16,
                                     precision=cell.precision)
        x = ref.pre_scale(rgba, 2.0)
    else:
        got = prog.batch(rgba[None].numpy())[0]
        x = rgba
    want = ref.upscale_frame(x, _ref_weights(w), cell.config["channels"],
                             cell.config["zero_mean_target"])
    n = compare.answer_numbers(got, want)
    if cell.precision == "f32":
        assert n["max_abs"] <= 1 and n["mean_abs"] < 2e-3, n
    else:  # the bf16 stream with its int8 first layer, within the JAX gates
        assert n["max_abs"] <= 6 and n["mean_abs"] < 1.0, n
    s = sum(f - 1 for f, _, _ in cell.layers)
    o = s // 2  # the border passes through
    assert np.array_equal(np.asarray(got)[:o], x[:o, :, :3].numpy())
    assert np.array_equal(want[:, :o].numpy(), x[:, :o, :3].numpy())


def test_pre_scale_matches_the_port_resize():
    from cnn_sr_tpu_torch.ops.resize import upscale_rgba

    rgba = frames.make_frames(1, 21, 33, 9, "cpu")[0]
    got, want = upscale_rgba(rgba, 2.0), ref.pre_scale(rgba, 2.0)
    assert got.shape == want.shape == (42, 66, 4)
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d != 0).float().mean()) < 1e-3


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0 - 2**-12])
    assert ref.round_to(x, "tf32").tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0]


def test_fp8_rounding_is_scaled_and_coarse():
    x = torch.linspace(-0.01, 0.02, 101)
    y = ref.round_to(x, "fp8")
    assert float(y.abs().max()) == pytest.approx(0.02)
    err = float(((y - x).abs() / x.abs().clamp(min=1e-3)).max())
    assert 0.01 < err < 0.2


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_worse_than_the_program(name):
    """On one of the numbers the cell compares, the control reads three
    times the program's gap or more, and past the limit."""
    cell, w, prog = _setup(name)
    rgba = frames.make_frames(1, 96, 128, 17, "cpu")[0]
    got = prog.batch(rgba[None].numpy())[0]
    args = (_ref_weights(w), cell.config["channels"], cell.config["zero_mean_target"])
    want = ref.upscale_frame(rgba, *args)
    ctrl = ref.upscale_frame(rgba, *args, control=cell.limits["control"])
    p, c = compare.answer_numbers(got, want), compare.answer_numbers(ctrl, want)
    assert any(c[k] > 3 * p[k] and c[k] > spec["limit"] >= p[k]
               for k, spec in cell.limits["numbers"].items()), (p, c)
