"""The SAME modes of the bf16 chain's kernels and the RRDBNet schedule on a
card (``csrc/conv_first_wgmma.cu``, ``conv_wgmma.cu``, ``conv_last_wgmma.cu``
through ``chain.same_forward``; ``ops/fused/rrdb.py``).

Every test here needs a card and skips without one. Each kernel mode is
held against its plain version, ``reference.same_layer``: SAME padding, a
channel prefix read and a channel slice written at K 64, 96, 128, 160 and
192, the epilogues none, LeakyReLU and the scaled residuals with the f32
copy, the first layer's 0..255 levels and the last layer's f32 output. The
whole Real-ESRGAN x4plus in bf16 at 540x960 is held against the
benchmark's plain reference, and one forward's launches are counted. This
module imports no JAX; on a card:

    python -m pytest tests/test_torch_rrdbnet_card.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import build, chain, entry, reference

SENTINEL = 7.0  # what the launch must leave in the channels it does not own


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _weights(f, k, n, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((f, f, k, n)) * scale * np.sqrt(2.0 / (f * f * k)))
                         .astype(np.float32)).to(device)
    b = torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32)).to(device)
    return w, b


def _close(got, want):
    """The same bf16 products in f32, summed in another order: within 2^-7
    of the output's magnitude."""
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2 ** -7 * float(want.abs().max())
    assert float(want.abs().max()) > 0


def _launch(src, k, w, b, dst, c0, lrelu, residuals=(), out32=None, first=False, last=False):
    f, _, _, n = w.shape
    plan = entry.bf16_layer_plan(f, k, n, first=first, last=last)
    if last:
        wp, bp = entry.pack_last(w, b, plan)
    else:
        wp, bp = entry.pack_bf16(w, b, first, 255 if first else 127)
    chain.same_forward(build.load_library(), src, k, wp, bp, dst, c0, plan, lrelu,
                       residuals, out32, torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 23, 37), (1, 130, 200)])
def test_first_layer_levels_into_a_slice_on_card(cuda_device, shape):
    """conv_first: RGB in 0..1 as its 0..255 levels (exact in bf16), SAME,
    into the first 64 channels of a 192-channel buffer, no activation."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3)).astype(np.float32) / 255.0).to(
        cuda_device)
    w, b = _weights(3, 3, 64, 2, cuda_device)
    dst = torch.full((*shape, 192), SENTINEL, dtype=torch.bfloat16, device=cuda_device)
    before = (chain.LAUNCHES_SAME, chain.LAUNCHES_FIRST)
    _launch(x, 3, w, b, dst, 0, False, first=True)
    want, _ = reference.same_layer(x, w, b, False, first=True)
    torch.cuda.synchronize()
    assert (chain.LAUNCHES_SAME, chain.LAUNCHES_FIRST) == (before[0] + 1, before[1] + 1)
    _close(dst[..., :64].float(), want)
    assert bool((dst[..., 64:] == SENTINEL).all())


# (K, n, c0 of the output in the same 192-channel buffer or None for another)
DENSE = {"conv1": (64, 32, 64), "conv2": (96, 32, 96), "conv3": (128, 32, 128),
         "conv4": (160, 32, 160), "conv5": (192, 64, None)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 23, 37), (1, 130, 200)])
@pytest.mark.parametrize("name", list(DENSE))
def test_dense_block_conv_on_card(cuda_device, name, shape):
    """A dense block's conv: the first K channels of a 192-channel buffer
    (a prefix), SAME; conv1-4 LeakyReLU into the slice after their input,
    conv5 into another buffer's first 64 channels with two scaled residuals
    (f32) and its f32 copy written over the second residual (in place)."""
    k, n, c0 = DENSE[name]
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.random((*shape, 192), np.float32)).to(cuda_device,
                                                                     torch.bfloat16)
    buf[..., k:] = SENTINEL
    w, b = _weights(3, k, n, 4, cuda_device)
    x = buf[..., :k].float()
    if c0 is not None:
        _launch(buf, k, w, b, buf, c0, True)
        want, _ = reference.same_layer(x, w, b, True)
        torch.cuda.synchronize()
        _close(buf[..., c0:c0 + n].float(), want)
        assert bool((buf[..., c0 + n:] == SENTINEL).all())
        return
    r0 = torch.from_numpy(rng.standard_normal((*shape, n), np.float32)).to(cuda_device)
    r1 = torch.from_numpy(rng.standard_normal((*shape, n), np.float32)).to(cuda_device)
    want, want32 = reference.same_layer(x, w, b, False, [(r0, 0.2), (r1, 0.2)])
    dst = torch.full((*shape, 192), SENTINEL, dtype=torch.bfloat16, device=cuda_device)
    before = chain.LAUNCHES_RESIDUAL
    _launch(buf, k, w, b, dst, 0, False, [(r0, 0.2), (r1, 0.2)], out32=r1)
    torch.cuda.synchronize()
    assert chain.LAUNCHES_RESIDUAL == before + 1
    _close(dst[..., :n].float(), want)
    _close(r1, want32)
    assert bool((dst[..., n:] == SENTINEL).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["head_lrelu", "body_residual"])
def test_sixty_four_channel_convs_on_card(cuda_device, case):
    """The head's 64 -> 64 convs (a contiguous input, LeakyReLU) and
    conv_body (a 64-channel prefix of a 192-channel buffer, residual scale 1
    from an f32 stream, into another buffer's first 64 channels)."""
    shape = (2, 41, 70)
    rng = np.random.default_rng(5)
    w, b = _weights(3, 64, 64, 6, cuda_device)
    if case == "head_lrelu":
        src = torch.from_numpy(rng.random((*shape, 64), np.float32)).to(cuda_device,
                                                                        torch.bfloat16)
        dst = torch.empty((*shape, 64), dtype=torch.bfloat16, device=cuda_device)
        _launch(src, 64, w, b, dst, 0, True)
        want, _ = reference.same_layer(src.float(), w, b, True)
        torch.cuda.synchronize()
        _close(dst.float(), want)
        return
    src = torch.from_numpy(rng.random((*shape, 192), np.float32)).to(cuda_device, torch.bfloat16)
    f32 = torch.from_numpy(rng.standard_normal((*shape, 64), np.float32)).to(cuda_device)
    dst = torch.full((*shape, 192), SENTINEL, dtype=torch.bfloat16, device=cuda_device)
    _launch(src, 64, w, b, dst, 0, False, [(f32, 1.0)])
    want, _ = reference.same_layer(src[..., :64].float(), w, b, False, [(f32, 1.0)])
    torch.cuda.synchronize()
    _close(dst[..., :64].float(), want)
    assert bool((dst[..., 64:] == SENTINEL).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 23, 37), (1, 130, 200)])
def test_last_layer_on_card(cuda_device, shape):
    """conv_last: 64 -> 3, SAME, f32 out, no activation."""
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.random((*shape, 64), np.float32)).to(cuda_device, torch.bfloat16)
    w, b = _weights(3, 64, 3, 8, cuda_device)
    dst = torch.empty((*shape, 3), dtype=torch.float32, device=cuda_device)
    before = chain.LAUNCHES_LAST
    _launch(src, 64, w, b, dst, 0, False, last=True)
    want, _ = reference.same_layer(src.float(), w, b, False, last=True)
    torch.cuda.synchronize()
    assert chain.LAUNCHES_LAST == before + 1
    _close(dst, want)


@pytest.mark.cuda
def test_refusals_on_card(cuda_device):
    """An even f takes no SAME padding; an f32 residual of odd stride and a
    channel stride that is not a multiple of 8 are refused."""
    lib = build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16, device=cuda_device)
    w, b = _weights(3, 64, 32, 9, cuda_device)
    plan = entry.bf16_layer_plan(3, 64, 32)
    wp, bp = entry.pack_bf16(w, b, False)
    odd = torch.zeros((1, 8, 8, 33), dtype=torch.float32, device=cuda_device)
    with pytest.raises(RuntimeError, match="SAME launch failed"):
        chain.same_forward(lib, x, 64, wp, bp, x, 0, plan, 0, [(odd, 0.2)], None, stream)
    narrow = torch.zeros((1, 8, 8, 36), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(RuntimeError, match="SAME launch failed"):
        chain.same_forward(lib, x, 64, wp, bp, narrow, 0, plan, 0, (), None, stream)
    w4, b4 = _weights(4, 64, 3, 10, cuda_device)
    plan4 = entry.bf16_layer_plan(4, 64, 3, last=True)
    wl, bl = entry.pack_last(w4, b4, plan4)
    y = torch.zeros((1, 8, 8, 3), dtype=torch.float32, device=cuda_device)
    with pytest.raises(RuntimeError, match="SAME launch failed"):
        chain.same_forward(lib, x, 64, wl, bl, y, 0, plan4, 0, (), None, stream)


def _x4plus(device):
    from benchmark import weights as weights_io
    from benchmark.core import ROOT, load_cell

    cell = load_cell("realesrgan-x4-bf16-frames540-b8")
    arrays = weights_io.load(ROOT, cell.config)
    return cell, arrays, [{"w": torch.as_tensor(w, device=device),
                           "b": torch.as_tensor(b, device=device)} for w, b in arrays]


@pytest.mark.cuda
def test_x4plus_at_540p_against_the_reference_on_card(cuda_device):
    """Real-ESRGAN x4plus, seeded weights, one 540x960 frame through
    ``api.upscale_batch`` in bf16 against the benchmark's plain f32
    reference on the card, within the cell's limits; one forward is 351
    launches, all SAME, 70 with residuals (69 conv_5 and conv_body)."""
    from benchmark import compare, frames
    from benchmark.reference import rrdbnet as ref
    from cnn_sr_tpu_torch import api
    from cnn_sr_tpu_torch.utils.config import parse_config

    cell, arrays, params = _x4plus(cuda_device)
    cfg = parse_config(cell.config["program_config"])
    rgba = frames.make_frames(1, 540, 960, 2**31 + 77, "cpu").numpy()
    before = (chain.LAUNCHES_BF16, chain.LAUNCHES_SAME, chain.LAUNCHES_RESIDUAL,
              chain.LAUNCHES_FIRST, chain.LAUNCHES_WGMMA, chain.LAUNCHES_LAST)
    got = api.upscale_batch(cfg, params, rgba, "bf16")
    after = (chain.LAUNCHES_BF16, chain.LAUNCHES_SAME, chain.LAUNCHES_RESIDUAL,
             chain.LAUNCHES_FIRST, chain.LAUNCHES_WGMMA, chain.LAUNCHES_LAST)
    assert [a - b for a, b in zip(after, before)] == [351, 351, 70, 1, 349, 1]
    assert got.shape == (1, 2160, 3840, 3)
    weights = [(torch.as_tensor(w, device=cuda_device), torch.as_tensor(b, device=cuda_device))
               for w, b in arrays]
    want = ref.upscale_frame(torch.as_tensor(rgba[0], device=cuda_device), weights)
    numbers = compare.answer_numbers(got[0], want)
    ok, checks = compare.judge(numbers, cell.limits)
    assert ok, checks
    with pytest.raises(NotImplementedError, match="#C4"):
        api.upscale_batch(cfg, params, rgba[:, :16, :16], "f32")
