"""The port's fused conv stack (``cnn_sr_tpu_torch.ops.fused``); the layer
chain beside it is in ``test_torch_chain.py``.

On the CPU, ``fused_forward`` is its plain version, held here against the
JAX package's Pallas kernel in interpret mode. The CUDA kernel runs only
on a card: those tests carry the ``cuda`` marker and skip without one.
A machine with a card may have no JAX, so this module imports JAX only
inside the test that needs it; there the card tests run with

    python -m pytest tests/test_torch_fused.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import build, chain, entry, reference
from cnn_sr_tpu_torch.ops.fused import fused_forward
from cnn_sr_tpu_torch.utils.params_io import params_to_torch


def _params(specs, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((f, f, k, n)) * 0.1).astype(np.float32),
             "b": (rng.standard_normal((n,)) * 0.05).astype(np.float32)}
            for f, k, n in specs]


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(np.float32)


NARROW_955 = [(9, 1, 8), (5, 8, 8), (5, 8, 1)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_cpu_matches_jax_pallas_interpret():
    import jax.numpy as jnp

    from cnn_sr_tpu.ops.pallas_fused import fused_forward as jfused_forward

    params = _params(NARROW_955, 0)
    x = _x((1, 40, 140, 1), 1)
    want = np.asarray(jfused_forward(params, x, tile_h=16, tile_w=128,
                                     dtype=jnp.float32))
    before = entry.LAUNCHES
    got = fused_forward(params_to_torch(params, "cpu"), torch.from_numpy(x))
    assert entry.LAUNCHES == before  # the CPU path launches no kernel
    assert tuple(got.shape) == want.shape == (1, 24, 124, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("specs,shape,refusal", [
    ([(9, 1, 8), (5, 8, 1)], (1, 30, 30, 1), None),
    ([(9, 1, 8), (5, 8, 8), (1, 8, 8), (5, 8, 1)], (1, 30, 30, 1), None),
    ([(3, 3, 8), (3, 8, 8), (3, 8, 5)], (1, 30, 30, 3), None),
    ([(3, 5, 8), (3, 8, 8), (3, 8, 1)], (1, 30, 30, 5), None),
    ([(9, 1, 128), (5, 128, 64), (5, 64, 1)], (1, 30, 30, 1), None),
    ([(3, 1, 128), (9, 128, 8), (3, 8, 1)], (1, 40, 40, 1), None),
    ([(3, 1, 8), (25, 8, 128), (3, 128, 1)], (1, 40, 40, 1), None),
    ([(3, 1, 8), (55, 8, 128), (3, 128, 1)], (1, 64, 64, 1), "shared bytes"),
], ids=["2-layer", "4-layer", "n_out", "c_in", "smem", "f9_k128", "f25_n128", "f55_n128"])
def test_outside_envelope_raises_on_every_device(specs, shape, refusal):
    """Outside the fused kernel's envelope. A stack the layer chain takes
    is routed to it and matches the JAX package's XLA forward (f9_k128:
    its f=9 layer's window over 128 channels streams in channel chunks;
    f25_n128: its f=25 layer takes 32 of 128 columns a block); a stack
    with a layer one input channel of whose window and weights fits no
    block's shared memory at NB columns a block is refused on every
    device, never served by the plain version instead."""
    from cnn_sr_tpu.models import forward as jforward

    params = _params(specs, 2)
    x = _x(shape, 3)
    if refusal:
        for dev in ("cpu", "meta"):
            with pytest.raises(NotImplementedError, match=refusal):
                fused_forward(params_to_torch(params, dev),
                              torch.from_numpy(x).to(dev))
        return
    assert entry.route(shape[3], specs)[0] == "chain"
    got = fused_forward(params_to_torch(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jforward(params, x)),
                               rtol=1e-5, atol=1e-5)


def test_device_without_kernel_raises():
    params = [{k: v.to("meta") for k, v in layer.items()}
              for layer in params_to_torch(_params(NARROW_955, 4), "cpu")]
    with pytest.raises(NotImplementedError, match="no kernel for device meta"):
        fused_forward(params, torch.empty((1, 40, 40, 1), device="meta"))


def test_malformed_input_raises():
    params = params_to_torch(_params(NARROW_955, 5), "cpu")
    x = torch.from_numpy(_x((1, 40, 48, 1), 6))
    with pytest.raises(ValueError, match="float32"):
        fused_forward(params, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_forward(params, x.transpose(1, 2))
    with pytest.raises(ValueError, match="receptive field"):
        fused_forward(params, x[:, :16].contiguous())
    with pytest.raises(ValueError, match="do not chain"):
        fused_forward(params[::-1], x)


def test_smem_sizing_matches_the_design():
    # flagship 9-5-5 at a 16x16 tile, each tile [c][x][y] with the odd
    # column stride of its reader (conv1 PX = 4, conv2 PX = 5, conv3 PX = 2):
    # 32·33·1 + 24·25·64 + 20·21·32 floats
    assert entry.FUSED_SHAPE == ((8, 4), (4, 5), (4, 2))
    assert [entry.col_stride(32, 9, 4), entry.col_stride(24, 5, 5),
            entry.col_stride(20, 5, 2)] == [33, 25, 21]
    assert entry.tile_bytes(1, [(9, 64), (5, 32), (5, 1)]) == 211_584
    # 9-1-5: 28·29 + 20·21·64 + 20·21·32
    assert entry.tile_bytes(1, [(9, 64), (1, 32), (5, 1)]) == 4 * (
        28 * 29 + 20 * 21 * 64 + 20 * 21 * 32)
    # a ragged last row block reads inside its column: 20 rows at PX = 8
    # need 24 + 8 rows of a 28-row window
    assert entry.col_stride(28, 9, 8) == 33
    # the rest of the block's shared memory, 5,216 floats, carries the
    # packed weights: conv1 (81·64) and conv3 (32 channels of 25·4, n3 = 1
    # padded to NB = 4) whole, conv2 through two cp.async stages of 2,608
    # floats, 3 of its 64 input channels (25·32 floats each) a stage
    wbuf, total = entry.smem_plan(1, [(9, 1, 64), (5, 64, 32), (5, 32, 1)])
    assert total == entry.SMEM_LIMIT and wbuf == (entry.SMEM_LIMIT - 211_584) // 4 == 5216
    assert entry.weight_stages(9, 1, 64, wbuf) == (1, 1)
    assert entry.weight_stages(5, 64, 32, wbuf) == (3, 2)
    assert entry.weight_stages(5, 32, 4, wbuf) == (32, 1)
    # 9-1-5: every layer's packed weights fit at once; the buffer takes no
    # more than the largest, conv1's
    wbuf, total = entry.smem_plan(1, [(9, 1, 64), (1, 64, 32), (5, 32, 1)])
    assert wbuf == 9 * 9 * 64 and total == 164_528 + 4 * wbuf < entry.SMEM_LIMIT
    assert entry.weight_stages(1, 64, 32, wbuf) == (64, 1)


def test_build_names_library_by_source_hash_and_needs_nvcc(monkeypatch, tmp_path):
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path == build.library_path()
    assert "compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else True)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.find_nvcc()


def test_library_hash_covers_headers(monkeypatch, tmp_path):
    """The kernels include shared headers (``ffma_plan.cuh``,
    ``ffma_stage.cuh``): an edited header must rebuild, though only the
    ``.cu`` files are compiled."""
    assert [p.name for p in build._sources()] == ["conv_layer.cu", "conv_wgmma.cu",
                                                  "fused_srcnn.cu", "fused_wgmma.cu",
                                                  "parity_copy.cu", "rowpair.cu", "wino5.cu",
                                                  "winograd.cu", "xpack.cu"]
    hashed = [p.name for p in build._hashed_files()]
    assert "ffma_plan.cuh" in hashed and "ffma_stage.cuh" in hashed
    assert "conv_stage.cuh" not in hashed  # the f32 chain runs on ffma_stage.cuh
    (tmp_path / "k.cu").write_text('#include "s.cuh"\n')
    (tmp_path / "s.cuh").write_text("// one\n")
    (tmp_path / "notes.txt").write_text("one")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build._sources() == [tmp_path / "k.cu"]
    before = build.library_path()
    (tmp_path / "notes.txt").write_text("two")
    assert build.library_path() == before
    (tmp_path / "s.cuh").write_text("// two\n")
    assert build.library_path() != before


@pytest.mark.cuda
@pytest.mark.parametrize("specs,shape", [
    (NARROW_955, (1, 40, 140, 1)),
    ([(9, 1, 64), (5, 64, 32), (5, 32, 1)], (2, 97, 131, 1)),
    ([(9, 1, 64), (1, 64, 32), (5, 32, 1)], (1, 80, 272, 1)),
    ([(3, 3, 16), (3, 16, 8), (3, 8, 3)], (1, 45, 70, 3)),
    ([(9, 1, 12), (1, 12, 4), (5, 4, 1)], (1, 48, 64, 1)),
    ([(9, 1, 64), (5, 64, 32), (5, 32, 1)], (1, 33, 49, 1)),
    ([(9, 1, 64), (5, 64, 32), (5, 32, 1)], (3, 50, 70, 1)),
    ([(9, 1, 60), (5, 60, 28), (5, 28, 1)], (1, 60, 90, 1)),
    ([(9, 1, 40), (9, 40, 56), (3, 56, 1)], (1, 40, 50, 1)),
], ids=["narrow_9-5-5", "flagship_ragged", "9-1-5", "rgb_3layer", "odd_widths",
        "flagship_17x33", "flagship_batch3", "flagship_depth_odd_widths", "one_stage_conv2"])
def test_kernel_matches_plain_on_card(cuda_device, specs, shape):
    # flagship_17x33: an output one pixel past a 16x16 tile edge both ways;
    # flagship_depth_odd_widths: n1, n2 not multiples of the kernel's NB
    # (padded lanes), conv2 streamed in partial chunks; one_stage_conv2:
    # conv2's weights through a single stage, one input channel a chunk
    # f32 sums of up to 1,600 terms in another order than cuDNN's
    params = params_to_torch(_params(specs, 7), cuda_device)
    x = torch.from_numpy(_x(shape, 8)).to(cuda_device)
    before = entry.LAUNCHES
    y = fused_forward(params, x)
    ref = reference.fused_forward(params, x)
    torch.cuda.synchronize()
    assert entry.LAUNCHES == before + 1
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_outside_envelope_raises_without_launch(cuda_device):
    # a layer one input channel of whose window and weights (f = 55 to
    # 128 columns) fits no block's shared memory: refused before any launch
    params = params_to_torch(_params([(3, 1, 8), (55, 8, 128), (3, 128, 1)], 9), cuda_device)
    before = (entry.LAUNCHES, chain.LAUNCHES)
    with pytest.raises(NotImplementedError, match="shared bytes"):
        fused_forward(params, torch.zeros((1, 64, 64, 1), device=cuda_device))
    assert (entry.LAUNCHES, chain.LAUNCHES) == before
