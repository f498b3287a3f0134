"""The port's strided-store probe (``cnn_sr_tpu_torch.probes.strided_store``)
and the parity layouts (``cnn_sr_tpu_torch.probes.layout``).

On the CPU the plain roundtrip is held against the JAX package's
``tools/strided_store_probe.py`` kernel in interpret mode, and the
layouts against numpy slicing. The CUDA kernel (``csrc/parity_copy.cu``)
runs only on a card: those tests carry the ``cuda`` marker and skip
without one. A machine with a card may have no JAX, so this module
imports JAX only inside the test that needs it; there the card tests run
with

    python -m pytest tests/test_torch_strided_store_probe.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.probes import layout, strided_store

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
DTYPES = [torch.float32, torch.bfloat16]
# (R, C): even and odd rows and columns
PACK_SHAPES = [(6, 8), (7, 8), (6, 9), (7, 9)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _act(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _pack_numpy(a, cwp):
    """The probe's parity input by numpy slicing, row by row."""
    r, c, k = a.shape
    out = np.zeros((2, (r + 1) // 2, cwp, 2 * k), a.dtype)
    for row in range(r):
        for cp in range(2):
            cols = a[row, cp::2]
            out[row % 2, row // 2, :cols.shape[0], cp * k:(cp + 1) * k] = cols
    return out


def test_plain_roundtrip_is_bit_equal_to_the_jax_probe(monkeypatch, capsys):
    sys.path.insert(0, TOOLS)
    import jax.numpy as jnp
    import strided_store_probe as sp

    made = []
    real = sp.pl.pallas_call

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(sp.pl, "pallas_call", recording)
    assert sp.main() == 0
    assert "max_abs_err=0.0" in capsys.readouterr().out
    a = np.random.default_rng(0).standard_normal((sp.R, sp.C, sp.K)).astype(np.float32)
    jax_out = np.asarray(made[0](jnp.asarray(a)))
    got = strided_store.strided_roundtrip_plain(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(strided_store.strided_roundtrip(torch.from_numpy(a)).numpy(),
                                  jax_out)


@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip_adds_one_rounded_once(dtype):
    a = _act((6, 10, 16), dtype, seed=1)
    got = strided_store.strided_roundtrip(a)
    assert got.dtype == dtype
    assert torch.equal(got, (a.float() + 1.0).to(dtype))
    assert torch.equal(got, strided_store.strided_roundtrip_plain(a))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PACK_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pack_rows_cols_is_exact(shape, dtype):
    a = _act((*shape, 8), dtype, seed=2)
    half_c = (shape[1] + 1) // 2
    for cwp in (None, half_c + 3):
        got = layout.pack_rows_cols(a, cwp)
        ref = _pack_numpy(a.float().numpy(), cwp or half_c)
        assert got.dtype == dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_and_merge_quadrants_are_exact_inverses(dtype):
    y = _act((6, 10, 8), dtype, seed=3)
    q = layout.split_quadrants(y)
    assert tuple(q.shape) == (2, 2, 3, 5, 8)
    yn = y.float().numpy()
    for p in range(2):
        for qq in range(2):
            np.testing.assert_array_equal(q[p, qq].float().numpy(), yn[p::2, qq::2])
    assert torch.equal(layout.merge_quadrants(q), y)


def test_layouts_refuse_what_they_cannot_hold():
    with pytest.raises(ValueError, match="even rows and columns"):
        layout.split_quadrants(torch.zeros((5, 4, 8)))
    with pytest.raises(ValueError, match="cwp"):
        layout.pack_rows_cols(torch.zeros((4, 9, 8)), cwp=4)
    with pytest.raises(ValueError, match="contiguous"):
        layout.pack_rows_cols(torch.zeros((4, 8, 8)).transpose(0, 1))
    with pytest.raises(ValueError, match="merge_quadrants"):
        layout.merge_quadrants(torch.zeros((3, 2, 2, 2, 8)))


@pytest.mark.parametrize("case", ["shape", "dtype", "dims"])
def test_parity_copy_refuses_mismatches(case):
    src = torch.zeros((2, 3, 4))
    dst = {"shape": torch.zeros((2, 3, 5)),
           "dtype": torch.zeros((2, 3, 4), dtype=torch.bfloat16),
           "dims": None}[case]
    if case == "dims":
        src = dst = torch.zeros((1,) * 6)
    with pytest.raises(ValueError, match="parity_copy"):
        layout.parity_copy(dst, src)


def test_parity_copy_keeps_negative_zero_without_an_add():
    src = torch.tensor([-0.0, 1.5, -2.0])
    dst = torch.empty(3)
    layout.parity_copy(dst, src)
    assert torch.equal(torch.signbit(dst), torch.signbit(src))


def test_cpu_main_exits_0(capsys):
    assert strided_store.main(["--device", "cpu"]) == 0
    assert "max_abs_err=0.0" in capsys.readouterr().out


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        strided_store.main([])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_roundtrip_kernel_is_bit_equal_on_card(cuda_device, dtype):
    a = _act((24, 256, 128), dtype).to(cuda_device)
    before = layout.LAUNCHES
    got = strided_store.strided_roundtrip(a)
    ref = strided_store.strided_roundtrip_plain(a)
    torch.cuda.synchronize()
    assert layout.LAUNCHES == before + 4
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", PACK_SHAPES + [(26, 258)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_layout_kernels_are_bit_equal_on_card(cuda_device, shape, dtype):
    a = _act((*shape, 16), dtype, seed=4).to(cuda_device)
    for cwp in (None, (shape[1] + 1) // 2 + 5):
        assert torch.equal(layout.pack_rows_cols(a, cwp), layout.pack_rows_cols_plain(a, cwp))
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:
        q = layout.split_quadrants(a)
        assert torch.equal(q, layout.split_quadrants_plain(a))
        assert torch.equal(layout.merge_quadrants(q), a)


@pytest.mark.cuda
def test_parity_copy_element_path_on_card(cuda_device):
    """Strides that break 16-byte vectors take the one-element path."""
    a = _act((9, 7, 5), torch.bfloat16, seed=5).to(cuda_device)
    dst = torch.zeros((7, 9, 5), dtype=torch.bfloat16, device=cuda_device)
    layout.parity_copy(dst.transpose(0, 1), a, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(dst.transpose(0, 1), (a.float() + 0.5).to(torch.bfloat16))
