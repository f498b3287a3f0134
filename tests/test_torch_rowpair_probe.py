"""The port's row-pair probe (``cnn_sr_tpu_torch.probes.rowpair``) against the
JAX package's ``tools/rowpair_probe.py``.

On the CPU the plain GEMM over the stride-2 rows is held against the
probe's own Pallas kernels in interpret mode, in its four cases. The CUDA
kernel (``csrc/rowpair.cu``) runs only on a card: those tests carry the
``cuda`` marker and skip without one. The probe imports JAX when it is
imported, and a machine with a card may have no JAX, so this module
imports the probe only inside the fixture that needs it; there the card
tests run with

    python -m pytest tests/test_torch_rowpair_probe.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.probes import layout
from cnn_sr_tpu_torch.probes import rowpair as rp

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
CASES = [(lanes, dtype) for lanes in rp.LANES for dtype in rp.DTYPES]


def _ids(case):
    return f"{case[1]}_{case[0]}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_probe():
    """The probe's kernels, captured from ``pallas_call`` while its
    ``main`` builds and runs its four cases, run again in interpret mode on
    its seeded inputs: {(lanes, dtype): output (32, 128, L) f32}."""
    sys.path.insert(0, TOOLS)
    import jax.numpy as jnp
    import rowpair_probe as probe

    made = []
    real = probe.pl.pallas_call

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(probe.pl, "pallas_call", recording)
        assert probe.main() == 0
    assert len(made) == len(CASES)  # main's order: lanes (128, 64) x (bf16, f32)
    outs = {}
    for fn, (lanes, dtype) in zip(made, CASES):
        a, wm = rp.probe_inputs(lanes)
        dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        outs[(lanes, dtype)] = np.asarray(fn(jnp.asarray(a, dt), jnp.asarray(wm, jnp.bfloat16)))
    return outs


def _operands(lanes, dtype, device="cpu"):
    a, wm = rp.probe_inputs(lanes)
    return (torch.from_numpy(a).to(device, rp.DTYPES[dtype]),
            torch.from_numpy(wm).to(device, torch.bfloat16))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_matches_jax_probe_interpret(jax_probe, case):
    """Relative 1e-5 of the output's largest magnitude: the same exact bf16
    products, 128 or 64 of them a sum, added in f32 in another order."""
    lanes, dtype = case
    a, w = _operands(lanes, dtype)
    got = torch.cat([rp.rowpair_gemm(a, w, rp.M_ROWS, rt) for rt in range(2)]).numpy()
    ref = jax_probe[case]
    assert got.shape == ref.shape == (2 * rp.M_ROWS, rp.W, lanes)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_contiguous_copy_reads_the_same_rows(case):
    lanes, dtype = case
    a, w = _operands(lanes, dtype)
    for rt in range(2):
        rows = a[rt::2][:rp.M_ROWS].contiguous()
        assert torch.equal(rp.rowpair_gemm(rows, w, rp.M_ROWS, 0, 1),
                           rp.rowpair_gemm(a, w, rp.M_ROWS, rt))


def test_operand_rounds_to_bf16_at_the_read():
    a, w = _operands(128, "f32")
    got = rp.rowpair_gemm(a, w, 4, 1, 3)
    want = (a[1:11:3].to(torch.bfloat16).double() @ w.double())
    assert torch.allclose(got.double(), want, rtol=0, atol=1e-4)
    assert not torch.allclose(got.double(), a[1:11:3].double() @ w.double(), rtol=0, atol=1e-3)


def test_malformed_operands_raise():
    a, w = _operands(64, "bf16")
    with pytest.raises(ValueError, match="rows"):
        rp.rowpair_gemm(a, w, 33, 0)
    with pytest.raises(ValueError, match="contiguous"):
        rp.rowpair_gemm(a.transpose(0, 1), w, 4, 0)
    with pytest.raises(ValueError, match="w must be"):
        rp.rowpair_gemm(a, w.float(), 4, 0)
    with pytest.raises(ValueError, match="f32 or bf16"):
        rp.rowpair_gemm(a.half(), w, 4, 0)
    with pytest.raises(NotImplementedError, match="L in"):
        rp.rowpair_gemm(a[..., :32].contiguous(), w[:32, :32].contiguous(), 4, 0)


def test_cpu_main_exits_0(capsys):
    assert rp.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for lanes, dtype in CASES:
        assert f"stride-2 leading-dim read, {dtype} {lanes}-lane: OK" in out


def test_routes_agree_on_the_cpu():
    """The routes at a cut operand: the strided read, the contiguous one and
    the copy are equal, the library's bf16 matmul is near."""
    ways, plain, a, w = rp.routes(64, "f32", torch.device("cpu"), shape=(6, 10))
    strided, copied, lib = ways["strided"](), ways["copy"](), ways["library"]()
    for s, c, t, p, l in zip(strided, copied, ways["contiguous"](), plain(), lib):
        assert tuple(s.shape) == (3, 10, 64)
        assert torch.equal(s, c) and torch.equal(s, t) and torch.equal(s, p)
        assert torch.allclose(l.float().view(s.shape), s, rtol=2 ** -7, atol=2 ** -6)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.main([])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_kernel_matches_plain_on_card(cuda_device, case):
    """rel ≤ 1e-5 at the probe's shape, in the stride-2 read and in a
    contiguous copy of the same rows, and 5 rows of 100 columns (a ragged
    last block of the 500 rows)."""
    lanes, dtype = case
    a, w = _operands(lanes, dtype, cuda_device)
    for rt in range(2):
        rows = torch.empty((rp.M_ROWS, rp.W, lanes), dtype=a.dtype, device=cuda_device)
        layout.parity_copy(rows, a[rt:rt + 2 * rp.M_ROWS:2])
        for x, m, r0, step in ((a, rp.M_ROWS, rt, 2), (rows, rp.M_ROWS, 0, 1),
                                   (a[:, :100], 5, rt + 2, 3)):
            before = rp.LAUNCHES
            y = rp.rowpair_gemm(x, w, m, r0, step)
            ref = rp.rowpair_gemm_plain(x, w, m, r0, step)
            torch.cuda.synchronize()
            assert rp.LAUNCHES == before + 1
            assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
