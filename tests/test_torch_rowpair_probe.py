"""The port's row-pair probe (``cnn_sr_tpu_torch.probes.rowpair``) against the
JAX package's ``tools/rowpair_probe.py``.

On the CPU the plain GEMM over the stride-2 rows is held against the
probe's own Pallas kernels in interpret mode, in its four cases; the
kernel's plan (``csrc/rowpair_plan.cuh``, compiled with ``g++``) against
``rowpair.plan``, and the wrapper's refusals, are held here too. The CUDA
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
from cnn_sr_tpu_torch.probes import rowpair_parts

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
    the copy are equal; ``torch.matmul``'s bf16 output is near (one bf16
    rounding); ``torch.mm`` with an f32 output, where this torch has it for
    the CPU, is the same function: within rel 1e-5, f32 sums in another
    order."""
    ways, plain, a, w = rp.routes(64, "f32", torch.device("cpu"), shape=(6, 10))
    strided, copied, bf16_out = ways["strided"](), ways["copy"](), ways["bf16_out"]()
    try:
        library = ways["library"]()
    except NotImplementedError:  # aten::mm.dtype registered for CUDA only
        library = [None, None]
    for s, c, t, p, l16, l in zip(strided, copied, ways["contiguous"](), plain(), bf16_out,
                                  library):
        assert tuple(s.shape) == (3, 10, 64)
        assert torch.equal(s, c) and torch.equal(s, t) and torch.equal(s, p)
        assert l16.dtype == torch.bfloat16
        assert torch.allclose(l16.float().view(s.shape), s, rtol=2 ** -7, atol=2 ** -6)
        if l is not None:
            assert l.dtype == torch.float32
            assert float((l.view(s.shape) - s).abs().max()) <= 1e-5 * float(s.abs().max())


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``RowpairPlan`` of ``csrc/rowpair_plan.cuh``, compiled with the host's
    C++ compiler: the arithmetic the CUDA launch runs. Returns plan(L) ->
    dict."""
    import subprocess

    from cnn_sr_tpu_torch.ops.fused import build

    tmp = tmp_path_factory.mktemp("rowpair_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "rowpair_plan.cuh"\nint main() {\n'
        '  int L;\n'
        '  while (scanf("%d", &L) == 1) {\n'
        '    const RowpairPlan p(L);\n'
        '    printf("%d %d %d %d %d\\n", p.stage, p.stages, p.w, p.ys, p.smem);\n  }\n}\n')
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)

    def plan(lanes):
        out = subprocess.run([str(exe)], input=f"{lanes}\n", check=True,
                             capture_output=True, text=True, timeout=60).stdout
        return dict(zip(("stage", "stages", "w", "ys", "smem"), map(int, out.split())))

    return plan


@pytest.mark.parametrize("lanes", [32, 64, 96, 128, 256])
def test_plan_matches_the_c_header(c_plan, lanes):
    """``rowpair.plan`` is ``RowpairPlan`` of ``csrc/rowpair_plan.cuh``, at
    the lanes the kernel takes and at others."""
    assert rp.plan(lanes) == c_plan(lanes)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plan_fits_a_block(case):
    """Every case the kernel takes: the ring's stages beside W and the f32
    staging of a tile, inside the shared bytes a block may use, each buffer
    a whole number of 1024-byte swizzle periods, with room for the
    alignment and the mbarriers; a tile's stages of 128 bytes of lanes
    cover L whole."""
    lanes, dtype = case
    esize = torch.empty((), dtype=rp.DTYPES[dtype]).element_size()
    p = rp.plan(lanes)
    assert p["stages"] >= 2 and p["stage"] == rp.BM * 128
    assert p["smem"] <= rp.SMEM_LIMIT and lanes * esize % 128 == 0
    assert p["w"] % 1024 == p["stage"] % 1024 == p["ys"] % 1024 == 0
    slack = p["smem"] - p["w"] - p["stages"] * p["stage"] - p["ys"]
    assert slack >= 1024 + 8 * (2 * p["stages"] + 1)


def _refused(kind):
    """An operand the kernel does not take, with the error raised for it:
    (a, w, m, rt, step, exception, message)."""
    lanes = 64
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((8, 16, lanes), generator=gen).to(torch.bfloat16)
    w = torch.randn((lanes, lanes), generator=gen).to(torch.bfloat16)
    if kind == "base":  # the rows read start 2 bytes past a 16-byte boundary
        a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(8, 16, lanes)
        return a, w, 4, 0, 2, ValueError, "16-byte aligned"
    if kind == "stride":  # rows 8 bytes past a multiple of 16 apart
        buf = torch.randn(8 * (16 * lanes + 2), generator=gen)
        a = buf.as_strided((8, 16, lanes), (16 * lanes + 2, lanes, 1))
        return a, w, 4, 0, 1, ValueError, "multiple of 16 bytes"
    if kind == "w_base":
        w = torch.cat([w.new_zeros(1), w.flatten()])[1:].view(lanes, lanes)
        return a, w, 4, 0, 2, ValueError, "16-byte aligned"
    if kind in ("L32", "L96", "L256"):
        n = int(kind[1:])
        return (torch.zeros((8, 16, n), dtype=torch.bfloat16),
                torch.zeros((n, n), dtype=torch.bfloat16), 4, 0, 2, NotImplementedError, "L in")
    if kind == "w_f32":
        return a, w.float(), 4, 0, 2, ValueError, "w must be"
    if kind == "w_shape":
        return a, w[:, :32].contiguous(), 4, 0, 2, ValueError, "w must be"
    if kind == "w_strided":
        return a, w.t(), 4, 0, 2, ValueError, "w must be"
    if kind == "a_f16":
        return a.half(), w, 4, 0, 2, ValueError, "f32 or bf16"
    raise AssertionError(kind)


MAP_KINDS = ("base", "stride", "w_base")  # what only the kernel's tensor maps refuse


@pytest.mark.parametrize("kind", ["base", "stride", "w_base", "L32", "L96", "L256", "w_f32",
                                  "w_shape", "w_strided", "a_f16"])
def test_wrapper_raises_on_operands_the_kernel_does_not_take(kind):
    """The wrapper states what the kernel takes and raises on anything else.
    Shapes, dtypes and L are refused on every device, the plain version
    included. The tensor maps' alignment is checked where the kernel
    launches, on CUDA tensors: ``map_check`` refuses the operand's
    addresses and row stride, while on the CPU the wrapper and the plain
    version compute the product as on an aligned copy."""
    a, w, m, rt, step, exc, msg = _refused(kind)
    if kind in MAP_KINDS:
        v = a[rt:rt + step * (m - 1) + 1:step]
        with pytest.raises(exc, match=msg):
            rp.map_check(v.data_ptr(), w.data_ptr(), v.stride(0) * v.element_size())
        want = rp.rowpair_gemm_plain(a.contiguous(), w.clone(), m, rt, step)
        assert torch.equal(rp.rowpair_gemm(a, w, m, rt, step), want)
        assert torch.equal(rp.rowpair_gemm_plain(a, w, m, rt, step), want)
        return
    with pytest.raises(exc, match=msg):
        rp.rowpair_gemm(a, w, m, rt, step)
    with pytest.raises(exc, match=msg):
        rp.rowpair_gemm_plain(a, w, m, rt, step)


@pytest.mark.parametrize("base, w_base, row_bytes, msg", [
    (0, 0, 2 * 954 * 128 * 2, None),            # the 1080p exit's stride-2 rows, bf16
    (4096 + 48, 1024 + 16, 954 * 64 * 4, None),  # contiguous f32 rows at 16-byte offsets
    (4096 + 8, 0, 256, "16-byte aligned"),
    (0, 1024 + 2, 256, "16-byte aligned"),
    (0, 0, 16 * 64 * 4 + 8, "multiple of 16 bytes"),
    (0, 0, 2, "multiple of 16 bytes"),
])
def test_map_check_takes_pointer_values(base, w_base, row_bytes, msg):
    """``map_check`` on addresses and a row stride in bytes: it passes what
    the tensor maps take and names what they do not."""
    if msg is None:
        rp.map_check(base, w_base, row_bytes)
    else:
        with pytest.raises(ValueError, match=msg):
            rp.map_check(base, w_base, row_bytes)


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


@pytest.mark.parametrize("variant", list(rowpair_parts.VARIANTS))
def test_parts_edit_the_kernel_source(variant):
    """Each copy of ``rowpair_parts`` is the kernel's source with its parts'
    texts found as often as the probe expects (``patched`` raises
    otherwise) and edited; the kernel as it is stays unedited."""
    parts = rowpair_parts.VARIANTS[variant]
    text = rowpair_parts.SOURCE.read_text()
    got = rowpair_parts.patched(parts)
    assert (got == text) == (not parts)
    assert len(got.splitlines()) >= len(text.splitlines()) - 3
    with pytest.raises(RuntimeError, match="expects 1 of"):
        rowpair_parts.patched(("store",), text.replace("tma_store_3d(&ty,", "store(&ty,"))


def test_parts_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rowpair_parts.main([])


RAGGED = [(lanes, dtype, cols, m) for lanes in rp.LANES for dtype in rp.DTYPES
          for cols in (8, 129, 954) for m in (1, 267)]


def _seeded(rows, cols, lanes, dtype, device, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((rows, cols, lanes)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((lanes, lanes)) / lanes ** 0.5).astype(np.float32))
    return a.to(device, rp.DTYPES[dtype]), w.to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED, ids=lambda c: f"{c[1]}_{c[0]}_W{c[2]}_m{c[3]}")
def test_kernel_matches_plain_on_ragged_shapes(cuda_device, case):
    """rel ≤ 1e-5 on ragged shapes: W = 8 (one tile, under a warpgroup's 64
    positions), 129 (a 1-column second tile) and 954 (7 x 128 + 58); m = 1
    (fewer tiles than SMs) and 267 (odd); the odd row parity of a (2m, W,
    L) operand, read with stride 2."""
    lanes, dtype, cols, m = case
    a, w = _seeded(2 * m, cols, lanes, dtype, cuda_device, seed=cols + m)
    before = rp.LAUNCHES
    y = rp.rowpair_gemm(a, w, m, 1)
    ref = rp.rowpair_gemm_plain(a, w, m, 1)
    torch.cuda.synchronize()
    assert rp.LAUNCHES == before + 1
    assert y.shape == ref.shape == (m, cols, lanes) and bool(torch.isfinite(y).all())
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_strided_equals_contiguous_bitwise_on_card(cuda_device, case):
    """At the 1080p exit's shape (534 x 954 x L): the kernel on the stride-2
    rows of each parity and on a contiguous copy of them gives the same
    bits (the walk and the order of the sums do not depend on the
    stride)."""
    lanes, dtype = case
    a, w = _seeded(534, 954, lanes, dtype, cuda_device, seed=lanes)
    for rt in range(2):
        rows = a[rt::2].contiguous()
        assert torch.equal(rp.rowpair_gemm(a, w, 267, rt), rp.rowpair_gemm(rows, w, 267, 0, 1))
