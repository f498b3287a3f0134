"""The port's f=5 conv2 probe (``cnn_sr_tpu_torch.probes.wino5``) against the
JAX package's ``tools/wino5_probe.py``.

On the CPU the plain versions of the four modes (quad, quadp, quad1, w55f)
are held against the probe's own Pallas kernels in interpret mode, on the
probe's seeded inputs at its chunk shape. The CUDA kernel
(``csrc/wino5.cu``) runs only on a card: those tests carry the ``cuda``
marker and skip without one. A machine with a card may have no JAX, so
this module imports JAX only inside the fixture that needs it; there the
card tests run with

    python -m pytest tests/test_torch_wino5_probe.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import chain
from cnn_sr_tpu_torch.probes import layout
from cnn_sr_tpu_torch.probes import wino5 as w5
from cnn_sr_tpu_torch.probes import wino5_parts
from cnn_sr_tpu_torch.probes import winograd

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import wino5_probe as wp  # noqa: E402  (numpy only at import; JAX inside main)

CHUNK = (2 * w5.TR, 2 * w5.TC)
# a small conv2: k = 16, the kernel's n = 32, an output of 14 x 70 (a
# ragged grid of 4 x 32 quad-pixel blocks) from an 18 x 74 activation
SMALL_K, SMALL_OUT = 16, (14, 70)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _small(seed):
    """A seeded activation (18, 74, 16) and weights (5, 5, 16, 32), f32
    uniform in [−0.5, 0.5)."""
    rng = np.random.default_rng(seed)
    oh, ow = SMALL_OUT
    act = (rng.random((oh + 4, ow + 4, SMALL_K), np.float32) - 0.5).astype(np.float32)
    g = (rng.random((5, 5, SMALL_K, w5.N), np.float32) - 0.5).astype(np.float32)
    return act, g


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_probe():
    """The probe's own kernels, captured from ``pallas_call`` while
    ``main(["--check", "--reps", "1"])`` builds and checks them (its grid
    is ``(reps,)``), run in interpret mode on its seeded inputs:
    {mode: output (2, 2, 12, 128, 32) f32}."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    made = []
    real = pl.pallas_call

    def recording(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        assert wp.main(["--check", "--reps", "1"]) == 0
    # built in VARIANTS order, each at inner 1 then 2 (:250-252)
    assert len(made) == 2 * len(w5.MODES)
    g, a = w5.probe_inputs()
    wq = jnp.asarray(wp.quad_weights(g), jnp.bfloat16)
    wf = jnp.asarray(wp.w55f_weights(g).reshape(6 * 3 * 2 * w5.K, 2 * w5.N), jnp.bfloat16)
    return {mode: np.asarray(jax.jit(made[2 * i])(jnp.asarray(a), wf if mode == "w55f" else wq),
                             np.float32)
            for i, mode in enumerate(w5.MODES)}


def test_matrices_and_weights_equal_the_probe():
    for name in ("B6", "G25", "AT25"):
        np.testing.assert_array_equal(getattr(w5, name), getattr(wp, name))
    w5._matrices_check()
    g, a = w5.probe_inputs()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(g, (rng.random((5, 5, 64, 32), np.float32) - 0.5))
    np.testing.assert_array_equal(a, rng.random((14, 136, 256), np.float32) - 0.5)
    np.testing.assert_array_equal(w5.quad_weights(g), wp.quad_weights(g))
    np.testing.assert_array_equal(w5.w55f_weights(g), wp.w55f_weights(g))
    for mode, shape in (("quad", (9 * 256, 128)), ("w55f", (6 * 3 * 128, 64))):
        wt = w5.weights(g, mode)
        assert wt.dtype == torch.bfloat16 and tuple(wt.shape) == shape


def test_pack_quad_is_the_probes_quad_image():
    """The probe's ``--check`` rebuilds the full-resolution block from its
    quad image (:270-274); ``pack_quad`` of that block is the image, bit
    for bit, in f32 and in bf16."""
    _, a = w5.probe_inputs()
    full = w5.unpack_quad(a)
    assert full.shape == (28, 272, 64)
    got = layout.pack_quad(torch.from_numpy(full), w5.TCP)
    assert got.dtype == torch.float32 and tuple(got.shape) == a.shape
    np.testing.assert_array_equal(got.numpy(), a)
    got16 = layout.pack_quad(torch.from_numpy(full).to(torch.bfloat16), w5.TCP)
    assert torch.equal(got16, torch.from_numpy(a).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 8), (7, 8), (6, 9), (7, 9)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_pack_quad_is_exact(shape, dtype):
    act = torch.from_numpy(np.random.default_rng(2).standard_normal((*shape, 8))
                           .astype(np.float32)).to(dtype)
    half_c = (shape[1] + 1) // 2
    for cwp in (None, half_c + 3):
        got = layout.pack_quad(act, cwp)
        want = np.zeros(((shape[0] + 1) // 2, cwp or half_c, 32), np.float32)
        a = act.float().numpy()
        for rp in range(2):
            for cp in range(2):
                src = a[rp::2, cp::2]
                want[:src.shape[0], :src.shape[1], (2 * rp + cp) * 8:(2 * rp + cp + 1) * 8] = src
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert torch.equal(got, layout.pack_quad_plain(act, cwp))
    with pytest.raises(ValueError, match="pack_quad: cwp"):
        layout.pack_quad(act, half_c - 1)


@pytest.mark.parametrize("mode", w5.MODES)
def test_plain_matches_jax_probe_interpret(jax_probe, mode):
    """≥ 99.9% of the outputs bit-equal to the probe's, and each within one
    bf16 ulp of itself, or, for outputs near 0 where the channel sums
    cancel, within 2^-16 of the output's largest magnitude: the operands'
    roundings are the probe's, only the order of the f32 sums differs."""
    g, a = w5.probe_inputs()
    got = w5.wino5(torch.from_numpy(a), w5.weights(g, mode), CHUNK, mode).float().numpy()
    ref = jax_probe[mode]
    assert got.shape == ref.shape == (2, 2, 12, 128, 32)
    equal = float((got == ref).mean())
    assert equal >= 0.999, equal
    limit = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 2.0 ** -16 * np.abs(ref).max()
    assert (np.abs(got - ref) <= limit).all(), np.abs(got - ref).max()


def test_quad_modes_differ_only_in_the_order_of_sums():
    act, g = _small(3)
    x = layout.pack_quad(torch.from_numpy(act))
    outs = [w5.wino5(x, w5.weights(g, mode), SMALL_OUT, mode).float() for mode in w5.GROUP]
    for y in outs[1:]:
        assert float((y == outs[0]).float().mean()) >= 0.99
        assert torch.allclose(y, outs[0], rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("mode", w5.MODES)
def test_each_mode_within_limit_of_float64_direct_conv(mode):
    act, g = _small(5)
    ref = winograd.direct_conv_f64(act, g)
    out = w5.wino5(layout.pack_quad(torch.from_numpy(act)), w5.weights(g, mode), SMALL_OUT, mode)
    y = layout.merge_quadrants(out).double().numpy()
    assert y.shape == ref.shape == (*SMALL_OUT, 32)
    assert np.abs(y - ref).max() <= w5.REL_LIMIT * np.abs(ref).max()


def test_sep_f5_is_the_bf16_direct_conv():
    """The generalised ``sep_plain`` at f=5 is a strict-f32 conv of the
    bf16 values, ReLU, one bf16 rounding: the float64 conv of the same
    bf16 values rounds to it but for sums next to a rounding boundary."""
    act, g = _small(4)
    ab, gb = (torch.from_numpy(v).to(torch.bfloat16) for v in (act, g))
    got = winograd.sep(ab, gb)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (*SMALL_OUT, 32)
    ref = torch.from_numpy(winograd.direct_conv_f64(ab.float().numpy(), gb.float().numpy()))
    ref = ref.float().to(torch.bfloat16)
    assert float((got == ref).float().mean()) >= 0.99
    assert torch.allclose(got.float(), ref.float(), rtol=2 ** -7, atol=0)
    with pytest.raises(ValueError, match="f odd"):
        winograd.sep(ab, gb[:4, :4].contiguous())


def test_malformed_operands_raise():
    act, g = _small(6)
    x = layout.pack_quad(torch.from_numpy(act))
    wq = w5.weights(g, "quad")
    with pytest.raises(ValueError, match="even output"):
        w5.wino5(x, wq, (13, 70))
    with pytest.raises(ValueError, match="mode"):
        w5.wino5(x, wq, SMALL_OUT, "sep")
    with pytest.raises(ValueError, match="contiguous f32"):
        w5.wino5(x.to(torch.bfloat16), wq, SMALL_OUT)
    with pytest.raises(ValueError, match="at least"):
        w5.wino5(x, wq, (16, 70))
    with pytest.raises(ValueError, match="w55f weights"):
        w5.wino5(x, w5.weights(g, "w55f")[:64], SMALL_OUT, "w55f")
    with pytest.raises(NotImplementedError, match="n = 32"):
        w5.wino5(x, w5.weights(g[..., :16], "quad"), SMALL_OUT)
    wide = torch.zeros((9, 36, 4 * 80))
    with pytest.raises(NotImplementedError, match="up to 64"):
        w5.wino5(wide, torch.zeros((9 * 320, 128), dtype=torch.bfloat16), (14, 68))


def test_cpu_check_exits_0(capsys):
    assert w5.main(["--device", "cpu", "--check"]) == 0
    out = capsys.readouterr().out
    for mode in w5.MODES:
        assert f"{mode:6s} max|err| " in out


def test_cpu_timing_runs_the_plain_versions(capsys):
    assert w5.main(["--device", "cpu", "--reps", "1", "--rounds", "1"]) == 0
    out = capsys.readouterr().out
    assert "on CPU (plain)" in out and "sep / w55f" in out and "pack" in out


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w5.main(["--check"])


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``kWino5MaxK`` and ``Wino5Plan`` of ``csrc/wino5_plan.cuh``, compiled
    with the host's C++ compiler: the arithmetic the CUDA launch runs.
    Returns (max_k, plan) with plan(k, w55f) -> dict."""
    import subprocess

    from cnn_sr_tpu_torch.ops.fused import build

    tmp = tmp_path_factory.mktemp("wino5_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "wino5_plan.cuh"\nint main() {\n'
        '  printf("%d\\n", kWino5MaxK);\n  int k, w55f;\n'
        '  while (scanf("%d %d", &k, &w55f) == 2) {\n'
        '    const Wino5Plan p(k, w55f != 0);\n'
        '    printf("%d %d %d %d %d %d %d %d\\n", p.as, p.kc, p.steps, p.nch, p.win, p.stage,\n'
        '           p.smem, p.ok ? 1 : 0);\n  }\n}\n')
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)

    def plan(k, w55f):
        out = subprocess.run([str(exe)], input=f"{k} {int(w55f)}\n", check=True,
                             capture_output=True, text=True, timeout=60).stdout.split("\n")
        names = ("as", "kc", "steps", "nch", "win", "stage", "smem", "ok")
        return dict(zip(names, map(int, out[1].split())))

    first = subprocess.run([str(exe)], input="", check=True, capture_output=True, text=True,
                           timeout=60).stdout
    return int(first.split()[0]), plan


@pytest.mark.parametrize("family", ["quad", "w55f"])
def test_max_k_is_the_kernels_limit(c_plan, family):
    """``MAX_K`` is the C plan's ``kWino5MaxK``; every k that is a multiple
    of 16 up to it has a plan that fits a block's shared memory (quad: the
    bf16 window of 6 x 34 cells of 4k + 8 lanes resident beside three
    stages of Wq rows, 16-row multiples of at most 128 that cover 4k, 136
    lanes a row; w55f: two chunk buffers of the six V_a, 4 x 34 cells of 40 lanes,
    six Wf stages of 3 x 32 rows of 72 lanes, eight mbarriers), and MAX_K +
    16 has none."""
    max_k, plan = c_plan
    assert max_k == w5.MAX_K >= 64
    w55f = family == "w55f"
    for k in range(16, w5.MAX_K + 1, 16):
        p = plan(k, w55f)
        assert p["ok"] == 1, (k, p)
        if w55f:
            assert p["nch"] == k // 16 and p["win"] == 0
            assert p["smem"] == 2 * 6 * 136 * 40 * 2 + 6 * 3 * 32 * 72 * 2 + 64 <= 232_448
        else:
            k4 = 4 * k
            assert p["as"] == k4 + 8 and (p["as"] * 2 // 16) % 2 == 1
            assert p["kc"] % 16 == 0 and p["kc"] <= 128
            assert (p["steps"] - 1) * p["kc"] < k4 <= p["steps"] * p["kc"]
            assert p["win"] == 6 * 34 * (k4 + 8) * 2 and p["stage"] == p["kc"] * 136 * 2
            assert p["smem"] == p["win"] + 3 * p["stage"] <= 232_448
    assert plan(w5.MAX_K + 16, w55f)["ok"] == 0
    assert plan(24, w55f)["ok"] == 0


@pytest.mark.parametrize("mode", w5.MODES)
def test_layer_at_max_k_runs_the_plain_version(mode):
    """k = MAX_K on CPU tensors: the plain version, no launch, within
    ``REL_LIMIT`` of the float64 direct conv."""
    rng = np.random.default_rng(13)
    out_hw = (6, 8)
    act = (rng.random((out_hw[0] + 4, out_hw[1] + 4, w5.MAX_K), np.float32) - 0.5)
    g = (rng.random((5, 5, w5.MAX_K, w5.N), np.float32) - 0.5) / 16
    before = w5.LAUNCHES
    out = w5.wino5(layout.pack_quad(torch.from_numpy(act)), w5.weights(g, mode), out_hw, mode)
    assert w5.LAUNCHES == before and tuple(out.shape) == (2, 2, 3, 4, w5.N)
    ref = winograd.direct_conv_f64(act, g)
    y = layout.merge_quadrants(out).double().numpy()
    assert np.abs(y - ref).max() <= w5.REL_LIMIT * np.abs(ref).max()


@pytest.mark.parametrize("mode", w5.MODES)
def test_past_max_k_raises(mode):
    k = w5.MAX_K + 16
    x = torch.zeros((4, 5, 4 * k))
    rows, lanes = (9 * 4 * k, 4) if mode in w5.GROUP else (6 * 3 * 2 * k, 2)
    wt = torch.zeros((rows, lanes * w5.N), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=f"up to {w5.MAX_K}"):
        w5.wino5(x, wt, (4, 6), mode)


@pytest.mark.parametrize("variant", list(wino5_parts.VARIANTS))
def test_parts_edit_the_kernel_source(variant):
    """Each copy of ``wino5_parts`` is the kernel's source with its parts'
    texts found as often as the probe expects (``patched`` raises
    otherwise) and edited; the kernel as it is stays unedited."""
    parts = wino5_parts.VARIANTS[variant]
    text = wino5_parts.SOURCE.read_text()
    got = wino5_parts.patched(parts)
    assert (got == text) == (not parts)
    assert len(got.splitlines()) >= len(text.splitlines()) - 3
    with pytest.raises(RuntimeError, match="expects 1 of"):
        wino5_parts.patched(("window",), text.replace("load_quad_window(x, g", "load(x, g"))


def test_parts_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wino5_parts.main([])


# the card's cases: the probe's chunk (k = 64, 12 x 128 quad outputs); each
# k the kernel takes on a ragged grid of the 4 x 32 block (13 x 35 quad
# outputs: 4 x 2 blocks, the last of each ragged); and k = MAX_K on a ragged
# grid of more blocks than the card has SMs (68 x 330: 17 x 11 blocks), where
# a persistent w55f block takes several
CARD_CASES = [(w5.K, CHUNK)] + [(k, (26, 70)) for k in range(16, w5.MAX_K + 1, 16)] + [
    (w5.MAX_K, (136, 660))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", w5.MODES)
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"k{c[0]}-{c[1][0]}x{c[1][1]}")
def test_kernel_matches_plain_on_card(cuda_device, mode, case):
    """Within 2^-7 of the output's magnitude and ≥ 99.9% bit-equal (the
    operands' roundings are the same, only the order of the f32 sums
    differs)."""
    k, out_hw = case
    if out_hw == CHUNK:
        g, a = w5.probe_inputs()
        x = torch.from_numpy(a).to(cuda_device)
    else:
        rng = np.random.default_rng(7 + k)
        act = (rng.random((out_hw[0] + 4, out_hw[1] + 4, k), np.float32) - 0.5)
        g = (rng.random((5, 5, k, w5.N), np.float32) - 0.5).astype(np.float32)
        x = layout.pack_quad(torch.from_numpy(act).to(cuda_device))
    wt = w5.weights(g, mode, cuda_device)
    before = w5.LAUNCHES
    y = w5.wino5(x, wt, out_hw, mode)
    ref = w5.wino5_plain(x, wt, out_hw, mode)
    torch.cuda.synchronize()
    assert w5.LAUNCHES == before + 1
    diff = (y.float() - ref.float()).abs()
    assert float(diff.max()) <= 2 ** -7 * float(ref.float().abs().max())
    assert float((y == ref).float().mean()) >= 0.999


@pytest.mark.cuda
def test_pack_quad_and_sep_f5_on_card(cuda_device):
    act, g = _small(8)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(act).to(cuda_device, dtype)
        before = layout.LAUNCHES
        assert torch.equal(layout.pack_quad(a, 40), layout.pack_quad_plain(a, 40))
        assert layout.LAUNCHES == before + 4
    ab, gb = (torch.from_numpy(v).to(cuda_device, torch.bfloat16) for v in (act, g))
    before = chain.LAUNCHES_BF16
    y = winograd.sep(ab, gb)
    ref = winograd.sep_plain(ab, gb)
    torch.cuda.synchronize()
    assert chain.LAUNCHES_BF16 == before + 1
    assert float((y.float() - ref.float()).abs().max()) <= 2 ** -7 * float(ref.float().abs().max())
