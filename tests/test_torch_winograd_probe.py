"""The port's Winograd probe (``cnn_sr_tpu_torch.probes.winograd``) against
the JAX package's ``tools/winograd_probe.py``.

On the CPU the plain versions of the three Winograd modes and ``repack``
are held against the probe's own Pallas kernels in interpret mode, on the
same seeded inputs at the probe's chunk shapes. The CUDA kernel
(``csrc/winograd.cu``) runs only on a card: those tests carry the
``cuda`` marker and skip without one. A machine with a card may have no
JAX, so this module imports JAX only inside the fixture that needs it;
there the card tests run with

    python -m pytest tests/test_torch_winograd_probe.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import chain
from cnn_sr_tpu_torch.probes import layout
from cnn_sr_tpu_torch.probes import winograd as w

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import winograd_probe as wp  # noqa: E402  (numpy only at import; JAX inside main)

CHUNK = (24, 256)
KINDS = {"wino": "direct", "winoF": "factored"}
# small widths for the tests that need no probe shapes
SMALL = ((16, 8), (8, 16))


def _inputs(k, n, rows, cols, seed):
    """The probe's ``_check`` inputs: activation and weights uniform in
    [−0.5, 0.5), f32."""
    rng = np.random.default_rng(seed)
    act = (rng.random((rows, cols, k), np.float32) - 0.5).astype(np.float32)
    g = (rng.random((3, 3, k, n), np.float32) - 0.5).astype(np.float32)
    return act, g


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_probe():
    """The probe's own kernels (``main(["--check", "--reps", "1"])`` with its
    checker replaced by one that keeps ``built``), run in interpret mode on
    seeded inputs of every pair; {(kind, k, n): output} and the inputs."""
    import jax.numpy as jnp

    kept = {}

    def keep(built, *_):
        kept.update(built)
        return 0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wp, "_check", keep)
        assert wp.main(["--check", "--reps", "1"]) == 0
    outs, inputs = {}, {}
    for k, n in w.PAIRS:
        act, g = _inputs(k, n, 26, 258, seed=k + n)
        # the parity input as the probe's _check builds it (:360-366)
        pa = np.zeros((2, 13, 144, 2 * k), np.float32)
        for r in range(26):
            for cpar in range(2):
                cols = act[r, cpar::2]
                pa[r % 2, r // 2, :cols.shape[0], cpar * k:(cpar + 1) * k] = cols
        u = wp.transform_weights(g, np.float32).reshape(16 * k, n)
        for kind in KINDS:
            outs[(kind, k, n)] = np.asarray(
                kept[f"{kind}{k}.{n}"][0](jnp.asarray(pa, jnp.bfloat16),
                                          jnp.asarray(u, jnp.bfloat16)), np.float32)
        # repack's dx-prepacked input (:379-382)
        sa = np.zeros((26, 264, 3 * k), np.float32)
        for dx in range(3):
            sa[:, :256, dx * k:(dx + 1) * k] = act[:, dx:dx + 256]
        outs[("repack", k, n)] = np.asarray(
            kept[f"repack{k}.{n}"][0](jnp.asarray(sa, jnp.bfloat16),
                                      jnp.asarray(g.reshape(9 * k, n), jnp.bfloat16)),
            np.float32)
        inputs[(k, n)] = (act, g, np.asarray(jnp.asarray(pa, jnp.bfloat16), np.float32))
    return outs, inputs


def test_matrices_and_weight_transform_equal_the_probe():
    np.testing.assert_array_equal(w.BT, wp.BT)
    np.testing.assert_array_equal(w.G, wp.G)
    np.testing.assert_array_equal(w.AT, wp.AT)
    g = np.random.default_rng(3).standard_normal((3, 3, 16, 8)).astype(np.float32)
    np.testing.assert_array_equal(w.transform_weights(g, np.float32),
                                  wp.transform_weights(g, np.float32))
    u = w.weights_u(g)
    assert u.dtype == torch.bfloat16 and tuple(u.shape) == (16 * 16, 8)


def test_pack_rows_cols_is_the_probes_parity_input(jax_probe):
    _, inputs = jax_probe
    for (k, n), (act, _, pa) in inputs.items():
        got = layout.pack_rows_cols(_bf16(act), w.CHUNK_CWP)
        assert tuple(got.shape) == (2, w.CHUNK_RH, w.CHUNK_CWP, 2 * k)
        np.testing.assert_array_equal(got.float().numpy(), pa)


@pytest.mark.parametrize("pair", w.PAIRS, ids=lambda p: f"{p[0]}.{p[1]}")
@pytest.mark.parametrize("kind", ["wino", "winoF", "repack"])
def test_plain_matches_jax_probe_interpret(jax_probe, kind, pair):
    """≥ 99.9% of the outputs bit-equal to the probe's, and each within one
    bf16 ulp of itself, or, for outputs near 0 where the channel sums cancel,
    within 2^-16 of the output's largest magnitude: only the order of the
    f32 sums differs (V's roundings are the probe's, add for add)."""
    outs, inputs = jax_probe
    k, n = pair
    act, g, _ = inputs[pair]
    if kind == "repack":
        got = w.repack(_bf16(act), _bf16(g))
    else:
        a_par = layout.pack_rows_cols(_bf16(act), w.CHUNK_CWP)
        got = w.winograd_f2x3(a_par, w.weights_u(g), CHUNK, KINDS[kind])
    got = got.float().numpy()
    ref = outs[(kind, k, n)]
    assert got.shape == ref.shape == (2, 2, 12, 128, n)
    equal = float((got == ref).mean())
    diff = np.abs(got - ref)
    assert equal >= 0.999, equal
    limit = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref))) + 2.0 ** -16 * np.abs(ref).max()
    assert (diff <= limit).all(), diff.max()


@pytest.mark.parametrize("mode", ["direct", "factored"])
@pytest.mark.parametrize("pair", SMALL, ids=lambda p: f"{p[0]}.{p[1]}")
def test_pre_given_the_transform_is_bit_equal(mode, pair):
    k, n = pair
    act, g = _inputs(k, n, 12, 18, seed=7)
    a_par = layout.pack_rows_cols(_bf16(act))
    u = w.weights_u(g)
    v = w.input_transform(a_par, (10, 16), mode)
    assert tuple(v.shape) == (16, 5 * 8, k) and v.dtype == torch.bfloat16
    assert torch.equal(w.winograd_f2x3(v, u, (10, 16), "pre"),
                       w.winograd_f2x3(a_par, u, (10, 16), mode))


@pytest.mark.parametrize("mode", ["direct", "factored"])
def test_transform_of_small_integers_is_exact(mode):
    """Small integers add exactly in bf16, so V is BᵀdB exactly in both
    orders of adds."""
    k = 8
    act = np.random.default_rng(1).integers(-8, 8, (8, 10, k)).astype(np.float32)
    v = w.input_transform(layout.pack_rows_cols(_bf16(act)), (6, 8), mode).float().numpy()
    for tr in range(3):
        for tc in range(4):
            d = act[2 * tr:2 * tr + 4, 2 * tc:2 * tc + 4]
            ref = np.einsum("ai,bj,ijc->abc", w.BT, w.BT, d).reshape(16, k)
            np.testing.assert_array_equal(v[:, tr * 4 + tc], ref)


@pytest.mark.parametrize("variant", ["direct", "factored", "pre", "repack"])
def test_each_variant_within_1e2_of_float64_direct_conv(variant):
    k, n = 16, 8
    act, g = _inputs(k, n, 14, 22, seed=11)
    ref = w.direct_conv_f64(act, g)
    if variant == "repack":
        out = w.repack(_bf16(act), _bf16(g))
    else:
        a_par = layout.pack_rows_cols(_bf16(act))
        x = w.input_transform(a_par, (12, 20)) if variant == "pre" else a_par
        out = w.winograd_f2x3(x, w.weights_u(g), (12, 20), variant)
    y = layout.merge_quadrants(out).double().numpy()
    assert np.abs(y - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("out_hw", [(9, 16), (10, 15)])
def test_odd_output_size_raises(out_hw):
    k, n = 8, 8
    act, g = _inputs(k, n, 12, 18, seed=2)
    a_par = layout.pack_rows_cols(_bf16(act))
    with pytest.raises(ValueError, match="even output"):
        w.winograd_f2x3(a_par, w.weights_u(g), out_hw)
    with pytest.raises(ValueError, match="even output"):
        w.input_transform(a_par, out_hw)


def test_malformed_layers_raise():
    act, g = _inputs(8, 8, 12, 18, seed=2)
    a_par = layout.pack_rows_cols(_bf16(act))
    u = w.weights_u(g)
    with pytest.raises(ValueError, match="bf16"):
        w.winograd_f2x3(a_par.float(), u, (10, 16))
    with pytest.raises(ValueError, match="parity input"):
        w.winograd_f2x3(a_par, u, (12, 16))  # needs 7 rows of tiles + 1
    with pytest.raises(ValueError, match="U must be"):
        w.winograd_f2x3(a_par, w.weights_u(_inputs(16, 8, 4, 4, 0)[1]), (10, 16))
    with pytest.raises(ValueError, match="mode"):
        w.winograd_f2x3(a_par, u, (10, 16), "sep")
    with pytest.raises(ValueError, match="multiple of 8"):
        w.winograd_f2x3(layout.pack_rows_cols(_bf16(act[..., :4])), u[:64], (10, 16))
    with pytest.raises(ValueError, match="V must be"):
        w.winograd_f2x3(a_par, u, (10, 16), "pre")
    wide = layout.pack_rows_cols(torch.zeros((6, 6, 200), dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="input channels"):
        w.winograd_f2x3(wide, torch.zeros((16 * 200, 8), dtype=torch.bfloat16), (4, 4))
    with pytest.raises(ValueError, match="direct' or 'factored"):
        w.input_transform(a_par, (10, 16), "pre")


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``kWinoMaxK`` and ``WinoPlan`` of ``csrc/winograd_plan.cuh``, compiled
    with the host's C++ compiler: the arithmetic the CUDA launch runs.
    Returns (max_k, plan) with plan(k, nb, window) -> dict."""
    import subprocess

    from cnn_sr_tpu_torch.ops.fused import build

    tmp = tmp_path_factory.mktemp("wino_plan")
    src = tmp / "plan.cpp"
    src.write_text(
        '#include <cstdio>\n#include "winograd_plan.cuh"\nint main() {\n'
        '  printf("%d\\n", kWinoMaxK);\n  int k, nb, window;\n'
        '  while (scanf("%d %d %d", &k, &nb, &window) == 3) {\n'
        '    const WinoPlan p(k, nb, window != 0);\n'
        '    printf("%d %d %d %d %d %d %d %d %d %d\\n", p.kp, p.kblk, p.kc, p.nch, p.win, p.v,\n'
        '           p.u, p.y, p.smem, p.ok ? 1 : 0);\n  }\n}\n')
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)
    cache = {}

    def plan(k, nb, window):
        key = (k, nb, window)
        if key not in cache:
            out = subprocess.run([str(exe)], input=f"{k} {nb} {int(window)}\n", check=True,
                                 capture_output=True, text=True, timeout=60).stdout.split("\n")
            names = ("kp", "kblk", "kc", "nch", "win", "v", "u", "y", "smem", "ok")
            cache[key] = dict(zip(names, map(int, out[1].split())))
        return cache[key]

    first = subprocess.run([str(exe)], input="", check=True, capture_output=True, text=True,
                           timeout=60).stdout
    return int(first.split()[0]), plan


@pytest.mark.parametrize("window", [True, False], ids=["direct-factored", "pre"])
@pytest.mark.parametrize("nb", [64, 128])
def test_max_k_is_the_kernels_limit(c_plan, nb, window):
    """``MAX_K`` is the C plan's ``kWinoMaxK``; every k up to it has a plan
    that fits a block's shared memory (V in 64-lane blocks of 64 tiles, U
    stages of 16-row multiples that cover kp and Y planes of 64 tiles, in
    128-byte rows; 1,040 bytes for alignment and the mbarriers), and MAX_K
    + 8 has none."""
    max_k, plan = c_plan
    assert max_k == w.MAX_K >= 160
    for k in range(8, w.MAX_K + 1, 8):
        p = plan(k, nb, window)
        assert p["ok"] == 1, (k, p)
        assert p["kp"] == -(-k // 16) * 16 and p["kblk"] == -(-p["kp"] // 64)
        assert p["v"] == p["kblk"] * 64 * 128 and p["u"] == p["kc"] * nb * 2
        assert p["kc"] % 16 == 0 and (p["nch"] - 1) * p["kc"] < p["kp"] <= p["nch"] * p["kc"]
        assert p["win"] == (2 * 5 * 17 * 2 * k * 2 if window else 0)
        assert p["y"] == 64 * nb * 2
        assert p["smem"] == 1040 + p["win"] + 2 * (p["v"] + p["u"] + p["y"]) <= 232_448
    assert plan(w.MAX_K + 8, nb, window)["ok"] == 0


@pytest.mark.parametrize("mode", w.MODES)
def test_layer_at_max_k_runs_the_plain_version(mode):
    """k = MAX_K on CPU tensors: the plain version, within 1e-2 of the
    float64 direct conv."""
    k, n = w.MAX_K, 8
    act, g = _inputs(k, n, 6, 8, seed=12)
    a_par = layout.pack_rows_cols(_bf16(act))
    x = w.input_transform(a_par, (4, 6)) if mode == "pre" else a_par
    before = w.LAUNCHES
    out = w.winograd_f2x3(x, w.weights_u(g), (4, 6), mode)
    assert w.LAUNCHES == before and tuple(out.shape) == (2, 2, 2, 3, n)
    ref = w.direct_conv_f64(act, g)
    y = layout.merge_quadrants(out).double().numpy()
    assert np.abs(y - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("entry", ["direct", "factored", "pre", "input_transform"])
def test_past_max_k_raises(entry):
    k = w.MAX_K + 8
    a_par = layout.pack_rows_cols(torch.zeros((6, 8, k), dtype=torch.bfloat16))
    u = torch.zeros((16 * k, 8), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=f"up to {w.MAX_K} input channels"):
        if entry == "input_transform":
            w.input_transform(a_par, (4, 6))
        elif entry == "pre":
            w.winograd_f2x3(torch.zeros((16, 6, k), dtype=torch.bfloat16), u, (4, 6), "pre")
        else:
            w.winograd_f2x3(a_par, u, (4, 6), entry)


def test_sep_is_the_bf16_streams_middle_layer():
    """Plain ``sep`` is a strict-f32 conv of bf16 values, ReLU, one bf16
    rounding: the float64 conv of the same bf16 values rounds to it but
    for sums that land next to a rounding boundary."""
    act, g = _inputs(16, 8, 9, 11, seed=4)
    ab, gb = _bf16(act), _bf16(g)
    got = w.sep(ab, gb)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (7, 9, 8)
    ref = torch.from_numpy(w.direct_conv_f64(ab.float().numpy(), gb.float().numpy()))
    ref = ref.float().to(torch.bfloat16)
    assert float((got == ref).float().mean()) >= 0.99
    assert torch.allclose(got.float(), ref.float(), rtol=2 ** -7, atol=0)


def test_cpu_check_exits_0(capsys):
    assert w.main(["--device", "cpu", "--check"]) == 0
    out = capsys.readouterr().out
    for k, n in w.PAIRS:
        for kind in ("wino", "winoF", "winoD", "repack"):
            assert f"{kind}{k}.{n} check: max_abs=" in out


def test_cpu_timing_runs_the_plain_versions(capsys):
    assert w.main(["--device", "cpu", "--reps", "1", "--rounds", "1"]) == 0
    out = capsys.readouterr().out
    assert "on CPU (plain)" in out and "wino128.128" in out and "split128.64" in out


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w.main(["--check"])


# the card's cases: the probe's pairs at its chunk (parity input padded to
# CHUNK_CWP columns), a ragged tile grid (out 20x68: 10 x 34 tiles against a
# block's 4 x 16), k = MAX_K, where U streams in stages of part of a
# position, and widths off the kernel's multiples: k of 8 and 8 mod 16 (V's
# lanes padded to 16), n below a block's 64 channels and 8 past 128 (a
# second channel group)
CARD_CASES = [(k, n, CHUNK) for k, n in w.PAIRS] + [
    (64, 128, (20, 68)), (w.MAX_K, 128, (20, 68)), (w.MAX_K, 64, CHUNK),
    (8, 16, (10, 16)), (40, 24, (20, 68)), (136, 136, (20, 68))]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", w.MODES)
@pytest.mark.parametrize("pair", CARD_CASES, ids=lambda p: f"{p[0]}.{p[1]}" + (
    "" if p[2] == CHUNK else f"-{p[2][0]}x{p[2][1]}"))
def test_kernel_matches_plain_on_card(cuda_device, mode, pair):
    """Within 2^-7 of the output's magnitude and ≥ 99.9% bit-equal: V is
    the same to the bit, only the order of the f32 sums differs."""
    k, n, out_hw = pair
    act, g = _inputs(k, n, out_hw[0] + 2, out_hw[1] + 2, seed=21)
    a_par = layout.pack_rows_cols(_bf16(act).to(cuda_device),
                                  w.CHUNK_CWP if out_hw == CHUNK else None)
    u = w.weights_u(g, cuda_device)
    x = w.input_transform(a_par, out_hw) if mode == "pre" else a_par
    before = w.LAUNCHES
    y = w.winograd_f2x3(x, u, out_hw, mode)
    ref = w.winograd_f2x3_plain(x, u, out_hw, mode)
    torch.cuda.synchronize()
    assert w.LAUNCHES == before + 1
    diff = (y.float() - ref.float()).abs()
    assert float(diff.max()) <= 2 ** -7 * float(ref.float().abs().max())
    assert float((y == ref).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "factored"])
def test_transform_kernel_is_bit_equal_on_card(cuda_device, mode):
    act, g = _inputs(64, 128, 22, 70, seed=22)  # a ragged tile grid: 10 x 34
    a_par = layout.pack_rows_cols(_bf16(act).to(cuda_device))
    assert torch.equal(w.input_transform(a_par, (20, 68), mode),
                       w.input_transform_plain(a_par, (20, 68), mode))


@pytest.mark.cuda
def test_repack_on_card_runs_the_shipped_layer_and_a_split(cuda_device):
    act, g = _inputs(64, 128, 26, 258, seed=23)
    ab, gb = _bf16(act).to(cuda_device), _bf16(g).to(cuda_device)
    before = chain.LAUNCHES_BF16, layout.LAUNCHES
    y = w.repack(ab, gb)
    ref = w.repack_plain(ab, gb)
    torch.cuda.synchronize()
    assert (chain.LAUNCHES_BF16, layout.LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert float((y.float() - ref.float()).abs().max()) <= 2 ** -7 * float(ref.float().abs().max())
