"""The port's xpack probes (``cnn_sr_tpu_torch.probes.xpack`` and ``xpack2``)
against the JAX package's ``tools/xpack_probe.py`` and ``tools/xpack_probe2.py``.

On the CPU the plain version of ``tap_gemm`` is held against the probes'
own Pallas kernels in interpret mode, in all 14 variants, on the probes'
seeded operands; the kernel's plan (``csrc/xpack_plan.cuh``, compiled
with ``g++``) against ``xpack.plan``, and ``xpack_parts``' edits of the
source, are held here too. The CUDA kernel (``csrc/xpack.cu``) runs only on a card:
those tests carry the ``cuda`` marker and skip without one. A machine with
a card may have no JAX, so this module imports JAX and the probes only
inside the fixture that needs them; there the card tests run with

    python -m pytest tests/test_torch_xpack_probe.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.probes import xpack as xp
from cnn_sr_tpu_torch.probes import xpack2 as xp2
from cnn_sr_tpu_torch.probes import xpack_parts

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
PROBES = {"xpack_probe": xp, "xpack_probe2": xp2}
VARIANTS = [(probe, v) for probe, mod in PROBES.items() for v in mod.VARIANTS]


def _vid(case):
    return case[1].name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_probes():
    """Each probe's kernels, captured from ``pallas_call`` (with
    ``interpret=True`` added) while ``main(["--reps", "1", "--rounds",
    "1"])`` builds and runs them, and the operands it drew, recorded from
    its generator: {probe: ([kernel per variant], [arrays in draw order])}."""
    sys.path.insert(0, TOOLS)
    from jax.experimental import pallas as pl
    import xpack_probe
    import xpack_probe2

    real_call, real_rng = pl.pallas_call, np.random.default_rng
    out = {}
    for name, probe in (("xpack_probe", xpack_probe), ("xpack_probe2", xpack_probe2)):
        made, drawn = [], []

        def interpreted(*args, **kwargs):
            made.append(real_call(*args, **{**kwargs, "interpret": True}))
            return made[-1]

        class Recording:
            def __init__(self, seed):
                self.rng = real_rng(seed)

            def random(self, shape, dtype):
                r = self.rng.random(shape, dtype)
                drawn.append(r - 0.5)
                return r

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pl, "pallas_call", interpreted)
            mp.setattr(np.random, "default_rng", Recording)
            assert probe.main(["--reps", "1", "--rounds", "1"]) == 0
        assert len(made) == len(PROBES[name].VARIANTS)
        out[name] = (made, drawn)
    return out


def _jax_output(jax_probes, probe, v):
    """The probe's kernel for ``v`` on its own draws, (out_shape) f32."""
    import jax.numpy as jnp

    made, drawn = jax_probes[probe]
    variants = PROBES[probe].VARIANTS
    i = variants.index(v)
    first = sum(1 + len(u.w_shapes) for u in variants[:i])
    args = [jnp.asarray(d, jnp.bfloat16) for d in drawn[first:first + 1 + len(v.w_shapes)]]
    return np.asarray(made[i](*args)).astype(np.float32)


@pytest.mark.parametrize("probe", PROBES)
def test_probe_inputs_equal_the_probes_draws(jax_probes, probe):
    _, drawn = jax_probes[probe]
    ours = [x for a, ws in PROBES[probe].probe_inputs().values() for x in (a, *ws)]
    assert len(ours) == len(drawn)
    for x, d in zip(ours, drawn):
        assert x.dtype == d.dtype == np.float32
        np.testing.assert_array_equal(x, d)


@pytest.mark.parametrize("case", VARIANTS, ids=_vid)
def test_plain_matches_jax_probe_interpret(jax_probes, case):
    """Within one bf16 ulp (2^-14 near 0) and ≥ 99.9% bit-equal: the same
    exact bf16 products, the f32 sums in another order."""
    probe, v = case
    a, ws = PROBES[probe].probe_inputs()[v.name]
    at, wt = xp.operands(v, a, ws)
    got = xp.tap_gemm(at, wt, v.taps, 1)
    assert got.dtype == torch.bfloat16 and got.shape[0] == 1
    got = got.view(v.out_shape)
    ref = torch.from_numpy(_jax_output(jax_probes, probe, v)).to(torch.bfloat16)
    assert tuple(ref.shape) == v.out_shape
    err, equal, ok = xp.agree(got, ref)
    assert ok, (err, equal)


def test_variant_tables_match_the_probes():
    """The multiply-adds a step of each variant (the probes' docstrings'
    slot counts) and the same output positions within each probe."""
    mac = {v.name: v.taps.mac for v in xp.VARIANTS + xp2.VARIANTS}
    assert mac["sep_32to32"] == 3 * 6144 * 96 * 32
    assert mac["xpack_32to32"] == 6 * 1536 * 128 * 128
    assert mac["xpk32t32"] == mac["xpk32t32s"] == 2 * mac["sep32t32"]
    assert mac["xpk32t64o"] == mac["xpk32t64d"] == 4 * mac["sep32t64"] // 3
    assert mac["xpk64t64"] == 4 * mac["sep64t64"] // 3
    assert {v.positions for v in xp.VARIANTS} == {xp.M}
    assert {v.positions for v in xp2.VARIANTS} == {xp2.ROWS * xp2.OW}
    assert xp.steps_1080p(xp.VARIANTS) == 338 and xp.steps_1080p(xp2.VARIANTS) == 85
    # xpk32t64o's second chunk reads lanes 64:192, a 128-byte lane offset
    assert {t.l0 for t in xp2.VARIANTS[4].taps.taps} == {0, 64}


@pytest.mark.parametrize("n", xp.WIDTHS)
def test_ragged_plain_is_the_float64_product_rounded(n):
    a, w, taps = xp.ragged(n)
    got = xp.tap_gemm(a, w, taps, 3)
    assert tuple(got.shape) == (3, 7, 37, 2 * n)
    assert torch.equal(got[1], got[0]) and torch.equal(got[2], got[0])
    a64, w64 = a.double().numpy(), w.double().numpy()
    ref = np.zeros((7, 37, 2 * n))
    for t in taps.taps:
        op = a64[t.dr:t.dr + 7, t.dc:t.dc + 37, t.l0:t.l0 + t.k]
        ref[..., t.chunk * n:(t.chunk + 1) * n] += op @ w64[t.w0:t.w0 + t.k]
    ref = torch.from_numpy(np.maximum(ref, 0.0)).to(torch.bfloat16)
    err, equal, ok = xp.agree(got[0], ref)
    assert ok, (err, equal)


def test_agree_holds_one_ulp_and_the_equal_share():
    ref = torch.linspace(0.0, 3.0, 4000).to(torch.bfloat16)
    assert xp.agree(ref, ref) == (0.0, 1.0, True)
    bits = ref.view(torch.int16)
    one = bits.clone()
    one[-1] += 1
    assert xp.agree(one.view(torch.bfloat16), ref)[2]
    two = bits.clone()
    two[-1] += 2
    assert not xp.agree(two.view(torch.bfloat16), ref)[2]
    many = bits.clone()
    many[-10:] += 1
    assert not xp.agree(many.view(torch.bfloat16), ref)[2]
    assert not xp.agree(ref.float(), ref)[2]


def _bad(kind):
    """A malformed call: (a, w, taps, steps)."""
    a = torch.zeros((6, 10, 64), dtype=torch.bfloat16)
    w = torch.zeros((128, 32), dtype=torch.bfloat16)
    good = xp.Tap(1, 1, 8, 32, 0)
    taps = {"K16": (xp.Tap(0, 0, 0, 40, 0),), "lane8": (xp.Tap(0, 0, 4, 32, 0),),
            "rows": (xp.Tap(3, 0, 0, 32, 0),), "cols": (xp.Tap(0, 3, 0, 32, 0),),
            "lanes": (xp.Tap(0, 0, 48, 32, 0),), "w_rows": (xp.Tap(0, 0, 0, 32, 112),),
            "empty_chunk": (xp.Tap(0, 0, 0, 32, 0, 1),),
            "k_steps": (xp.Tap(0, 0, 0, 32, 0),) * 129}.get(kind, (good,))
    n = 48 if kind == "N" else 32
    if kind == "N":
        w = torch.zeros((128, 48), dtype=torch.bfloat16)
    if kind == "dtype":
        a = a.float()
    return a, w, xp.TapList(4, 8, n, taps), 0 if kind == "steps" else 2


BAD = {"K16": "multiple of 16", "lane8": "multiple of 8", "N": "N must be",
       "rows": "reads outside a", "cols": "reads outside a", "lanes": "reads outside a",
       "w_rows": "reads outside w", "empty_chunk": "have no taps", "k_steps": "k-steps",
       "steps": "steps must be", "dtype": "contiguous bf16"}


@pytest.mark.parametrize("kind", BAD)
def test_malformed_taps_raise(kind):
    a, w, taps, steps = _bad(kind)
    with pytest.raises(ValueError, match=BAD[kind]):
        xp.tap_gemm(a, w, taps, steps)
    with pytest.raises(ValueError, match=BAD[kind]):
        xp.tap_gemm_plain(a, w, taps, steps)


def test_the_good_call_of_the_malformed_cases_runs():
    a, w, taps, steps = _bad("none")
    assert tuple(xp.tap_gemm(a, w, taps, steps).shape) == (2, 4, 8, 32)


@pytest.mark.parametrize("probe", PROBES)
def test_cpu_check_exits_0(capsys, probe):
    assert PROBES[probe].main(["--device", "cpu", "--check", "--steps", "1"]) == 0
    out = capsys.readouterr().out
    for v in PROBES[probe].VARIANTS:
        assert f"{v.name:<14} kernel vs plain, 1 steps: " in out and "WRONG" not in out


def test_cpu_timing_runs_the_plain_versions(capsys):
    assert xp.main(["--device", "cpu", "--steps", "1", "--reps", "1", "--rounds", "1"]) == 0
    out = capsys.readouterr().out
    assert "on CPU (plain)" in out and "rep 0 sep_32to32" in out
    assert "xpack_64to64 / sep_64to64" in out and "ms (L4, 1072x1912x64 out)" in out


@pytest.mark.parametrize("probe", PROBES)
def test_default_device_without_cuda_raises(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROBES[probe].main(["--check"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", VARIANTS, ids=_vid)
def test_kernel_matches_plain_on_card(cuda_device, case):
    """At the probe's shapes, one step and three, one launch each."""
    probe, v = case
    a, w = xp.operands(v, *PROBES[probe].probe_inputs()[v.name], cuda_device)
    for steps in (1, 3):
        before = xp.LAUNCHES
        y = xp.tap_gemm(a, w, v.taps, steps)
        ref = xp.tap_gemm_plain(a, w, v.taps, steps)
        torch.cuda.synchronize()
        assert xp.LAUNCHES == before + 1
        err, equal, ok = xp.agree(y, ref)
        assert ok, (err, equal)


@pytest.mark.cuda
@pytest.mark.parametrize("n", xp.WIDTHS)
def test_kernel_ragged_on_card(cuda_device, n):
    """259 output rows (a part block), two chunks, K = 48 and 16, lane
    offsets 8 to 40, at three steps."""
    a, w, taps = xp.ragged(n, cuda_device)
    before = xp.LAUNCHES
    y = xp.tap_gemm(a, w, taps, 3)
    ref = xp.tap_gemm_plain(a, w, taps, 3)
    torch.cuda.synchronize()
    assert xp.LAUNCHES == before + 1
    err, equal, ok = xp.agree(y, ref)
    assert ok, (err, equal)
    with pytest.raises(ValueError, match="multiple of 8"):
        xp.tap_gemm(a, w, xp.TapList(7, 37, n, (xp.Tap(0, 0, 4, 32, 0),)), 1)
    assert xp.LAUNCHES == before + 1


# The kernel's plan (csrc/xpack_plan.cuh) against xpack.plan, its fit and
# its item split; the copies of xpack_parts.
PLAN_CASES = ([(v.name, v.taps) for _, v in VARIANTS]
              + [(f"{kind} N={n}", getattr(xp, kind)(n)[2]) for kind in ("ragged", "streamed")
                 for n in xp.WIDTHS])
PLAN_KEYS = ("n", "tc", "tr", "tiles_c", "tiles", "chunks", "boxes", "slices", "a_res", "w_res",
             "ring", "out_stages", "wslice", "stage", "a_bytes", "w_bytes", "ring_bytes",
             "out_bytes", "zero_bytes", "smem")


def _pid(case):
    return case[0]


@pytest.fixture(scope="module")
def c_plan(tmp_path_factory):
    """``xpack_plan`` of ``csrc/xpack_plan.cuh``, compiled with the host's C++
    compiler: the arithmetic the CUDA launch runs. Returns plan(taps) ->
    (dict of PLAN_KEYS, boxes, slices) or None where it refuses the taps."""
    import subprocess

    from cnn_sr_tpu_torch.ops.fused import build

    tmp = tmp_path_factory.mktemp("xpack_plan")
    src = tmp / "plan.cpp"
    fields = ", ".join(f"p.{k}" for k in PLAN_KEYS)
    src.write_text(
        '#include <cstdio>\n#include "xpack_plan.cuh"\nint main() {\n'
        '  int n, R, C, L, w_rows, rows, cols, chunks, ntaps, taps[6 * 256];\n'
        '  scanf("%d %d %d %d %d %d %d %d %d", &n, &R, &C, &L, &w_rows, &rows, &cols, &chunks,'
        ' &ntaps);\n'
        '  for (int i = 0; i < 6 * ntaps; ++i) scanf("%d", &taps[i]);\n'
        '  static XpackPlan p;\n'
        '  if (xpack_plan(p, n, R, C, L, w_rows, rows, cols, chunks, taps, ntaps)) {\n'
        '    printf("refused\\n");\n    return 0;\n  }\n'
        f'  printf("{" ".join(["%d"] * len(PLAN_KEYS))}\\n", {fields});\n'
        '  for (int j = 0; j < chunks; ++j) {\n'
        '    for (int b = p.box_begin[j]; b < p.box_begin[j + 1]; ++b)\n'
        '      printf("%d %d %d ", p.box[b].dr, p.box[b].dc, p.box[b].lane);\n'
        '    printf("\\n");\n'
        '    for (int s = p.slice_begin[j]; s < p.slice_begin[j + 1]; ++s)\n'
        '      printf("%d %d %d %d ", p.slice[s].box, p.slice[s].half, p.slice[s].w_row,'
        ' p.slice[s].k16);\n'
        '    printf("\\n");\n  }\n}\n')
    exe = tmp / "plan"
    subprocess.run(["g++", "-std=c++17", "-O1", f"-I{build.CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)

    def plan(taps, shape=None, w_rows=4096):
        shape = shape or (taps.rows + 8, taps.cols + 8, 1024)
        head = [taps.n, *shape, w_rows, taps.rows, taps.cols, taps.chunks, len(taps.taps)]
        flat = [v for t in taps.taps for v in (t.dr, t.dc, t.l0, t.k, t.w0, t.chunk)]
        out = subprocess.run([str(exe)], input=" ".join(map(str, head + flat)) + "\n",
                             check=True, capture_output=True, text=True, timeout=60).stdout
        lines = out.splitlines()
        if lines[0] == "refused":
            return None
        nums = [list(map(int, ln.split())) for ln in lines[1:]]
        boxes = [[tuple(b[i:i + 3]) for i in range(0, len(b), 3)] for b in nums[0::2]]
        slices = [[tuple(s[i:i + 4]) for i in range(0, len(s), 4)] for s in nums[1::2]]
        return dict(zip(PLAN_KEYS, map(int, lines[0].split()))), boxes, slices

    return plan


@pytest.mark.parametrize("case", PLAN_CASES, ids=_pid)
def test_plan_matches_the_c_header(c_plan, case):
    """``xpack.plan`` and ``xpack.tables`` are ``xpack_plan`` of
    ``csrc/xpack_plan.cuh``, in the 14 variants and the ragged and streamed
    cases at every N."""
    _, taps = case
    got, boxes, slices = c_plan(taps)
    p = xp.plan(taps)
    assert {k: p[k] for k in PLAN_KEYS} == got
    assert xp.tables(taps) == (boxes, slices)


def test_plan_refuses_what_the_wrapper_refuses(c_plan):
    """The header refuses the taps ``_check`` refuses (a K off 16, a lane
    offset off 8, a read past the operand, more than 128 k-steps)."""
    good = xp.TapList(4, 8, 32, (xp.Tap(1, 1, 8, 32, 0),))
    assert c_plan(good, (6, 10, 64), 128) is not None
    for taps in ((xp.Tap(0, 0, 0, 40, 0),), (xp.Tap(0, 0, 4, 32, 0),), (xp.Tap(3, 0, 0, 32, 0),),
                 (xp.Tap(0, 0, 48, 32, 0),), (xp.Tap(0, 0, 0, 32, 112),),
                 (xp.Tap(0, 0, 0, 32, 0),) * 129):
        assert c_plan(xp.TapList(4, 8, 32, taps), (6, 10, 64), 128) is None


@pytest.mark.parametrize("case", PLAN_CASES, ids=_pid)
def test_plan_fits_a_block_and_balances_the_items(case):
    """Every buffer inside the shared bytes a block may use, each a whole
    number of 1024-byte swizzle periods, with room for the alignment and
    the mbarriers; a ring of 2 to 16 stages only where something streams,
    and W resident wherever A, W and one output stage fit; 16 rows of
    zero weights. At one step
    and at a 1080p layer's steps, each of min(items, 132) blocks takes
    ⌊items / blocks⌋ or ⌈items / blocks⌉ items, a run of at most a few
    (chunk, tile) pairs."""
    _, taps = case
    p = xp.plan(taps)
    assert p["smem"] <= xp.SMEM_LIMIT
    assert p["tc"] * p["tr"] == xp.ROWS and p["tc"] >= min(taps.cols, xp.ROWS)
    for k in ("a_bytes", "w_bytes", "stage", "out_bytes", "zero_bytes"):
        assert p[k] % 1024 == 0
    slack = (p["smem"] - p["a_bytes"] - p["w_bytes"] - p["ring_bytes"] - p["out_bytes"]
             - p["zero_bytes"])
    assert slack >= 1024 + 8 * (2 * xp.MAX_RING + 4)
    out = 2 * xp.LANES * xp.ROWS * 2
    fits = (p["boxes"] * xp.BOX + p["slices"] * p["wslice"] + out
            <= xp.SMEM_LIMIT - xp.SLACK - p["zero_bytes"])
    assert bool(p["w_res"]) == fits and (p["ring"] == 0) == bool(p["a_res"] and p["w_res"])
    assert p["ring"] == 0 or 2 <= p["ring"] <= xp.MAX_RING
    assert p["zero_bytes"] >= 16 * taps.n * 2
    for steps in (1, 85, 338):
        items = taps.chunks * p["tiles"] * steps
        grid = min(items, 132)
        sizes = [items * (b + 1) // grid - items * b // grid for b in range(grid)]
        assert set(sizes) <= {items // grid, -(-items // grid)}
        for b in range(grid):
            lo, hi = items * b // grid, items * (b + 1) // grid
            assert (hi - 1) // steps - lo // steps + 1 <= -(-sizes[b] // steps) + 1


def test_the_probes_plans():
    """What the plan makes of the probes: A resident everywhere; W
    resident but for the five packed forms whose weights reach 144-192 KB
    a chunk (they stream through the ring); probe 1 in tiles of 64 rows
    of one column, probe 2 of one row of 64 columns."""
    plans = {v.name: xp.plan(v.taps) for _, v in VARIANTS}
    streamed = {name for name, p in plans.items() if not p["w_res"]}
    assert streamed == {"xpack_32to32", "xpack_64to64", "xpk32t32", "xpk32t32s", "xpk64t64"}
    assert all(p["a_res"] for p in plans.values())
    assert all((p["tc"], p["tr"]) == (1, 64) for name, p in plans.items()
               if name in {v.name for v in xp.VARIANTS})
    assert all((p["tc"], p["tr"]) == (64, 1) for name, p in plans.items()
               if name in {v.name for v in xp2.VARIANTS})
    # probe 1's sep taps share their boxes: 96 lanes, two boxes for three taps
    assert plans["sep_32to32"]["boxes"] == 2 and plans["sep_32to32"]["slices"] == 9
    assert not any(xp.plan(xp.streamed(n)[2])["a_res"] for n in xp.WIDTHS)


@pytest.mark.parametrize("variant", list(xpack_parts.VARIANTS))
def test_parts_edit_the_kernel_source(variant):
    """Each copy of ``xpack_parts`` is the kernel's source with its parts'
    texts found as often as the probe expects (``patched`` raises
    otherwise) and edited; the kernel as it is stays unedited."""
    parts = xpack_parts.VARIANTS[variant]
    text = xpack_parts.SOURCE.read_text()
    got = xpack_parts.patched(parts)
    assert (got == text) == (not parts)
    assert len(got.splitlines()) >= len(text.splitlines())
    if "mma" in parts:
        assert "if (false) mma_ss<N>(acc[t]" in got
    if "regs" in parts:
        assert "mma_rs<N>(acc[t], af[kk]" in got and "mma_ss<N>(acc" not in got
    if "regp" in parts:
        # resident forms take the pairs of slices; the ring's keep A by descriptor
        assert "if constexpr (!kRing) {" in got and "issue_rs<N, G>(acc, af[1]" in got
        assert "mma_ss<N>(acc[t], da, db, scale)" in got
    with pytest.raises(RuntimeError, match="expects 1 of"):
        xpack_parts.patched(("store",), text.replace("tma_store_4d(&to,", "store(&to,"))


def test_parts_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xpack_parts.main([])


@pytest.mark.cuda
@pytest.mark.parametrize("case", VARIANTS, ids=_vid)
def test_kernel_matches_plain_at_many_steps(cuda_device, case):
    """133 and 1,000 steps, neither a multiple of the 132 SMs: a block's
    items span one to several (chunk, tile) pairs, a chunk's W is loaded
    again where a block crosses into the next chunk, and the last pass of
    a pair leaves a warpgroup without a step."""
    probe, v = case
    a, w = xp.operands(v, *PROBES[probe].probe_inputs()[v.name], cuda_device)
    for steps in (133, 1000):
        before = xp.LAUNCHES
        y = xp.tap_gemm(a, w, v.taps, steps)
        ref = xp.tap_gemm_plain(a, w, v.taps, steps)
        torch.cuda.synchronize()
        assert xp.LAUNCHES == before + 1
        err, equal, ok = xp.agree(y, ref)
        assert ok, (steps, err, equal)
        del y, ref


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ragged", "streamed"])
@pytest.mark.parametrize("n", xp.WIDTHS)
def test_kernel_off_the_probes_at_many_steps(cuda_device, kind, n):
    """The ragged case (odd lane offsets, part tiles, two chunks) and the
    streamed one (A and W both through the ring) at 1, 133 and 1,000
    steps."""
    a, w, taps = getattr(xp, kind)(n, cuda_device)
    for steps in (1, 133, 1000):
        before = xp.LAUNCHES
        y = xp.tap_gemm(a, w, taps, steps)
        ref = xp.tap_gemm_plain(a, w, taps, steps)
        torch.cuda.synchronize()
        assert xp.LAUNCHES == before + 1
        err, equal, ok = xp.agree(y, ref)
        assert ok, (steps, err, equal)
