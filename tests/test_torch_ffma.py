"""The f32 fused kernel's host side (``cnn_sr_tpu_torch.ops.fused.entry``):
its weight packing (``pack_f32``, ``packed_f32``), its shared-memory plan
(``smem_plan``, ``weight_stages``) and its route. The kernel itself
(``csrc/fused_srcnn.cu`` on ``csrc/ffma_stage.cuh``) runs only on a card:
``test_torch_fused.py`` holds it against its plain version there.
"""

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch.ops.fused import build, entry, fused_forward, tune
from cnn_sr_tpu_torch.utils.params_io import params_to_torch

FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]
C915 = [(9, 1, 64), (1, 64, 32), (5, 32, 1)]
# the stacks the f32 fused route takes: the shipped luma models and the
# card tests' stacks (tests/test_torch_fused.py)
FUSED = {
    "flagship": (1, FLAGSHIP),
    "9-1-5": (1, C915),
    "narrow_9-5-5": (1, [(9, 1, 8), (5, 8, 8), (5, 8, 1)]),
    "rgb_3layer": (3, [(3, 3, 16), (3, 16, 8), (3, 8, 3)]),
    "odd_widths": (1, [(9, 1, 12), (1, 12, 4), (5, 4, 1)]),
    "flagship_depth_odd_widths": (1, [(9, 1, 60), (5, 60, 28), (5, 28, 1)]),
    "one_stage_conv2": (1, [(9, 1, 40), (9, 40, 56), (3, 56, 1)]),
}
# stacks it refuses, with the kind they take instead
REFUSED = {
    "wide_9-5-5": (1, [(9, 1, 128), (5, 128, 64), (5, 64, 1)], "chain"),
    "2-layer": (1, [(9, 1, 8), (5, 8, 1)], "chain"),
    "4-layer": (1, [(9, 1, 8), (5, 8, 8), (1, 8, 8), (5, 8, 1)], "chain"),
    "n_out": (3, [(3, 3, 8), (3, 8, 8), (3, 8, 5)], "chain"),
    "c_in": (5, [(3, 5, 8), (3, 8, 8), (3, 8, 1)], "chain"),
    "rgb_7layer": (3, [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128),
                       (3, 128, 128), (3, 128, 3)], "chain"),
}


def _layer(f, k, n, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((f, f, k, n)) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32))
    return w, b


@pytest.mark.parametrize("f,k,n,nb", [
    (9, 1, 64, 8), (5, 64, 32, 8), (5, 32, 1, 4), (1, 64, 32, 8), (9, 1, 12, 8),
    (1, 12, 4, 8), (5, 60, 28, 8), (3, 3, 16, 8), (3, 8, 3, 4),
])
def test_pack_f32_unpacks_bit_for_bit_with_zero_padding(f, k, n, nb):
    w, b = _layer(f, k, n, f * 100 + k + n)
    wp, bp = entry.pack_f32(w, b, nb)
    npad = entry.n_pad_f32(n, nb)
    assert npad % nb == 0 and npad - nb < n <= npad
    assert tuple(wp.shape) == (k, f * f, npad) and tuple(bp.shape) == (npad,)
    assert wp.dtype == bp.dtype == torch.float32 and wp.is_contiguous()
    # row dy·f + dx of channel ci holds w[dy, dx, ci]
    back = wp[:, :, :n].reshape(k, f, f, n).permute(1, 2, 0, 3)
    assert torch.equal(back, w) and torch.equal(bp[:n], b)
    assert not wp[:, :, n:].any() and not bp[n:].any()
    # a chunk of input channels is one contiguous run of 16-byte units
    assert (f * f * npad) % 4 == 0


def test_packed_f32_made_once_and_again_after_an_edit():
    w, b = _layer(5, 8, 6, 1)
    first = entry.packed_f32(w, b, 8)
    assert entry.packed_f32(w, b, 8) is first
    params = [{"w": w, "b": b}]
    assert entry.f32_weights(params)[0] is first
    with torch.no_grad():
        w[0, 0, 0, 0] += 1.0
    second = entry.packed_f32(w, b, 8)
    assert second is not first and second[0][0, 0, 0] == w[0, 0, 0, 0]
    assert entry.packed_f32(w, b, 8) is second
    with torch.no_grad():
        b[5] = 7.0
    third = entry.packed_f32(w, b, 8)
    assert third is not second and third[1][5] == 7.0
    # the bf16 packing is cached beside it, not over it
    entry.packed_bf16(w, b, False)
    assert entry.packed_f32(w, b, 8) is third


@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_plan_fits_and_streams_every_layer(name):
    c, specs = FUSED[name]
    wbuf, smem = entry.smem_plan(c, specs)
    tiles = entry.tile_bytes(c, [(f, n) for f, _, n in specs])
    assert smem == tiles + 4 * wbuf <= entry.SMEM_LIMIT and wbuf % 4 == 0
    for (f, k, n), nb in zip(specs, entry.FUSED_NB):
        npad = entry.n_pad_f32(n, nb)
        ck, stages = entry.weight_stages(f, k, npad, wbuf)
        assert 1 <= ck <= k and stages in (1, 2)
        assert stages * ck * f * f * npad <= wbuf
        if stages == 2:  # the second stage starts 16-byte aligned
            assert (ck * f * f * npad) % 4 == 0


def test_weight_stages_cover_each_way_through_the_buffer():
    """The card tests' stacks take each of the three ways: whole layers,
    two cp.async stages (the flagship's conv2) and one stage of a chunk at
    a time (one_stage_conv2's conv2, 4,536 floats a channel in 7,540)."""
    ways = set()
    for c, specs in FUSED.values():
        wbuf, _ = entry.smem_plan(c, specs)
        for (f, k, n), nb in zip(specs, entry.FUSED_NB):
            ck, stages = entry.weight_stages(f, k, entry.n_pad_f32(n, nb), wbuf)
            ways.add("whole" if ck == k else f"{stages} stages")
    assert ways == {"whole", "2 stages", "1 stages"}
    assert entry.weight_stages(9, 40, 56, 7540) == (1, 1)


@pytest.mark.parametrize("name", sorted(FUSED) + sorted(REFUSED))
def test_route_keeps_the_f32_kinds(name):
    if name in FUSED:
        c, specs = FUSED[name]
        kind, plan = entry.route(c, specs, 4)
        assert kind == "fused" and plan == entry.smem_plan(c, specs)
    else:
        c, specs, want = REFUSED[name]
        kind, plans = entry.route(c, specs, 4)
        assert kind == want and len(plans) == len(specs)


@pytest.mark.parametrize("name", ["flagship_depth_odd_widths", "odd_widths"])
def test_cpu_path_matches_jax_forward_at_padded_widths(name):
    """The stacks whose widths the kernel pads: on the CPU the port's plain
    version, held against the JAX package's f32 forward."""
    from cnn_sr_tpu.models import forward as jforward

    c, specs = FUSED[name]
    rng = np.random.default_rng(11)
    params = [{"w": (rng.standard_normal((f, f, k, n)) * 0.1).astype(np.float32),
               "b": (rng.standard_normal(n) * 0.05).astype(np.float32)} for f, k, n in specs]
    x = rng.uniform(-0.5, 0.5, (2, 33, 40, c)).astype(np.float32)
    got = fused_forward(params_to_torch(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jforward(params, x)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(tune.VARIANTS))
def test_tune_variants_rewrite_the_block_shape(name):
    """``ops/fused/tune.py`` builds each block shape from the shipped source
    with only its constants replaced; "shipped" is the source as it is."""
    src = (build.CSRC / "fused_srcnn.cu").read_text()
    threads, shape = tune.VARIANTS[name]
    got = tune.variant_source(src, threads, shape)
    assert f"constexpr int kThreads = {threads};" in got
    for i, (nb, px) in enumerate(shape, 1):
        assert f"constexpr int kNB{i} = {nb}, kPX{i} = {px};" in got
    assert len(got.splitlines()) == len(src.splitlines())
    if name == "shipped":
        assert got == src
        assert shape == entry.FUSED_SHAPE
    with pytest.raises(ValueError):
        tune.variant_source("// no shape here\n", threads, shape)


@pytest.mark.parametrize("name", ["shipped"] + sorted(tune.CHAIN_VARIANTS))
def test_tune_chain_variants_rewrite_the_classes(name):
    """``ops/fused/tune.py`` builds each chain variant from the shipped
    ``ffma_plan.cuh`` with only its width classes replaced ("shipped": the
    header as it is, whose classes are ``entry.CHAIN_SHAPE``), and each
    plans every checked layer within a block's shared memory, one item a
    thread."""
    src = (build.CSRC / "ffma_plan.cuh").read_text()
    shapes = tune.chain_shapes(name)
    got = tune.chain_variant_source(src, shapes)
    for cls, vals in shapes.items():
        decl = f"constexpr int kChain{cls.capitalize()}[5] = {{{', '.join(map(str, vals))}}};"
        assert decl in got
    assert len(got.splitlines()) == len(src.splitlines())
    if name == "shipped":
        assert got == src
    for specs in [tune.RGB7] + tune.CHAIN_CHECKED:
        for f, k, n in specs:
            plan = tune.chain_plan(shapes, f, k, n)
            assert plan.smem <= entry.SMEM_LIMIT
            assert plan.items <= shapes[entry.chain_class(n)][2]
    with pytest.raises(ValueError):
        tune.chain_variant_source("// no classes here\n", shapes)


def test_ptxas_entry_reads_one_kernels_report():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN2_118fused_srcnn_tc_kernelEv' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN2_118fused_srcnn_kernelEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN2_118fused_srcnn_kernelEv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
    ])
    regs, spill = build.ptxas_entry(log, "fused_srcnn_kernel")
    assert regs == 255 and spill.startswith("8 bytes stack frame, 4 bytes spill stores")
    assert build.ptxas_entry(log, "fused_srcnn_tc_kernel")[0] == 128
    assert build.ptxas_entry(log, "conv_layer_kernel") is None
    # every instance, in the report's order
    assert [e[1] for e in build.ptxas_entries(log, "fused_srcnn")] == [128, 255]
    assert build.ptxas_entries(log, "fused_srcnn_kernel")[0][0] == "_ZN2_118fused_srcnn_kernelEv"
