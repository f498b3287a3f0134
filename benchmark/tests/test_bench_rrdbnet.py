"""The Real-ESRGAN x4plus configuration's pieces: its seeded init, its
reference's counts, the two readers of the trunk's and the head's roofline
shares on a hand-made trace, and a CPU rehearsal of its cell."""

import numpy as np
import pytest

from benchmark import core, generators, span_roofline, trace, weights as weights_io
from benchmark.inits import rrdbnet_basicsr
from benchmark.reference import rrdbnet as ref

CELL = "realesrgan-x4-bf16-frames540-b8"
CONFIG = core.load_cell(CELL).config
LAYERS = [tuple(x) for x in CONFIG["layers"]]


def test_the_configuration_is_x4plus_uncut():
    assert len(LAYERS) == 351 and LAYERS[0] == (3, 3, 64) and LAYERS[-1] == (3, 64, 3)
    assert sum(9 * k * n + n for _, k, n in LAYERS) == 16_697_987
    assert CONFIG["program_config"] == {"arch": "rrdbnet", "channels": 3, "scale": 4,
                                        "num_feat": 64, "num_grow_ch": 32, "num_block": 23}
    assert not CONFIG["zero_mean_target"]


def test_init_shapes_digest_and_seed():
    made = weights_io.load(core.ROOT, CONFIG)  # checks the shapes and the digest
    assert [w.shape for w, _ in made] == [(f, f, k, n) for f, k, n in LAYERS]
    again = rrdbnet_basicsr.make(LAYERS, CONFIG["weights_seed"])
    assert all(np.array_equal(a, c) and np.array_equal(b, d)
               for (a, b), (c, d) in zip(made, again))
    other = rrdbnet_basicsr.make(LAYERS, CONFIG["weights_seed"] + 1)
    assert not np.array_equal(made[0][0], other[0][0])


def test_init_follows_basicsr():
    """Dense-block convs: kaiming_normal x 0.1 (std 0.1·sqrt(2 / fan_in)),
    biases 0; the others PyTorch's Conv2d default, within ±1/sqrt(fan_in)."""
    made = rrdbnet_basicsr.make(LAYERS, CONFIG["weights_seed"])
    for i in (1, 5, 345):  # conv1 and conv5 of the first block, conv5 of the last
        w, b = made[i]
        fan_in = 9 * w.shape[2]
        assert w.std() == pytest.approx(0.1 * np.sqrt(2.0 / fan_in), rel=0.05)
        assert not b.any()
    for i in (0, 346, 347, 348, 349, 350):
        w, b = made[i]
        bound = 1.0 / np.sqrt(9 * w.shape[2])
        assert np.abs(w).max() <= bound and np.abs(b).max() <= bound
        assert w.std() == pytest.approx(bound / np.sqrt(3.0), rel=0.2)
    with pytest.raises(ValueError):
        rrdbnet_basicsr.make(LAYERS[:-1], 1)


def test_flops_a_low_resolution_pixel():
    assert ref.flops(CONFIG, (1, 1, 1, 3)) == 2 * 17_926_848
    assert ref._macs(LAYERS, (1, 1, 1, 3), "trunk") == 16_572_096
    assert ref._macs(LAYERS, (1, 1, 1, 3), "head") == 1_354_752
    assert ref.flops(CONFIG, (8, 540, 960, 3)) == 2 * 17_926_848 * 8 * 540 * 960


@pytest.mark.parametrize("fn, flops", [
    (ref.bound_ms, 2 * 17_926_848), (ref.trunk_bound_ms, 2 * 16_572_096),
    (ref.head_bound_ms, 2 * 1_354_752)])
def test_bounds_are_operations_at_540p(fn, flops):
    ms, by = fn(CONFIG, (8, 540, 960, 3), "bf16")
    assert by == "operations"
    assert ms == pytest.approx(flops * 8 * 540 * 960 / 989e12 * 1e3)


def _x(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _call(t0, shape, corr0):
    """One API call at t0: a trunk span with two launches, a head span with
    one, and a launch in api.pixels outside both; device times 100 + 50,
    30 and 7 µs."""
    s, h, w = shape
    return [
        _x("user_annotation", f"bench.api:{s}x{h}x{w}", t0, 1000),
        _x("user_annotation", "model.forward", t0 + 100, 800),
        _x("user_annotation", "model.rrdb.trunk", t0 + 110, 500),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 120, 2, corr=corr0),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 130, 2, corr=corr0 + 1),
        _x("user_annotation", "model.rrdb.head", t0 + 620, 200),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 630, 2, corr=corr0 + 2),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 950, 2, corr=corr0 + 3),
        _x("kernel", "conv_layer_wgmma_kernel", t0 + 200, 100, tid=7, pid=0, corr=corr0),
        _x("kernel", "conv_layer_wgmma_kernel", t0 + 300, 50, tid=7, pid=0, corr=corr0 + 1),
        _x("kernel", "conv_last_wgmma_kernel", t0 + 700, 30, tid=7, pid=0, corr=corr0 + 2),
        _x("kernel", "elementwise", t0 + 960, 7, tid=7, pid=0, corr=corr0 + 3),
    ]


EVENTS = [_x("Trace", "PyTorch Profiler (0)", 0, 5000, tid=0)] + _call(0, (8, 540, 960), 1) + \
    _call(2000, (2, 30, 40), 11)


def _ctx(events, card=True):
    cell = core.load_cell(CELL)
    win = generators.Window(t0=0.0, t_end=1.0, out_pixels=1)
    return core.Context(cell, win, events, trace.attribute(events) if card else None,
                        trace.busy(events) if card else None)


def test_device_time_joins_each_span():
    got = sorted(us for _, us in span_roofline.per_span_us(EVENTS, "model.rrdb.trunk"))
    assert got == [150.0, 150.0]
    assert sorted(us for _, us in span_roofline.per_span_us(EVENTS, "model.rrdb.head")) == [30, 30]


@pytest.mark.parametrize("name, part, us", [("rrdb_trunk_roofline", "trunk", 300.0),
                                            ("rrdb_head_roofline", "head", 60.0)])
def test_readers_on_a_hand_made_trace(name, part, us):
    bound = getattr(ref, f"{part}_bound_ms")
    want = sum(bound(CONFIG, (s, h, w, 3), "bf16")[0] for s, h, w in ((8, 540, 960), (2, 30, 40)))
    assert core.read_metric(name, _ctx(EVENTS)) == pytest.approx(100.0 * want * 1e3 / us)


@pytest.mark.parametrize("name", ["rrdb_trunk_roofline", "rrdb_head_roofline"])
def test_readers_give_none_without_spans_or_a_card(name):
    bare = [e for e in EVENTS if not e["name"].startswith("model.rrdb")]
    assert core.read_metric(name, _ctx(bare)) is None
    assert core.read_metric(name, _ctx(EVENTS, card=False)) is None


TINY = {"h": 12, "w": 16, "batch": 2, "pool_batches": 2}


def test_the_cell_rehearses_on_the_cpu():
    r = core.run_cell(CELL, 2**31 + 5, 0.3, False, device="cpu", overrides=TINY,
                      log=lambda m: None)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert set(r["checks"]) == set(core.load_cell(CELL).limits["numbers"]) | {"failed"}


def test_the_control_in_the_programs_place_is_caught():
    import torch

    cell = core.load_cell(CELL)
    w = [(torch.as_tensor(a), torch.as_tensor(b)) for a, b in weights_io.load(core.ROOT,
                                                                               cell.config)]

    def patch(program):
        def one(rgba):
            return ref.upscale_frame(torch.as_tensor(np.ascontiguousarray(rgba)), w,
                                     control="fp8").numpy()
        program.api = type("Api", (), {
            "upscale_batch": staticmethod(lambda cfg, p, rgbas, *a: np.stack([one(r)
                                                                              for r in rgbas]))})

    r = core.run_cell(CELL, 2**31 + 6, 0.3, False, device="cpu",
                      overrides={**TINY, "h": 24, "w": 32}, patch=patch, log=lambda m: None)
    assert not r["correct"], r["checks"]
