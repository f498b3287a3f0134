"""Each traffic mix is deterministic in --seed, and every seed gets the
same work in another order."""

import numpy as np
import pytest
import torch

from benchmark import core, frames, generators
from benchmark.loops import closed_batch, open_serve

BIG = 2**31 + 977


def test_frames_are_deterministic_in_the_seed():
    a = frames.make_frames(2, 24, 40, BIG, "cpu")
    b = frames.make_frames(2, 24, 40, BIG, "cpu")
    c = frames.make_frames(2, 24, 40, BIG + 1, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2, 24, 40, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((a[..., 3] == 255).all())
    assert float(a[..., :3].float().std()) > 20  # structure, not a flat frame


def test_frozen_make_image():
    a = frames.make_image(20, 30, 5)
    assert a.shape == (20, 30, 4) and np.array_equal(a, frames.make_image(20, 30, 5))


@pytest.mark.parametrize("seed", [0, BIG, -7])
def test_seed_any_whole_number(seed):
    assert 0 <= frames.seed64(seed) < 2**63


def _serve(seconds=10.0):
    cell = core.load_cell("srcnn955-f32-serve-photos-x2")
    return open_serve.Loop(cell.mix, program=None), cell.mix


def test_schedule_same_work_for_every_seed():
    loop, mix = _serve()
    d1, s1, p1 = loop.schedule(BIG, 10.0)
    d2, s2, p2 = loop.schedule(BIG, 10.0)
    d3, s3, _ = loop.schedule(BIG + 1, 10.0)
    assert np.array_equal(d1, d2) and np.array_equal(s1, s2) and np.array_equal(p1, p2)
    assert not np.array_equal(d1, d3)
    n = int(round(mix["rate_per_s"] * 10))
    assert len(d1) == len(d3) == n
    assert d1[0] == 0 and d1[-1] < 10.0 and np.all(np.diff(d1) > 0)
    assert sorted(np.bincount(s1)) == sorted(np.bincount(s3))
    assert np.bincount(s1).max() - np.bincount(s1).min() <= 1


def test_batch_pool_is_deterministic_in_the_seed():
    class Fake:
        device = "cpu"

        def batch(self, b):
            return b[..., :3].copy()

        def sync(self):
            pass

    mix = {**core.load_cell("srcnn955-bf16-frames1080-b8").mix,
           "h": 12, "w": 16, "batch": 2, "pool_batches": 2}
    a, b = closed_batch.Loop(mix, Fake()), closed_batch.Loop(mix, Fake())
    a.setup(BIG)
    b.setup(BIG)
    assert all(np.array_equal(x, y) for x, y in zip(a.batches, b.batches))
    assert not np.array_equal(a.batches[0], a.batches[1])


def test_a_mix_finds_its_loop_by_name():
    for w in core.manifest()["workloads"]:
        mix = core.load_cell(w["name"]).mix
        loop = generators.loop_for(mix, program=None)
        assert type(loop).__module__ == f"benchmark.loops.{mix['loop']}"

