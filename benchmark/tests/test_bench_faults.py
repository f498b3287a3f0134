"""A run with the timed path broken underneath comes out not correct, and
so does the control put in the program's place.

Each test drives ``core.run_cell`` on the CPU at a tiny size (the look for
a card is ``run.py``'s and is skipped), with ``patch`` breaking the
program: an answer altered where it is produced; half of the batch left
out, its answers taken from the other half. The control is the plain
reference in the cell's lower precision (``limits/<cell>.json``:
``control``) answering in the program's place. The ``cuda`` cases run the
control at the cell's own size on the card.
"""

import numpy as np
import pytest
import torch

from benchmark import core, weights as weights_io
from benchmark.reference import srcnn as ref

BATCH = ["srcnn955-bf16-frames1080-b8", "vgg7rgb-bf16-frames1080-b8",
         "vgg7rgb-f32-frames1080-b8"]
SERVE = ["srcnn955-f32-serve-photos-x2"]
TINY = {"open_serve": {"sizes": [[14, 18], [16, 20], [18, 22], [20, 26], [22, 30]],
                       "rate_per_s": 25.0, "pool_per_size": 2, "sample_requests": 6,
                       "grace_s": 10},
        "closed_batch": {"h": 30, "w": 44, "batch": 4, "pool_batches": 2}}
# the fp8 control's share of values off by two levels grows with the frame:
# at 30 x 44 a luma frame reads about 0.002, at 96 x 128 0.03-0.04
LARGER = {**TINY, "closed_batch": {"h": 96, "w": 128, "batch": 2, "pool_batches": 1}}
SEED = 2**31 + 101


def _run(name, patch=None, seed=SEED, device="cpu", overrides=TINY, seconds=0.4):
    cell = core.load_cell(name)
    ov = overrides[cell.mix["loop"]] if overrides else None
    return core.run_cell(name, seed, seconds, False, device=device, overrides=ov,
                         patch=patch, log=lambda m: None)


def _altered(out):
    return np.clip(out.astype(np.int16) + 16, 0, 255).astype(np.uint8)


def alter_an_answer(program):
    """Every call's first answer, altered where the API produces it."""
    api = program.api
    batch, image = api.upscale_batch, api.upscale_image

    def upscale_batch(*a, **k):
        out = batch(*a, **k)
        out[0] = _altered(out[0])
        return out

    def upscale_image(*a, **k):
        return _altered(image(*a, **k))

    program.saved = (batch, image)
    api.upscale_batch, api.upscale_image = upscale_batch, upscale_image


def half_the_batch(program):
    """The batch's second half left out: its answers are the first half's."""
    api = program.api
    batch = api.upscale_batch

    def upscale_batch(cfg, params, rgbas, *a, **k):
        half = max(1, rgbas.shape[0] // 2)
        out = batch(cfg, params, np.ascontiguousarray(rgbas[:half]), *a, **k)
        return np.concatenate([out, out])[:rgbas.shape[0]]

    program.saved = (batch, api.upscale_image)
    api.upscale_batch = upscale_batch


def control_in_place(program, name):
    """The reference in the cell's lower precision answers instead."""
    cell = core.load_cell(name)
    w = [(torch.as_tensor(a, device=program.device), torch.as_tensor(b, device=program.device))
         for a, b in weights_io.load(core.ROOT, cell.config)]
    api = program.api

    def one(rgba):
        x = torch.as_tensor(np.ascontiguousarray(rgba), device=program.device)
        return ref.upscale_frame(x, w, cell.config["channels"], cell.config["zero_mean_target"],
                                 control=cell.limits["control"]).cpu().numpy()

    program.saved = (api.upscale_batch, api.upscale_image)
    api.upscale_batch = lambda cfg, params, rgbas, *a, **k: np.stack([one(r) for r in rgbas])
    api.upscale_image = lambda cfg, params, rgba, *a, **k: one(rgba)


@pytest.fixture
def restore_api():
    from cnn_sr_tpu_torch import api

    saved = api.upscale_batch, api.upscale_image
    yield
    api.upscale_batch, api.upscale_image = saved


@pytest.mark.parametrize("name", BATCH + SERVE)
def test_unbroken_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", BATCH + SERVE)
def test_an_altered_answer_is_caught(name, restore_api):
    r = _run(name, patch=alter_an_answer)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", BATCH)
def test_half_the_batch_left_out_is_caught(name, restore_api):
    r = _run(name, patch=half_the_batch)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", BATCH + SERVE)
def test_the_control_is_caught(name, restore_api):
    r = _run(name, patch=lambda p: control_in_place(p, name), overrides=LARGER)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
@pytest.mark.parametrize("name", BATCH + SERVE)
def test_the_control_is_caught_on_the_card_at_the_cells_size(name, seed, cuda_device,
                                                              restore_api):
    r = _run(name, patch=lambda p: control_in_place(p, name), seed=seed, device=cuda_device,
             overrides=None, seconds=1.0)
    assert not r["correct"], r["checks"]
