"""The two forms of a configuration's weights: a checkpoint and a seeded
init, each pinned by its digest, and a cell that runs on seeded weights,
held to limits of its own."""

import dataclasses
import json
import sys
import types

import numpy as np
import pytest

from benchmark import core, weights as weights_io
from benchmark.inits import kaiming_normal
from benchmark.tests.test_bench_faults import LARGER, TINY, control_in_place, restore_api  # noqa: F401

FLAGSHIP = "srcnn955-bf16-frames1080-b8"
SEED = 2**31 + 77


def x4plus_layers():
    """Real-ESRGAN x4plus (RRDBNet: num_feat 64, num_grow_ch 32, num_block
    23) as (f, k, n) convs: conv_first, 23 RRDBs of three dense blocks of
    five convs, conv_body, two upsampling convs, conv_hr, conv_last."""
    dense = [(3, 64 + 32 * i, 32) for i in range(4)] + [(3, 192, 64)]
    return [(3, 3, 64)] + dense * 3 * 23 + [(3, 64, 64)] * 4 + [(3, 64, 3)]


def seeded(cfg, seed=SEED, **init_args):
    """``cfg`` with its checkpoint replaced by ``kaiming_normal`` weights."""
    out = {k: v for k, v in cfg.items() if k not in ("weights", "weights_sha256")}
    out.update(init="kaiming_normal", weights_seed=seed)
    if init_args:
        out["init_args"] = init_args
    made = kaiming_normal.make([tuple(x) for x in cfg["layers"]], seed, **init_args)
    out["weights_sha256"] = weights_io.digest(made)
    return out


def test_seeded_weights_are_the_same_every_time():
    cfg = seeded(core.load_cell(FLAGSHIP).config)
    a, b = weights_io.load(core.ROOT, cfg), weights_io.load(core.ROOT, cfg)
    assert [w.shape for w, _ in a] == [(9, 9, 1, 64), (5, 5, 64, 32), (5, 5, 32, 1)]
    for (wa, ba), (wb, bb) in zip(a, b):
        assert wa.dtype == np.float32 and np.array_equal(wa, wb) and np.array_equal(ba, bb)
    other = weights_io.load(core.ROOT, seeded(cfg, seed=SEED + 1))
    assert not np.array_equal(a[0][0], other[0][0])


@pytest.mark.parametrize("form", ["checkpoint", "seeded"])
def test_a_changed_digest_is_refused(form):
    cfg = core.load_cell(FLAGSHIP).config
    cfg = {**(seeded(cfg) if form == "seeded" else cfg), "weights_sha256": "0" * 64}
    with pytest.raises(weights_io.WeightsError, match="SHA-256"):
        weights_io.load(core.ROOT, cfg)


@pytest.mark.parametrize("wrong", ["w", "b", "layers"])
def test_wrong_shapes_are_refused(monkeypatch, wrong):
    def make(layers, seed):
        out = kaiming_normal.make(layers, seed)
        if wrong == "w":
            out[1] = (out[1][0][:, :, :, :-1], out[1][1])
        elif wrong == "b":
            out[1] = (out[1][0], out[1][1][:-1])
        else:
            out = out[:-1]
        return out

    monkeypatch.setitem(sys.modules, "benchmark.inits._wrong", types.SimpleNamespace(make=make))
    cfg = {**seeded(core.load_cell(FLAGSHIP).config), "init": "_wrong"}
    cfg["weights_sha256"] = weights_io.digest(make([tuple(x) for x in cfg["layers"]], SEED))
    with pytest.raises(weights_io.WeightsError, match="layer"):
        weights_io.load(core.ROOT, cfg)


@pytest.mark.parametrize("keys", [("weights", "init"), ()])
def test_exactly_one_of_weights_and_init(keys):
    cfg = seeded(core.load_cell(FLAGSHIP).config)
    cfg = {k: v for k, v in cfg.items() if k != "init"}
    for k in keys:
        cfg[k] = core.load_cell(FLAGSHIP).config["weights"] if k == "weights" else "kaiming_normal"
    with pytest.raises(weights_io.WeightsError, match="exactly one"):
        weights_io.load(core.ROOT, cfg)


def test_kaiming_normal_at_x4plus_shapes():
    layers = x4plus_layers()
    assert len(layers) == 351
    made = kaiming_normal.make(layers, SEED, scale=0.1)
    assert sum(w.size + b.size for w, b in made) == 16_697_987
    assert all(w.shape == (f, f, k, n) and w.dtype == np.float32 and not b.any()
               for (f, k, n), (w, b) in zip(layers, made))
    # the widest layer: std 0.1 x sqrt(2) / sqrt(9 x 192), within 1% (110,592 draws)
    w = made[5][0]
    assert w.std() == pytest.approx(0.1 * np.sqrt(2) / np.sqrt(9 * 192), rel=0.01)
    per_layer = kaiming_normal.make(layers[:2], SEED, scale=[1.0, 0.5])
    assert per_layer[1][0].std() == pytest.approx(0.5 * np.sqrt(2 / (9 * 64)), rel=0.05)


# A seeded configuration sets its own limits: the flagship's were set on the
# trained checkpoint and do not carry over. Readings of the flagship's layers
# on kaiming_normal at scale 0.5 (NVIDIA H100, 1080p batches of 8, seeds 31,
# 2**31 + 32, 33): the program's share_over_1 0 on every seed, the fp8
# control's 1.308e-3 to 1.334e-3; on the CPU at 96 x 128, 0 against
# 4.3e-4 to 5.4e-4. max_abs (1 against 2 or 3) separates them by less than
# three times and is not compared.
SEEDED_SCALE = 0.5
SEEDED_LIMITS = {"control": "fp8",
                 "numbers": {"share_over_1": {"limit": 2e-4, "lower": 0.0, "upper": 1.308e-3}}}


@pytest.fixture
def seeded_flagship(monkeypatch, tmp_path):
    """The flagship cell with its configuration's checkpoint replaced by
    ``kaiming_normal`` weights at ``SEEDED_SCALE``, held to
    ``SEEDED_LIMITS``."""
    man = core.manifest()
    conf = next(c for c in man["configs"] if c["name"] == "srcnn-9-5-5")
    path = tmp_path / "srcnn-9-5-5.json"
    cfg = seeded(json.loads((core.ROOT / conf["file"]).read_text()), scale=SEEDED_SCALE)
    path.write_text(json.dumps(cfg))
    conf["file"] = str(path)  # absolute, so ROOT / file is the copy
    monkeypatch.setattr(core, "manifest", lambda: man)
    load_cell = core.load_cell
    monkeypatch.setattr(core, "load_cell", lambda *a, **k: dataclasses.replace(
        load_cell(*a, **k), limits=SEEDED_LIMITS))
    cell = core.load_cell(FLAGSHIP)
    assert cell.config["init"] == "kaiming_normal" and "weights" not in cell.config
    return FLAGSHIP


def test_a_cell_on_seeded_weights_is_correct(seeded_flagship):
    """Through the whole run on the CPU at a tiny size."""
    r = core.run_cell(seeded_flagship, SEED, 0.4, False, device="cpu",
                      overrides=TINY["closed_batch"], log=lambda m: None)
    assert r["correct"], r["checks"]


def test_the_control_on_seeded_weights_is_caught(seeded_flagship, restore_api):
    """The fp8 control in the program's place, on the seeded weights,
    fails the seeded configuration's own limits (``compare.judge``)."""
    r = core.run_cell(seeded_flagship, SEED, 0.4, False, device="cpu",
                      overrides=LARGER["closed_batch"],
                      patch=lambda p: control_in_place(p, seeded_flagship), log=lambda m: None)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 2**31 + 22, 23])
@pytest.mark.parametrize("side", ["program", "control"])
def test_seeded_weights_at_the_cells_size_on_the_card(seeded_flagship, side, seed,
                                                      cuda_device, restore_api):
    """At 1080p batches of 8 the program on seeded weights is correct and
    the fp8 control in its place is not."""
    patch = (lambda p: control_in_place(p, seeded_flagship)) if side == "control" else None
    r = core.run_cell(seeded_flagship, seed, 1.0, False, device=cuda_device, patch=patch,
                      log=lambda m: None)
    assert r["correct"] == (side == "program"), r["checks"]
