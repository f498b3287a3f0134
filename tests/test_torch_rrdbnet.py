"""Real-ESRGAN x4plus (basicsr's ``RRDBNet``) on the port's CPU path.

The port's plain schedule (``ops/fused/rrdb.py`` with
``reference.same_layer`` in place of each launch) against the benchmark's
plain reference (``benchmark/reference/rrdbnet.py``, written from basicsr)
at all 23 blocks, with the benchmark's seeded weights
(``benchmark/inits/rrdbnet_basicsr.py``); the API's shapes and paths; the
config; the spans; and that the RGB model's and the flagship's plans and
packings are what they were. The kernels themselves are held on a card by
``tests/test_torch_rrdbnet_card.py``.
"""

import numpy as np
import pytest
import torch

from benchmark import compare, frames
from benchmark.inits import rrdbnet_basicsr
from benchmark.reference import rrdbnet as ref
from cnn_sr_tpu_torch import api
from cnn_sr_tpu_torch.models import RRDBNet
from cnn_sr_tpu_torch.ops.fused import entry, reference, rrdb
from cnn_sr_tpu_torch.utils.config import (ConfigError, ConfigValidationError, RRDBNetConfig,
                                           parse_config, rrdbnet_layers)

X4PLUS = {"arch": "rrdbnet", "channels": 3, "scale": 4, "num_feat": 64, "num_grow_ch": 32,
          "num_block": 23}
SEED = 20261019  # the benchmark configuration's weights_seed


@pytest.fixture(scope="module")
def x4plus():
    """The config, the seeded weights as the port's layer list and as the
    reference's pairs, and two 12x16 frames."""
    cfg = parse_config(dict(X4PLUS))
    arrays = rrdbnet_basicsr.make(cfg.layers(), SEED)
    params = [{"w": torch.from_numpy(w), "b": torch.from_numpy(b)} for w, b in arrays]
    pairs = [(p["w"], p["b"]) for p in params]
    rgbas = frames.make_frames(2, 12, 16, 2**31 + 29, "cpu")
    return cfg, params, pairs, rgbas


@pytest.fixture(scope="module")
def answers(x4plus):
    """The port's f32 and bf16 answers and nets' outputs, the reference's
    and its fp8 control's, for both frames."""
    cfg, params, pairs, rgbas = x4plus
    x = (rgbas[..., :3].to(torch.float32) / 255.0).contiguous()
    out = {"f32": api.upscale_batch(cfg, params, rgbas.numpy(), "f32"),
           "bf16": api.upscale_batch(cfg, params, rgbas.numpy(), "bf16"),
           "net_f32": rrdb.forward(params, x, "f32")}
    with ref.strict_f32():
        out["net_ref"] = ref.net(x.permute(0, 3, 1, 2), pairs).permute(0, 2, 3, 1)
    out["ref"] = [ref.upscale_frame(r, pairs) for r in rgbas]
    out["fp8"] = [ref.upscale_frame(r, pairs, control="fp8") for r in rgbas]
    return out


def test_x4plus_counts():
    cfg = parse_config(dict(X4PLUS))
    assert isinstance(cfg, RRDBNetConfig) and cfg.arch == "rrdbnet"
    assert cfg.num_layers == 351 and cfg.total_padding() == 0
    specs = cfg.layer_specs()
    assert sum(s.weight_size + s.bias_size for s in specs) == 16_697_987
    assert sum(9 * s.n_in * s.n_out for s in specs[:-4]) == 16_572_096  # the trunk, a LR pixel
    assert sum(s.relu for s in specs) == 23 * 3 * 4 + 3  # conv1-4 of each block, up1, up2, hr


def test_f32_path_matches_the_reference_before_rounding(answers):
    torch.testing.assert_close(answers["net_f32"], answers["net_ref"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("s", [0, 1])
def test_f32_answers_match_the_reference(answers, s):
    """Equal to the uint8 level but for values that sit on a rounding edge:
    at most a 1e-3 share, each one level off."""
    got, want = answers["f32"][s], answers["ref"][s].numpy()
    assert got.shape == want.shape == (48, 64, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


# The bf16 stream against the f32 reference: bf16 operands (8 significant
# bits) through 351 convolutions, the residual stream in f32, move an answer
# by a third of a level on average and by at most a few levels (12x16 and
# 48x64 frames on the CPU: mean_abs 0.29-0.32, max_abs 3, share_over_1
# 0.011-0.017); the fp8 control, one step lower, reads mean_abs about 6,
# max_abs about 44 and share_over_1 about 0.6 at 48x64
BF16_TOLERANCE = {"mean_abs": 1.0, "max_abs": 8.0, "share_over_1": 0.1}


def _within(numbers):
    return all(numbers[k] <= v for k, v in BF16_TOLERANCE.items())


@pytest.mark.parametrize("s", [0, 1])
def test_bf16_path_within_its_tolerances(answers, s):
    n = compare.answer_numbers(answers["bf16"][s], answers["ref"][s])
    assert _within(n), n
    assert n["max_abs"] > 0  # the bf16 stream does round


@pytest.mark.parametrize("s", [0, 1])
def test_fp8_control_fails_the_bf16_tolerances(answers, s):
    n = compare.answer_numbers(answers["fp8"][s], answers["ref"][s])
    assert not _within(n), n


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_batch_answers_equal_single_images(x4plus, answers, precision):
    cfg, params, _, rgbas = x4plus
    assert answers[precision].shape == (2, 48, 64, 3)
    for s in range(2):
        one = api.upscale_image(cfg, params, rgbas[s].numpy(), precision=precision)
        assert np.array_equal(one, answers[precision][s])


@pytest.mark.parametrize("case", ["count", "conv_first", "dense", "conv5", "head", "bias"])
def test_wrong_layers_are_refused(x4plus, case):
    _, params, _, _ = x4plus
    bad = [dict(p) for p in params]
    if case == "count":
        bad = bad[:-1]
    elif case == "conv_first":
        bad[0] = {"w": torch.zeros(3, 3, 4, 64), "b": torch.zeros(64)}
    elif case == "dense":
        bad[3] = {"w": torch.zeros(3, 3, 64, 32), "b": torch.zeros(32)}
    elif case == "conv5":
        bad[5] = {"w": torch.zeros(3, 3, 192, 32), "b": torch.zeros(32)}
    elif case == "head":
        bad[-2] = {"w": torch.zeros(1, 1, 64, 64), "b": torch.zeros(64)}
    else:
        bad[-1] = {"w": bad[-1]["w"], "b": torch.zeros(4)}
    with pytest.raises(ValueError):
        RRDBNet(bad)


def test_the_layer_list_is_basicsrs():
    layers = rrdbnet_layers(3, 64, 32, 2)
    assert layers[0] == (3, 3, 64)
    assert layers[1:6] == [(3, 64, 32), (3, 96, 32), (3, 128, 32), (3, 160, 32), (3, 192, 64)]
    assert layers[1:16] == layers[16:31]
    assert layers[-5:] == [(3, 64, 64)] * 4 + [(3, 64, 3)]


@pytest.mark.parametrize("raw, err", [
    ({**X4PLUS, "scale": 2}, ConfigValidationError),
    ({**X4PLUS, "num_feat": 60}, ConfigValidationError),
    ({k: v for k, v in X4PLUS.items() if k != "num_block"}, ConfigError),
    ({**X4PLUS, "arch": "swinir"}, ConfigError),
])
def test_bad_configs_are_refused(raw, err):
    with pytest.raises(err):
        parse_config(raw)


def test_config_takes_no_training_keys():
    cfg = parse_config({**X4PLUS, "num_block": 1})
    assert cfg.num_layers == 21 and not cfg.learning_rates and not cfg.distributions


def test_the_other_paths_refuse_a_same_model(x4plus):
    cfg, params, _, rgbas = x4plus
    with pytest.raises(ValueError, match="VALID"):
        api.upscale_image(cfg, params, rgbas[0].numpy(), bucket=16)
    with pytest.raises(ValueError, match="VALID"):
        api.upscale_image_spatial(cfg, params, rgbas[0].numpy(), 2, devices=["cpu", "cpu"])


@pytest.mark.parametrize("shape, what", [((0, 5, 4), "image"), ((5, 0, 4), "image")])
def test_size_check_of_a_same_model(x4plus, shape, what):
    cfg, params, _, _ = x4plus
    with pytest.raises(ValueError, match="smaller than 1 px"):
        api.upscale_image(cfg, params, np.zeros(shape, np.uint8))


def test_a_one_pixel_image_is_answered():
    cfg = parse_config({**X4PLUS, "num_block": 1, "num_feat": 16, "num_grow_ch": 8})
    rng = np.random.default_rng(2)
    params = [{"w": torch.from_numpy(rng.normal(0, 0.1, (f, f, k, n)).astype(np.float32)),
               "b": torch.zeros(n)} for f, k, n in cfg.layers()]
    out = api.upscale_image(cfg, params, np.full((1, 1, 4), 200, np.uint8))
    assert out.shape == (4, 4, 3) and out.dtype == np.uint8


def test_spans_one_trunk_and_one_head_a_forward():
    cfg = parse_config({**X4PLUS, "num_block": 1, "num_feat": 16, "num_grow_ch": 8})
    rng = np.random.default_rng(3)
    params = [{"w": torch.from_numpy(rng.normal(0, 0.1, (f, f, k, n)).astype(np.float32)),
               "b": torch.zeros(n)} for f, k, n in cfg.layers()]
    rgbas = np.zeros((2, 6, 5, 4), np.uint8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        api.upscale_batch(cfg, params, rgbas, "bf16")
        api.upscale_image(cfg, params, rgbas[0], precision="f32")
    names = [e.name for e in prof.events()]
    for name in ("model.forward", "model.rrdb.trunk", "model.rrdb.head"):
        assert names.count(name) == 2, name


def test_f32_off_the_cpu_names_the_roadmap_entry():
    """Off the CPU an RRDBNet runs in bf16 only: f32 raises before any
    kernel, naming ROADMAP #C4 (tensors without storage stand in for a
    card's here)."""
    cfg = parse_config({**X4PLUS, "num_block": 1})
    params = [{"w": torch.empty((f, f, k, n), device="meta"), "b": torch.empty(n, device="meta")}
              for f, k, n in cfg.layers()]
    x = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(NotImplementedError, match="#C4"):
        rrdb.forward(params, x, "f32")
    with pytest.raises(NotImplementedError, match="no kernel"):
        rrdb.forward(params, x, "bf16")


def test_first_layer_levels_fold():
    """A SAME model's first layer: RGB in 0..1 as its 0..255 levels, exact in
    bf16, with 1/255 folded into w; the default fold stays the int8
    plane's 1/127."""
    x = torch.arange(256, dtype=torch.float32) / 255.0
    q = reference.quantize(x, 255)
    assert torch.equal(q, torch.arange(256, dtype=torch.float32))
    assert torch.equal(q.to(torch.bfloat16).float(), q)
    w = torch.randn(3, 3, 3, 64)
    wp, _ = entry.pack_bf16(w, torch.zeros(64), True, 255)
    assert torch.equal(wp[:, :9, :64], (w / 255.0).to(torch.bfloat16).reshape(3, 9, 64))
    assert torch.equal(entry.pack_bf16(w, torch.zeros(64), True)[0],
                       entry.pack_bf16(w, torch.zeros(64), True, 127)[0])
    b = torch.zeros(64)
    assert entry.packed_bf16(w, b, True, 255) is not entry.packed_bf16(w, b, True, 127)


def test_same_instances_are_x4plus_plans():
    """The wgmma kernels compile a SAME twin only of the instances that
    x4plus's plans launch, each one of the kernel's VALID instances; every
    x4plus layer's plan has one, and an RRDBNet of other widths is refused
    before any launch."""
    same = entry.same_instances()
    assert same == (("first", 64, 1), ("last", 16, 64, 2), ("wgmma", 32, 64, 4),
                    ("wgmma", 64, 64, 2))
    valid = {"first": entry.first_instances(), "wgmma": entry.wgmma_instances(),
             "last": entry.last_instances()}
    assert all(inst[1:] in valid[inst[0]] for inst in same)

    def meta(cfg):
        return [{"w": torch.empty((f, f, k, n), device="meta")} for f, k, n in cfg.layers()]

    plans = rrdb.card_plans(meta(parse_config(dict(X4PLUS))))
    assert len(plans) == 351 and {entry.plan_instance(p) for p in plans} == set(same)
    narrow = parse_config({**X4PLUS, "num_block": 1, "num_feat": 16, "num_grow_ch": 8})
    with pytest.raises(NotImplementedError, match="no SAME kernel instance"):
        rrdb.card_plans(meta(narrow))


@pytest.mark.parametrize("kind, kwargs", [
    ("first", {"lrelu": True}), ("first", {"residuals": "r"}), ("last", {"lrelu": True}),
    ("last", {"out32": "r"})])
def test_same_forward_takes_an_epilogue_only_on_a_middle_plan(kind, kwargs):
    """conv_first and conv_last of a SAME model take no activation, no
    residual and no f32 copy: ``chain.same_forward`` refuses them before
    any launch."""
    from cnn_sr_tpu_torch.ops.fused import chain

    r = torch.zeros((1, 4, 4, 64))
    kwargs = {k: ([(r, 0.2)] if k == "residuals" else r) if v == "r" else v
              for k, v in kwargs.items()}
    if kind == "first":
        plan, src, dst = entry.first_layer_plan(3, 3, 64), torch.zeros((1, 4, 4, 3)), r
    else:
        plan, src, dst = entry.last_layer_plan(3, 64, 3), r, torch.zeros((1, 4, 4, 3))
    w, b = torch.zeros(16, dtype=torch.bfloat16), torch.zeros(16)
    with pytest.raises(ValueError, match="only a middle layer"):
        chain.same_forward(None, src, src.shape[3], w, b, dst, 0, plan,
                           kwargs.pop("lrelu", False), **kwargs)


def test_same_is_the_config_s_one_predicate():
    """``Config.same`` says SAME model for an arch config and VALID stack
    for every SRCNN-style config; the API's three checks read it."""
    import os

    from cnn_sr_tpu_torch.utils.config import read_config

    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
    assert parse_config(dict(X4PLUS)).same
    for name in ("srcnn_9-5-5_pretrained.json", "waifu2x_7layer_rgb_pretrained.json"):
        assert not read_config(os.path.join(configs, name)).same


RGB7 = [(3, 3, 32), (3, 32, 32), (3, 32, 64), (3, 64, 64), (3, 64, 128), (3, 128, 128),
        (3, 128, 3)]
FLAGSHIP = [(9, 1, 64), (5, 64, 32), (5, 32, 1)]


@pytest.mark.parametrize("layers, smem", [
    (RGB7, [142912, 226816, 218624, 218624, 222720, 222720, 185856]),
    (FLAGSHIP, [128320, 230912, 217600]),
])
def test_the_valid_models_plans_are_unchanged(layers, smem):
    got = [entry.bf16_layer_plan(*l, first=i == 0, last=i == len(layers) - 1).smem
           for i, l in enumerate(layers)]
    assert got == smem
    assert entry.route(layers[0][1], layers, 2)[0] == ("fused" if layers is FLAGSHIP else "chain")
    if layers is FLAGSHIP:
        assert entry.fused_wgmma_plan(1, layers).smem == 198360


@pytest.mark.parametrize("same", [False, True])
def test_plain_same_layer_pads_and_rounds(same):
    """``same_layer`` is the zero-padded convolution; its bf16 output is the
    f32 one rounded once."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((1, 5, 6, 8), np.float32)).to(torch.bfloat16).float()
    w = torch.from_numpy(rng.normal(0, 0.2, (3, 3, 8, 8)).astype(np.float32))
    b = torch.zeros(8)
    r = torch.from_numpy(rng.normal(0, 1, (1, 5, 6, 8)).astype(np.float32))
    res = [(r, 0.2)] if same else []
    y, v = reference.same_layer(x, w, b, True, res, precision="bf16")
    y32, _ = reference.same_layer(x, w.to(torch.bfloat16).float(), b, True, res,
                                  precision="f32")
    assert y.shape == (1, 5, 6, 8)
    assert torch.equal(y, reference.round_bf16(v)) and torch.equal(v, y32)
