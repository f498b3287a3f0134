"""Port parity end to end: ``cnn_sr_tpu_torch.api.upscale_image`` and the
``cnn_torch`` CLI against the JAX package, on the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from cnn_sr_tpu import api as japi
from cnn_sr_tpu.utils.config import parse_config as jparse_config
from cnn_sr_tpu.utils.config import read_config as jread_config
from cnn_sr_tpu.utils.metrics import psnr, psnr_y
from cnn_sr_tpu_torch import api
from cnn_sr_tpu_torch import cli
from cnn_sr_tpu_torch.utils.config import parse_config, read_config
from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch, random_parameters

from test_determinism_and_golden import CFG as GOLDEN_CFG
from test_determinism_and_golden import GOLDEN_DIR, _fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = {
    **GOLDEN_CFG, "n1": 8, "n2": 8, "f1": 9, "f2": 5, "f3": 5,
}


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_upscale_matches_jax_pallas_f32():
    cfg_raw = {**NARROW, "zero_mean_target": True}
    jcfg = jparse_config(cfg_raw)
    params = random_parameters(jcfg.layer_specs(), jcfg.distributions, seed=2)
    rgba = np.random.default_rng(3).integers(0, 256, (40, 140, 4), dtype=np.uint8)
    want = japi.upscale_image(jcfg, params, rgba, use_pallas=True, pallas_precision="f32")
    got = api.upscale_image(parse_config(cfg_raw), params_to_torch(params, "cpu"), rgba)
    assert got.shape == want.shape == (40, 140, 3) and got.dtype == np.uint8
    assert _max_diff(got, want) <= 1


@pytest.mark.parametrize("squared", [False, True])
def test_upscale_subtract_squared_mean(squared):
    raw = {**NARROW, "subtract_squared_mean": squared}
    jcfg = jparse_config(raw)
    params = random_parameters(jcfg.layer_specs(), jcfg.distributions, seed=4)
    rgba = np.random.default_rng(5).integers(0, 256, (36, 44, 4), dtype=np.uint8)
    want = japi.upscale_image(jcfg, params, rgba)
    got = api.upscale_image(parse_config(raw), params_to_torch(params, "cpu"), rgba)
    assert _max_diff(got, want) <= 1


def test_flagship_pretrained_on_demo_crop():
    path = os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json")
    cfg, jcfg = read_config(path), jread_config(path)
    params, _ = init_params(cfg)
    with Image.open(os.path.join(ROOT, "docs", "demo", "demo_photo_small.png")) as im:
        rgba = np.asarray(im.convert("RGBA"))[100:164, 90:170].copy()
    want = japi.upscale_image(jcfg, params, rgba)  # XLA f32 HIGHEST
    got = api.upscale_image(cfg, params_to_torch(params, "cpu"), rgba)
    assert _max_diff(got, want) <= 1
    assert (got != rgba[..., :3]).any()


def test_golden_upscale():
    """The JAX package's golden image, with its PSNR contract
    (test_determinism_and_golden.py)."""
    _, params, rgba = _fixture()
    out = api.upscale_image(parse_config(GOLDEN_CFG), params_to_torch(params, "cpu"), rgba)
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, "upscale_9-1-5_seed1234.png"))
                        .convert("RGB"))
    assert out.shape == golden.shape
    assert psnr_y(out, golden) > 55.0, f"PSNR(Y) {psnr_y(out, golden):.2f} dB"
    assert psnr(out, golden, peak=255.0) > 50.0


def test_upscale_rejects_what_is_not_ported():
    cfg = parse_config(NARROW)
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 0), "cpu")
    with pytest.raises(ValueError, match="receptive field"):
        api.upscale_image(cfg, params, np.zeros((16, 64, 4), np.uint8))


RGB_PRETRAINED = os.path.join(ROOT, "configs", "waifu2x_7layer_rgb_pretrained.json")
# a narrow 7-layer RGB model, f=3 throughout like configs/waifu2x_7layer_rgb.json;
# He-scaled random weights keep the activations O(1) through the stack
NARROW_RGB = {
    "channels": 3,
    "layers": [{"n": n, "f": 3} for n in (8, 8, 16, 16, 16, 16, 3)],
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [1e-4] * 7,
    "parameters_distribution": {"mean_w": 0.0, "mean_b": 0.0,
                                "std_deviation_w": 0.15, "std_deviation_b": 0.02},
}


@pytest.mark.parametrize("zero_mean_target", [True, False])
def test_rgb_upscale_matches_jax_pallas_f32(zero_mean_target):
    raw = {**NARROW_RGB, "zero_mean_target": zero_mean_target}
    jcfg = jparse_config(raw)
    params = random_parameters(jcfg.layer_specs(), jcfg.distributions, seed=7)
    rgba = np.random.default_rng(8).integers(0, 256, (40, 140, 4), dtype=np.uint8)
    want = japi.upscale_image(jcfg, params, rgba, use_pallas=True, pallas_precision="f32")
    got = api.upscale_image(parse_config(raw), params_to_torch(params, "cpu"), rgba)
    assert got.shape == want.shape == (40, 140, 3) and got.dtype == np.uint8
    assert _max_diff(got, want) <= 1
    assert (got != rgba[..., :3]).any()


def test_rgb_pretrained_on_demo_crop():
    """The in-repo 7-layer RGB checkpoint at its full widths against the
    JAX package's XLA f32 path (``use_pallas=False``)."""
    cfg, jcfg = read_config(RGB_PRETRAINED), jread_config(RGB_PRETRAINED)
    assert cfg.channels == 3 and cfg.zero_mean_target
    params, _ = init_params(cfg)
    with Image.open(os.path.join(ROOT, "docs", "demo", "rgb_demo_small.png")) as im:
        rgba = np.asarray(im.convert("RGBA"))[150:214, 120:200].copy()
    want = japi.upscale_image(jcfg, params, rgba)  # XLA f32 HIGHEST
    got = api.upscale_image(cfg, params_to_torch(params, "cpu"), rgba)
    assert got.shape == want.shape == (64, 80, 3)
    assert _max_diff(got, want) <= 1
    assert (got != rgba[..., :3]).any()
    # the border (7 px, the stack's half shrink) passes through
    np.testing.assert_array_equal(got[:7], rgba[:7, :, :3])
    np.testing.assert_array_equal(got[:, -7:], rgba[:, -7:, :3])


def _write_config(tmp_path, raw, name="cfg.json"):
    import json

    path = tmp_path / name
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_cpu_writes_what_the_api_returns(tmp_path):
    cfg_path = _write_config(tmp_path, NARROW)
    rgba = np.random.default_rng(6).integers(0, 256, (30, 41, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "in.png")
    out = tmp_path / "out.png"
    rc = cli.main(["-c", cfg_path, "-i", str(tmp_path / "in.png"), "-o", str(out),
                   "--seed", "3", "--device", "cpu"])
    assert rc == 0
    cfg = read_config(cfg_path)
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 3), "cpu")
    want = api.upscale_image(cfg, params, rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")), want)


def test_cli_rgb_config_writes_what_the_api_returns(tmp_path):
    rgba = np.random.default_rng(11).integers(0, 256, (30, 41, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "in.png")
    out = tmp_path / "out.png"
    rc = cli.main(["-c", RGB_PRETRAINED, "-i", str(tmp_path / "in.png"), "-o", str(out),
                   "--device", "cpu"])
    assert rc == 0
    cfg = read_config(RGB_PRETRAINED)
    want = api.upscale_image(cfg, params_to_torch(init_params(cfg)[0], "cpu"), rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")), want)


def test_cli_directory_and_dry(tmp_path, capsys):
    cfg_path = _write_config(tmp_path, NARROW)
    src = tmp_path / "imgs"
    src.mkdir()
    for i in range(2):
        img = np.random.default_rng(i).integers(0, 256, (24, 28, 3), dtype=np.uint8)
        Image.fromarray(img, "RGB").save(src / f"im{i}.png")
    dst = tmp_path / "out"
    assert cli.main(["-c", cfg_path, "-i", str(src), "-o", str(dst), "--device", "cpu"]) == 0
    assert sorted(os.listdir(dst)) == ["im0_sr.png", "im1_sr.png"]
    assert cli.main(["dry", "-c", cfg_path, "-i", str(src), "--device", "cpu"]) == 0
    assert "DONE" in capsys.readouterr().out


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    cfg_path = _write_config(tmp_path, NARROW)
    img = tmp_path / "in.png"
    Image.fromarray(np.zeros((24, 24, 3), np.uint8), "RGB").save(img)
    assert cli.main(["-c", cfg_path, "-i", str(img)]) == 1  # no -o, not dry
    assert cli.main(["train", "-c", cfg_path, "-i", str(img), "-o", "p.json"]) == 1
    missing = _write_config(tmp_path, {**NARROW, "parameters_file": "nowhere.json"},
                            "missing.json")
    assert cli.main(["dry", "-c", missing, "-i", str(img), "--device", "cpu"]) == 1
    # no quiet CPU path when CUDA is asked for and missing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["dry", "-c", cfg_path, "-i", str(img)]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_pil():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import cnn_sr_tpu_torch, cnn_sr_tpu_torch.api, cnn_sr_tpu_torch.cli
        from cnn_sr_tpu_torch.utils.config import read_config
        from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch
        cfg = read_config("configs/srcnn_9-1-5.json")
        params = params_to_torch(init_params(cfg, seed=0)[0], "cpu")
        rgba = np.random.default_rng(0).integers(0, 256, (30, 34, 4), dtype=np.uint8)
        out = cnn_sr_tpu_torch.api.upscale_image(cfg, params, rgba)
        assert out.shape == (30, 34, 3), out.shape
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "PIL", "cnn_sr_tpu"))
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
