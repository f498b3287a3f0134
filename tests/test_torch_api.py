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
from test_torch_bf16 import LUMA_CFG, RGB_CFG

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
    # train mode needs a directory of samples, not an image
    assert cli.main(["train", "-c", cfg_path, "-i", str(img), "-o", "p.json",
                     "--device", "cpu"]) == 1
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
        import cnn_sr_tpu_torch.serve, cnn_sr_tpu_torch.ops.resize
        import cnn_sr_tpu_torch.probes.strided_store, cnn_sr_tpu_torch.probes.winograd
        import cnn_sr_tpu_torch.probes.wino5, cnn_sr_tpu_torch.probes.rowpair
        import cnn_sr_tpu_torch.probes.xpack, cnn_sr_tpu_torch.probes.xpack2
        from cnn_sr_tpu_torch.utils.config import read_config
        from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch
        cfg = read_config("configs/srcnn_9-1-5.json")
        params = params_to_torch(init_params(cfg, seed=0)[0], "cpu")
        rgba = np.random.default_rng(0).integers(0, 256, (30, 34, 4), dtype=np.uint8)
        out = cnn_sr_tpu_torch.api.upscale_image(cfg, params, rgba)
        assert out.shape == (30, 34, 3), out.shape
        out = cnn_sr_tpu_torch.api.upscale_image(cfg, params, rgba, precision="bf16")
        assert out.shape == (30, 34, 3), out.shape
        out = cnn_sr_tpu_torch.api.upscale_image(cfg, params, rgba, bucket=64)
        assert out.shape == (30, 34, 3), out.shape
        worker = cnn_sr_tpu_torch.serve.DeviceWorker({"default": {"cfg": cfg,
                                                                  "params": params}})
        assert worker.snapshot()["models"] == ["default"]
        assert cnn_sr_tpu_torch.probes.strided_store.main(["--device", "cpu"]) == 0
        assert cnn_sr_tpu_torch.probes.rowpair.main(["--device", "cpu"]) == 0
        assert cnn_sr_tpu_torch.probes.xpack.main(["--device", "cpu", "--check",
                                                   "--steps", "1"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "PIL", "cnn_sr_tpu", "tools",
                                            "winograd_probe", "strided_store_probe",
                                            "wino5_probe", "rowpair_probe", "xpack_probe",
                                            "xpack_probe2"))
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---- shape buckets, batches and the CLI's --precision/--bucket/--scale ----

SMALL = {**GOLDEN_CFG, "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3}
SMALL_RGB = {
    "channels": 3,
    "layers": [{"n": 6, "f": 3}, {"n": 4, "f": 3}, {"n": 3, "f": 3}],
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [1e-3] * 3,
    "parameters_distribution": {"mean_w": 0.0, "mean_b": 0.0,
                                "std_deviation_w": 0.05, "std_deviation_b": 0.0},
}


@pytest.mark.parametrize("raw,bucket,shapes,f32_tol", [
    (SMALL, 64, [(30, 37), (64, 64), (41, 70)], 0),
    ({**SMALL, "subtract_squared_mean": True}, 64, [(30, 37), (41, 70)], 0),
    (SMALL_RGB, 32, [(25, 31), (40, 40)], 0),
    ({**NARROW, "zero_mean_target": True}, 64, [(40, 52), (70, 33)], 0),
    ({**NARROW_RGB, "zero_mean_target": True}, 32, [(40, 52), (33, 70)], 1),
], ids=["luma", "luma_squared_mean", "rgb", "luma_9-5-5", "rgb_7layer"])
def test_bucketed_upscale_identical_to_exact(raw, bucket, shapes, f32_tol):
    """The counterparts of test_api.py:107-154: in f32, bucketing does not
    change a byte of the port's output, and the port's bucketed output
    is within ±1 of the JAX package's bucketed output. In bf16 the
    bucketed output is within ±1 of the exact one. The valid-region mean
    is an f32 sum under the mask, as JAX takes it, so it can differ from
    the whole image's mean in its last bit; seven layers deep that moved
    1 of the 6,930 bytes of the 33x70 RGB image by 1, hence ±1 there."""
    cfg, jcfg = parse_config(raw), jparse_config(raw)
    params = random_parameters(jcfg.layer_specs(), jcfg.distributions, seed=4)
    tparams = params_to_torch(params, "cpu")
    rng = np.random.default_rng(5)
    for h, w in shapes:
        rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        exact = api.upscale_image(cfg, tparams, rgba)
        bucketed = api.upscale_image(cfg, tparams, rgba, bucket=bucket)
        if f32_tol:
            assert _max_diff(bucketed, exact) <= f32_tol
        else:
            np.testing.assert_array_equal(bucketed, exact, err_msg=f"shape {h}x{w}")
        assert _max_diff(bucketed, japi.upscale_image(jcfg, params, rgba, bucket=bucket)) <= 1
        bf16 = api.upscale_image(cfg, tparams, rgba, bucket=bucket, precision="bf16")
        assert _max_diff(bf16, api.upscale_image(cfg, tparams, rgba, precision="bf16")) <= 1
    if raw.get("subtract_squared_mean"):  # the flag is live under the mask
        plain = api.upscale_image(parse_config(SMALL), tparams, rgba, bucket=bucket)
        assert (plain != exact).any()


@pytest.mark.parametrize("raw,precision", [
    (SMALL, "f32"), ({**NARROW, "zero_mean_target": True}, "f32"),
    ({**NARROW, "subtract_squared_mean": True}, "bf16"), (SMALL_RGB, "f32"),
    ({**NARROW_RGB, "zero_mean_target": True}, "f32"),
    ({**NARROW_RGB, "zero_mean_target": True}, "bf16"),
], ids=["luma", "luma_9-5-5", "luma_squared_bf16", "rgb", "rgb_7layer", "rgb_7layer_bf16"])
def test_upscale_batch_matches_single(raw, precision):
    """The counterpart of test_api.py:28-37: each image of
    ``upscale_batch`` equals ``upscale_image`` byte for byte, and (in
    f32) JAX's ``upscale_batch`` within ±1."""
    cfg, jcfg = parse_config(raw), jparse_config(raw)
    params = random_parameters(jcfg.layer_specs(), jcfg.distributions, seed=0)
    tparams = params_to_torch(params, "cpu")
    rgbas = np.random.default_rng(1).integers(0, 256, (3, 40, 44, 4), dtype=np.uint8)
    batched = api.upscale_batch(cfg, tparams, rgbas, precision=precision)
    assert batched.shape == (3, 40, 44, 3) and batched.dtype == np.uint8
    for i in range(3):
        single = api.upscale_image(cfg, tparams, rgbas[i], precision=precision)
        np.testing.assert_array_equal(batched[i], single)
    if precision == "f32":
        assert _max_diff(batched, japi.upscale_batch(jcfg, params, rgbas)) <= 1


def test_batch_and_bucket_keep_the_receptive_field_errors():
    cfg = parse_config(NARROW)  # shrink 16
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 2), "cpu")
    tiny = np.zeros((16, 30, 4), np.uint8)
    with pytest.raises(ValueError, match="receptive field"):
        api.upscale_image(cfg, params, tiny, bucket=64)
    with pytest.raises(ValueError, match="receptive field"):
        api.upscale_batch(cfg, params, tiny[None])
    with pytest.raises(ValueError, match="precision"):
        api.upscale_image(cfg, params, np.zeros((30, 30, 4), np.uint8), precision="f16")


def test_cli_precision_bucket_scale_writes_what_the_api_returns(tmp_path):
    from cnn_sr_tpu_torch.ops.resize import upscale_rgba

    cfg_path = _write_config(tmp_path, {**NARROW, "zero_mean_target": True})
    rgba = np.random.default_rng(12).integers(0, 256, (20, 23, 4), dtype=np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "in.png")
    out = tmp_path / "out.png"
    rc = cli.main(["-c", cfg_path, "-i", str(tmp_path / "in.png"), "-o", str(out),
                   "--seed", "3", "--device", "cpu", "--precision", "bf16",
                   "--bucket", "64", "--scale", "2"])
    assert rc == 0
    cfg = read_config(cfg_path)
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 3), "cpu")
    big = upscale_rgba(torch.from_numpy(rgba), 2.0).numpy()
    want = api.upscale_image(cfg, params, big, bucket=64, precision="bf16")
    got = np.asarray(Image.open(out).convert("RGB"))
    assert got.shape == (40, 46, 3)
    np.testing.assert_array_equal(got, want)


# the configs of test_torch_bf16.py: the 8-channel 9-5-5 with the plain and
# the squared mean, and the narrow 7-layer RGB
BF16_CFGS = {"luma": LUMA_CFG, "luma_squared_mean": {**LUMA_CFG, "subtract_squared_mean": True},
             "rgb": {**RGB_CFG, "zero_mean_target": True}}


@pytest.mark.parametrize("name", list(BF16_CFGS))
def test_bf16_bucketed_matches_jax_use_pallas(name):
    """The port's bf16 bucketed path against JAX's ``use_pallas=True``
    bucketed path (its bf16 stream in interpret mode): ±1 uint8."""
    raw = BF16_CFGS[name]
    jcfg = jparse_config(raw)
    params = random_parameters(jcfg.layer_specs(), jcfg.distributions, seed=2)
    rgba = np.random.default_rng(3).integers(0, 256, (41, 70, 4), dtype=np.uint8)
    got = api.upscale_image(parse_config(raw), params_to_torch(params, "cpu"), rgba, bucket=32,
                            precision="bf16")
    want = japi.upscale_image(jcfg, params, rgba, use_pallas=True, bucket=32)
    assert got.shape == want.shape == (41, 70, 3)
    assert _max_diff(got, want) <= 1


@pytest.mark.parametrize("name", list(BF16_CFGS))
def test_bf16_batch_matches_jax_use_pallas(name):
    """The port's bf16 ``upscale_batch`` against JAX's ``use_pallas=True``
    ``upscale_batch``: ±1 uint8."""
    raw = BF16_CFGS[name]
    jcfg = jparse_config(raw)
    params = random_parameters(jcfg.layer_specs(), jcfg.distributions, seed=2)
    rgbas = np.random.default_rng(4).integers(0, 256, (2, 40, 52, 4), dtype=np.uint8)
    got = api.upscale_batch(parse_config(raw), params_to_torch(params, "cpu"), rgbas,
                            precision="bf16")
    want = japi.upscale_batch(jcfg, params, rgbas, use_pallas=True)
    assert got.shape == want.shape == (2, 40, 52, 3)
    assert _max_diff(got, want) <= 1


# ---- the API layer's copies: pageable on the CPU (the card's page-locked
# path is held to it in test_torch_api_card.py) ----

@pytest.mark.parametrize("raw", [SMALL, SMALL_RGB], ids=["luma", "rgb"])
def test_cpu_device_counts_pageable_bytes_only(raw):
    cfg = parse_config(raw)
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 0), "cpu")
    rgbas = np.random.default_rng(13).integers(0, 256, (2, 30, 37, 4), dtype=np.uint8)
    before = dict(api.TRANSFERS)
    batch = api.upscale_batch(cfg, params, rgbas)
    single = api.upscale_image(cfg, params, rgbas[0], bucket=64)
    moved = {k: api.TRANSFERS[k] - before[k] for k in before}
    assert moved == {"pinned_in": 0, "pinned_out": 0,
                     "pageable_in": rgbas.nbytes + rgbas[0].nbytes,
                     "pageable_out": batch.nbytes + single.nbytes}


def _channel_planar(frames):
    """The same pixels with each image's channels planar (strides W, 1,
    H·W), as ``serve._pre_scale`` returns them."""
    return np.moveaxis(np.ascontiguousarray(np.moveaxis(frames, -1, -3)), -3, -1)


@pytest.mark.parametrize("raw", [SMALL, SMALL_RGB], ids=["luma", "rgb"])
def test_read_only_and_channel_planar_inputs_give_todays_answers(raw):
    cfg = parse_config(raw)
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 1), "cpu")
    rgbas = np.random.default_rng(14).integers(0, 256, (2, 30, 37, 4), dtype=np.uint8)
    read_only = rgbas.copy()
    read_only.setflags(write=False)
    planar = _channel_planar(rgbas)
    assert not planar.flags.c_contiguous and planar.strides[-1] == 30 * 37
    want = api.upscale_batch(cfg, params, rgbas)
    for arr in (read_only, planar):
        np.testing.assert_array_equal(api.upscale_batch(cfg, params, arr), want)
        for bucket in (0, 64):
            np.testing.assert_array_equal(api.upscale_image(cfg, params, arr[1], bucket=bucket),
                                          api.upscale_image(cfg, params, rgbas[1], bucket=bucket))


@pytest.mark.parametrize("layout", ["contiguous", "read_only", "channel_planar", "flipped"])
def test_stage_copies_a_frame_in_any_layout(layout):
    """``api._stage``, the host copy into the page-locked buffer (a plain
    host tensor here), takes torch's copy where torch can wrap the frame
    and numpy's where it cannot."""
    frame = np.random.default_rng(15).integers(0, 256, (21, 34, 4), dtype=np.uint8)
    src = {"contiguous": frame, "read_only": frame.copy(),
           "channel_planar": _channel_planar(frame), "flipped": frame[::-1]}[layout]
    if layout == "read_only":
        src.setflags(write=False)
    host = torch.empty(src.shape, dtype=torch.uint8)
    api._stage(host, src)
    np.testing.assert_array_equal(host.numpy(), src)


def test_link_probe_needs_a_card(monkeypatch, capsys):
    """``probes.link`` times the API's copies on a card only: without one
    it says so and exits 1, reading no host clock as a link rate."""
    from cnn_sr_tpu_torch.probes import link

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert link.main(["--reps", "1"]) == 1
    assert "needs an NVIDIA card" in capsys.readouterr().err
