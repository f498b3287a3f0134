"""Port parity: the user tools ``cnn_sr_tpu_torch.tools.*`` against the
JAX package's scripts under ``tools/``, on the CPU, on the same seeded
inputs."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from PIL import Image

from cnn_sr_tpu_torch.tools import evaluate, generate_training_samples, profile
from cnn_sr_tpu_torch.tools import schedule_training, serve_latency, weights_visualize
from cnn_sr_tpu_torch.utils.config import parse_config
from cnn_sr_tpu_torch.utils.params_io import random_parameters, save_parameters_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST = {"mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.0}
CFG = {
    "n1": 8, "n2": 4, "f1": 9, "f2": 5, "f3": 5,
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [0.01, 0.01, 0.001],
    **{f"parameters_distribution_{i}": DIST for i in (1, 2, 3)},
}


def _jax_tool(name):
    """A script of ``tools/`` as a module (its names clash with the port's
    and, for ``profile``, with the standard library's)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(tmp_path, raw=CFG):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as fh:
        json.dump(raw, fh)
    return path


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("scale", [1, 3])
@pytest.mark.parametrize("channels", [1, 3])
def test_weights_visualize_matches_jax(tmp_path, capsys, scale, channels):
    """The same PNG sheets, byte for byte, and the same Σw² lines."""
    raw = {**CFG, "channels": channels}
    cfg = parse_config(raw)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=channels)
    ppath = str(tmp_path / "params.json")
    save_parameters_file(ppath, params, epochs=7)
    cpath = _config(tmp_path, raw)
    lines = {}
    for name, main in (("jax", _jax_tool("weights_visualize").main),
                       ("port", lambda a: weights_visualize.main([*a, "--device", "cpu"]))):
        assert main(["-c", cpath, "-p", ppath, "-o", str(tmp_path / name),
                     "--scale", str(scale)]) == 0
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if not ln.startswith("  -> ")]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 4
    assert sorted(os.listdir(str(tmp_path / "port"))) == ["weights1.png", "weights2.png",
                                                          "weights3.png"]
    for f in os.listdir(str(tmp_path / "jax")):
        assert _read(str(tmp_path / "port" / f)) == _read(str(tmp_path / "jax" / f)), f


def _scores(monkeypatch, module, run):
    """Run an evaluate tool, recording every PSNR(Y) it computes."""
    import importlib

    metrics = importlib.import_module(module)
    scores, real = [], metrics.psnr_y
    monkeypatch.setattr(metrics, "psnr_y", lambda a, b: scores.append(real(a, b)) or scores[-1])
    assert run() == 0
    return scores


@pytest.mark.parametrize("mode", ["pairs", "degrade"])
def test_evaluate_matches_jax(tmp_path, monkeypatch, capsys, mode):
    """Per-image and mean PSNR(Y) of bicubic and of the flagship checkpoint
    within 0.01 dB of the JAX tool's (its XLA f32 forward, the port's f32
    kernels' plain version), over ``*_large/*_small`` pairs and over
    plain images degraded by 2 on the fly."""
    samples = str(tmp_path / "samples")
    assert generate_training_samples.main(["--synthetic", "3", "-o", samples, "-s", "48",
                                           "--seed", "1", "--device", "cpu"]) == 0
    in_dir = samples
    extra = []
    if mode == "degrade":
        in_dir = str(tmp_path / "plain")
        os.makedirs(in_dir)
        for f in os.listdir(samples):
            if "_large" in f:
                os.rename(os.path.join(samples, f), os.path.join(in_dir, f))
        extra = ["--degrade", "2"]
    line = ["-c", os.path.join(ROOT, "configs", "srcnn_9-5-5_pretrained.json"), "-i", in_dir,
            *extra]
    capsys.readouterr()
    want = _scores(monkeypatch, "cnn_sr_tpu.utils.metrics",
                   lambda: _jax_tool("evaluate").main(line))
    jout = capsys.readouterr().out
    got = _scores(monkeypatch, "cnn_sr_tpu_torch.utils.metrics",
                  lambda: evaluate.main([*line, "--device", "cpu"]))
    tout = capsys.readouterr().out
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, atol=0.01, rtol=0)
    np.testing.assert_allclose(np.mean(got[1::2]), np.mean(want[1::2]), atol=0.01, rtol=0)
    assert [ln.split()[0] for ln in tout.splitlines()] == [ln.split()[0]
                                                          for ln in jout.splitlines()]


@pytest.mark.parametrize("source", ["synthetic", "directory"])
def test_generate_training_samples_pil_matches_jax(tmp_path, source):
    """The Pillow backend writes the JAX tool's files, byte for byte."""
    if source == "synthetic":
        line = ["--synthetic", "4", "-s", "32", "-d", "2", "--seed", "3"]
    else:
        raw = tmp_path / "raw"
        os.makedirs(str(raw))
        rng = np.random.default_rng(0)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(
                str(raw / f"img{i}.png"))
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(raw / "tiny.png"))
        line = ["-i", str(raw), "-s", "24", "-d", "2", "--seed", "0"]
    assert _jax_tool("generate_training_samples").main([*line, "-o", str(tmp_path / "j")]) == 0
    assert generate_training_samples.main([*line, "-o", str(tmp_path / "t"),
                                           "--device", "cpu"]) == 0
    names = sorted(os.listdir(str(tmp_path / "j")))
    assert sorted(os.listdir(str(tmp_path / "t"))) == names and len(names) in (6, 8)
    for n in names:
        assert _read(str(tmp_path / "t" / n)) == _read(str(tmp_path / "j" / n)), n


@pytest.mark.parametrize("size,factor", [(32, 2), (40, 3), (36, 2.5)])
def test_generate_training_samples_torch_backend_matches_jax_backend(size, factor):
    """The torch backend's degraded image within 1 uint8 of the JAX
    backend's (``jax.image.resize`` lanczos3), compared before encoding."""
    rng = np.random.default_rng(size)
    large = generate_training_samples.synth_image(rng, 64).crop((3, 5, 3 + size, 5 + size))
    want = np.asarray(_jax_tool("generate_training_samples")._degrade_jax(large, size, factor))
    got = np.asarray(generate_training_samples._degrade_torch(large, size, factor, "cpu"))
    assert got.shape == want.shape == (size, size, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_generate_training_samples_torch_backend_and_empty_directory(tmp_path, capsys):
    out = str(tmp_path / "t")
    assert generate_training_samples.main(["--synthetic", "2", "-o", out, "-s", "24",
                                           "--backend", "torch", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["sample_0_large.png", "sample_0_small.png",
                                       "sample_1_large.png", "sample_1_small.png"]
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    capsys.readouterr()
    assert _jax_tool("generate_training_samples").main(["-i", empty, "-o", out, "-s", "8"]) == 1
    assert generate_training_samples.main(["-i", empty, "-o", out, "-s", "8",
                                           "--device", "cpu"]) == 1
    assert capsys.readouterr().out.count("No files were created") == 2


def test_schedule_training_convert_and_dry(tmp_path, monkeypatch):
    """tests/test_tools.py ``test_schedule_training_convert_and_dry`` on the
    port's tool: each iteration runs ``cnn_torch.py train`` on the device
    asked for, and the arguments after ``--`` go on verbatim."""
    assert schedule_training.convert_to_seconds("90s") == 90
    assert schedule_training.convert_to_seconds("2m") == 120
    assert schedule_training.convert_to_seconds("1h") == 3600

    calls = []

    def fake_call(cmd, stdout=None, stderr=None):
        calls.append(cmd)
        params = {"epochs": 1, **{f"layer{i}": {"weights": [0.0], "bias": [0.0]}
                                  for i in (1, 2, 3)}}
        with open(str(tmp_path / "params.json"), "w") as fh:
            json.dump(params, fh)
        return 0

    monkeypatch.setattr(schedule_training.subprocess, "call", fake_call)
    line = ["-c", "cfg.json", "-i", "samples", "--epochs-per-iteration", "500",
            "--params-file", str(tmp_path / "params.json"),
            "--logs-dir", str(tmp_path / "logs"), "--device", "cpu"]
    assert schedule_training.main([*line, "--epochs", "1000"]) == 0
    assert len(calls) == 2
    assert calls[0][1] == os.path.join(ROOT, "cnn_torch.py") and calls[0][2] == "train"
    assert calls[0][calls[0].index("--device") + 1] == "cpu"
    logs = os.listdir(str(tmp_path / "logs"))
    assert any(n.startswith("log_") for n in logs)
    assert any(n.startswith("parameters_") for n in logs)

    calls.clear()
    assert schedule_training.main([*line, "--epochs", "500", "--", "--train-precision",
                                   "bf16", "--data-parallel", "4"]) == 0
    assert calls[0][-4:] == ["--train-precision", "bf16", "--data-parallel", "4"]

    calls.clear()
    monkeypatch.setattr(schedule_training.subprocess, "call", lambda *a, **k: 3)
    assert schedule_training.main([*line, "--duration", "1m"]) == 3


def _samples(tmp_path, n=4, size=20):
    d = tmp_path / "samples"
    os.makedirs(str(d))
    rng = np.random.default_rng(1)
    for i in range(n):
        large = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(large).save(str(d / f"s{i}_large.png"))
        Image.fromarray(np.roll(large, 1, 0)).save(str(d / f"s{i}_small.png"))
    return str(d)


def test_profile_stage_line_parses_the_port_clis_stage_table(tmp_path, capsys):
    """The tool's ``STAGE_LINE`` (the JAX tool's regex) reads every line of
    the port CLI's stage table, as the JAX tool's reads it."""
    from cnn_sr_tpu_torch import cli

    assert profile.STAGE_LINE.pattern == _jax_tool("profile").STAGE_LINE.pattern
    assert cli.main(["train", "dry", "profile", "-c", _config(tmp_path), "-i",
                     _samples(tmp_path), "-e", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    table = out[out.index("---- stage profile ----"):out.index("Total measured time")]
    rows = [profile.STAGE_LINE.match(ln) for ln in table.splitlines()[1:]]
    assert all(rows) and sorted(m.group(4) for m in rows) == ["load_samples", "train_loop"]
    assert not any(profile.STAGE_LINE.match(ln) for ln in out.splitlines()
                   if "ms (" in ln)


def test_profile_tool_runs_the_port_cli(tmp_path, capsys):
    assert profile.main(["stage", "-c", _config(tmp_path), "-i", _samples(tmp_path),
                         "-e", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cnn_torch.py train dry" in out and "s/epoch" in out
    assert "Time in measured stages" in out and "- train_loop" in out
    assert "---- op profile (device time) ----" in out and "Total device op time" in out


@pytest.mark.parametrize("flags", [[], ["--no-pallas", "--bucket", "16"]])
def test_serve_latency_rows(monkeypatch, capsys, flags):
    """The tool's two workloads shrunk to 64x64: a sequential and a
    concurrent row each, with percentiles and no failed request."""
    monkeypatch.setattr(serve_latency, "WORKLOADS",
                        [(name, slot, cfg, 64, 64)
                         for name, slot, cfg, _, _ in serve_latency.WORKLOADS])
    assert serve_latency.main(["--device", "cpu", "--n-seq", "2", "--clients", "2",
                               "--n-per-client", "2", *flags]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert [r["metric"] for r in rows] == [
        "serving_latency_luma_1080p_sequential",
        "serving_latency_luma_1080p_concurrent2" + ("_bucket16" if flags else ""),
        "serving_latency_rgb_540p_sequential",
        "serving_latency_rgb_540p_concurrent2" + ("_bucket16" if flags else "")]
    for r in rows:
        assert r["p50_ms"] > 0 and r["p99_ms"] >= r["p50_ms"]
        assert r["n"] == (2 if r["metric"].endswith("sequential") else 4)
        assert r.get("failed", 0) == 0


def test_new_modules_import_neither_jax_nor_the_jax_package(tmp_path):
    """With ``jax`` and ``cnn_sr_tpu`` blocked in ``sys.modules``: every
    module of this slice imports, and a ``profile`` run, the debug helpers
    and the tools' entry points work."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "cnn_sr_tpu"):
            sys.modules[name] = None
        import numpy as np, torch
        from PIL import Image
        from cnn_sr_tpu_torch import cli, profiling
        from cnn_sr_tpu_torch.utils import debug
        from cnn_sr_tpu_torch.tools import (evaluate, generate_training_samples, profile,
                                            schedule_training, serve_latency,
                                            weights_visualize)
        d = {str(tmp_path)!r}
        Image.fromarray(np.full((30, 30, 3), 90, np.uint8)).save(d + "/in.png")
        assert cli.main(["profile", "-c", "configs/srcnn_9-1-5.json", "-i", d + "/in.png",
                         "-o", d + "/out.png", "--device", "cpu", "--seed", "0",
                         "--pallas"]) == 0
        debug.print_array("x", torch.ones(3))
        assert generate_training_samples.main(["--synthetic", "1", "-o", d + "/s", "-s",
                                               "24", "--backend", "torch",
                                               "--device", "cpu"]) == 0
        assert evaluate.main(["-c", "configs/srcnn_9-1-5.json", "-i", d + "/s",
                              "--seed", "0", "--device", "cpu"]) == 0
        print("IMPORTS-OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "IMPORTS-OK" in proc.stdout and "op profile (device time)" in proc.stdout
