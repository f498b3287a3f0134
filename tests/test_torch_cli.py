"""Port parity: ``cnn_torch.py``'s train mode and the JAX CLI's command
lines, against ``cnn.py``, on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from cnn_sr_tpu.cli import main as jmain
from cnn_sr_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {
    "n1": 8, "n2": 4, "f1": 9, "f2": 5, "f3": 5,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [0.001, 0.001, 0.0001],
    **{f"parameters_distribution_{i}": {"mean_w": 0.0, "mean_b": 0.0,
                                        "std_deviation_w": 0.05, "std_deviation_b": 0.0}
       for i in (1, 2, 3)},
}


def _setup(tmp_path, n=6, size=24):
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump(CFG, fh)
    d = tmp_path / "samples"
    os.makedirs(str(d))
    rng = np.random.default_rng(1)
    for i in range(n):
        large = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        small = ((large.astype(np.float32) + np.roll(large, 1, 0)) / 2).astype(np.uint8)
        Image.fromarray(large, "RGB").save(str(d / f"s{i}_large.png"))
        Image.fromarray(small, "RGB").save(str(d / f"s{i}_small.png"))
    return cfg_path, str(d)


def test_train_matches_cnn_py(tmp_path):
    """``cnn_torch.py train --device cpu`` and ``cnn.py train`` on the same
    samples, seed and flags: parameters within 1e-5 of each tensor's
    largest entry, the same ``epochs``, the same messages."""
    cfg_path, d = _setup(tmp_path)
    flags = ["-e", "5", "--seed", "2", "--mini-batch-count", "2", "--validation-cadence", "2",
             "--epochs-per-dispatch", "3"]
    outs = {}
    for name, launcher, extra in (("jax", "cnn.py", []),
                                  ("port", "cnn_torch.py", ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.json")
        proc = subprocess.run([sys.executable, os.path.join(ROOT, launcher), "train", "-c",
                               cfg_path, "-i", d, "-o", out, *flags, *extra],
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs[name] = (json.load(open(out)), proc.stdout)
    (jp, jout), (tp, tout) = outs["jax"], outs["port"]
    assert tp["epochs"] == jp["epochs"] == 5 and set(tp) == set(jp)
    for key in ("layer1", "layer2", "layer3"):
        for field in ("weights", "bias"):
            a, b = np.asarray(tp[key][field]), np.asarray(jp[key][field])
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), (key, field)
    for line in ("Training mode, epochs: 5", "Loaded 6 samples of 24x24",
                 "validation_set_size: 1/6", "Training time: ", "Saving parameters to: ",
                 "DONE"):
        assert line in jout and line in tout, line


def test_train_dry_writes_nothing_and_full_state_writes_the_sidecar(tmp_path, capsys):
    cfg_path, d = _setup(tmp_path, n=5, size=20)
    before = set(os.listdir(tmp_path))
    assert cli.main(["train", "dry", "-c", cfg_path, "-i", d, "-e", "2", "--device", "cpu",
                     "-o", str(tmp_path / "never.json")]) == 0
    assert set(os.listdir(tmp_path)) == before
    assert "mean validation error" in capsys.readouterr().out

    out = str(tmp_path / "p.json")
    assert cli.main(["train", "-c", cfg_path, "-i", d, "-e", "2", "-o", out, "--device", "cpu",
                     "--full-state", "--seed", "0", "--train-precision", "bf16"]) == 0
    assert os.path.isfile(out + ".state.npz")
    with open(cfg_path, "w") as fh:
        json.dump({**CFG, "parameters_file": out}, fh)
    assert cli.main(["train", "-c", cfg_path, "-i", d, "-e", "1", "-o", out + ".2",
                     "--device", "cpu", "--full-state"]) == 0
    text = capsys.readouterr().out
    assert "Resumed full training state" in text
    assert json.load(open(out + ".2"))["epochs"] == 3


def test_train_refusals(tmp_path, monkeypatch, capsys):
    cfg_path, d = _setup(tmp_path, n=2, size=20)
    assert cli.main(["train", "-c", cfg_path, "-i", str(tmp_path / "none"), "-e", "1",
                     "--device", "cpu", "-o", "p.json"]) == 1
    assert "File not found" in capsys.readouterr().out
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert cli.main(["train", "-c", cfg_path, "-i", d, "-e", "1", "-o", "p.json"]) == 1
    assert "no CUDA device" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--packed-io", "--no-packed-io"])
def test_jax_command_line_with_packed_io_parses_and_upscales_identically(tmp_path, flag):
    """Both flags are accepted and change nothing (ROADMAP Queue 3 #2)."""
    cfg_path, _ = _setup(tmp_path, n=0)
    img = np.random.default_rng(5).integers(0, 256, (30, 36, 3), dtype=np.uint8)
    src = str(tmp_path / "in.png")
    Image.fromarray(img).save(src)
    line = ["-c", cfg_path, "-i", src, "--seed", "3", flag]
    assert jmain([*line, "-o", str(tmp_path / "j.png")]) == 0
    assert cli.main([*line, "-o", str(tmp_path / "t.png"), "--device", "cpu"]) == 0
    assert cli.main(["-c", cfg_path, "-i", src, "--seed", "3", "-o", str(tmp_path / "d.png"),
                     "--device", "cpu"]) == 0
    got = np.asarray(Image.open(str(tmp_path / "t.png")))
    np.testing.assert_array_equal(got, np.asarray(Image.open(str(tmp_path / "d.png"))))
    want = np.asarray(Image.open(str(tmp_path / "j.png")))
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert "does nothing" in cli.build_parser().format_help()


def test_forward_spatial_shard_matches_single(tmp_path):
    """``--spatial-shard N`` on the CPU (the CPU named N times): the image's
    rows over N bands with one halo exchange, within ±1 uint8 of the
    single-device run (78 rows: the bottom-pad path at 4 shards)."""
    cfg_path, _ = _setup(tmp_path, n=0)
    img = np.random.default_rng(6).integers(0, 256, (78, 40, 3), dtype=np.uint8)
    src = str(tmp_path / "in.png")
    Image.fromarray(img).save(src)
    line = ["-c", cfg_path, "-i", src, "--seed", "0", "--device", "cpu"]
    ref = str(tmp_path / "ref.png")
    assert cli.main([*line, "-o", ref]) == 0
    b = np.asarray(Image.open(ref)).astype(int)
    for n in ("2", "4"):
        out = str(tmp_path / f"out_s{n}.png")
        assert cli.main([*line, "-o", out, "--spatial-shard", n]) == 0
        assert np.abs(np.asarray(Image.open(out)).astype(int) - b).max() <= 1, n
    with pytest.raises(SystemExit, match="devices"):
        cli.main([*line, "-o", ref, "--spatial-shard", "-2"])


def test_train_data_parallel_matches_single(tmp_path, capsys):
    """``--data-parallel 2``: 10 samples, train 8 and validation 2 split over
    two replicas; the parameters of the single-device run within rtol
    1e-5, atol 1e-7 (tests/test_cli.py's)."""
    cfg_path, d = _setup(tmp_path, n=10)
    line = ["train", "-c", cfg_path, "-i", d, "-e", "3", "--seed", "7", "--device", "cpu"]
    p1, p2 = str(tmp_path / "p1.json"), str(tmp_path / "p2.json")
    assert cli.main([*line, "-o", p1]) == 0
    assert cli.main([*line, "-o", p2, "--data-parallel", "2"]) == 0
    assert "Data-parallel training over 2 devices" in capsys.readouterr().out
    w1, w2 = json.load(open(p1)), json.load(open(p2))
    for layer in ("layer1", "layer2", "layer3"):
        for field in ("weights", "bias"):
            np.testing.assert_allclose(w2[layer][field], w1[layer][field], rtol=1e-5,
                                       atol=1e-7)


def test_train_data_parallel_indivisible_split_errors(tmp_path):
    cfg_path, d = _setup(tmp_path, n=5)  # train 4 / validation 1: 1 % 2 != 0
    with pytest.raises(SystemExit, match="must both divide"):
        cli.main(["train", "-c", cfg_path, "-i", d, "-o", str(tmp_path / "p.json"), "-e", "1",
                  "--device", "cpu", "--data-parallel", "2"])


def _image(tmp_path, seed=5, shape=(30, 36, 3)):
    src = str(tmp_path / "in.png")
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)).save(src)
    return src


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_train_dry_profile(tmp_path, capsys):
    """``train dry profile`` on the CPU (tests/test_cli.py
    ``test_train_dry_profile``): the banner, the stage table, the op table
    with the convolutions in it, and no parameters file."""
    cfg_path, d = _setup(tmp_path, n=5, size=20)
    before = set(os.listdir(tmp_path))
    assert cli.main(["train", "dry", "profile", "-c", cfg_path, "-i", d, "-e", "2",
                     "--device", "cpu", "-o", str(tmp_path / "params_out.json")]) == 0
    out = capsys.readouterr().out
    for text in ("!!! RUNNING IN PROFILING MODE !!!", "---- stage profile ----",
                 "- load_samples", "- train_loop", "---- op profile (device time) ----",
                 "convolution", "Total device op time", "[cpu] memory stats unavailable"):
        assert text in out, text
    assert set(os.listdir(tmp_path)) == before


@pytest.mark.parametrize("extra,stages", [
    ([], ["load_image", "upscale (luma+forward+swap)", "write_image"]),
    (["--scale", "1.5"], ["load_image", "upscale_input (bicubic)",
                          "upscale (luma+forward+swap)", "write_image"]),
    (["--precision", "bf16", "--bucket", "16"], ["load_image", "upscale (luma+forward+swap)",
                                                 "write_image"]),
])
def test_forward_profile_writes_the_unprofiled_bytes(tmp_path, capsys, extra, stages):
    """A ``profile`` forward run times JAX's stages, prints both tables,
    and writes a PNG byte-equal to an unprofiled run's."""
    cfg_path, _ = _setup(tmp_path, n=0)
    line = ["-c", cfg_path, "-i", _image(tmp_path), "--seed", "3", "--device", "cpu", *extra]
    plain, profiled = str(tmp_path / "plain.png"), str(tmp_path / "profiled.png")
    assert cli.main([*line, "-o", plain]) == 0
    capsys.readouterr()
    assert cli.main(["profile", *line, "-o", profiled]) == 0
    out = capsys.readouterr().out
    assert _read(profiled) == _read(plain)
    table = out[out.index("---- stage profile ----"):out.index("Total measured time")]
    assert sorted(ln.split(" - ", 1)[1] for ln in table.splitlines()[1:]) == sorted(stages)
    assert "---- op profile (device time) ----" in out and "convolution" in out


@pytest.mark.parametrize("mode", ["forward", "train"])
def test_trace_dir_alone_writes_a_trace_and_no_table(tmp_path, capsys, mode):
    from cnn_sr_tpu_torch import profiling

    cfg_path, d = _setup(tmp_path, n=4, size=20)
    trace = str(tmp_path / "trace")
    if mode == "forward":
        line = ["-c", cfg_path, "-i", _image(tmp_path), "--seed", "3", "--device", "cpu"]
        assert cli.main([*line, "-o", str(tmp_path / "plain.png")]) == 0
        assert cli.main([*line, "-o", str(tmp_path / "traced.png"), "--trace-dir", trace]) == 0
        assert _read(str(tmp_path / "traced.png")) == _read(str(tmp_path / "plain.png"))
    else:
        line = ["train", "-c", cfg_path, "-i", d, "-e", "2", "--seed", "4", "--device", "cpu"]
        assert cli.main([*line, "-o", str(tmp_path / "plain.json")]) == 0
        assert cli.main([*line, "--trace-dir", trace, "-o", str(tmp_path / "traced.json")]) == 0
        assert _read(str(tmp_path / "traced.json")) == _read(str(tmp_path / "plain.json"))
    out = capsys.readouterr().out
    assert "stage profile" not in out and "op profile" not in out and "PROFILING" not in out
    assert [f.endswith(profiling.TRACE_SUFFIX) for f in os.listdir(trace)] == [True]
    assert any("convolution" in name for name, _, _ in profiling.op_shares(trace))


@pytest.mark.parametrize("pallas,precision", [
    (["--pallas"], "bf16"),
    (["--pallas", "--pallas-precision", "bf16"], "bf16"),
    (["--pallas", "--pallas-precision", "f32"], "f32"),
    (["--pallas-precision", "bf16"], "f32"),
    (["--pallas", "--precision", "bf16"], "bf16"),
])
def test_pallas_flags_map_onto_precision(tmp_path, pallas, precision):
    """``--pallas`` is bit-equal to ``--precision bf16``, ``--pallas
    --pallas-precision f32`` to ``--precision f32``; without ``--pallas``
    the JAX CLI's XLA forward is f32."""
    cfg_path, _ = _setup(tmp_path, n=0)
    line = ["-c", cfg_path, "-i", _image(tmp_path), "--seed", "3", "--device", "cpu"]
    assert cli.main([*line, *pallas, "-o", str(tmp_path / "a.png")]) == 0
    assert cli.main([*line, "--precision", precision, "-o", str(tmp_path / "b.png")]) == 0
    assert _read(str(tmp_path / "a.png")) == _read(str(tmp_path / "b.png"))


@pytest.mark.parametrize("pallas", [["--pallas"], ["--pallas", "--pallas-precision", "f32"]])
def test_jax_command_line_with_pallas_runs_through_both_clis(tmp_path, pallas):
    """The same command line through ``cnn.py``'s main (Pallas in interpret
    mode on the CPU, as the JAX tests run it) and ``cnn_torch.py``'s: the
    outputs within ±1 uint8."""
    cfg_path, _ = _setup(tmp_path, n=0)
    line = ["-c", cfg_path, "-i", _image(tmp_path), "--seed", "3", *pallas]
    assert jmain([*line, "-o", str(tmp_path / "j.png")]) == 0
    assert cli.main([*line, "-o", str(tmp_path / "t.png"), "--device", "cpu"]) == 0
    got = np.asarray(Image.open(str(tmp_path / "t.png"))).astype(np.int16)
    want = np.asarray(Image.open(str(tmp_path / "j.png"))).astype(np.int16)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1


@pytest.mark.parametrize("flags", [
    ["--pallas", "--precision", "f32"],
    ["--pallas", "--pallas-precision", "f32", "--precision", "bf16"],
])
def test_contradictory_precision_flags_are_refused(tmp_path, capsys, flags):
    cfg_path, _ = _setup(tmp_path, n=0)
    with pytest.raises(SystemExit) as exc:
        cli.main(["-c", cfg_path, "-i", _image(tmp_path), "-o", str(tmp_path / "o.png"),
                  "--device", "cpu", *flags])
    assert exc.value.code == 2
    assert "contradicts --pallas" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "o.png"))


def test_profile_without_a_card_fails_cleanly(tmp_path, monkeypatch, capsys):
    cfg_path, _ = _setup(tmp_path, n=0)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert cli.main(["profile", "-c", cfg_path, "-i", _image(tmp_path),
                     "-o", str(tmp_path / "o.png")]) == 1
    out = capsys.readouterr().out
    assert "no CUDA device" in out and "[cuda] memory stats unavailable" in out
