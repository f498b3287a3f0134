"""Port parity: the parameters file the port writes and the ``--full-state``
sidecar, against the JAX package's, on the CPU."""

import os

import numpy as np
import pytest

from cnn_sr_tpu import native as jnative
from cnn_sr_tpu.training import checkpoint as jcheckpoint
from cnn_sr_tpu.training import trainer as jtrainer
from cnn_sr_tpu.training.samples import SampleSet as JSampleSet
from cnn_sr_tpu.utils import params_io as jparams_io
from cnn_sr_tpu.utils.config import parse_config as jparse_config
from cnn_sr_tpu_torch import native
from cnn_sr_tpu_torch.training import checkpoint, trainer
from cnn_sr_tpu_torch.training.samples import SampleSet
from cnn_sr_tpu_torch.utils import params_io
from cnn_sr_tpu_torch.utils.config import parse_config

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0001,
    "learning_rates": [0.01, 0.01, 0.001],
    **{f"parameters_distribution_{i}": {"mean_w": 0.0, "mean_b": 0.0,
                                        "std_deviation_w": 0.05, "std_deviation_b": 0.01}
       for i in (1, 2, 3)},
}


def _arrays(n=6, hw=16, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, 1), np.float32), rng.random((n, hw, hw, 1), np.float32))


def _port_run(state, epochs, rng):
    x, t = _arrays()
    assert not trainer.train_loop(parse_config(CFG), SampleSet(x, t, 16, 16), state, epochs,
                                  rng=rng, log=lambda *_: None, device="cpu")


def _jax_run(state, epochs, rng):
    x, t = _arrays()
    assert not jtrainer.train_loop(jparse_config(CFG), JSampleSet(x, t, 16, 16), state,
                                   epochs, rng=rng, log=lambda *_: None)


@pytest.mark.parametrize("formatter", ["native", "repr"])
def test_parameters_file_byte_identical_and_bit_exact(tmp_path, monkeypatch, formatter):
    """The same bytes as the JAX package's writer, through the native
    formatter or, where the library does not build, ``repr``; and the
    file loads back bit for bit."""
    if formatter == "repr":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    params = trainer.init_train_state(parse_config(CFG), seed=4).params
    params[0]["w"][0, 0, 0, :2] = [0.0, -3.4e38]
    params[1]["b"][0] = 1e-38
    p, pj = str(tmp_path / "p.json"), str(tmp_path / "pj.json")
    params_io.save_parameters_file(p, params, epochs=17)
    jparams_io.save_parameters_file(pj, params, epochs=17)
    assert open(p, "rb").read() == open(pj, "rb").read()
    specs = parse_config(CFG).layer_specs()
    back, epochs = params_io.load_parameters_file(p, specs)
    assert epochs == 17
    for a, b in zip(back, params):
        assert a["w"].tobytes() == b["w"].tobytes() and a["b"].tobytes() == b["b"].tobytes()


def test_split_run_with_sidecar_matches_straight_run(tmp_path):
    straight = trainer.init_train_state(parse_config(CFG), seed=0)
    _port_run(straight, 6, np.random.default_rng(0))

    st = trainer.init_train_state(parse_config(CFG), seed=0)
    rng = np.random.default_rng(0)
    _port_run(st, 3, rng)
    path = str(tmp_path / "p.json")
    params_io.save_parameters_file(path, st.params, epochs=st.epochs)
    assert checkpoint.save_full_state(path, st, rng) == checkpoint.sidecar_path(path)

    st2 = trainer.init_train_state(parse_config({**CFG, "parameters_file": path}))
    rng2 = checkpoint.load_full_state(path, st2)
    assert rng2 is not None and st2.epochs == 3
    for a, b in zip(st2.prev_delta, st.prev_delta):
        np.testing.assert_array_equal(a["w"], b["w"])
    _port_run(st2, 3, rng2)
    for a, b in zip(st2.params, straight.params):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sidecars_resume_across_packages(tmp_path, writer):
    """A sidecar written by one package resumes in the other: the same
    momentum and RNG state restored, and three more epochs land within
    the f32 tolerance of the writer's own resumed run."""
    run, ckpt, init, parse = ((_jax_run, jcheckpoint, jtrainer.init_train_state, jparse_config)
                              if writer == "jax" else
                              (_port_run, checkpoint, trainer.init_train_state, parse_config))
    st = init(parse(CFG), seed=0)
    rng = np.random.default_rng(0)
    run(st, 3, rng)
    path = str(tmp_path / "p.json")
    (jparams_io if writer == "jax" else params_io).save_parameters_file(
        path, st.params, epochs=st.epochs)
    ckpt.save_full_state(path, st, rng)

    cfg_raw = {**CFG, "parameters_file": path}
    mine = init(parse(cfg_raw))
    other_init, other_ckpt, other_run, other_parse = (
        (trainer.init_train_state, checkpoint, _port_run, parse_config) if writer == "jax"
        else (jtrainer.init_train_state, jcheckpoint, _jax_run, jparse_config))
    theirs = other_init(other_parse(cfg_raw))
    rng_mine, rng_theirs = ckpt.load_full_state(path, mine), other_ckpt.load_full_state(
        path, theirs)
    assert rng_mine is not None and rng_theirs is not None
    assert rng_mine.bit_generator.state == rng_theirs.bit_generator.state
    for a, b in zip(mine.prev_delta, theirs.prev_delta):
        np.testing.assert_array_equal(np.asarray(a["w"]), np.asarray(b["w"]))
        np.testing.assert_array_equal(np.asarray(a["b"]), np.asarray(b["b"]))
    run(mine, 3, rng_mine)
    other_run(theirs, 3, rng_theirs)
    assert mine.epochs == theirs.epochs == 6
    for a, b in zip(theirs.params + theirs.prev_delta, mine.params + mine.prev_delta):
        for k in ("w", "b"):
            scale = float(np.abs(b[k]).max())
            assert float(np.abs(np.asarray(a[k]) - b[k]).max()) <= 1e-5 * scale


def test_stale_missing_and_corrupt_sidecars_are_ignored(tmp_path):
    st = trainer.init_train_state(parse_config(CFG), seed=0)
    rng = np.random.default_rng(0)
    _port_run(st, 2, rng)
    path = str(tmp_path / "p.json")
    params_io.save_parameters_file(path, st.params, epochs=st.epochs)
    checkpoint.save_full_state(path, st, rng)
    # the epoch counter no longer matches (the params file was replaced)
    params_io.save_parameters_file(path, st.params, epochs=99)
    st2 = trainer.init_train_state(parse_config({**CFG, "parameters_file": path}))
    assert checkpoint.load_full_state(path, st2) is None
    # other weights at the same epoch (a retrained file)
    params_io.save_parameters_file(path, st.params, epochs=st.epochs)
    st3 = trainer.init_train_state(parse_config({**CFG, "parameters_file": path}))
    st3.params[0]["w"] = st3.params[0]["w"] + 1
    assert checkpoint.load_full_state(path, st3) is None
    os.remove(checkpoint.sidecar_path(path))
    assert checkpoint.load_full_state(path, st2) is None
    with open(checkpoint.sidecar_path(path), "wb") as fh:
        fh.write(b"PK\x03\x04 definitely not a real zip")
    assert checkpoint.load_full_state(path, st2) is None
