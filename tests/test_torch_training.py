"""Port parity: the training path of ``cnn_sr_tpu_torch`` (``models.loss_sum``
and its autograd gradients, ``training.samples``, ``training.trainer``)
against the JAX package's, on the same numpy inputs, on the CPU.

Sizes: the 9-5-5 at n1 = 8, n2 = 4 and a 3-layer f = 3 RGB stack at widths
4/4, 24x24 samples, a few epochs. Tolerances: f32 gradients, parameters
and momentum within 1e-5 of each tensor's largest entry (the sums run in
another order); the validation errors within 1e-5 relative; bf16 as
stated at ``test_bf16_gradients_within_bf16_envelope_of_jax``.
"""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cnn_sr_tpu.models import loss_sum as jloss_sum
from cnn_sr_tpu.models import srcnn as jsrcnn
from cnn_sr_tpu.training import samples as jsamples
from cnn_sr_tpu.training import trainer as jtrainer
from cnn_sr_tpu.utils.config import parse_config as jparse_config
from cnn_sr_tpu_torch.models import srcnn
from cnn_sr_tpu_torch.training import samples, trainer
from cnn_sr_tpu_torch.utils.config import parse_config
from cnn_sr_tpu_torch.utils.params_io import save_parameters_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-5
DIST = {"mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.01}
LUMA = {"n1": 8, "n2": 4, "f1": 9, "f2": 5, "f3": 5, "momentum": 0.9,
        "weight_decay_parameter": 1e-4, "learning_rates": [1e-3, 1e-3, 1e-4],
        **{f"parameters_distribution_{i}": DIST for i in (1, 2, 3)}}
RGB = {"channels": 3, "layers": [{"n": 4, "f": 3}, {"n": 4, "f": 3}, {"n": 3, "f": 3}],
       "momentum": 0.9, "weight_decay_parameter": 1e-4, "learning_rates": [1e-3] * 3,
       "parameters_distribution": DIST}
STACKS = {"luma": [(9, 1, 8), (5, 8, 4), (5, 4, 1)], "rgb": [(3, 3, 4), (3, 4, 4), (3, 4, 3)]}


def _params(specs, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((f, f, k, n)) * (1 / (f * f * k)) ** 0.5)
             .astype(np.float32),
             "b": (rng.standard_normal(n) * 0.05).astype(np.float32)} for f, k, n in specs]


def _data(n, c, seed, hw=24):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.5, 0.5, (n, hw, hw, c)).astype(np.float32),
            rng.uniform(0, 1, (n, hw, hw, c)).astype(np.float32))


def _t(layers, grad=False):
    return [{k: torch.tensor(v, requires_grad=grad) for k, v in layer.items()}
            for layer in layers]


def _jax_grads(params, x, t, **kw):
    g = jax.grad(jloss_sum)(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                            jnp.asarray(t), **kw)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in g]


def _torch_grads(params, x, t, **kw):
    tp = _t(params, grad=True)
    srcnn.loss_sum(tp, torch.from_numpy(x), torch.from_numpy(t), **kw).backward()
    return [{k: v.grad.numpy() for k, v in layer.items()} for layer in tp]


def _assert_rel(got, want, rel=F32_REL, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        for k in ("w", "b"):
            scale = max(float(np.abs(b[k]).max()), 1e-30)
            err = float(np.abs(np.asarray(a[k]) - b[k]).max())
            assert err <= rel * scale, f"{what} layer {i + 1} {k}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "nogate"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_loss_and_gradients_match_jax_f32(stack, gate):
    c = 1 if stack == "luma" else 3
    params = _params(STACKS[stack], seed=len(stack))
    x, t = _data(3, c, seed=5)
    jl = float(jloss_sum(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(t),
                         relu_gate=gate))
    tl = float(srcnn.loss_sum(_t(params), torch.from_numpy(x), torch.from_numpy(t),
                              relu_gate=gate))
    assert tl == pytest.approx(jl, rel=1e-6)
    _assert_rel(_torch_grads(params, x, t, relu_gate=gate),
                _jax_grads(params, x, t, relu_gate=gate), what=stack)


@pytest.mark.parametrize("gate", [True, False], ids=["gate", "nogate"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_bf16_gradients_within_bf16_envelope_of_jax(stack, gate, monkeypatch):
    """Mixed precision against JAX's mixed precision. Both round the same
    f32 computation to bf16 (2^-8 relative a rounding) at different
    points: torch adds the bias inside the bf16 convolution and reduces
    the bias gradient in f32, JAX adds it after and reduces in bf16. So
    neither equals the other, and each is a bf16 perturbation of the f32
    gradient. The bound: per tensor, relative to its largest f32 entry,
    |port − JAX| ≤ 2·|JAX − f32| + 2^-6, i.e. the port is no further
    from the f32 gradient than JAX's own bf16 gradient is, give or take a
    few bf16 rounding steps (2^-6 = 4 of them) through three layers. And
    each is f32-typed and points the f32 gradient's way.

    That bound holds for an f32 computation too, so the test also shows
    that the port computes in bf16: every convolution of the forward gets
    bf16 operands, and on some tensor the gradient differs from the
    port's own f32 gradient by at least half a bf16 step (2^-9) of that
    tensor's largest entry."""
    c = 1 if stack == "luma" else 3
    params = _params(STACKS[stack], seed=len(stack) + 1)
    x, t = _data(3, c, seed=6)
    g32 = _jax_grads(params, x, t, relu_gate=gate)
    j16 = _jax_grads(params, x, t, relu_gate=gate, compute_dtype=jnp.bfloat16)
    p32 = _torch_grads(params, x, t, relu_gate=gate)
    tp = _t(params, grad=True)
    conv_dtypes = []
    conv2d = torch.nn.functional.conv2d

    def recording_conv2d(inp, weight, *args, **kwargs):
        conv_dtypes.append((inp.dtype, weight.dtype))
        return conv2d(inp, weight, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording_conv2d)
    srcnn.loss_sum(tp, torch.from_numpy(x), torch.from_numpy(t), relu_gate=gate,
                   compute_dtype=torch.bfloat16).backward()
    monkeypatch.undo()
    assert conv_dtypes == [(torch.bfloat16, torch.bfloat16)] * len(params)
    gap = max(float(np.abs(a[k].grad.numpy() - f[k]).max() / np.abs(f[k]).max())
              for a, f in zip(tp, p32) for k in ("w", "b"))
    assert gap >= 2.0 ** -9, gap
    for i, (a, j, f) in enumerate(zip(tp, j16, g32)):
        for k in ("w", "b"):
            g = a[k].grad
            assert g.dtype == torch.float32
            g = g.numpy()
            scale = float(np.abs(f[k]).max())
            bound = 2 * float(np.abs(j[k] - f[k]).max()) + 2.0 ** -6 * scale
            assert float(np.abs(g - j[k]).max()) <= bound, (i, k)
            va, vb = f[k].ravel(), g.ravel()
            cos = float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
            assert cos > 0.99, (i, k, cos)


def test_bf16_grads_match_f32_direction():
    """tests/test_learning_smoke.py's check on its own problem: the bf16
    gradients are f32-typed, point the f32 gradient's way and agree in
    magnitude to bf16's scale."""
    from test_learning_smoke import CFG

    from cnn_sr_tpu_torch.utils.params_io import random_parameters

    cfg = parse_config(CFG)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=3)
    rng = np.random.default_rng(7)
    x = rng.random((2, 20, 20, 1), np.float32)
    t = rng.random((2, 20, 20, 1), np.float32)
    g32 = _torch_grads(params, x, t, relu_gate=False)
    tp = _t(params, grad=True)
    srcnn.loss_sum(tp, torch.from_numpy(x), torch.from_numpy(t), relu_gate=False,
                   compute_dtype=torch.bfloat16).backward()
    for l32, l16 in zip(g32, tp):
        for k in ("w", "b"):
            assert l16[k].grad.dtype == torch.float32
            a, b = l32[k].ravel(), l16[k].grad.numpy().ravel()
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 0.99, (k, cos)
            assert np.linalg.norm(b - a) < 0.05 * np.linalg.norm(a) + 1e-6


def test_relu_backprop_gate_and_model_helpers():
    y = torch.tensor([[-1.0, 2.0], [0.0, -3.0]], requires_grad=True)
    w = torch.tensor([[1.0, 10.0], [100.0, 1000.0]])
    (srcnn.ReluBackpropGate.apply(y) * w).sum().backward()
    assert y.grad.tolist() == [[0.0, 10.0], [0.0, 0.0]]
    assert srcnn.ReluBackpropGate.apply(y.detach()).tolist() == y.tolist()

    params = _params(STACKS["luma"], seed=2)
    x, t = _data(2, 1, seed=3)
    jacts = jsrcnn.forward_activations(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tacts = srcnn.forward_activations(_t(params), torch.from_numpy(x))
    for a, b in zip(tacts, jacts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        srcnn.center_crop(torch.from_numpy(t), 9, 7).numpy(),
        np.asarray(jsrcnn.center_crop(jnp.asarray(t), 9, 7)))
    want = float(jsrcnn.luma_mse_metrics(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                         jnp.asarray(t)))
    got = float(srcnn.luma_mse_metrics(_t(params), torch.from_numpy(x), torch.from_numpy(t)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hidden_relu_gradient_at_zero_matches_jax(dtype):
    """The hidden layers' ReLU passes half the gradient where its input is
    exactly 0, as ``jnp.maximum(y, 0.0)`` does; and a layer stack with zero
    biases and a dead pixel (every input channel 0, so the next layer's
    pre-activation is exactly its zero bias) differentiates as JAX's."""
    y = torch.tensor([-1.0, 0.0, 2.0, 0.0], dtype=dtype, requires_grad=True)
    g = torch.tensor([3.0, 4.0, 5.0, 6.0], dtype=dtype)
    (srcnn.Relu.apply(y) * g).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0.0) * jnp.asarray(g.float().numpy())))(
        jnp.asarray(y.detach().float().numpy()))
    np.testing.assert_array_equal(y.grad.float().numpy(), np.asarray(want))
    assert y.grad.tolist() == [0.0, 2.0, 5.0, 3.0]

    params = _params([(3, 1, 4), (1, 4, 3), (3, 3, 1)], seed=4)
    for layer in params:
        layer["b"][:] = 0.0
    x, t = _data(2, 1, seed=5, hw=12)
    x[:, 4:7, 4:7] = 0.0  # a dead patch: conv1 gives exactly 0 at its centre
    _assert_rel(_torch_grads(params, x, t), _jax_grads(params, x, t))


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_chunked_gradients_equal_unchunked_and_jax(precision):
    params = _params(STACKS["luma"], seed=4)
    x, t = _data(4, 1, seed=4)
    tp, tx, tt = _t(params), torch.from_numpy(x), torch.from_numpy(t)
    one = trainer._grads(tp, tx, tt, 1, precision)
    two = trainer._grads(tp, tx, tt, 2, precision)
    _assert_rel([{k: v.numpy() for k, v in g.items()} for g in two],
                [{k: v.numpy() for k, v in g.items()} for g in one], rel=1e-5 if precision
                is None else 1e-2, what="chunks")
    if precision is None:
        jg = jtrainer._grads(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                             jnp.asarray(t), 2)
        _assert_rel([{k: v.numpy() for k, v in g.items()} for g in two],
                    [{k: np.asarray(v) for k, v in g.items()} for g in jg], what="vs jax")


def _write_pairs(d, n=6, size=16, seed=0, ext="png"):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        large = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        small = large.astype(np.float32)
        small = ((small + np.roll(small, 1, 0) + np.roll(small, 1, 1)) / 3.0).astype(np.uint8)
        Image.fromarray(large, "RGB").save(os.path.join(d, f"s{i}_large.{ext}"))
        Image.fromarray(small, "RGB").save(os.path.join(d, f"s{i}_small.{ext}"))


def test_find_training_samples_same_pairs_and_messages(tmp_path, capsys):
    d = str(tmp_path / "s")
    _write_pairs(d, n=3)
    open(os.path.join(d, "notes.txt"), "w").write("x")
    open(os.path.join(d, "photo.png"), "wb").write(b"")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(os.path.join(d, "lone_large.jpg"))
    os.makedirs(os.path.join(d, "sub_large.png"))
    want = jsamples.find_training_samples(d)
    want_out = capsys.readouterr().out
    got = samples.find_training_samples(d)
    assert got == want and len(got) == 3
    assert capsys.readouterr().out == want_out
    assert "Only 1 image for pair with name 'lone'" in want_out

    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(os.path.join(d, "s0_large.jpg"))
    with pytest.raises(ValueError) as je:
        jsamples.find_training_samples(d)
    with pytest.raises(ValueError) as te:
        samples.find_training_samples(d)
    assert str(te.value) == str(je.value) and "ambiguous sample" in str(te.value)


@pytest.mark.parametrize("kw", [
    {}, {"squared_mean": True}, {"zero_mean_target": True}, {"channels": 3},
    {"channels": 3, "zero_mean_target": True}],
    ids=["luma_native", "luma_squared", "luma_zero_mean", "rgb", "rgb_zero_mean"])
def test_load_sample_set_equals_jax(tmp_path, kw):
    d = str(tmp_path / "s")
    _write_pairs(d, n=4, size=14, seed=1)
    pairs = samples.find_training_samples(d)
    want = jsamples.load_sample_set(pairs, **kw)
    got = samples.load_sample_set(pairs, **kw)
    assert (got.width, got.height, got.count) == (want.width, want.height, want.count)
    np.testing.assert_allclose(got.input_luma, want.input_luma, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.expected_luma, want.expected_luma, rtol=0, atol=1e-6)


def test_load_sample_set_per_image_path_equals_jax(tmp_path, monkeypatch):
    """The path taken where the native library does not build."""
    d = str(tmp_path / "s")
    _write_pairs(d, n=4, size=14, seed=2)
    pairs = samples.find_training_samples(d)
    monkeypatch.setattr(jsamples, "_load_sample_set_native", lambda pairs: None)
    monkeypatch.setattr(samples, "_load_sample_set_native", lambda pairs: None)
    want = jsamples.load_sample_set(pairs)
    got = samples.load_sample_set(pairs)
    np.testing.assert_allclose(got.input_luma, want.input_luma, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.expected_luma, want.expected_luma)
    with pytest.raises(ValueError, match="no training samples"):
        samples.load_sample_set([])


def test_divide_samples_equal_for_the_same_generator():
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        for x, y in zip(samples.divide_samples(11, 2, a), jsamples.divide_samples(11, 2, b)):
            np.testing.assert_array_equal(x, y)


def _run_both(raw, data, epochs, **kw):
    """Train the same state on the same samples in both packages; returns
    (jax state, port state, jax logs, port logs, jax (epoch, err), port's)."""
    x, t = data
    hw = x.shape[1]
    runs = []
    for parse, mod, smod, extra in ((jparse_config, jtrainer, jsamples, {}),
                                    (parse_config, trainer, samples, {"device": "cpu"})):
        cfg = parse(raw)
        state = mod.init_train_state(cfg, seed=1)
        logs, errs = [], []
        error = mod.train_loop(cfg, smod.SampleSet(x, t, hw, hw), state, epochs,
                               log=logs.append, on_epoch=lambda e, v: errs.append((e, v)),
                               **kw, **extra)
        runs.append((error, state, logs, errs))
    return runs


def _numbers_out(lines):
    return [re.sub(r"[-+0-9.e]+(inf|nan)?", "#", line) for line in lines]


@pytest.mark.parametrize("raw,k", [(LUMA, 1), (LUMA, 3), (RGB, 3)],
                         ids=["luma_per_epoch", "luma_k3", "rgb_k3"])
def test_train_loop_matches_jax(raw, k):
    c = raw.get("channels", 1)
    (je, js, jl, jerrs), (te, ts, tl, terrs) = _run_both(
        raw, _data(10, c, seed=7), 5, mini_batch_count=2, validation_cadence=2,
        epochs_per_dispatch=k, seed=3)
    assert not je and not te and js.epochs == ts.epochs == 5
    _assert_rel(ts.params, js.params, what="params")
    _assert_rel(ts.prev_delta, js.prev_delta, what="prev_delta")
    assert [e for e, _ in terrs] == [e for e, _ in jerrs] == list(range(5))
    assert [v is None for _, v in terrs] == [v is None for _, v in jerrs]
    np.testing.assert_allclose([v for _, v in terrs if v is not None],
                               [v for _, v in jerrs if v is not None], rtol=F32_REL)
    assert _numbers_out(tl) == _numbers_out(jl) and tl[0] == jl[0]


@pytest.mark.parametrize("k", [1, 5])
def test_nan_abort_both_dispatch_paths(k):
    raw = {**LUMA, "learning_rates": [1e6] * 3}
    (je, js, jl, _), (te, ts, tl, _) = _run_both(
        raw, _data(6, 1, seed=8, hw=20), 20, validation_cadence=1, epochs_per_dispatch=k,
        seed=0)
    assert je and te and ts.epochs == js.epochs
    assert tl[-1] == jl[-1] and tl[-1].startswith("Error: squared error is NAN/Inf, after ")


@pytest.mark.parametrize("k", [1, 3])
def test_zero_validation_percent_both_dispatch_paths(k):
    (je, js, jl, jerrs), (te, ts, tl, terrs) = _run_both(
        LUMA, _data(4, 1, seed=9, hw=20), 5, validation_percent=0, epochs_per_dispatch=k,
        seed=0)
    assert not te and ts.epochs == 5 and tl == jl == ["[WARNING] Validation set is empty"]
    assert terrs == jerrs == [(e, None) for e in range(5)]
    _assert_rel(ts.params, js.params)


def test_init_train_state_from_a_parameters_file(tmp_path, capsys):
    cfg = parse_config(LUMA)
    state = trainer.init_train_state(cfg, seed=5)
    jstate = jtrainer.init_train_state(jparse_config(LUMA), seed=5)
    for a, b in zip(state.params + state.prev_delta, jstate.params + jstate.prev_delta):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])
    pfile = str(tmp_path / "p.json")
    save_parameters_file(pfile, state.params, epochs=123)
    state2 = trainer.init_train_state(parse_config({**LUMA, "parameters_file": pfile}))
    assert state2.epochs == 123
    for a, b, p in zip(state.params, state2.params, state2.prev_delta):
        np.testing.assert_array_equal(a["w"], b["w"])
        assert not p["w"].any() and not p["b"].any() and p["w"].shape == a["w"].shape
    trainer.init_train_state(parse_config({**LUMA, "parameters_file": str(tmp_path / "no")}))
    assert "not found, using random initialization" in capsys.readouterr().out


def test_training_lowers_the_validation_error(tmp_path):
    """The counterpart of tests/test_learning_smoke.py and
    test_training.py's learning check: real files through the loader, 30
    epochs, validation every epoch, in f32 and in bf16."""
    d = str(tmp_path / "s")
    _write_pairs(d, n=6, size=14, seed=1)
    raw = {"n1": 8, "n2": 4, "f1": 3, "f2": 1, "f3": 3, "momentum": 0.9,
           "weight_decay_parameter": 0.0, "learning_rates": [0.01, 0.01, 0.001],
           **{f"parameters_distribution_{i}": {**DIST, "std_deviation_w": 0.1,
                                               "std_deviation_b": 0.0} for i in (1, 2, 3)}}
    data = samples.load_sample_set(samples.find_training_samples(d))
    for precision in (None, "bf16"):
        state = trainer.init_train_state(parse_config(raw), seed=0)
        errs = []
        error = trainer.train_loop(parse_config(raw), data, state, 30, validation_cadence=1,
                                   seed=0, precision=precision, device="cpu",
                                   log=lambda *a: None,
                                   on_epoch=lambda e, v: errs.append(v))
        assert not error and state.epochs == 30 and len(errs) == 30
        assert errs[-1] < errs[0] * 0.8, (precision, errs[0], errs[-1])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_config(LUMA)
    x, t = _data(2, 1, seed=0, hw=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train_loop(cfg, samples.SampleSet(x, t, 20, 20),
                           trainer.init_train_state(cfg, seed=0), 1)
    with pytest.raises(ValueError, match="unknown training precision"):
        with srcnn.conv_precision("fast"):
            pass


def test_precision_names_map_to_tf32_flags():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    for name, tf32 in ((None, False), ("highest", False), ("bf16", False),
                       ("high", True), ("default", True)):
        with srcnn.conv_precision(name):
            assert torch.backends.cudnn.allow_tf32 is tf32
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_training_modules_import_neither_jax_nor_the_jax_package(tmp_path):
    """The new modules, with ``jax`` and ``cnn_sr_tpu`` blocked in
    ``sys.modules``: a short run from sample files to a parameters file."""
    d = str(tmp_path / "s")
    _write_pairs(d, n=5, size=14, seed=3)
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "cnn_sr_tpu", "PIL"):
            sys.modules[name] = None
        import cnn_sr_tpu_torch.native, cnn_sr_tpu_torch.ops.image
        import cnn_sr_tpu_torch.optim, cnn_sr_tpu_torch.utils.metrics
        import cnn_sr_tpu_torch.training.checkpoint
        from cnn_sr_tpu_torch import cli
        rc = cli.main(["train", "-c", "configs/srcnn_9-1-5.json", "-i", {d!r}, "-e", "2",
                       "-o", {str(tmp_path / "p.json")!r}, "--device", "cpu", "--seed", "0",
                       "--full-state", "--no-packed-io"])
        assert rc == 0, rc
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                     "cnn_sr_tpu", "PIL") and sys.modules[m] is not None)
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.path.isfile(str(tmp_path / "p.json.state.npz"))
