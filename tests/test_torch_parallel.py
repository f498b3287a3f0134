"""Port parity: ``cnn_sr_tpu_torch.parallel`` (the mesh, data-parallel
training, halo-exchange spatial sharding) and ``api.upscale_image_spatial``
against the JAX package's ``cnn_sr_tpu.parallel`` and its
``upscale_image_spatial``, on the CPU: the cases of
``tests/test_parallel.py`` but its two ``__graft_entry__`` ones.

JAX runs on ``tests/conftest.py``'s eight virtual CPU devices; the port's
meshes name the CPU device several times, which is what its virtual
devices are. Tolerances are ``tests/test_parallel.py``'s: the sharded
forward within 1e-5 (the fused plain route within 1e-4), the
data-parallel parameters within rtol 1e-5, atol 1e-6 (the replicas' sums
are added in another order), the uint8 pipelines within ±1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cnn_sr_tpu import api as japi
from cnn_sr_tpu.models import forward as jforward
from cnn_sr_tpu.parallel.mesh import make_mesh as jmake_mesh
from cnn_sr_tpu.parallel.spatial import sharded_forward as jsharded_forward
from cnn_sr_tpu.training import trainer as jtrainer
from cnn_sr_tpu.training.samples import SampleSet as JSampleSet
from cnn_sr_tpu.utils.config import parse_config as jparse_config
from cnn_sr_tpu_torch import api
from cnn_sr_tpu_torch.models.srcnn import forward
from cnn_sr_tpu_torch.parallel import (
    all_reduce_grads,
    available_devices,
    make_mesh,
    replicate,
    shard_batch,
    sharded_forward,
)
from cnn_sr_tpu_torch.training import trainer
from cnn_sr_tpu_torch.training.samples import SampleSet
from cnn_sr_tpu_torch.utils.config import parse_config
from cnn_sr_tpu_torch.utils.params_io import params_to_torch, random_parameters

from test_parallel import CFG
from test_torch_bf16 import LUMA_CFG

CPU = torch.device("cpu")
DIST = {"mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.0}
LUMA = {"n1": 6, "n2": 4, "f1": 5, "f2": 3, "f3": 3, "momentum": 0.9,
        "weight_decay_parameter": 0.0, "learning_rates": [1e-3] * 3,
        **{f"parameters_distribution_{i}": DIST for i in (1, 2, 3)}}
RGB = {"channels": 3, "layers": [{"n": 8, "f": 3}, {"n": 8, "f": 3}, {"n": 3, "f": 3}],
       "momentum": 0.9, "weight_decay_parameter": 0.0, "learning_rates": [1e-3] * 3,
       "parameters_distribution": DIST}


def _cpu_mesh(n_data=1, n_spatial=1):
    return make_mesh(n_data, n_spatial, devices=[CPU] * (n_data * n_spatial))


def _np(layers):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in layers]


def _state(cfg, seed=0):
    """(params, prev_delta) of ``init_train_state`` as numpy lists."""
    state = trainer.init_train_state(cfg, seed=seed)
    return state.params, state.prev_delta


def _copy(layers):
    """The layer list as torch tensors that own their memory
    (``params_to_torch`` may share the numpy arrays')."""
    return [{k: torch.tensor(v) for k, v in layer.items()} for layer in layers]


def _close(got, want, rtol=1e-5, atol=1e-6):
    for a, b in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=rtol,
                                       atol=atol)


def _max_diff(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


# ---- the mesh ----

def test_mesh_construction():
    mesh = make_mesh(n_data=4, n_spatial=2, devices=available_devices("cpu")[:8])
    assert mesh.shape == {"data": 4, "spatial": 2}
    assert mesh.shape == jmake_mesh(n_data=4, n_spatial=2, devices=jax.devices()).shape
    assert mesh.data_devices == [CPU] * 4 and mesh.spatial_devices == [CPU] * 2
    with pytest.raises(ValueError):
        make_mesh(n_data=16, n_spatial=1, devices=[CPU] * 8)
    assert make_mesh(n_spatial=2, devices=[CPU] * 7).shape == {"data": 3, "spatial": 2}


def test_no_card_no_cuda_mesh(monkeypatch):
    """The default devices are the cards; without one that fails and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        available_devices("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(n_data=1)
    assert len(available_devices("cpu")) >= 1


def test_replicate_shares_a_repeated_device_and_shard_batch_splits():
    params = params_to_torch(_state(parse_config(CFG))[0], CPU)
    copies = replicate(_cpu_mesh(4), params)
    assert list(copies) == [CPU]
    assert all(a["w"] is b["w"] for a, b in zip(copies[CPU], params))
    t = torch.arange(8.0)
    parts = shard_batch(_cpu_mesh(4), t)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert shard_batch(_cpu_mesh(4), parts) is parts
    with pytest.raises(ValueError, match="divide"):
        shard_batch(_cpu_mesh(3), t)
    summed = all_reduce_grads(_cpu_mesh(4), [[{"w": p}] for p in parts])
    assert summed[0]["w"].tolist() == [12.0, 16.0]


# ---- data-parallel training ----

@pytest.mark.parametrize("precision", [None, "bf16"])
def test_data_parallel_step_matches_single_device_and_jax(precision):
    """n replicas add their gradients in the order in which one device adds
    n chunks, so a mesh of n matches the single step in n chunks, in f32
    and in bf16 (bf16 rounds each chunk's convolutions apart: about 3e-3
    of the largest gradient from the unchunked step); in f32 the mesh also
    matches the unchunked step and JAX's ``make_train_step(cfg,
    mesh=make_mesh(n_data=8))``. All within tests/test_parallel.py's
    tolerance."""
    cfg = parse_config(CFG)
    rng = np.random.default_rng(0)
    inputs = rng.standard_normal((8, 12, 12, 1)).astype(np.float32)
    gts = rng.uniform(0, 1, (8, 12, 12, 1)).astype(np.float32)
    p0, d0 = _state(cfg)

    def run(mesh, chunks):
        # copies: the step updates its tensors in place
        p, d = _copy(p0), _copy(d0)
        step = trainer.make_train_step(cfg, chunks, precision, mesh=mesh)
        return step(p, d, torch.from_numpy(inputs), torch.from_numpy(gts))

    p_mesh, d_mesh = run(_cpu_mesh(8), 1)
    for n, chunks in ((8, 1), (2, 1), (2, 2)):
        p_single, d_single = run(None, n * chunks)
        p_n, d_n = run(_cpu_mesh(n), chunks)
        _close(p_n, p_single)
        _close(d_n, d_single)
    if precision is None:
        p_single, d_single = run(None, 1)
        _close(p_mesh, p_single)
        _close(d_mesh, d_single)
        jcfg = jparse_config(CFG)
        jmesh = jmake_mesh(n_data=8, devices=jax.devices())
        jp, jd = jtrainer.make_train_step(jcfg, mesh=jmesh)(
            jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, d0), inputs, gts)
        _close(p_mesh, _np(jp))
        _close(d_mesh, _np(jd))


def test_data_parallel_validation_sums_the_replicas():
    cfg = parse_config(CFG)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 12, 12, 1)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0, 1, (6, 12, 12, 1)).astype(np.float32))
    params = params_to_torch(_state(cfg)[0], CPU)
    single = float(trainer.make_validation_fn()(params, x, t))
    for n in (2, 3):
        got = float(trainer.make_validation_fn(_cpu_mesh(n))(params, x, t))
        assert got == pytest.approx(single, rel=1e-6)


@pytest.mark.parametrize("k", [1, 3])
def test_scanned_dispatch_over_mesh_matches_single_and_jax(k):
    """Both dispatch paths over a 2-replica mesh against the single path
    and against JAX's ``train_loop(mesh=…)`` (10 samples: 8 train, 2
    validation, both split over the replicas)."""
    cfg, jcfg = parse_config(CFG), jparse_config(CFG)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((10, 12, 12, 1)).astype(np.float32)
    t = rng.uniform(0, 1, (10, 12, 12, 1)).astype(np.float32)
    kw = dict(epochs=6, validation_cadence=2, seed=5, epochs_per_dispatch=k,
              mini_batch_count=2)
    errs = {}

    def run(name, mod, samples, **extra):
        state = mod.init_train_state(cfg if mod is trainer else jcfg, seed=4)
        errs[name] = []
        assert not mod.train_loop(cfg if mod is trainer else jcfg, samples, state, **kw,
                                  log=lambda *a: None,
                                  on_epoch=lambda e, v, n=name: errs[n].append(v), **extra)
        return state

    single = run("single", trainer, SampleSet(x, t, 12, 12), device="cpu")
    meshed = run("mesh", trainer, SampleSet(x, t, 12, 12), mesh=_cpu_mesh(2))
    jaxed = run("jax", jtrainer, JSampleSet(x, t, 12, 12),
                mesh=jmake_mesh(n_data=2, devices=jax.devices()))
    assert single.epochs == meshed.epochs == jaxed.epochs == 6
    for other in (single, jaxed):
        _close(meshed.params, other.params)
        _close(meshed.prev_delta, other.prev_delta)
    for other in ("single", "jax"):
        assert [v is None for v in errs["mesh"]] == [v is None for v in errs[other]]
        np.testing.assert_allclose([v for v in errs["mesh"] if v is not None],
                                   [v for v in errs[other] if v is not None], rtol=1e-5)


def test_train_loop_mesh_refusals():
    cfg = parse_config(CFG)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 12, 12, 1)).astype(np.float32)
    samples = SampleSet(x, x, 12, 12)
    state = trainer.init_train_state(cfg, seed=0)
    # train 4 / validation 1: the validation split does not divide by 2
    with pytest.raises(ValueError, match="divide"):
        trainer.train_loop(cfg, samples, state, 1, mesh=_cpu_mesh(2), log=lambda *a: None)
    with pytest.raises(ValueError, match="first device"):
        trainer.train_loop(cfg, samples, state, 1, mesh=make_mesh(1, devices=["meta"]),
                           device="cpu", log=lambda *a: None)


# ---- spatial sharding ----

def _luma_params(seed=1):
    return _state(parse_config(CFG), seed)[0]


def _rgb_params():
    rng = np.random.default_rng(12)
    return [{"w": (rng.standard_normal((3, 3, 3, 8)) * 0.1).astype(np.float32),
             "b": np.zeros(8, np.float32)},
            {"w": (rng.standard_normal((3, 3, 8, 3)) * 0.1).astype(np.float32),
             "b": np.zeros(3, np.float32)}]


@pytest.mark.parametrize("n_spatial", [2, 4])
@pytest.mark.parametrize("kind", ["luma", "rgb"])
def test_spatial_sharded_forward_matches_unsharded_and_jax(kind, n_spatial):
    params = _luma_params() if kind == "luma" else _rgb_params()
    c = 1 if kind == "luma" else 3
    rng = np.random.default_rng(2)
    # shrink 4; H divisible by n_spatial, shard height >= shrink
    x = rng.standard_normal((1, 8 * n_spatial, 20, c)).astype(np.float32)
    tp = params_to_torch(params, CPU)
    got = sharded_forward(_cpu_mesh(1, n_spatial), tp, torch.from_numpy(x)).numpy()
    want = forward(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 8 * n_spatial - 4, 16, c)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jmesh = jmake_mesh(n_data=1, n_spatial=n_spatial, devices=jax.devices())
    jgot = np.asarray(jsharded_forward(jmesh, jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(x)))
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(jgot, np.asarray(jforward(jax.tree.map(jnp.asarray, params),
                                                         jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_spatial_sharding_validates_shapes():
    params = params_to_torch(_luma_params(), CPU)
    mesh = _cpu_mesh(1, 4)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_forward(mesh, params, torch.zeros((1, 30, 20, 1)))  # 30 % 4 != 0
    with pytest.raises(ValueError, match="smaller than"):
        sharded_forward(mesh, params, torch.zeros((1, 8, 20, 1)))  # shard < shrink


def test_spatial_sharded_fused_forward():
    """Halo-exchange sharding composed with the kernel route (its plain
    version on the CPU) against JAX's with the fused Pallas path in
    interpret mode (``tile_h=16, tile_w=128, dtype=f32``)."""
    from cnn_sr_tpu.ops.pallas_fused import fused_forward as jfused_forward
    from cnn_sr_tpu_torch.ops.fused import fused_forward

    rng = np.random.default_rng(13)
    params = [{"w": (rng.standard_normal(s) * 0.1).astype(np.float32),
               "b": np.zeros(s[-1], np.float32)}
              for s in ((5, 5, 1, 8), (3, 3, 8, 8), (3, 3, 8, 1))]
    x = rng.standard_normal((1, 80, 150, 1)).astype(np.float32)
    got = sharded_forward(_cpu_mesh(1, 2), params_to_torch(params, CPU), torch.from_numpy(x),
                          forward_fn=fused_forward).numpy()
    want = np.asarray(jsharded_forward(
        jmake_mesh(n_data=1, n_spatial=2, devices=jax.devices()),
        jax.tree.map(jnp.asarray, params), jnp.asarray(x),
        forward_fn=lambda p, a: jfused_forward(p, a, tile_h=16, tile_w=128,
                                               dtype=jnp.float32)))
    assert got.shape == want.shape == (1, 72, 142, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("raw,shape,n", [(RGB, (30, 40, 4), 4), (LUMA, (32, 44, 4), 2)],
                         ids=["rgb_pad", "luma"])
def test_upscale_image_spatial_matches_single_and_jax(raw, shape, n):
    """Both model families, the RGB one with the bottom-pad path (30 rows
    over 4 shards), against the port's ``upscale_image`` and JAX's
    ``upscale_image_spatial``: ±1 uint8."""
    cfg, jcfg = parse_config(raw), jparse_config(raw)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=3)
    rgba = np.random.default_rng(21).integers(0, 256, shape, dtype=np.uint8)
    tp = params_to_torch(params, CPU)
    got = api.upscale_image_spatial(cfg, tp, rgba, n)
    assert got.shape == shape[:2] + (3,) and got.dtype == np.uint8
    assert _max_diff(got, api.upscale_image(cfg, tp, rgba)) <= 1
    assert _max_diff(got, japi.upscale_image_spatial(jcfg, params, rgba, n)) <= 1
    # a device list naming the CPU as often as there are shards
    np.testing.assert_array_equal(api.upscale_image_spatial(cfg, tp, rgba, n, devices=[CPU] * n),
                                  got)


def test_upscale_image_spatial_bf16_matches_single_and_jax():
    """``precision="bf16"`` through the same entry: each band in the bf16
    stream with the int8 first layer (its plain version here), against
    the port's unsharded bf16 request and JAX's ``use_pallas=True`` spatial
    request (its bf16 stream in interpret mode): ±1 uint8."""
    cfg, jcfg = parse_config(LUMA_CFG), jparse_config(LUMA_CFG)
    params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=2)
    rgba = np.random.default_rng(5).integers(0, 256, (50, 56, 4), dtype=np.uint8)
    tp = params_to_torch(params, CPU)
    got = api.upscale_image_spatial(cfg, tp, rgba, 2, precision="bf16")
    assert _max_diff(got, api.upscale_image(cfg, tp, rgba, precision="bf16")) <= 1
    want = japi.upscale_image_spatial(jcfg, params, rgba, 2, use_pallas=True)
    assert _max_diff(got, want) <= 1


def test_upscale_image_spatial_errors():
    """JAX's three errors: too many shards, an image inside the receptive
    field, a shard lower than the stack's shrink."""
    cfg = parse_config(LUMA)
    tp = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, seed=0), CPU)
    img = np.zeros((40, 40, 4), np.uint8)
    with pytest.raises(ValueError, match="devices"):
        api.upscale_image_spatial(cfg, tp, img, 3, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="receptive field"):
        api.upscale_image_spatial(cfg, tp, np.zeros((8, 40, 4), np.uint8), 2)
    with pytest.raises(ValueError, match="shard height"):
        api.upscale_image_spatial(cfg, tp, img, 8, devices=[CPU] * 8)


def test_parallel_modules_import_neither_jax_nor_the_jax_package():
    """With ``jax`` and ``cnn_sr_tpu`` blocked in ``sys.modules``: a sharded
    request and a data-parallel step."""
    import os
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "cnn_sr_tpu"):
            sys.modules[name] = None
        import numpy as np, torch
        from cnn_sr_tpu_torch import api, parallel
        from cnn_sr_tpu_torch.training import trainer
        from cnn_sr_tpu_torch.utils.config import read_config
        from cnn_sr_tpu_torch.utils.params_io import init_params, params_to_torch
        cfg = read_config("configs/srcnn_9-1-5.json")
        params = params_to_torch(init_params(cfg, seed=0)[0], "cpu")
        rgba = np.random.default_rng(0).integers(0, 256, (40, 30, 4), dtype=np.uint8)
        out = api.upscale_image_spatial(cfg, params, rgba, 2)
        assert out.shape == (40, 30, 3), out.shape
        mesh = parallel.make_mesh(2, devices=["cpu", "cpu"])
        x = torch.zeros((4, 20, 20, 1))
        prev = params_to_torch(trainer.init_train_state(cfg, seed=0).prev_delta, "cpu")
        trainer.make_train_step(cfg, mesh=mesh)(params, prev, x, x)
        assert not parallel.initialize_multihost()
    """)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "RANK", "WORLD_SIZE")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
