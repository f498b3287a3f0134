"""The port's HTTP server (``cnn_sr_tpu_torch.serve``) on the CPU: the
counterparts of ``tests/test_serve_slo.py`` (admission control, deadlines,
the stall flag) and of the serve tests of ``tests/test_serve_and_evaluate.py``
(round trip, model slots, the batching queue for luma and RGB, the body
limit, the spatial latency mode). The SLO tests drive the
admission and deadline paths deterministically by seeding the worker's
EWMA and dispatch markers (the real signals are timing-based)."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from cnn_sr_tpu_torch import api, serve
from cnn_sr_tpu_torch.utils.config import parse_config
from cnn_sr_tpu_torch.utils.params_io import params_to_torch, random_parameters

CFG = {
    "n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3,
    "momentum": 0.9, "weight_decay_parameter": 0.0,
    "learning_rates": [0.01, 0.01, 0.001],
    **{
        f"parameters_distribution_{i}": {
            "mean_w": 0.0, "mean_b": 0.0,
            "std_deviation_w": 0.05, "std_deviation_b": 0.0,
        }
        for i in (1, 2, 3)
    },
}


@pytest.fixture
def cfg_path(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(CFG))
    return str(p)


def _slot(path, seed=0):
    return serve.load_slot(path, seed=seed, device="cpu")


def _make_worker(cfg_path, **kw):
    return serve.DeviceWorker({"default": _slot(cfg_path)}, **kw)


def _job():
    return serve._Job("default", np.zeros((20, 20, 4), np.uint8))


def _start_server(cfg_path, **kw):
    slots = {"default": _slot(cfg_path)}
    for name, path in kw.pop("extra_slots", {}).items():
        slots[name] = _slot(path, seed=1)
    server, worker = serve.make_server(slots, "127.0.0.1", 0, **kw)
    worker.start()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, worker, server.server_address[1]


def _png_bytes(img):
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, "PNG")
    return buf.getvalue()


def _post_upscale(port, body, query=""):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/upscale{query}", data=body, method="POST")
    with urllib.request.urlopen(req) as r:
        return np.asarray(Image.open(io.BytesIO(r.read())))


def _post_all(port, imgs):
    """Post ``imgs`` concurrently; returns the replies in order."""
    outs, errs = [None] * len(imgs), []

    def post(i):
        try:
            outs[i] = _post_upscale(port, _png_bytes(imgs[i]))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs
    assert all(out is not None for out in outs), "a post thread timed out"
    return outs


# ---- the SLO policy (tests/test_serve_slo.py) ----

def test_queue_bound_rejects_429(cfg_path):
    worker = _make_worker(cfg_path, max_queue=1)  # worker not started
    worker.submit(_job())  # fills the queue
    with pytest.raises(serve.Rejected) as e:
        worker.submit(_job())
    assert e.value.code == 429
    assert worker.snapshot()["rejected_queue_full"] == 1


def test_load_shed_rejects_503_with_retry_after(cfg_path):
    worker = _make_worker(cfg_path, deadline_s=1.0)
    worker._ewma_job_s = 10.0  # one queued job -> est wait 10 s > 1 s
    worker.submit(_job())
    with pytest.raises(serve.Rejected) as e:
        worker.submit(_job())
    assert e.value.code == 503
    assert e.value.retry_after_s > 0
    assert worker.snapshot()["rejected_load"] == 1


def test_cold_start_never_sheds(cfg_path):
    # the EWMA is None until the first round completes: the first
    # requests are admitted whatever the deadline or the queue depth
    worker = _make_worker(cfg_path, deadline_s=0.001)
    for _ in range(5):
        worker.submit(_job())
    assert worker.snapshot()["rejected_load"] == 0


def test_deadline_exceeded_at_dequeue(cfg_path):
    worker = _make_worker(cfg_path, deadline_s=0.5)
    job = _job()
    worker.submit(job)
    job.t_submit -= 10.0  # it "sat queued" past the deadline
    worker.start()
    try:
        assert job.done.wait(30)
        assert isinstance(job.error, serve.DeadlineExceeded)
        assert worker.snapshot()["rejected_deadline"] == 1
    finally:
        worker.stop()


def test_stats_stall_indicator(cfg_path):
    worker = _make_worker(cfg_path)
    snap = worker.snapshot()
    assert snap["stalled"] is False and snap["ewma_job_s"] is None
    worker._ewma_job_s = 0.05
    worker._dispatch_started = time.monotonic() - 100.0
    snap = worker.snapshot()
    assert snap["stalled"] is True
    assert snap["dispatch_elapsed_s"] > 99
    # the in-flight stall also inflates the admission estimate
    assert snap["est_wait_s"] > 99


def test_http_503_shed_and_headers(cfg_path):
    """An overloaded server answers 503 + Retry-After at once, and /stats
    reports the SLO fields."""
    server, worker, port = _start_server(cfg_path, deadline_s=1.0)
    try:
        # a stalled in-flight dispatch (the worker thread is idle; the
        # marker is what admission control reads)
        worker._ewma_job_s = 50.0
        worker._dispatch_started = time.monotonic()
        img = np.random.default_rng(0).integers(0, 256, (20, 20, 3), dtype=np.uint8)
        body = _png_bytes(img)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/upscale", data=body,
                                     method="POST")
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 503
        assert int(e.value.headers["Retry-After"]) >= 1
        assert time.monotonic() - t0 < 5  # fast rejection, no blocking
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats") as r:
            stats = json.load(r)
        assert stats["rejected_load"] == 1
        assert stats["deadline_s"] == 1.0
        # the stall clears -> the same request is admitted and served
        worker._dispatch_started = None
        worker._ewma_job_s = 0.01
        assert _post_upscale(port, body).shape == (20, 20, 3)
    finally:
        server.shutdown()
        worker.stop()


# ---- serving (tests/test_serve_and_evaluate.py) ----

def test_serve_upscale_roundtrip(cfg_path):
    server, worker, port = _start_server(cfg_path)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert r.read() == b"ok\n"
        img = np.random.default_rng(0).integers(0, 256, (20, 24, 3), dtype=np.uint8)
        out = _post_upscale(port, _png_bytes(img))
        assert out.shape == (20, 24, 3)
        np.testing.assert_array_equal(out[0, 0], img[0, 0])  # border passthrough
        # the reply is the API's bucketed single-image result
        cfg = parse_config(CFG)
        params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 0),
                                 "cpu")
        rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
        np.testing.assert_array_equal(out, api.upscale_image(cfg, params, rgba, bucket=64))
        # garbage body -> a clean 400
        req = urllib.request.Request(f"http://127.0.0.1:{port}/upscale",
                                     data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 400
    finally:
        server.shutdown()
        worker.stop()


def test_serve_model_slots_and_stats(cfg_path, tmp_path):
    p2 = tmp_path / "cfg2.json"
    p2.write_text(json.dumps(dict(CFG, n1=2, f1=5)))
    server, worker, port = _start_server(cfg_path, extra_slots={"alt": str(p2)})
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/models") as r:
            models = json.load(r)["models"]
        assert set(models) == {"default", "alt"}
        assert models["alt"]["layers"][0]["f"] == 5
        img = np.random.default_rng(1).integers(0, 256, (24, 24, 3), dtype=np.uint8)
        assert _post_upscale(port, _png_bytes(img), query="?model=alt").shape == (24, 24, 3)
        # unknown model -> 404 listing the slots; unknown path -> 404
        req = urllib.request.Request(f"http://127.0.0.1:{port}/upscale?model=nope",
                                     data=_png_bytes(img), method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 404
        assert json.loads(exc.value.read())["models"] == ["alt", "default"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nowhere")
        assert exc.value.code == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats") as r:
            stats = json.load(r)
        assert stats["ok"] >= 1 and stats["per_model"]["alt"] >= 1
    finally:
        server.shutdown()
        worker.stop()


def test_serve_batching_queue(cfg_path):
    # a long batch window and concurrent same-shape posts -> one batch;
    # max_batch == the post count, so the round closes as soon as all
    # four arrive (the window is an upper bound, not a sleep)
    server, worker, port = _start_server(cfg_path, batch_wait_ms=2000.0, max_batch=4)
    try:
        rng = np.random.default_rng(2)
        imgs = [rng.integers(0, 256, (20, 20, 3), dtype=np.uint8) for _ in range(4)]
        for img, out in zip(imgs, _post_all(port, imgs)):
            assert out.shape == (20, 20, 3)
            np.testing.assert_array_equal(out[0, 0], img[0, 0])
        stats = worker.snapshot()
        assert stats["ok"] == 4
        assert stats["batched_jobs"] >= 2  # at least one batch ran
    finally:
        server.shutdown()
        worker.stop()


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_serve_batching_queue_rgb(tmp_path, precision):
    """RGB models batch too: one ``upscale_batch`` per same-shape group,
    outputs identical to the single-image path; within ±1 of the JAX
    package's single-image path in f32."""
    from cnn_sr_tpu.api import upscale_image as jupscale_image
    from cnn_sr_tpu.utils.config import parse_config as jparse_config

    rgb_cfg = dict(CFG, channels=3)
    p = tmp_path / "rgb.json"
    p.write_text(json.dumps(rgb_cfg))
    server, worker, port = _start_server(str(p), batch_wait_ms=2000.0, max_batch=3,
                                         precision=precision)
    try:
        rng = np.random.default_rng(5)
        imgs = [rng.integers(0, 256, (22, 26, 3), dtype=np.uint8) for _ in range(3)]
        outs = _post_all(port, imgs)
        stats = worker.snapshot()
        assert stats["ok"] == 3
        assert stats["batched_jobs"] >= 2, "RGB group did not batch"
        cfg = parse_config(rgb_cfg)
        params = random_parameters(cfg.layer_specs(), cfg.distributions, seed=0)
        for img, out in zip(imgs, outs):
            rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
            np.testing.assert_array_equal(
                out, api.upscale_image(cfg, params_to_torch(params, "cpu"), rgba,
                                       precision=precision))
            if precision == "f32":
                want = jupscale_image(jparse_config(rgb_cfg), params, rgba)
                assert int(np.abs(out.astype(int) - want.astype(int)).max()) <= 1
    finally:
        server.shutdown()
        worker.stop()


def test_serve_rejects_oversized_body(cfg_path):
    server, worker, port = _start_server(cfg_path)
    worker.max_body_bytes = 1024  # shrink the limit for the test
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/upscale", data=b"x" * 2048,
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 413
    finally:
        worker.stop()
        server.shutdown()


def test_serve_scale_pre_upscales(cfg_path):
    """``--scale 2``: every request is bicubic-upscaled on the device
    before the net, as ``ops.resize.upscale_rgba`` does it."""
    import torch

    from cnn_sr_tpu_torch.ops.resize import upscale_rgba

    server, worker, port = _start_server(cfg_path, scale=2.0)
    try:
        img = np.random.default_rng(3).integers(0, 256, (12, 14, 3), dtype=np.uint8)
        out = _post_upscale(port, _png_bytes(img))
        rgba = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
        big = upscale_rgba(torch.from_numpy(rgba), 2.0).numpy()
        cfg = parse_config(CFG)
        params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, 0),
                                 "cpu")
        np.testing.assert_array_equal(out, api.upscale_image(cfg, params, big, bucket=64))
    finally:
        worker.stop()
        server.shutdown()


def test_serve_spatial_shard_mode(cfg_path):
    """``spatial_shard=4``, the latency mode (tests/test_serve_and_evaluate.py
    ``test_serve_spatial_shard_mode``): each request alone, its rows over
    four bands (the CPU named four times); the reply within ±1 uint8 of the
    single-device server's, and nothing batched."""
    img = np.random.default_rng(5).integers(0, 256, (32, 28, 3), dtype=np.uint8)
    body = _png_bytes(img)
    server, worker, port = _start_server(cfg_path)
    try:
        ref = _post_upscale(port, body)
    finally:
        worker.stop()
        server.shutdown()
    server, worker, port = _start_server(cfg_path, spatial_shard=4, batch_wait_ms=500.0,
                                         max_batch=4)
    try:
        outs = _post_all(port, [img] * 3)
        stats = worker.snapshot()
    finally:
        worker.stop()
        server.shutdown()
    for out in outs:
        assert out.shape == ref.shape
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert stats["ok"] == 3 and stats["batched_jobs"] == 0


def test_main_builds_a_spatial_server(cfg_path, monkeypatch, capsys):
    """``serve.main([... "--spatial-shard", "2"])`` builds the server and its
    worker in the latency mode (``serve_forever`` returns at once here)."""
    built = []
    monkeypatch.setattr(serve.ThreadingHTTPServer, "serve_forever", lambda self: None)
    real = serve.make_server

    def spy(*args, **kw):
        built.append(real(*args, **kw))
        return built[-1]

    monkeypatch.setattr(serve, "make_server", spy)
    assert serve.main(["-c", cfg_path, "--device", "cpu", "--port", "0",
                       "--spatial-shard", "2"]) == 0
    assert built[0][1].spatial_shard == 2
    assert "listening on" in capsys.readouterr().out


def test_main_refuses_cuda_without_a_card(cfg_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        serve.main(["-c", cfg_path])
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("flags,precision", [
    (["--pallas"], "bf16"),
    (["--pallas", "--pallas-precision", "f32"], "f32"),
    (["--pallas-precision", "bf16"], "f32"),
    ([], "f32"),
])
def test_main_maps_the_jax_servers_pallas_flags(cfg_path, monkeypatch, capsys, flags, precision):
    """``serve.main([... "--pallas"])`` (a JAX server command line) builds a
    bf16 server; ``--pallas --pallas-precision f32`` and no ``--pallas`` an
    f32 one."""
    built = []
    monkeypatch.setattr(serve.ThreadingHTTPServer, "serve_forever", lambda self: None)
    real = serve.make_server

    def spy(*args, **kw):
        built.append(real(*args, **kw))
        return built[-1]

    monkeypatch.setattr(serve, "make_server", spy)
    assert serve.main(["-c", cfg_path, "--device", "cpu", "--port", "0", *flags]) == 0
    assert built[0][1].precision == precision
    assert f"cpu, {precision})" in capsys.readouterr().out


def test_main_refuses_contradictory_precision_flags(cfg_path, capsys):
    with pytest.raises(SystemExit):
        serve.main(["-c", cfg_path, "--device", "cpu", "--pallas", "--precision", "f32"])
    assert "contradicts --pallas" in capsys.readouterr().err
