"""The port's own spans (``profiling.span``) on the CPU: what a
``torch.profiler`` that records every thread sees of an API call and of a
server worker's rounds, nested as the layers nest and inside the
profiler's window; that nothing is recorded, and no ``record_function``
entered, without a profiler; and that ``StageProfiler``'s stages are
spans of the trace it writes."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cnn_sr_tpu_torch import api, profiling, serve
from cnn_sr_tpu_torch.utils.config import parse_config
from cnn_sr_tpu_torch.utils.params_io import params_to_torch, random_parameters

DIST = {"mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.0}
CONFIGS = {
    "luma": {"n1": 4, "n2": 2, "f1": 3, "f2": 1, "f3": 3, "momentum": 0.9,
             "weight_decay_parameter": 0.0, "learning_rates": [0.01, 0.01, 0.001],
             **{f"parameters_distribution_{i}": DIST for i in (1, 2, 3)}},
    "rgb": {"channels": 3, "layers": [{"n": n, "f": 3} for n in (4, 4, 3)],
            "momentum": 0.9, "weight_decay_parameter": 0.0, "learning_rates": [1e-4] * 3,
            "parameters_distribution": DIST},
}
# the parts of a public call, and each call's spans in order
API_PARTS = ("api.upload", "api.pixels", "model.forward", "api.readback")
CALL = {
    "batch": ["api.upscale_batch", "api.upload", "api.pixels", "model.forward", "api.pixels",
              "api.readback"],
    "image": ["api.upscale_image", "api.upload", "api.pixels", "model.forward", "api.pixels",
              "api.readback"],
    "spatial": ["api.upscale_image_spatial", "api.upload", "api.pixels", "model.forward",
                "model.forward", "api.pixels", "api.readback"],
}
CALL["image_bucket"] = CALL["image"]


def _model(kind):
    cfg = parse_config(CONFIGS[kind])
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, seed=3),
                             "cpu")
    return cfg, params


def _images(n=2, h=20, w=24, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 4), dtype=np.uint8)


def _call(kind, cfg, params, images):
    if kind == "batch":
        return api.upscale_batch(cfg, params, images)
    if kind == "image":
        return api.upscale_image(cfg, params, images[0])
    if kind == "image_bucket":
        return api.upscale_image(cfg, params, images[0], bucket=64)
    return api.upscale_image_spatial(cfg, params, images[0], 2,
                                     devices=[torch.device("cpu")] * 2)


def _record(tmp_path, fn):
    """Run ``fn`` under a CPU ``torch.profiler`` that records every thread;
    returns the events of the trace it exports."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=config)
    prof.start()
    try:
        fn()
    finally:
        prof.stop()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events):
    """The program's spans, ``[(start, end, name, tid, parent name)]`` in
    start order, each with the innermost span of its thread around it;
    every one of them inside the profiler's window."""
    window = [e for e in events if e.get("cat") == "Trace"]
    assert len(window) == 1
    t0 = float(window[0]["ts"])
    t1 = t0 + float(window[0]["dur"])
    rows = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e["tid"])
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda r: (r[0], -r[1]))
    out, stacks = [], {}
    for s, e, name, tid in rows:
        assert t0 <= s <= e <= t1, (name, s, e, t0, t1)
        stack = stacks.setdefault(tid, [])
        while stack and stack[-1][0] <= s:
            stack.pop()
        out.append((s, e, name, tid, stack[-1][1] if stack else None))
        stack.append((e, name))
    return out


def _check_call_nesting(spans):
    """Each API part inside the public call around it, every call's parts
    in order; returns the public calls."""
    calls = [sp for sp in spans if sp[2].startswith("api.upscale_")]
    for sp in spans:
        if sp[2] in API_PARTS:
            assert sp[4] in {c[2] for c in calls}, sp
    return calls


@pytest.mark.parametrize("model", sorted(CONFIGS))
@pytest.mark.parametrize("kind", sorted(CALL))
def test_an_api_call_records_its_spans_on_its_thread(tmp_path, model, kind):
    cfg, params = _model(model)
    images = _images()
    want = _call(kind, cfg, params, images)
    got = {}
    events = _record(tmp_path, lambda: got.update(out=_call(kind, cfg, params, images)))
    np.testing.assert_array_equal(got["out"], want)
    spans = _spans(events)
    assert [sp[2] for sp in spans] == CALL[kind]
    assert {sp[3] for sp in spans} == {threading.get_native_id()}
    assert spans[0][4] is None and _check_call_nesting(spans) == spans[:1]


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_a_worker_started_before_the_profiler_records_its_rounds(tmp_path, model):
    """Two rounds of a ``DeviceWorker`` whose thread started before the
    profiler: two shapes (two singles through ``upscale_image``), then two
    of one shape (one ``upscale_batch``), each pre-scaled x2."""
    cfg, params = _model(model)
    worker = serve.DeviceWorker({"default": {"cfg": cfg, "params": params}}, scale=2.0,
                                max_batch=2, batch_wait_ms=5000, bucket=16)
    worker.start()
    images = _images(3)
    small = _images(1, 16, 20, seed=1)[0]
    warm = [serve._Job("default", im) for im in images[:2]]
    for j in warm:
        worker.submit(j)
    for j in warm:
        assert j.done.wait(60) and j.error is None, j.error
    time.sleep(0.2)  # the worker is back in its queue's wait, unrecorded
    jobs = [serve._Job("default", im) for im in (images[0], small, images[1], images[2])]

    def rounds():
        for pair in (jobs[:2], jobs[2:]):
            for j in pair:
                worker.submit(j)
            for j in pair:
                assert j.done.wait(60) and j.error is None, j.error
        worker.stop()
        worker.join(60)
        assert not worker.is_alive()

    spans = _spans(_record(tmp_path, rounds))
    assert {sp[3] for sp in spans} == {worker.native_id}
    if spans[0][2] == "serve.wait":  # it got there only once the profiler recorded
        spans = spans[1:]
    names = [sp[2] for sp in spans]
    if names[-1] == "serve.wait":  # unless the worker saw the stop before it waited again
        names.pop()
    single = ["serve.dispatch", "serve.pre_scale"] + CALL["image"]
    assert names == (["serve.gather"] + single + single + ["serve.wait", "serve.gather",
                     "serve.dispatch", "serve.pre_scale", "serve.pre_scale"]
                     + CALL["batch"])
    for sp in spans:
        if sp[2] in ("serve.wait", "serve.gather", "serve.dispatch"):
            assert sp[4] is None, sp
        elif sp[2] == "serve.pre_scale" or sp[2].startswith("api.upscale_"):
            assert sp[4] == "serve.dispatch", sp
    assert len(_check_call_nesting(spans)) == 3
    assert jobs[2].result.shape == (40, 48, 3)


class _Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")


@pytest.mark.parametrize("kind", sorted(CALL) + ["worker", "stages"])
def test_without_a_profiler_no_span_is_made(monkeypatch, kind):
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Refused)
    cfg, params = _model("luma")
    images = _images()
    if kind in CALL:
        assert _call(kind, cfg, params, images).shape[-1] == 3
    elif kind == "worker":
        worker = serve.DeviceWorker({"default": {"cfg": cfg, "params": params}}, scale=2.0,
                                    max_batch=2, batch_wait_ms=5000, bucket=16)
        worker.start()
        jobs = [serve._Job("default", im) for im in images]
        for j in jobs:
            worker.submit(j)
        for j in jobs:
            assert j.done.wait(60) and j.error is None, j.error
        worker.stop()
        worker.join(60)
        assert not worker.is_alive() and worker.stats["batched_jobs"] == 2
    else:
        prof = profiling.StageProfiler()
        with prof.stage("load_image"):
            pass
        assert prof.timed("upscale", api.upscale_batch, cfg, params, images).shape == (2, 20, 24, 3)
        assert dict(prof.counts) == {"load_image": 1, "upscale": 1}


def test_span_is_a_shared_no_op_unless_a_profiler_records():
    assert profiling.span("api.upload") is profiling.span("serve.wait")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("api.upload"), torch.profiler.record_function)
    assert profiling.span("api.upload") is profiling.span("serve.wait")


def test_stage_profiler_stages_are_spans_of_its_trace(tmp_path):
    cfg, params = _model("luma")
    prof = profiling.StageProfiler(profile_dir=str(tmp_path))
    prof.start_trace()
    with prof.stage("load_image"):
        images = _images()
    prof.timed("upscale (luma+forward+swap)", api.upscale_batch, cfg, params, images)
    prof.stop_trace()
    spans = _spans(profiling._newest_trace(str(tmp_path)))
    names = [sp[2] for sp in spans]
    assert names == ["load_image", "upscale (luma+forward+swap)"] + CALL["batch"]
    assert spans[2][4] == "upscale (luma+forward+swap)"
