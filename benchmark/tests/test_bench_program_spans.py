"""The readers of the program's own spans on a hand-made trace, what they
give without those spans or on the CPU, and, on the card, that a kernel's
launch falls inside ``model.forward`` on the trace's clock."""

import os

import numpy as np
import pytest

from benchmark import core, generators, program_spans, trace


def _x(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, t0, t1, tid=1):
    return _x("user_annotation", name, t0, t1 - t0, tid=tid)


def _dev(cat, name, t0, t1, corr):
    return _x(cat, name, t0, t1 - t0, tid=7, pid=0, corr=corr)


# a worker round (tid 1): a pre-scale, then one batched API call inside
# the benchmark's own spans; the next round's gather; a launch from the
# main thread (tid 2) outside every span
EVENTS = [
    _x("Trace", "PyTorch Profiler (0)", 0, 2000, tid=0),
    _span("serve.gather", 0, 50),
    _span("serve.dispatch", 50, 1000),
    _span("serve.pre_scale", 60, 200),
    _x("cuda_runtime", "cudaMemcpyAsync", 70, 2, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 150, 2, corr=3),
    _span("bench.api:2x10x20", 205, 995),
    _span("api.upscale_batch", 210, 990),
    _span("api.upload", 220, 300),
    _x("cuda_runtime", "cudaMemcpyAsync", 230, 2, corr=4),
    _span("api.pixels", 300, 400),
    _x("cuda_runtime", "cudaLaunchKernel", 310, 2, corr=5),
    _span("bench.net:2x10x20x1", 398, 497),
    _span("model.forward", 400, 495),
    _x("cuda_runtime", "cudaLaunchKernel", 410, 2, corr=6),
    _span("api.pixels", 500, 600),
    _x("cuda_runtime", "cudaLaunchKernel", 510, 2, corr=7),
    _span("api.readback", 600, 980),
    _x("cuda_runtime", "cudaMemcpyAsync", 610, 2, corr=8),
    _span("serve.wait", 1000, 1100),
    _span("serve.gather", 1100, 1450),
    _span("serve.dispatch", 1450, 1600),
    _x("cuda_runtime", "cudaLaunchKernel", 1460, 2, corr=9),
    _x("cuda_runtime", "cudaLaunchKernel", 1690, 2, tid=2, corr=10),
    _dev("gpu_memcpy", "Memcpy HtoD", 75, 95, 1),
    _dev("kernel", "bicubic", 125, 145, 2),
    _dev("gpu_memcpy", "Memcpy DtoH", 155, 195, 3),
    _dev("gpu_memcpy", "Memcpy HtoD", 250, 290, 4),
    _dev("kernel", "luma", 320, 340, 5),
    _dev("kernel", "fused_srcnn_kernel", 420, 480, 6),
    _dev("kernel", "swap", 522, 540, 7),
    _dev("gpu_memcpy", "Memcpy DtoH", 620, 970, 8),
    _dev("kernel", "luma", 1500, 1520, 9),
    _dev("kernel", "other", 1700, 1710, 10),
]
# the gaps and the spans open at their midpoints:
#   95-125 and 145-155 in serve.pre_scale          -> server, 30 + 10
#   195-250 in api.upload                           -> API, 55
#   290-320, 340-420, 480-522, 540-620 in api.pixels -> API, 30 + 80 + 42 + 80
#   970-1500 in serve.gather                        -> server, 530
#   1520-1700 outside every span                    -> neither, 180
API_US, SERVER_US, PRESCALE_US = 287.0, 570.0, 80.0


def _ctx(events, out_pixels=2_000_000, card=True):
    win = generators.Window(t0=0.0, t_end=1.0, out_pixels=out_pixels)
    return core.Context(None, win, events, trace.attribute(events) if card else None,
                        trace.busy(events) if card else None)


def test_gaps_are_charged_where_their_midpoints_lie():
    assert program_spans.api_idle_us(EVENTS) == pytest.approx(API_US)
    assert program_spans.server_idle_us(EVENTS) == pytest.approx(SERVER_US)
    assert dict(program_spans.idle_by_span(EVENTS)) == pytest.approx(
        {"api.upload": 55.0, "api.pixels": 232.0, "serve.pre_scale": 40.0,
         "serve.gather": 530.0, "outside": 180.0})


def test_the_split_script_names_each_gaps_span_and_host_event():
    from benchmark import idle_split

    got = idle_split.split(EVENTS)
    assert got["idle_s"] == pytest.approx(1037e-6)
    assert dict(got["by_span_and_host"]) == pytest.approx(
        {"api.upload / api.upload": 55e-6, "api.pixels / api.pixels": 232e-6,
         "serve.pre_scale / serve.pre_scale": 30e-6, "serve.pre_scale / cudaMemcpyAsync": 10e-6,
         "serve.gather / serve.gather": 530e-6, "outside / host idle": 180e-6})


def test_launches_inside_the_pre_scale_join_their_device_events():
    assert program_spans.launched_in_us(EVENTS, program_spans.PRE_SCALE) == PRESCALE_US


@pytest.mark.parametrize("name, want_us", [
    ("api_idle_ms_per_mpix", API_US),
    ("server_idle_ms_per_mpix", SERVER_US),
    ("prescale_ms_per_mpix", PRESCALE_US),
])
def test_readers(name, want_us):
    assert core.read_metric(name, _ctx(EVENTS)) == pytest.approx(want_us / 1e3 / 2.0)


WITHOUT_PROGRAM_SPANS = [e for e in EVENTS if not (
    e["cat"] == "user_annotation" and e["name"].startswith(program_spans.PREFIXES))]


@pytest.mark.parametrize("name", ["api_idle_ms_per_mpix", "server_idle_ms_per_mpix",
                                  "prescale_ms_per_mpix"])
@pytest.mark.parametrize("case", ["no program spans", "cpu", "nothing answered"])
def test_readers_give_none(name, case):
    ctx = {"no program spans": lambda: _ctx(WITHOUT_PROGRAM_SPANS),
           "cpu": lambda: _ctx(EVENTS, card=False),
           "nothing answered": lambda: _ctx(EVENTS, out_pixels=0)}[case]()
    assert core.read_metric(name, ctx) is None


def test_the_breakdown_names_the_program_spans_not_the_benchmarks():
    names = [n for n, _ in trace.idle_gaps(EVENTS)]
    assert "api.upload" in names and "serve.gather" in names
    assert not any(n.startswith("bench.") for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("cell, kernel", [
    ("srcnn955-f32-serve-photos-x2", "fused_srcnn_kernel"),
    ("srcnn955-bf16-frames1080-b8", "fused_wgmma_kernel"),
])
def test_the_fused_kernel_is_launched_inside_model_forward(cuda_device, tmp_path, cell, kernel):
    """On the card: the launch of the fused kernel lies inside a
    ``model.forward`` span of its thread on the trace's clock, and the
    kernel's event joins that launch by correlation id. (The kernel's own
    start is on the device's clock, which the trace aligns with the host's
    only to within tens of µs: on an H100 it read 61 µs before its launch once.)"""
    import torch

    from benchmark import frames, weights as weights_io

    c = core.load_cell(cell)
    program = core.Program(c, weights_io.load(core.ROOT, c.config), cuda_device)
    rgba = frames.make_frames(2, 96, 128, 2**31 + 7, cuda_device).cpu().numpy()
    program.batch(rgba)  # warm: the build and the packed weights
    program.sync()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        out = program.batch(rgba)
        program.sync()
    assert out.shape == (2, 96, 128, 3)
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    events = trace.load(path)
    kernels = [e for e in events if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    assert len(kernels) == 1, [e.get("name") for e in events if e.get("cat") == "kernel"]
    corr = kernels[0]["args"]["correlation"]
    launches = [e for e in events if e.get("cat") in trace.LAUNCH_CATS
                and e.get("args", {}).get("correlation") == corr]
    assert len(launches) == 1 and "Launch" in launches[0]["name"]
    launch = launches[0]
    forwards = program_spans.spans(events, ("model.forward",)).get(launch["tid"], [])
    assert len(forwards) == 1
    t0, t1, _ = forwards[0]
    assert t0 <= float(launch["ts"]) and float(launch["ts"]) + float(launch["dur"]) <= t1
    assert np.isfinite(program_spans.api_idle_us(events))
