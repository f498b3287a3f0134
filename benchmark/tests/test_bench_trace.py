"""The trace arithmetic on a hand-made trace, and what a trace without
device work gives."""

import pytest

from benchmark import core, trace


def _x(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("Trace", "PyTorch Profiler (0)", 0, 1000, tid=0),
    _x("user_annotation", "bench.api:2x10x20", 10, 500),
    _x("user_annotation", "bench.net:2x10x20x1", 100, 200),
    _x("cpu_op", "aten::sub", 20, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=1),        # outside the net
    _x("cuda_runtime", "cudaMemcpyAsync", 15, 2, corr=2),         # the upload
    _x("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=3),       # inside the net
    _x("cuda_runtime", "cudaMemsetAsync", 160, 2, corr=4),        # inside the net
    _x("gpu_memcpy", "Memcpy HtoD", 30, 100, tid=7, pid=0, corr=2),
    _x("kernel", "elementwise", 130, 20, tid=7, pid=0, corr=1),
    _x("kernel", "fused_wgmma_kernel", 200, 300, tid=7, pid=0, corr=3),
    _x("gpu_memset", "Memset", 190, 5, tid=7, pid=0, corr=4),
]


def test_busy_is_the_union_of_device_ops():
    b = trace.busy(EVENTS)
    # [30, 150], [190, 195] and [200, 500]: 120 + 5 + 300
    assert b == {"window": 1000.0, "span": 470.0, "busy": 425.0}


def test_attribute_by_launching_span():
    a = trace.attribute(EVENTS)
    assert a["net_us"] == pytest.approx(305.0)
    assert a["copy_us"] == pytest.approx(100.0)
    assert a["other_kernel_us"] == pytest.approx(20.0)
    assert a["net_calls"] == [("bench.api:2x10x20", 305.0)]


def test_self_times_rank_device_ops():
    rows = trace.self_times(EVENTS)
    assert rows[0][0] == "fused_wgmma_kernel" and rows[0][1] == 300.0
    assert {r[0] for r in rows} == {"fused_wgmma_kernel", "Memcpy HtoD", "elementwise", "Memset"}


def test_idle_gaps_named_by_the_host():
    # gaps 150-190 and 195-200, both inside bench.net (100-300) on the
    # host with no narrower event there
    assert trace.idle_gaps(EVENTS) == [("bench.net", pytest.approx(45e-6))]


HOST_ONLY = [e for e in EVENTS if e["cat"] not in trace.DEVICE_CATS]


def test_host_ops_are_never_device_lanes():
    assert trace.device_lanes(HOST_ONLY) == {}
    assert trace.busy(HOST_ONLY) is None
    assert set(trace.device_lanes(HOST_ONLY, ("cpu_op",))) == {(1, 1)}


@pytest.mark.parametrize("events, frames_done, why", [
    (HOST_ONLY, False, "no kernel"),
    ([e for e in EVENTS if not e["name"].startswith("bench.net")], True, "no bench.net"),
])
def test_a_card_trace_without_its_evidence_is_refused(events, frames_done, why):
    with pytest.raises(RuntimeError, match=why):
        trace.check_card_trace(events, frames_done)
    trace.check_card_trace(EVENTS, True)


def test_a_cpu_rehearsal_reports_no_device_metric():
    r = core.run_cell("srcnn955-f32-serve-photos-x2", 2**31 + 41, 0.4, True, device="cpu",
                      overrides={"sizes": [[14, 18], [16, 20], [18, 22], [20, 26], [22, 30]],
                                 "rate_per_s": 25.0, "pool_per_size": 2,
                                 "sample_requests": 6, "grace_s": 10},
                      log=lambda m: None)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"jobs_per_round", "latency_p95_ms.serve"}
    assert "device_trace" not in r and r["breakdown"]["device_ops"]

