"""Port parity: ``cnn_sr_tpu_torch.profiling`` and ``utils/debug.py``
against the JAX package's ``profiling.py`` and ``utils/debug.py``, on the
CPU: the same strings, the same stage table, and the same op table from
one list of events written once in each package's trace format."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from cnn_sr_tpu import profiling as jprofiling
from cnn_sr_tpu.utils import debug as jdebug
from cnn_sr_tpu_torch import profiling
from cnn_sr_tpu_torch.utils import debug


@pytest.mark.parametrize("shape", [(10,), (3, 5), (2, 2, 3), (0,)])
@pytest.mark.parametrize("per_line,line_numbers,prefix",
                         [(8, True, ""), (4, True, "  "), (3, False, "> ")])
def test_dump_vector_matches_jax(shape, per_line, line_numbers, prefix):
    data = np.random.default_rng(0).normal(0, 100, shape).astype(np.float32)
    want = jdebug.dump_vector(data, per_line, line_numbers, prefix)
    assert debug.dump_vector(data, per_line, line_numbers, prefix) == want
    assert debug.dump_vector(torch.from_numpy(data), per_line, line_numbers, prefix) == want


@pytest.mark.parametrize("kind", ["numpy", "tensor", "nonfinite", "int"])
def test_print_array_matches_jax(kind):
    rng = np.random.default_rng(1)
    data = rng.normal(0, 3, (4, 7)).astype(np.float32)
    if kind == "nonfinite":
        data[1, 2] = np.inf
    if kind == "int":
        data = rng.integers(-5, 5, (6,), dtype=np.int32)
    want, got = [], []
    jdebug.print_array("x", data, log=want.append, sample=10)
    debug.print_array("x", torch.from_numpy(data) if kind == "tensor" else data,
                      log=got.append, sample=10)
    assert got == want


def test_print_array_takes_a_bf16_tensor():
    got = []
    debug.print_array("w", torch.tensor([1.5, -2.0], dtype=torch.bfloat16), log=got.append)
    assert got[0].startswith("w: shape=(2,) dtype=float32 min=-2 max=1.5")


def test_warn_blocking_transfers_on_the_cpu_touches_no_cuda(monkeypatch):
    """On the CPU there is nothing to log: the scope never reaches
    ``torch.cuda`` (whose sync debug mode asserts on a CPU build)."""
    def refuse(*_):
        raise AssertionError("torch.cuda reached on the CPU")

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", refuse)
    for enabled in (True, False):
        with debug.warn_blocking_transfers(enabled, "cpu"):
            y = (torch.ones(4) * 2).cpu().numpy()
        assert y.tolist() == [2.0] * 4
    with debug.warn_blocking_transfers(False, "cuda"):
        pass


@pytest.mark.parametrize("totals", [
    {"load_image": 0.0123, "upscale (luma+forward+swap)": 1.5, "write_image": 0.25},
    {"load_samples": 0.5, "train_loop": 12.75},
    {"a": 1e-6},
])
def test_stage_report_matches_jax(totals):
    lines = {}
    for name, mod in (("jax", jprofiling), ("port", profiling)):
        prof = mod.StageProfiler()
        for i, (stage, t) in enumerate(totals.items()):
            prof.totals[stage] = t
            prof.counts[stage] = i + 1
        lines[name] = []
        prof.report(log=lines[name].append)
    assert lines["port"] == lines["jax"]
    assert lines["port"][0] == "---- stage profile ----"


def test_stage_profiler_times_and_passes_outputs_through():
    prof = profiling.StageProfiler()
    out = prof.timed("double", lambda x: x * 2, torch.ones(3))
    with prof.stage("block"):
        pass
    assert out.tolist() == [2.0] * 3
    assert dict(prof.counts) == {"double": 1, "block": 1}
    off = profiling.StageProfiler(enabled=False)
    assert off.timed("x", lambda: 5) == 5
    lines = []
    off.report(log=lines.append)
    assert lines == [] and not off.totals


# (name, ts, dur) per lane: flat ops, nesting three deep, a span that
# wraps two children, and a second lane
EVENT_SETS = {
    "flat": [[("conv", 0.0, 10.0), ("copy", 10.0, 5.0), ("conv", 20.0, 10.0)]],
    "nested": [[("loop", 0.0, 100.0), ("body", 10.0, 60.0), ("conv", 20.0, 10.0),
                ("conv", 75.0, 20.0)]],
    "span_wraps_two": [[("while", 0.0, 50.0), ("conv", 5.0, 10.0), ("relu", 20.0, 10.0),
                        ("copy", 60.0, 4.0)]],
    "two_lanes": [[("conv", 0.0, 30.0), ("relu", 30.0, 3.0)],
                  [("copy", 5.0, 7.5), ("conv", 15.0, 2.0)]],
}


def _write_jax_trace(root, lanes):
    events = [{"ph": "M", "name": "process_name", "pid": 1,
               "args": {"name": "/device:TPU:0"}}]
    for tid, lane in enumerate(lanes):
        events.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                       "args": {"name": "XLA Ops"}})
        events += [{"ph": "X", "pid": 1, "tid": tid, "ts": ts, "dur": dur, "name": name}
                   for name, ts, dur in lane]
    d = os.path.join(root, "plugins", "profile", "run1")
    os.makedirs(d)
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)


def _write_port_trace(root, lanes, cat):
    events = [{"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
               "tid": "PyTorch Profiler", "ts": -10.0, "dur": 200.0}]
    if cat == "kernel":
        # host-side events beside the device lanes: not device time
        events.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 9, "tid": 9,
                       "ts": 0.0, "dur": 500.0})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "pid": 9, "tid": 9, "ts": 1.0, "dur": 3.0})
    for tid, lane in enumerate(lanes):
        events += [{"ph": "X", "cat": cat, "pid": 0, "tid": 7 + tid, "ts": ts, "dur": dur,
                    "name": name} for name, ts, dur in lane]
    os.makedirs(root)
    with gzip.open(os.path.join(root, "x" + profiling.TRACE_SUFFIX), "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("cat", ["cpu_op", "kernel"])
@pytest.mark.parametrize("case", sorted(EVENT_SETS))
def test_op_shares_match_jax_on_the_same_events(tmp_path, case, cat):
    """One event list in JAX's trace format (``/device:`` lanes) and in the
    port's Chrome trace (CPU ops, or CUDA kernels beside host events):
    the same rows, names, self times and counts."""
    _write_jax_trace(str(tmp_path / "jax"), EVENT_SETS[case])
    _write_port_trace(str(tmp_path / "port"), EVENT_SETS[case], cat)
    want = jprofiling.op_shares(str(tmp_path / "jax"))
    got = profiling.op_shares(str(tmp_path / "port"))
    assert [(n, c) for n, _, c in got] == [(n, c) for n, _, c in want]
    np.testing.assert_allclose([t for _, t, _ in got], [t for _, t, _ in want], rtol=1e-12)
    total = sum(dur for lane in EVENT_SETS[case] for _, ts, dur in lane
                if not any(o_ts < ts and ts + dur <= o_ts + o_dur
                           for _, o_ts, o_dur in lane))
    assert sum(t for _, t, _ in got) == pytest.approx(total)
    lines = {}
    for name, mod, d in (("jax", jprofiling, "jax"), ("port", profiling, "port")):
        lines[name] = []
        mod.report_op_shares(str(tmp_path / d), log=lines[name].append, top=2)
    assert lines["port"] == lines["jax"]


def test_op_shares_without_a_trace(tmp_path):
    lines = []
    profiling.report_op_shares(str(tmp_path), log=lines.append)
    assert profiling.op_shares(str(tmp_path)) == [] and profiling.idle_share(str(tmp_path)) is None
    assert lines == [f"(no profiler trace found under {tmp_path})"]


def test_idle_share_counts_overlapping_lanes_once(tmp_path):
    _write_port_trace(str(tmp_path / "t"), EVENT_SETS["two_lanes"], "kernel")
    got = profiling.idle_share(str(tmp_path / "t"))
    # busy: [0, 33] covers the second lane's [5, 12.5] and [15, 17]
    assert got == {"window": 200.0, "span": 33.0, "busy": 33.0}


def test_real_cpu_trace_of_a_forward(tmp_path):
    """A ``torch.profiler`` trace of a tiny forward on the CPU: the conv ops
    lead the table, each op is charged its self time, so the table's time
    is the outermost ops' time and its shares add up to 100%."""
    from cnn_sr_tpu_torch.models.srcnn import SRCNN
    from cnn_sr_tpu_torch.utils.config import parse_config
    from cnn_sr_tpu_torch.utils.params_io import params_to_torch, random_parameters

    dist = {"mean_w": 0.0, "mean_b": 0.0, "std_deviation_w": 0.05, "std_deviation_b": 0.0}
    cfg = parse_config({"n1": 8, "n2": 4, "f1": 9, "f2": 5, "f3": 5, "momentum": 0.9,
                        "weight_decay_parameter": 0.0, "learning_rates": [0.01, 0.01, 0.001],
                        **{f"parameters_distribution_{i}": dist for i in (1, 2, 3)}})
    params = params_to_torch(random_parameters(cfg.layer_specs(), cfg.distributions, seed=0),
                             "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (1, 40, 40, 1))
                         .astype(np.float32))
    prof = profiling.StageProfiler(profile_dir=str(tmp_path))
    prof.start_trace()
    y = prof.timed("forward", SRCNN(params), x)
    prof.stop_trace()
    assert y.shape == (1, 24, 24, 1)
    rows = profiling.op_shares(str(tmp_path))
    assert any("convolution" in name for name, _, _ in rows[:3]), rows[:5]
    outer = 0.0
    for lane in profiling._device_lanes(profiling._newest_trace(str(tmp_path))).values():
        end = -1.0
        for ts, dur, _ in sorted(lane, key=lambda r: (r[0], -r[1])):
            if ts >= end:
                outer += dur
                end = ts + dur
    assert sum(t for _, t, _ in rows) == pytest.approx(outer, rel=1e-9)
    lines = []
    profiling.report_op_shares(str(tmp_path), log=lines.append, top=len(rows))
    shares = [float(ln.split("(")[1].split("%")[0]) for ln in lines[1:-1]]
    assert sum(shares) == pytest.approx(100.0, abs=0.01 * len(shares))


def test_print_device_memory_on_the_cpu():
    got, want = [], []
    profiling.print_device_memory(log=got.append, device="cpu")
    jprofiling.print_device_memory(log=want.append)
    assert got == ["[cpu] memory stats unavailable"]
    assert all(line.endswith("] memory stats unavailable") for line in want)
