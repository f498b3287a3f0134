"""One run of one cell: set-up, the measured window, the comparison, the
metrics and the result line.

``run_cell`` is the whole run apart from the look for a card, so that
the CPU tests drive it at a tiny size (``overrides``) and with a broken
program underneath (``patch``). ``run.py`` adds the look for a card, the
import check and the printing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import compare, generators, roofline, trace, weights as weights_io

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cnn_sr_tpu")


class CellError(RuntimeError):
    """The manifest or a file it names is missing or malformed."""


def manifest() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise CellError(f"no BENCHMARK.json at {ROOT}")
    return json.loads(path.read_text())


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    spec: dict      # the workloads entry
    config: dict    # configs/<config>.json
    mix: dict       # traffic/<traffic>.json
    limits: dict    # limits/<cell>.json
    end_to_end: list
    per_layer: list

    @property
    def layers(self):
        return [tuple(x) for x in self.config["layers"]]

    @property
    def precision(self) -> str:
        return self.mix["precision"]

    def _counts(self, fn: str):
        """The reference module's ``fn`` (``flops`` or ``bound_ms``), or None
        for a stack of VALID convolutions (``roofline``)."""
        ref = importlib.import_module(f"benchmark.reference.{self.config['reference']}")
        return getattr(ref, fn, None)

    def flops(self, shape) -> int:
        """2 x the model's multiply-adds on the API's input ``(n, h, w, c)``."""
        flops = self._counts("flops")
        if flops is None:
            return roofline.stack_flops(self.layers, shape)
        return flops(self.config, shape)

    def bound_ms(self, shape) -> tuple:
        """``(ms, "operations" | "bytes")``: the model's least time on this
        card at ``shape`` in the cell's precision."""
        bound_ms = self._counts("bound_ms")
        if bound_ms is None:
            return roofline.bound_ms(self.layers, shape, self.precision)
        return bound_ms(self.config, shape, self.precision)


def load_cell(name: str, overrides=None) -> Cell:
    man = manifest()
    spec = next((w for w in man["workloads"] if w["name"] == name), None)
    if spec is None:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == spec["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{spec['traffic']}.json").read_text())
    mix.update(overrides or {})
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    every = [w["name"] for w in man["workloads"]]
    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", every)]
    # a per-layer metric without a workloads list goes wherever its
    # end-to-end metric is reported
    moved = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, spec, config, mix, limits, e2e, per)


class Program:
    """The system under test as the generator drives it: the port's API
    and server, on one device, with the cell's weights."""

    def __init__(self, cell: Cell, weights_np, device: str):
        import torch

        from cnn_sr_tpu_torch import api, serve
        from cnn_sr_tpu_torch.utils.config import parse_config

        self.api, self.serve, self.device = api, serve, device
        self.cfg = parse_config(dict(cell.config["program_config"]))
        self.params = [{"w": torch.as_tensor(w, device=device), "b": torch.as_tensor(b, device=device)}
                       for w, b in weights_np]
        self.precision = cell.precision
        self.torch = torch

    def batch(self, frames: np.ndarray) -> np.ndarray:
        return self.api.upscale_batch(self.cfg, self.params, frames, self.precision)

    def worker(self, mix: dict):
        return self.serve.DeviceWorker(
            {"default": {"cfg": self.cfg, "params": self.params}}, precision=self.precision,
            scale=float(mix["scale"]), max_batch=mix["max_batch"],
            batch_wait_ms=mix["batch_wait_ms"], bucket=mix["bucket"])

    def job(self, rgba: np.ndarray):
        return self.serve._Job("default", rgba)

    def sync(self) -> None:
        if self.device != "cpu":
            self.torch.cuda.synchronize()


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against the boot clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Context:
    """What a per-layer metric's reader reads. ``attributed`` and
    ``busy`` come from the card's trace and are None in a CPU rehearsal,
    where a reader of a device metric returns None."""
    cell: Cell
    win: generators.Window
    events: list
    attributed: dict
    busy: dict

    @property
    def window_s(self) -> float:
        return self.win.t_end - self.win.t0

    @property
    def out_mpix(self) -> float:
        return self.win.out_pixels / 1e6

    @property
    def peak_flops(self) -> float:
        return roofline.PEAK_FLOPS[self.cell.precision]

    def frames_flops(self) -> int:
        c = self.cell.config["channels"]
        return sum(self.cell.flops((1, h, w, c)) for h, w in self.win.frames)


def read_metric(name: str, ctx: Context):
    path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def end_to_end(cell: Cell, win, setup_s: float) -> dict:
    rate = win.out_pixels / 1e6 / (win.t_end - win.t0)
    values = {"setup_s": setup_s, "mpix_per_s": rate}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}


def _all_threads(torch) -> dict:
    """The profiler option that records the CPU ops and annotations of
    every thread, the server's worker among them. Without it the worker's
    launches go unrecorded, so a torch that lacks it cannot be traced."""
    try:
        return {"experimental_config":
                torch._C._profiler._ExperimentalConfig(profile_all_threads=True)}
    except (AttributeError, TypeError) as e:
        raise RuntimeError(f"this torch cannot record every thread's ops: {e!r}") from e


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             overrides=None, patch=None, log=print) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, maybe ``breakdown``, ``checks``).
    ``patch(program)`` may break the program underneath (the tests)."""
    cell = load_cell(name, overrides)
    ref_module = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    weights_np = weights_io.load(ROOT, cell.config)
    program = Program(cell, weights_np, device)
    if patch is not None:
        patch(program)
    loop = generators.loop_for(cell.mix, program)
    loop.setup(seed)
    torch = program.torch
    spans = prof = tmpdir = None
    if traced:
        from .spans import Spans

        spans = Spans(program.api)
        spans.install()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts, **_all_threads(torch))
        prof.start()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    setup_s = process_age_s()
    log(f"setup {setup_s:.3f} s")
    win = loop.window(seconds)
    program.sync()
    events = []
    if traced:
        prof.stop()
        spans.remove()
        tmpdir = tempfile.mkdtemp(prefix="bench_trace_")
        path = os.path.join(tmpdir, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        log(f"trace written: {os.path.getsize(path) / 1e6:.1f} MB")
        events = trace.load(path)
        shutil.rmtree(tmpdir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    if win.lateness_s:
        lat = sorted(win.lateness_s)
        log(f"generator lateness ms: p50 {statistics.median(lat) * 1e3:.3f} "
            f"p99 {lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.3f} max {lat[-1] * 1e3:.3f} "
            f"over {len(lat)} requests")
    log(f"window {win.t_end - win.t0:.3f} s, attempted {win.attempted}, failed {win.failed}, "
        f"counters {win.counters}")
    for e in win.errors[:3]:
        log(f"error: {e}")
    result = {"attempted": win.attempted, "failed": win.failed}
    if traced:
        # the device metrics come from the card's trace alone; a CPU
        # rehearsal reads the host's metrics and a breakdown of its ops
        cats, bz, attributed = ("cpu_op",), None, None
        if device != "cpu":
            trace.check_card_trace(events, bool(win.frames))
            cats, bz, attributed = trace.DEVICE_CATS, trace.busy(events), trace.attribute(events)
            result["device_trace"] = {"busy_s": bz["busy"] / 1e6, "window_s": bz["window"] / 1e6}
        ctx = Context(cell, win, events, attributed, bz)
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {
            "device_ops": [[n, t / 1e6] for n, t, _ in trace.self_times(events, cats)[:10]],
            "idle_gaps": [[n, s] for n, s in trace.idle_gaps(events, cats=cats)]}
    else:
        result["metrics"] = end_to_end(cell, win, setup_s)
    result["memory_peak_bytes"] = peak
    # free the program's state before the reference runs
    samples = win.samples
    del loop, program, win, events
    if device != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = compare.worst(compare.reference_answers(samples, ref_module, weights_np,
                                                      cell.config, device))
    log(f"reference over {len(samples)} answers: {time.perf_counter() - t_ref:.3f} s, "
        f"numbers {numbers}")
    ok, checks = compare.judge(numbers, cell.limits)
    result["correct"] = bool(ok and result["failed"] == 0 and samples)
    result["checks"] = {**checks, "failed": {"value": result["failed"], "limit": 0}}
    return result
