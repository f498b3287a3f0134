"""The host link on the card: what the API layer's copies can reach.

Times, on one card, the copies ``api.py`` makes for a batch of eight
1080p RGBA frames (66.4 MB in, and the 49.8 MB of their RGB answers out):

* ``link``: one ``copy_`` of the whole batch each way between the device
  and page-locked host memory (CUDA events), and the same copies through
  pageable memory (host clock to a synchronise);
* ``stage``: the host copy of a C-contiguous batch into page-locked
  memory, by ``torch``'s multi-threaded ``copy_`` (whole, and a frame at a
  time) and by ``np.copyto``;
* ``gather``: the same for a channel-planar stack (strides W, 1, H·W
  within each image, as the server's pre-scaled photos come), against
  ``np.require(..., "C")``, the pageable path's own gather;
* ``upload``: the page-locked upload as ``api._upload`` makes it, each
  frame staged and sent without blocking, against ``stage`` then one copy;
* ``api`` (``--api``): ``upscale_batch`` in a closed loop over three such
  batches, as the benchmark's batch cells call it: each call's time and
  the host's time in its upload and staging copies, bf16 luma and RGB and
  f32 RGB, at torch's threads and at 4.

Each number is the median of ``--reps`` turns after one warm-up turn, in
ms and GB/s. Needs a card; exits 1 without one.

    python -m cnn_sr_tpu_torch.probes.link [--reps N] [--api]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import api


def _median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _event_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _planar(rng, s: int, h: int, w: int) -> np.ndarray:
    """(s, h, w, 4) uint8 with each image's channels planar: strides
    (4·h·w, w, 1, h·w), as ``np.stack`` of the server's pre-scaled images
    lays them out."""
    planes = rng.integers(0, 256, (s, 4, h, w), dtype=np.uint8)
    return planes.transpose(0, 2, 3, 1)


def _quantiles(ms: list) -> dict:
    q = statistics.quantiles(ms, n=10)
    return {"min": min(ms), "p10": q[0], "median": statistics.median(ms), "p90": q[-1],
            "max": max(ms)}


def _api_calls(batches: list, reps: int) -> dict:
    """``upscale_batch`` in a closed loop as the benchmark's batch cells
    call it: ``reps`` calls over a pool of batches, each answer held
    through the next call. For the bf16 luma and RGB models and the f32
    RGB one, at torch's threads and at 4: each call's wall time, and the
    host's time in ``_upload`` and in its staging copies (``_stage``), in
    ms (min, deciles, median, max)."""
    import os
    from unittest import mock

    from ..utils.config import read_config
    from ..utils.params_io import init_params, params_to_torch

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    stage, upload = api._stage, api._upload
    parts = {"stage": 0.0, "upload": 0.0}

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                parts[key] += (time.perf_counter() - t0) * 1e3
        return run

    out, threads = {}, torch.get_num_threads()
    for name, precision in (("srcnn_9-5-5_pretrained", "bf16"),
                            ("waifu2x_7layer_rgb_pretrained", "bf16"),
                            ("waifu2x_7layer_rgb_pretrained", "f32")):
        cfg = read_config(os.path.join(root, "configs", f"{name}.json"))
        params = params_to_torch(init_params(cfg)[0], "cuda")
        for n in (threads, 4):
            torch.set_num_threads(n)
            rows = {"call": [], "upload": [], "stage": []}
            held = api.upscale_batch(cfg, params, batches[0], precision=precision)
            with mock.patch.object(api, "_stage", timed(stage, "stage")), \
                    mock.patch.object(api, "_upload", timed(upload, "upload")):
                for i in range(reps if precision == "bf16" else max(reps // 8, 3)):
                    parts.update(stage=0.0, upload=0.0)
                    t0 = time.perf_counter()
                    # the last answer is released only once this one is assigned
                    held = api.upscale_batch(cfg, params, batches[i % len(batches)],
                                             precision=precision)
                    rows["call"].append((time.perf_counter() - t0) * 1e3)
                    rows["upload"].append(parts["upload"])
                    rows["stage"].append(parts["stage"])
            del held
            out[f"{name}.{precision}.threads{n}"] = {k: _quantiles(v) for k, v in rows.items()}
    torch.set_num_threads(threads)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--api", action="store_true",
                    help="also time upscale_batch's calls in a closed loop, and their parts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("link: needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    s, h, w = 8, 1080, 1920
    batch = rng.integers(0, 256, (s, h, w, 4), dtype=np.uint8)
    mb_in, mb_out = batch.nbytes / 1e6, s * h * w * 3 / 1e6
    pin_in = torch.empty(batch.shape, dtype=torch.uint8, pin_memory=True)
    pin_out = torch.empty((s, h, w, 3), dtype=torch.uint8, pin_memory=True)
    dev_in = torch.empty(batch.shape, dtype=torch.uint8, device=dev)
    dev_out = torch.randint(0, 256, (s, h, w, 3), dtype=torch.uint8, device=dev)
    r = {"device": torch.cuda.get_device_name(dev), "torch": torch.__version__,
         "threads": torch.get_num_threads(), "mb_in": mb_in, "mb_out": mb_out}

    r["link"] = {
        "pinned_h2d_ms": _event_ms(lambda: dev_in.copy_(pin_in, non_blocking=True), args.reps),
        "pinned_d2h_ms": _event_ms(lambda: pin_out.copy_(dev_out, non_blocking=True), args.reps),
        "pageable_h2d_ms": _median_ms(lambda: dev_in.copy_(torch.from_numpy(batch)), args.reps),
        "pageable_d2h_ms": _median_ms(lambda: dev_out.cpu(), args.reps),
    }
    src = torch.from_numpy(batch)

    def per_frame():
        for d, f in zip(pin_in, src):
            d.copy_(f)

    r["stage"] = {
        "torch_whole_ms": _median_ms(lambda: pin_in.copy_(src), args.reps),
        "torch_per_frame_ms": _median_ms(per_frame, args.reps),
        "numpy_copyto_ms": _median_ms(lambda: np.copyto(pin_in.numpy(), batch), args.reps),
    }
    r["gather"] = {}
    for gs, gh, gw in ((4, 1440, 2560), (1, 960, 1280)):
        planar = _planar(rng, gs, gh, gw)
        pin = torch.empty(planar.shape, dtype=torch.uint8, pin_memory=True)
        r["gather"][f"{gs}x{gh}x{gw}"] = {
            "np_require_ms": _median_ms(lambda: np.require(planar, requirements=("C", "W")),
                                        args.reps),
            "torch_to_pinned_ms": _median_ms(lambda: pin.copy_(torch.from_numpy(planar)),
                                             args.reps),
            "numpy_to_pinned_ms": _median_ms(lambda: np.copyto(pin.numpy(), planar), args.reps),
        }

    def whole_then_copy():
        pin_in.copy_(src)
        dev_in.copy_(pin_in, non_blocking=True)

    params = [{"w": torch.zeros(1, device=dev)}]
    r["upload"] = {
        "api_upload_ms": _median_ms(lambda: api._upload(params, batch), args.reps),
        "stage_then_copy_ms": _median_ms(whole_then_copy, args.reps),
    }
    if args.api:
        r["api"] = _api_calls([batch] + [rng.integers(0, 256, batch.shape, dtype=np.uint8)
                                         for _ in range(2)], args.reps)
    for k in ("pinned_h2d", "pageable_h2d"):
        r["link"][k.replace("h2d", "h2d_gbs")] = mb_in / r["link"][f"{k}_ms"]
    for k in ("pinned_d2h", "pageable_d2h"):
        r["link"][k.replace("d2h", "d2h_gbs")] = mb_out / r["link"][f"{k}_ms"]
    print(json.dumps(r, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
