"""End-to-end serving latency: p50/p99 through the port's HTTP server.

The port's counterpart of ``tools/serve_latency.py``: the real server
runs in-process (``serve.make_server``: HTTP handler threads, the
batching queue, one device worker) and each request's wall-clock time is
taken at the HTTP client:

* **sequential**: one request at a time, the single-request latency a
  lone client sees (decode + upscale + PNG encode);
* **concurrent**: C client threads firing back-to-back for N requests
  each, the batching-queue regime; ``failed`` counts the answers that
  are neither 200 nor a shed 503/429.

``WORKLOADS`` are the JAX tool's two: 1080p luma on the flagship SRCNN
9-5-5 and 540p RGB on the 7-layer model (random weights, seed 0),
synthetic image-like PNGs (``generate_training_samples.synth_image``,
not noise, which is PNG's worst case). Prints one JSON line per row.

    python -m cnn_sr_tpu_torch.tools.serve_latency [--n-seq 40] [--clients 8]
        [--n-per-client 12] [--no-pallas] [--bucket N] [--deadline S]
        [--max-queue N] [--device cuda|cpu]

The server runs the bf16 stream (the JAX tool's default, ``--pallas``);
``--no-pallas`` runs the f32 kernels (``cli.resolve_precision``).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from . import ROOT, add_device_flag, check_device

# (row name, model slot, config under the repository root, height, width)
WORKLOADS = [
    ("luma_1080p", "default", "configs/srcnn_9-5-5.json", 1080, 1920),
    ("rgb_540p", "rgb", "configs/waifu2x_7layer_rgb.json", 540, 960),
]


def _png_bytes(rng, h, w):
    """Representative synthetic content (gradients, shapes, texture), not
    noise, which would overstate the host codec's share of the latency."""
    from .generate_training_samples import synth_image

    im = synth_image(rng, size=max(h, w)).crop((0, 0, w, h))
    buf = io.BytesIO()
    im.save(buf, "PNG")
    return buf.getvalue()


def _post_status(url, body):
    """Returns (seconds, http_status): 503/429 (SLO shedding) and server
    errors come back as their status instead of raising."""
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            resp.read()
        return time.perf_counter() - t0, 200
    except urllib.error.HTTPError as e:
        return time.perf_counter() - t0, e.code


def _post(url, body):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "image/png"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        resp.read()
        assert resp.status == 200
    return time.perf_counter() - t0


def _percentiles(ts):
    a = np.sort(np.asarray(ts) * 1e3)
    return {
        "p50_ms": round(float(np.percentile(a, 50)), 1),
        "p90_ms": round(float(np.percentile(a, 90)), 1),
        "p99_ms": round(float(np.percentile(a, 99)), 1),
        "mean_ms": round(float(a.mean()), 1),
        "n": len(a),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cnn_sr_tpu_torch.tools.serve_latency")
    p.add_argument("--n-seq", type=int, default=40)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--n-per-client", type=int, default=12)
    p.add_argument("--no-pallas", action="store_true",
                   help="serve with the f32 kernels instead of the bf16 stream")
    p.add_argument("--bucket", type=int, default=0,
                   help="pad single-image shapes to multiples of this (0 = exact)")
    p.add_argument("--deadline", type=float, default=0.0, metavar="S",
                   help="run the concurrent tables with the server's latency SLO "
                        "on (serve --deadline): 503/429 rejections are counted as "
                        "shed, percentiles cover SERVED requests")
    p.add_argument("--max-queue", type=int, default=0)
    add_device_flag(p)
    args = p.parse_args(argv)
    check_device(p, args.device)

    from ..serve import load_slot, make_server

    slots = {slot: load_slot(os.path.join(ROOT, cfg), seed=0, device=args.device)
             for _, slot, cfg, _, _ in WORKLOADS}
    server, worker = make_server(slots, precision="f32" if args.no_pallas else "bf16",
                                 bucket=args.bucket, deadline_s=args.deadline,
                                 max_queue=args.max_queue)
    worker.start()
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    host, port = server.server_address
    base = f"http://{host}:{port}/upscale"

    rng = np.random.default_rng(0)
    workloads = [(name, f"{base}?model={slot}", _png_bytes(rng, h, w))
                 for name, slot, _, h, w in WORKLOADS]

    try:
        for name, url, body in workloads:
            # warm-up: the first request pays the kernels' load and the
            # allocator's growth
            t_first = _post(url, body)
            _post(url, body)
            # sequential single-request latency
            ts = [_post(url, body) for _ in range(args.n_seq)]
            row = {"metric": f"serving_latency_{name}_sequential",
                   **_percentiles(ts),
                   "first_request_s": round(t_first, 3),
                   "note": "single client"}
            print(json.dumps(row), flush=True)

            # concurrent clients through the batching queue
            all_ts: list = []
            shed = [0]
            failed = [0]
            lock = threading.Lock()

            def client():
                mine, my_shed, my_failed = [], 0, 0
                for _ in range(args.n_per_client):
                    dt, status = _post_status(url, body)
                    if status == 200:
                        mine.append(dt)
                    elif status in (429, 503):
                        my_shed += 1
                    else:
                        my_failed += 1
                with lock:
                    all_ts.extend(mine)
                    shed[0] += my_shed
                    failed[0] += my_failed

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client)
                       for _ in range(args.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            n_req = args.clients * args.n_per_client
            row = {"metric": f"serving_latency_{name}_concurrent"
                             f"{args.clients}"
                             + (f"_bucket{args.bucket}" if args.bucket
                                else "")
                             + (f"_deadline{args.deadline:g}"
                                if args.deadline else ""),
                   **_percentiles(all_ts),
                   "req_per_s": round(n_req / wall, 1),
                   "failed": failed[0],
                   "note": f"{args.clients} clients back-to-back; "
                           "batching-queue regime"}
            if args.deadline:
                row["shed"] = shed[0]
                row["shed_rate"] = round(shed[0] / n_req, 3)
                row["note"] += ("; percentiles over SERVED requests, "
                                "503/429 shed counted separately")
            print(json.dumps(row), flush=True)
    finally:
        server.shutdown()
        worker.stop()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
