"""HTTP upscaling service on the port (stdlib HTTP, torch on the device).

Counterpart of ``tools/serve.py``, run as ``python -m cnn_sr_tpu_torch.serve``:

* **model slots**: ``-c cfg.json`` registers the ``default`` slot;
  repeatable ``--model name=cfg.json`` adds named slots selected per
  request with ``POST /upscale?model=name``. Each slot's weights stay on
  the device.
* **device-owner worker + batching queue**: one thread launches on the
  device. HTTP handler threads decode and encode images and enqueue
  jobs; the worker drains the queue, groups the same-model, same-shape
  jobs that arrive within ``--batch-wait-ms`` into one
  ``api.upscale_batch`` (one conv-stack call over the group, the same
  output as the single-image path), and runs the rest through
  ``api.upscale_image`` with ``--bucket`` shape buckets.
* **spatial latency mode** (``--spatial-shard N``): instead of batching,
  every request runs alone with its rows split over N devices
  (``api.upscale_image_spatial``: one halo exchange per image).
* **latency SLO policy** (``--deadline S``): admission control answers
  **503 + Retry-After** when the EWMA-estimated queue wait exceeds the
  deadline; jobs whose queue wait crossed the deadline are answered 503
  at dequeue instead of dispatched; ``--max-queue N`` bounds the queue
  (**429** beyond it).
* **observability**: ``GET /models`` (slots and per-slot request counts),
  ``GET /stats`` (queue depth, batch counts, errors, EWMA service time,
  current wait estimate, and a ``stalled`` flag: the in-flight dispatch
  has run far past its EWMA), ``GET /healthz``.

    python -m cnn_sr_tpu_torch.serve -c cfg.json [--model rgb=rgb.json ...]
        [--port 8200] [--precision f32|bf16] [--pallas [--pallas-precision P]]
        [--device cuda|cpu]
        [--scale 2] [--max-batch 8] [--batch-wait-ms 3] [--bucket 64]
        [--spatial-shard N]

    curl -s --data-binary @photo.png localhost:8200/upscale > photo_sr.png
    curl -s --data-binary @a.png 'localhost:8200/upscale?model=rgb' > b.png
    curl -s localhost:8200/stats

``--precision bf16`` runs the bf16 stream of the conv kernels, f32 (the
default) the f32 ones. The JAX server's ``--pallas`` and
``--pallas-precision`` map onto it as on the CLI (``cli.resolve_precision``):
``--pallas`` alone is bf16, ``--pallas --pallas-precision f32`` is f32,
no ``--pallas`` is f32 (the JAX server's XLA forward); a ``--precision``
that contradicts ``--pallas`` is an error. ``--device cuda`` (the
default) needs a card and ``cpu`` runs the kernels' plain version. Pillow is imported only by the
HTTP handler, so the worker runs where Pillow is missing.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class DeadlineExceeded(Exception):
    """A request spent longer than the latency deadline in the queue
    (failed before dispatch: the device never ran it). Maps to 503."""


class Rejected(Exception):
    """Admission-control rejection (queue full / expected wait exceeds
    the deadline). Carries the HTTP code and a Retry-After hint."""

    def __init__(self, code: int, message: str, retry_after_s: float):
        super().__init__(message)
        self.code = code
        self.retry_after_s = retry_after_s


class _Job:
    """One enqueued upscale request; the handler thread blocks on
    ``done`` until the device worker fills ``result`` or ``error``."""

    __slots__ = ("model", "rgba", "done", "result", "error", "t_submit")

    def __init__(self, model: str, rgba: np.ndarray):
        self.model = model
        self.rgba = rgba
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.t_submit = time.monotonic()


class DeviceWorker(threading.Thread):
    """The single thread that launches on the device.

    Pulls jobs from the queue; after the first job of a round, waits up
    to ``batch_wait_ms`` for more (max ``max_batch``), groups them by
    (model, image shape) and dispatches each group of two or more as one
    ``upscale_batch``, each single through ``upscale_image``. With
    ``spatial_shard`` > 0 (latency mode) every job runs alone through
    ``upscale_image_spatial`` over that many devices of its slot's kind.
    """

    def __init__(self, slots: dict, precision: str = "f32",
                 scale: float = 1.0, max_batch: int = 8,
                 batch_wait_ms: float = 3.0, bucket: int = 0,
                 job_timeout_s: float = 600.0,
                 spatial_shard: int = 0,
                 max_body_bytes: int = 64 * 1024 * 1024,
                 deadline_s: float = 0.0,
                 max_queue: int = 0):
        super().__init__(daemon=True, name="device-worker")
        self.slots = slots
        self.precision = precision
        # >0: latency mode, every image's rows over this many devices
        # (halo-exchange spatial sharding) instead of batching requests
        self.spatial_shard = spatial_shard
        self.max_body_bytes = max_body_bytes
        self.scale = scale
        self.max_batch = max(1, max_batch)
        self.batch_wait_s = max(0.0, batch_wait_ms) / 1e3
        self.bucket = bucket
        self.job_timeout_s = job_timeout_s
        # latency SLO policy: deadline_s > 0 sheds load with 503 +
        # Retry-After when the EWMA-estimated queue wait already exceeds
        # the deadline, and fails (503) any job whose queue wait crossed
        # the deadline before dispatching it. max_queue > 0 bounds the
        # queue depth (429 beyond it).
        self.deadline_s = max(0.0, deadline_s)
        self.max_queue = max(0, max_queue)
        self._ewma_job_s: float | None = None  # None until the first round
        self._dispatch_started: float | None = None
        self.queue: "queue.Queue[_Job | None]" = queue.Queue()
        self._stopping = False
        self.lock = threading.Lock()
        self.stats = {
            "requests": 0, "ok": 0, "errors": 0,
            "rounds": 0, "batched_jobs": 0, "max_batch_seen": 0,
            "rejected_queue_full": 0, "rejected_load": 0,
            "rejected_deadline": 0,
            "per_model": {name: 0 for name in slots},
        }

    def _est_wait_s(self) -> float:
        """Expected queue wait for a new arrival: per-job EWMA service
        time × jobs ahead, plus the in-flight dispatch's remaining time
        (its full EWMA when one is running, or what has elapsed if more).
        0.0 until the first round completes (a cold start never sheds)."""
        ewma = self._ewma_job_s
        if ewma is None:
            return 0.0
        est = self.queue.qsize() * ewma
        started = self._dispatch_started
        if started is not None:
            est += max(ewma, time.monotonic() - started)
        return est

    def submit(self, job: _Job) -> None:
        """Enqueue, or raise ``Rejected`` (admission control)."""
        if self._stopping:
            job.error = RuntimeError("server shutting down")
            job.done.set()
            return
        with self.lock:
            self.stats["requests"] += 1
            if job.model in self.stats["per_model"]:
                self.stats["per_model"][job.model] += 1
            if self.max_queue and self.queue.qsize() >= self.max_queue:
                self.stats["rejected_queue_full"] += 1
                raise Rejected(
                    429, f"queue full ({self.max_queue} jobs)",
                    self._est_wait_s() or 1.0)
            if self.deadline_s:
                est = self._est_wait_s()
                if est > self.deadline_s:
                    self.stats["rejected_load"] += 1
                    raise Rejected(
                        503,
                        f"expected queue wait {est:.1f}s exceeds the "
                        f"{self.deadline_s:.1f}s deadline",
                        est - self.deadline_s)
        self.queue.put(job)

    def stop(self) -> None:
        self._stopping = True
        self.queue.put(None)

    def _drain_queue(self) -> None:
        """Fail any jobs still enqueued (shutdown) so their handler
        threads unblock at once instead of at the timeout."""
        while True:
            try:
                job = self.queue.get_nowait()
            except queue.Empty:
                return
            if job is not None:
                job.error = RuntimeError("server shutting down")
                job.done.set()

    def snapshot(self) -> dict:
        with self.lock:
            s = {**self.stats, "per_model": dict(self.stats["per_model"])}
        s["queue_depth"] = self.queue.qsize()
        s["models"] = sorted(self.slots)
        # SLO observability: EWMA service time, the wait estimate that
        # admission control would use now, and a stall flag (the
        # in-flight dispatch has run far past its EWMA)
        ewma = self._ewma_job_s
        s["ewma_job_s"] = round(ewma, 4) if ewma is not None else None
        s["est_wait_s"] = round(self._est_wait_s(), 3)
        started = self._dispatch_started
        elapsed = (time.monotonic() - started) if started is not None else 0.0
        s["dispatch_elapsed_s"] = round(elapsed, 3)
        s["stalled"] = bool(
            started is not None
            and elapsed > max(10.0, 5 * (ewma or 0.0) * self.max_batch))
        s["deadline_s"] = self.deadline_s or None
        s["max_queue"] = self.max_queue or None
        return s

    # ---- worker internals ----

    def run(self) -> None:
        while not self._stopping:
            job = self.queue.get()
            if job is None:
                break
            batch = [job]
            deadline = time.monotonic() + self.batch_wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self.queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stopping = True
                    break
                batch.append(nxt)

            if self.deadline_s:
                # shed at dequeue: a job whose queue wait already blew the
                # deadline gets a fast 503 instead of a dispatch whose
                # result its client has given up on
                now = time.monotonic()
                live = []
                for j in batch:
                    if now - j.t_submit > self.deadline_s:
                        j.error = DeadlineExceeded(
                            f"spent {now - j.t_submit:.1f}s queued "
                            f"(> {self.deadline_s:.1f}s deadline)")
                        j.done.set()
                        with self.lock:
                            self.stats["rejected_deadline"] += 1
                    else:
                        live.append(j)
                batch = live
            groups: dict = {}
            for j in batch:
                groups.setdefault((j.model, j.rgba.shape), []).append(j)
            t0 = time.monotonic()
            self._dispatch_started = t0
            try:
                for group in groups.values():
                    self._process_group(group)
            finally:
                self._dispatch_started = None
            if batch:
                per_job = (time.monotonic() - t0) / len(batch)
                prev = self._ewma_job_s
                self._ewma_job_s = (per_job if prev is None
                                    else 0.7 * prev + 0.3 * per_job)
            with self.lock:
                self.stats["rounds"] += 1
                self.stats["max_batch_seen"] = max(
                    self.stats["max_batch_seen"], len(batch))
        self._drain_queue()

    def _process_group(self, jobs) -> None:
        from .api import upscale_batch, upscale_image, upscale_image_spatial

        try:
            slot = self.slots[jobs[0].model]
            cfg, params = slot["cfg"], slot["params"]
            rgbas = [self._pre_scale(j.rgba, params) for j in jobs]
            if self.spatial_shard:
                # latency mode: one image at a time, its rows over the mesh
                for j, rgba in zip(jobs, rgbas):
                    j.result = upscale_image_spatial(cfg, params, rgba, self.spatial_shard,
                                                     precision=self.precision)
            elif len(jobs) > 1:
                # one batched dispatch per same-shape group, luma and RGB
                outs = upscale_batch(cfg, params, np.stack(rgbas),
                                     precision=self.precision)
                for j, out in zip(jobs, outs):
                    j.result = out
                with self.lock:
                    self.stats["batched_jobs"] += len(jobs)
            else:
                for j, rgba in zip(jobs, rgbas):
                    j.result = upscale_image(cfg, params, rgba, bucket=self.bucket,
                                             precision=self.precision)
            with self.lock:
                self.stats["ok"] += len(jobs)
        except Exception as e:  # noqa: BLE001 — reported per job to clients
            for j in jobs:
                j.error = e
            with self.lock:
                self.stats["errors"] += len(jobs)
        finally:
            for j in jobs:
                j.done.set()

    def _pre_scale(self, rgba: np.ndarray, params) -> np.ndarray:
        """The bicubic pre-upscale by ``scale``, on the slot's device."""
        if self.scale == 1.0:
            return rgba
        import torch

        from .ops.resize import upscale_rgba

        img = torch.as_tensor(np.require(rgba, requirements=("C", "W")),
                              device=params[0]["w"].device)
        return upscale_rgba(img, self.scale).cpu().numpy()


def build_handler(worker: DeviceWorker):
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            print(f"[serve] {fmt % args}")

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, obj, code: int = 200) -> None:
            self._reply(code, (json.dumps(obj) + "\n").encode(),
                        "application/json")

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/healthz":
                self._reply(200, b"ok\n", "text/plain")
            elif path == "/models":
                snap = worker.snapshot()
                self._reply_json({
                    "models": {
                        name: {
                            "layers": [
                                {"f": s.f, "n_in": s.n_in, "n_out": s.n_out}
                                for s in slot["cfg"].layer_specs()
                            ],
                            "channels": slot["cfg"].channels,
                            "requests": snap["per_model"].get(name, 0),
                        }
                        for name, slot in worker.slots.items()
                    },
                })
            elif path == "/stats":
                self._reply_json(worker.snapshot())
            else:
                self.send_error(404)

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path != "/upscale":
                self.send_error(404)
                return
            model = urllib.parse.parse_qs(parsed.query).get(
                "model", ["default"])[0]
            if model not in worker.slots:
                self._reply_json(
                    {"error": f"unknown model {model!r}",
                     "models": sorted(worker.slots)}, code=404)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > worker.max_body_bytes:
                    self._reply_json(
                        {"error": f"body {length} bytes exceeds the "
                                  f"{worker.max_body_bytes}-byte limit"},
                        code=413)
                    return
                raw = self.rfile.read(length)
                # PIL's own decompression-bomb guard (Image.MAX_IMAGE_PIXELS)
                # stays active and bounds the decoded size
                with Image.open(io.BytesIO(raw)) as im:
                    rgba = np.asarray(im.convert("RGBA"), dtype=np.uint8)
            except Exception as e:  # noqa: BLE001 — bad input is a client error
                self._reply(400, f"error: {type(e).__name__}: {e}\n".encode(),
                            "text/plain")
                return

            job = _Job(model, rgba)
            try:
                worker.submit(job)
            except Rejected as rej:  # admission control: fast, honest
                self.send_response(rej.code)
                self.send_header("Retry-After",
                                 str(max(1, int(rej.retry_after_s + 0.5))))
                body = f"error: {rej}\n".encode()
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if not job.done.wait(worker.job_timeout_s) or job.error is not None:
                err = job.error or TimeoutError("device worker timeout")
                # ValueError = bad request content (shape, format);
                # DeadlineExceeded = overload (503, retryable); anything
                # else, device and runtime errors included, is a server fault
                if isinstance(job.error, ValueError):
                    code = 400
                elif isinstance(job.error, DeadlineExceeded):
                    code = 503
                else:
                    code = 500
                self._reply(
                    code,
                    f"error: {type(err).__name__}: {err}\n".encode(),
                    "text/plain")
                return
            buf = io.BytesIO()
            Image.fromarray(job.result, "RGB").save(buf, "PNG")
            self._reply(200, buf.getvalue(), "image/png")

    return Handler


def load_slot(config_path: str, seed=None, device="cuda") -> dict:
    """Build one model slot: the config and its parameters on ``device``
    (loaded from the config's ``parameters_file`` when set, random-init
    from ``seed`` otherwise)."""
    from .utils.config import read_config
    from .utils.params_io import init_params, params_to_torch

    cfg = read_config(config_path)
    return {"cfg": cfg, "params": params_to_torch(init_params(cfg, seed=seed)[0], device)}


def make_server(slots: dict, host: str = "127.0.0.1", port: int = 0,
                precision: str = "f32", scale: float = 1.0,
                max_batch: int = 8, batch_wait_ms: float = 3.0,
                bucket: int = 0, job_timeout_s: float = 600.0,
                spatial_shard: int = 0,
                max_body_bytes: int = 64 * 1024 * 1024,
                deadline_s: float = 0.0, max_queue: int = 0):
    """Wire up (ThreadingHTTPServer, DeviceWorker); the caller starts both."""
    worker = DeviceWorker(slots, precision=precision, scale=scale,
                          max_batch=max_batch, batch_wait_ms=batch_wait_ms,
                          bucket=bucket, job_timeout_s=job_timeout_s,
                          spatial_shard=spatial_shard,
                          max_body_bytes=max_body_bytes,
                          deadline_s=deadline_s, max_queue=max_queue)
    server = ThreadingHTTPServer((host, port), build_handler(worker))
    return server, worker


def build_parser() -> argparse.ArgumentParser:
    from .cli import add_precision_flags

    p = argparse.ArgumentParser(prog="python -m cnn_sr_tpu_torch.serve",
                                description="HTTP upscaling service (PyTorch/CUDA).")
    p.add_argument("--config", "-c",
                   help="config for the 'default' model slot")
    p.add_argument("--model", "-m", action="append", default=[],
                   metavar="NAME=CONFIG",
                   help="add a named model slot (repeatable)")
    p.add_argument("--port", type=int, default=8200)
    p.add_argument("--host", default="127.0.0.1")
    add_precision_flags(p)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the CUDA kernels; cpu their plain version")
    p.add_argument("--scale", type=float, default=1.0,
                   help="bicubic pre-upscale of every request by this factor")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-batch", type=int, default=8,
                   help="max requests fused into one device batch")
    p.add_argument("--batch-wait-ms", type=float, default=3.0,
                   help="how long the first request of a round waits "
                        "for batch-mates")
    p.add_argument("--bucket", type=int, default=64,
                   help="pad single-image shapes to multiples of this "
                        "(0 = exact shapes)")
    p.add_argument("--spatial-shard", type=int, default=0, metavar="N",
                   help="latency mode: split every image's rows over N devices "
                        "(halo exchange) instead of batching requests, for hosts "
                        "with several cards serving large frames (0 = off)")
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--job-timeout", type=float, default=600.0,
                   help="seconds a request waits for the device worker")
    p.add_argument("--deadline", type=float, default=0.0, metavar="S",
                   help="latency SLO: shed load with 503 + Retry-After "
                        "when the estimated queue wait exceeds S "
                        "seconds, and 503 any job whose queue wait "
                        "crossed S before dispatch (0 = off; a cold "
                        "start never sheds: the estimate needs one "
                        "completed round)")
    p.add_argument("--max-queue", type=int, default=0, metavar="N",
                   help="reject (429) requests beyond N queued jobs "
                        "(0 = unbounded)")
    return p


def main(argv=None) -> int:
    from .cli import resolve_precision

    p = build_parser()
    args = p.parse_args(argv)
    resolve_precision(p, args)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: no CUDA device is available")

    slots = {}
    if args.config:
        slots["default"] = load_slot(args.config, seed=args.seed, device=args.device)
    for spec in args.model:
        name, _, path = spec.partition("=")
        if not path:
            p.error(f"--model needs NAME=CONFIG, got {spec!r}")
        slots[name] = load_slot(path, seed=args.seed, device=args.device)
    if not slots:
        p.error("register at least one model (-c and/or --model)")
    for name, slot in slots.items():
        print(f"[serve] model {name!r}:")
        print(slot["cfg"])

    server, worker = make_server(
        slots, args.host, args.port, precision=args.precision,
        scale=args.scale, max_batch=args.max_batch,
        batch_wait_ms=args.batch_wait_ms, bucket=args.bucket,
        job_timeout_s=args.job_timeout, spatial_shard=args.spatial_shard,
        max_body_bytes=args.max_body_mb * 1024 * 1024,
        deadline_s=args.deadline, max_queue=args.max_queue)
    worker.start()
    print(f"[serve] listening on http://{args.host}:{server.server_address[1]} "
          f"(POST /upscale[?model=NAME], GET /models /stats /healthz; "
          f"{args.device}, {args.precision})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        worker.stop()
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
