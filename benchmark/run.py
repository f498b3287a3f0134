"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers compared beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``. Exits non-zero, printing
no result, without a CUDA card (or with fewer than the cell asks for),
when a module of JAX or of the JAX package is loaded once the window has
closed, or when the program or a file the cell names is missing. Runs the
program on the benchmark's host threads (``benchmark.HOST_THREADS``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")

from benchmark import set_host_threads  # noqa: E402

set_host_threads()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    from benchmark import core

    try:
        cell = core.load_cell(args.workload)
    except (core.CellError, OSError, KeyError, StopIteration, ValueError) as e:
        log(f"cannot load cell {args.workload!r}: {e!r}")
        return 2
    import torch

    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count = {torch.cuda.device_count()}")
        return 2
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               device="cuda", log=log)
    except ImportError as e:
        log(f"the program cannot be imported: {e!r}")
        return 2
    bad = core.forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": result.pop("memory_peak_bytes")}
    dt = result.pop("device_trace", None)
    if dt is not None:
        device.update(dt)
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
