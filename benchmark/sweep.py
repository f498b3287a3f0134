"""Find the rate an open-loop mix sustains: one window at each offered
rate, in one process on the card.

    python3 benchmark/sweep.py --workload <cell> --rates 10,15,20 [--seconds 10]
        [--seeds 1,2] [--set block=20 ...]

Prints a JSON line a rate: requests, the rate completed, p50/p95/p99 of
latency, and the median latency of the window's last quarter of requests
over its first quarter (above 1 by far: the backlog grows).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import set_host_threads  # noqa: E402

set_host_threads()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", default="1", help="a window for each seed at each rate")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="override a key of the mix, e.g. block=20")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark import core, generators, weights as weights_io

    cell = core.load_cell(args.workload)
    weights_np = weights_io.load(core.ROOT, cell.config)
    program = core.Program(cell, weights_np, args.device)
    mix = dict(cell.mix)
    for kv in args.set:
        key, value = kv.split("=", 1)
        mix[key] = json.loads(value)
    for rate, seed in ((float(r), int(s)) for r in args.rates.split(",")
                       for s in args.seeds.split(",")):
        loop = generators.loop_for({**mix, "rate_per_s": rate}, program)
        loop.setup(seed)
        win = loop.window(args.seconds)
        lat = win.latencies_s
        q = max(1, len(lat) // 4)
        xs = sorted(lat)
        pct = {f"p{k}_ms": xs[max(0, math.ceil(k / 100 * len(xs)) - 1)] * 1e3 for k in (50, 95, 99)}
        print(json.dumps({"rate_per_s": rate, "seed": seed, "set": args.set,
                          "requests": len(lat), "failed": win.failed,
                          "completed_per_s": (len(lat) - win.failed) / (win.t_end - win.t0),
                          "mpix_per_s": win.out_pixels / 1e6 / (win.t_end - win.t0),
                          **pct, "last_over_first_quarter": statistics.median(lat[-q:])
                          / statistics.median(lat[:q]),
                          "jobs_per_round": win.counters["ok"] / max(1, win.counters["rounds"]),
                          "lateness_max_ms": max(win.lateness_s) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
