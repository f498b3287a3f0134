"""Where a cell's idle device time lies among the program's own spans,
from one traced run on the card.

    python3 benchmark/idle_split.py --workload <cell> --seed <n> [--seconds 10]

Runs the cell as ``run.py --trace 1`` does and prints one JSON line: the
run's per-layer metrics and counters, the window's idle seconds, and the
idle seconds by the innermost of the program's spans open at each gap's
midpoint (``program_spans.idle_by_span``), alone and beside the innermost
host event there (``trace.idle_gaps``' name: ``cudaMemcpyAsync``, an aten
op, or the span itself where the host ran Python).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import set_host_threads  # noqa: E402

set_host_threads()


def split(events, top: int = 25) -> dict:
    from benchmark import program_spans, trace

    launching = program_spans.launching_threads(events)
    host: dict = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in trace.HOST_CATS and e.get("dur")
                and e.get("tid") in launching and not e.get("name", "").startswith("bench.")):
            host[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                       e.get("name", "")))
    segs = [trace._innermost(h) for h in host.values()]
    starts = [[sg[0] for sg in ss] for ss in segs]
    gs = sorted(program_spans.gaps(events))
    by_pair: dict = defaultdict(float)
    for (mid, length), (_, st) in zip(gs, program_spans.gap_stacks(events)):
        what = "host idle"
        for ss, s0 in zip(segs, starts):
            i = bisect.bisect_right(s0, mid) - 1
            if i >= 0 and ss[i][1] >= mid:
                what = ss[i][2]
                break
        by_pair[f"{st[0][-1] if st else 'outside'} / {what}"] += length / 1e6
    return {"idle_s": sum(length for _, length in gs) / 1e6,
            "api_idle_s": program_spans.api_idle_us(events) / 1e6,
            "server_idle_s": program_spans.server_idle_us(events) / 1e6,
            "by_span": [[k, v / 1e6] for k, v in program_spans.idle_by_span(events)[:top]],
            "by_span_and_host": [[k, v] for k, v in
                                 sorted(by_pair.items(), key=lambda kv: -kv[1])[:top]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    from benchmark import core, trace

    kept = []
    load = trace.load

    def keep(path):
        kept.append(load(path))
        return kept[-1]

    trace.load = keep
    logs = []
    result = core.run_cell(args.workload, args.seed, args.seconds, True, device="cuda",
                           log=logs.append)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": result["correct"], "metrics": result["metrics"],
                      "device_trace": result.get("device_trace"),
                      "window": [ln for ln in logs if ln.startswith("window")],
                      **split(kept[0])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
