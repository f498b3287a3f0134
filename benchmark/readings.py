"""The readings that a cell's limits are set from, in one process on the
card: the program's numbers on each of ``--seeds`` (a short window at the
cell's own load, the answers compared as a run compares them), and the
control's on each of ``--control-seeds`` (the reference in a lower
precision, ``limits/<cell>.json``'s ``control``, put in the program's
place, on the same sampled inputs a run of that seed compares).

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--seconds 2]

Prints one JSON line a seed and a last line with the lower reading (the
largest of the program's) and the upper (the smallest of the control's)
of every number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import importlib

    import torch

    from benchmark import compare, core, generators, weights as weights_io

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    control = cell.limits["control"]
    ref = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    weights_np = weights_io.load(core.ROOT, cell.config)
    program = core.Program(cell, weights_np, args.device)
    loop = generators.loop_for(cell.mix, program)
    lower, upper = {}, {}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",")):
            loop.setup(seed)
            win = loop.window(args.seconds)
            per = compare.reference_answers(win.samples, ref, weights_np, cell.config,
                                            args.device,
                                            control=control if kind == "control" else None)
            nums = compare.worst(per)
            best = lower if kind == "program" else upper
            for k, v in nums.items():
                best[k] = max(best.get(k, v), v) if kind == "program" else min(best.get(k, v), v)
            print(json.dumps({"kind": kind, "seed": seed, "answers": len(per),
                              "failed": win.failed, "numbers": nums}), flush=True)
    print(json.dumps({"workload": args.workload, "control": control,
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
