"""Timed training run + ranked per-stage breakdown.

The port's counterpart of ``tools/profile.py`` (the reference's
profile.py:9-53): run ``cnn_torch.py train dry [profile]`` as a
subprocess, measure wall clock and s/epoch, and in ``stage`` mode
re-print the CLI's ranked stage table (``STAGE_LINE``) and its ranked
device time by op (the hand-written kernels and cuDNN's under their own
names on a card).

    python -m cnn_sr_tpu_torch.tools.profile -c cfg.json -i samples -e 100 [stage] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

from . import ROOT, add_device_flag

STAGE_LINE = re.compile(r"^\s*([\d.]+)s\s+\(\s*([\d.]+)%\)\s+x(\d+)\s+-\s+(.*)$")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cnn_sr_tpu_torch.tools.profile",
                                description="Profile a training run.")
    p.add_argument("mode", nargs="?", choices=["stage"], default=None,
                   help="'stage' = also print the per-stage breakdown")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--in-dir", "-i", required=True)
    p.add_argument("--epochs", "-e", type=int, default=100)
    add_device_flag(p)
    args = p.parse_args(argv)

    cmd = [sys.executable, os.path.join(ROOT, "cnn_torch.py"), "train", "dry",
           "-c", args.config, "-i", args.in_dir, "-e", str(args.epochs),
           "--device", args.device]
    if args.mode == "stage":
        cmd.append("profile")
    print(f"Command to execute:\n'{' '.join(cmd)}'")
    print(f"Will do {args.epochs} epochs")

    start = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.time() - start
    if proc.returncode != 0:
        print("---- FAIL ----")
        print(proc.stdout[-2000:])
        print(proc.stderr[-2000:])
        return proc.returncode

    print(
        f"Execution time: {dt:.3f}s = {dt / 60:.2f}min "
        f"({dt / args.epochs:.5f} s/epoch, {args.epochs / dt:.2f} epochs/s)"
    )

    if args.mode == "stage":
        stages = []
        for line in proc.stdout.splitlines():
            m = STAGE_LINE.match(line)
            if m:
                stages.append((float(m.group(1)), float(m.group(2)),
                               int(m.group(3)), m.group(4)))
        total = sum(s[0] for s in stages)
        for secs, pct, count, name in sorted(stages):
            print(f"{secs:8.4f}s ({pct:5.2f}%) x{count:<5d} - {name[:65]}")
        print(f"Time in measured stages: {total:.4f}s "
              f"({total * 100 / dt:.2f}% of wall clock)")
        # re-print the CLI's ranked per-op device-time table verbatim
        in_ops = False
        for line in proc.stdout.splitlines():
            if line.startswith("---- op profile"):
                in_ops = True
            if in_ops:
                print(line)
            if in_ops and line.startswith("Total device op time"):
                in_ops = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
