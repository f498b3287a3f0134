"""Long-run training scheduler with checkpoint rotation.

The port's counterpart of ``tools/schedule_training.py`` (the reference's
schedule_training.py:17-93): run ``cnn_torch.py train`` in fixed-epoch
iterations as subprocesses, log each iteration's output to
``logs/log_<ts>.txt``, and snapshot the parameters file to
``logs/parameters_<ts>.json`` after each iteration. Resume works because
the config's ``parameters_file`` is reloaded at the next iteration's
start and the epoch counter persists in the JSON.

    python -m cnn_sr_tpu_torch.tools.schedule_training -c cfg.json -i samples \\
        --duration 2h [--device cuda|cpu] [-- --train-precision bf16 ...]

Arguments after ``--`` go verbatim to every ``cnn_torch.py train``;
``--device`` goes to each too.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from datetime import datetime

from . import ROOT, add_device_flag

SECONDS_PER_UNIT = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}


def convert_to_seconds(s: str) -> int:
    return int(s[:-1]) * SECONDS_PER_UNIT[s[-1]]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cnn_sr_tpu_torch.tools.schedule_training",
        description="Run training in iterations with log + parameter snapshots."
    )
    action = p.add_mutually_exclusive_group(required=True)
    action.add_argument("--duration", "-d",
                        help="X[s|m|h|d|w]: train for approximately this long")
    action.add_argument("--epochs", "-e", type=int, help="total epochs")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--in-dir", "-i", required=True, help="samples directory")
    p.add_argument("--params-file", default="data/parameters.json",
                   help="parameters file the config points at")
    p.add_argument("--epochs-per-iteration", type=int, default=500)
    p.add_argument("--logs-dir", default="logs")
    p.add_argument("--seconds-per-epoch", type=float, default=0.7,
                   help="estimate for converting --duration to epochs")
    p.add_argument("--dry", action="store_true", help="do not output any files")
    p.add_argument("--full-state", action="store_true",
                   help="pass --full-state to each iteration (momentum + "
                   "RNG survive across iterations) and snapshot the "
                   "'.state.npz' sidecar too")
    add_device_flag(p)
    p.add_argument("extra", nargs="*", default=[],
                   help="arguments after '--' are forwarded verbatim to "
                   "each cnn_torch.py train invocation (e.g. -- "
                   "--train-precision bf16 --data-parallel 4)")
    args = p.parse_args(argv)

    if args.duration:
        total_epochs = int(convert_to_seconds(args.duration) / args.seconds_per_epoch)
    else:
        total_epochs = args.epochs
    per_iter = args.epochs_per_iteration
    total_epochs = max(total_epochs, per_iter)
    iters = total_epochs // per_iter
    total_epochs = iters * per_iter

    cmd = [sys.executable, os.path.join(ROOT, "cnn_torch.py"), "train", "-c", args.config,
           "-i", args.in_dir, "-e", str(per_iter), "--device", args.device]
    if args.dry:
        cmd.append("dry")
    else:
        cmd += ["-o", args.params_file]
    if args.full_state:
        cmd.append("--full-state")
    cmd += args.extra
    print(f"Command to execute:\n'{' '.join(cmd)}'")
    print(f"Will do {iters} iterations x {per_iter} epochs = {total_epochs} total")

    os.makedirs(args.logs_dir, exist_ok=True)
    start = time.time()
    for i in range(iters):
        stamp = datetime.now().strftime("%Y-%m-%d--%H-%M-%S")
        log_path = os.path.join(args.logs_dir, f"log_{stamp}.txt")
        snap_path = os.path.join(args.logs_dir, f"parameters_{stamp}.json")
        left_min = int((iters - i) * per_iter * args.seconds_per_epoch) // 60
        print(f"\n---- {i + 1}/{iters} - {stamp} (est. time left: {left_min}min) ----")

        with open(log_path, "w") as log:
            rc = subprocess.call(cmd, stdout=log, stderr=subprocess.STDOUT)
        print(f"return code: {rc}")
        if rc != 0:
            print("---- FAIL ----")
            return rc

        if not args.dry:
            print(f"saving sub results to: '{snap_path}'")
            shutil.copy2(args.params_file, snap_path)
            sidecar = args.params_file + ".state.npz"
            if args.full_state and os.path.isfile(sidecar):
                shutil.copy2(sidecar, snap_path + ".state.npz")

    dt = time.time() - start
    print(
        f"Execution time: {dt:.3f}s = {dt / 60:.2f}min "
        f"({dt / total_epochs:.5f} s/epoch)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
