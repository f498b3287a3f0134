"""The ``cnn_torch`` command line: forward mode of ``cnn_sr_tpu/cli.py``.

    python cnn_torch.py [dry] -c cfg.json -i <image|dir> [-o <out>]
                        [--seed N] [--device cuda|cpu] [--precision f32|bf16]
                        [--bucket N] [--scale X]

Decode → (bicubic pre-upscale by ``--scale``) → luma or RGB pipeline (by
the config's ``channels``) → net → swap → encode, for one image or for
every image of a directory (written as ``<stem>_sr.png``). ``dry`` runs
without writing. ``--device cuda`` (the default) runs the CUDA kernels
and fails without a card; ``cpu`` runs their plain version.
``--precision bf16`` runs the bf16 stream (the JAX CLI's ``--pallas``);
``--bucket N`` pads shapes to multiples of N, as the JAX CLI's. Not
ported yet (ROADMAP.md Queue 1): the ``train`` and ``profile`` modes,
``--spatial-shard``, ``--data-parallel``, ``--packed-io`` and
``--trace-dir``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cnn_torch",
        description="SRCNN super-resolution on PyTorch/CUDA: upscale images.",
    )
    p.add_argument("-c", "--config", required=True, help="CNN configuration file")
    p.add_argument("-i", "--in", dest="in_path", required=True,
                   help="image, or a directory of images")
    p.add_argument("-o", "--out", dest="out_path", default=None,
                   help="result image, or directory for a directory input")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the random weights when the config names no "
                   "parameters file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the CUDA kernels; cpu their plain version")
    p.add_argument("--precision", choices=("f32", "bf16"), default="f32",
                   help="conv-stack precision: f32, or the bf16 stream with the "
                   "int8 first layer (the JAX CLI's --pallas)")
    p.add_argument("--bucket", type=int, default=0,
                   help="pad image shapes up to multiples of this (identical "
                   "results; 0 = exact shapes)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="bicubic upscale of the input on the device by this "
                   "factor before the net")
    return p


def _load_model(args, cfg):
    import torch

    from .utils.params_io import init_params, params_to_torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    params, _ = init_params(cfg, seed=args.seed)
    return params_to_torch(params, torch.device(args.device))


def _upscale_file(args, cfg, params, src: str, dst: Optional[str]) -> None:
    from .api import upscale_image
    from .ops.image import load_image, write_image

    rgba = load_image(src)
    t0 = time.perf_counter()
    if args.scale != 1.0:
        import numpy as np
        import torch

        from .ops.resize import upscale_rgba

        img = torch.as_tensor(np.require(rgba, requirements=("C", "W")),
                              device=params[0]["w"].device)
        rgba = upscale_rgba(img, args.scale).cpu().numpy()
        print(f"Pre-scaled by {args.scale}x to {rgba.shape[1]}x{rgba.shape[0]}")
    out = upscale_image(cfg, params, rgba, bucket=args.bucket, precision=args.precision)
    dt = time.perf_counter() - t0
    print(f"{src}: {rgba.shape[1]}x{rgba.shape[0]} upscaled in {dt * 1e3:.1f} ms")
    if dst:
        write_image(dst, out)
        print(f"Output written: {dst}")


def run_forward(args, cfg) -> int:
    # forward mode with random weights only ever produces garbage, so a
    # parameters file that is named but missing is an error here
    if cfg.parameters_file and not os.path.isfile(cfg.parameters_file):
        print(f"Parameters file not found: '{cfg.parameters_file}' "
              "(forward mode needs trained weights)")
        return 1
    params = _load_model(args, cfg)
    if not os.path.isdir(args.in_path):
        _upscale_file(args, cfg, params, args.in_path, args.out_path)
        return 0
    return _run_forward_dir(args, cfg, params)


def _run_forward_dir(args, cfg, params) -> int:
    files = sorted(f for f in os.listdir(args.in_path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        print(f"no images found in '{args.in_path}'")
        return 1
    if args.out_path:
        os.makedirs(args.out_path, exist_ok=True)
    for name in files:
        dst = None
        if args.out_path:
            dst = os.path.join(args.out_path, f"{os.path.splitext(name)[0]}_sr.png")
        _upscale_file(args, cfg, params, os.path.join(args.in_path, name), dst)
    return 0


_MODE_WORDS = {"train", "dry", "profile"}
_VALUED_OPTS = {"-c", "--config", "-i", "--in", "-o", "--out", "--seed", "--device",
                "--precision", "--bucket", "--scale"}


def _split_modes(argv: List[str]):
    """Extract bare-word mode flags from anywhere in the argument list
    (``cnn_torch dry -c cfg -i img``); a valued option's argument is never
    taken for one."""
    modes, rest = set(), []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in _VALUED_OPTS and i + 1 < len(argv):
            rest.extend(argv[i : i + 2])
            i += 2
        elif tok in _MODE_WORDS:
            modes.add(tok)
            i += 1
        else:
            rest.append(tok)
            i += 1
    return modes, rest


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    modes, rest = _split_modes(list(argv))
    args = build_parser().parse_args(rest)
    unported = modes & {"train", "profile"}
    if unported:
        print(f"mode(s) {sorted(unported)} are not ported yet; use cnn.py")
        return 1
    if "dry" in modes:
        args.out_path = None
    elif not args.out_path:
        print("Either provide out path or do the dry run")
        return 1

    from .utils.config import ConfigError, read_config

    try:
        cfg = read_config(args.config)
    except FileNotFoundError:
        print(f"Config file not found: '{args.config}'")
        return 1
    except ConfigError as e:
        print(f"Invalid config: {e}")
        return 1
    print(cfg)
    try:
        rc = run_forward(args, cfg)
    except FileNotFoundError as e:
        print(f"File not found: {e}")
        return 1
    except (ValueError, RuntimeError) as e:
        print(f"Error: {e}")
        return 1
    if rc == 0:
        print("DONE")
    return rc


if __name__ == "__main__":
    sys.exit(main())
