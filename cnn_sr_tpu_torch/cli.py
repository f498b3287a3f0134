"""The ``cnn_torch`` command line: ``cnn_sr_tpu/cli.py`` on PyTorch/CUDA.

    python cnn_torch.py [dry] [profile] -c cfg.json -i <image|dir> [-o <out>]
                        [--seed N] [--device cuda|cpu] [--precision f32|bf16]
                        [--pallas [--pallas-precision bf16|f32]]
                        [--bucket N] [--scale X] [--spatial-shard N] [--trace-dir D]
    python cnn_torch.py train [dry] [profile] -c cfg.json -i <samples dir> -e N
                        [-o params.json]
                        [--device cuda|cpu] [--train-precision highest|high|default|bf16]
                        [--validation-percent P] [--mini-batch-count M]
                        [--validation-cadence C] [--epochs-per-dispatch K]
                        [--full-state] [--seed N] [--data-parallel N] [--trace-dir D]

Forward mode: decode → (bicubic pre-upscale by ``--scale``) → luma or RGB
pipeline (by the config's ``channels``) → net → swap → encode, for one
image or for every image of a directory (written as ``<stem>_sr.png``).
``--precision bf16`` runs the bf16 stream. The JAX CLI's ``--pallas`` and
``--pallas-precision`` are taken and map onto it: ``--pallas`` alone is
``bf16``, ``--pallas --pallas-precision f32`` is ``f32``, and without
``--pallas`` the JAX CLI runs XLA in f32, which is ``f32`` here; a
``--precision`` that contradicts ``--pallas`` is an error. ``--bucket N``
pads shapes to multiples of N, as the JAX CLI's.
``--spatial-shard N`` splits each image's rows over N devices of
``--device``'s kind with one halo exchange (``api.upscale_image_spatial``).

Training mode (``train``): pair the samples of the directory, train for
``-e`` epochs with the reference's exact update rule
(``training.train_loop``) and write the parameters file, which ``cnn.py``
and ``cnn_torch.py`` both load. The reference's hardcoded knobs are
flags with its values as defaults (``--validation-percent`` 20,
``--mini-batch-count`` 2, ``--validation-cadence`` 25);
``--epochs-per-dispatch`` queues that many epochs per host round trip;
``--full-state`` saves and resumes the momentum buffers and the shuffle
RNG in ``<params>.state.npz``, the same sidecar as the JAX package's.
``--train-precision``: ``highest`` is f32 with TF32 off; ``high`` and
``default`` are TF32 convolutions on the card (plain f32 on the CPU);
``bf16`` is mixed precision with f32 master weights. ``--data-parallel N``
splits the samples over N devices (``parallel.make_mesh``) and sums the
replicas' gradients; the train and validation splits must divide by N.

``dry`` runs without writing. ``profile`` times the stages (``load_image``,
``upscale_input (bicubic)``, the upscale, ``write_image``;
``load_samples``, ``train_loop``), traces the run with ``torch.profiler``
into ``--trace-dir`` (a temporary directory without one), warns at every
host-blocking device operation (``utils.debug.warn_blocking_transfers``),
and at the end prints the ranked stage table, the ranked device time by
op (``profiling.report_op_shares``: the hand-written kernels under their
own names on a card) and the device memory. ``--trace-dir D`` without
``profile`` writes the trace and prints no table. Profiling changes no
output. ``--device cuda`` (the default) runs on the
card and fails without one; ``cpu`` runs the plain versions.
``--packed-io`` and ``--no-packed-io`` are accepted and do nothing: the
JAX CLI's uint32-packed color ends change only the TPU's layout, not
the output.

A device count N of -1 means every device of the kind: every card, or on
the CPU the CPU named once per core (``parallel.available_devices``).
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
        description="SRCNN super-resolution on PyTorch/CUDA: train or upscale.",
    )
    p.add_argument("-c", "--config", required=True, help="CNN configuration file")
    p.add_argument("-i", "--in", dest="in_path", required=True,
                   help="image or directory of images (forward), samples directory "
                   "(training)")
    p.add_argument("-o", "--out", dest="out_path", default=None,
                   help="result image, directory for a directory input, or new "
                   "parameters file (training)")
    p.add_argument("-e", "--epochs", type=int, default=0, help="number of training epochs")
    p.add_argument("--validation-percent", type=int, default=20)
    p.add_argument("--mini-batch-count", type=int, default=2)
    p.add_argument("--validation-cadence", type=int, default=25)
    p.add_argument("--epochs-per-dispatch", type=int, default=8,
                   help="training: queue this many epochs per host round trip and read "
                   "their validation errors back once; the same results as 1")
    p.add_argument("--full-state", action="store_true",
                   help="training: also save and resume the momentum buffers and the "
                   "shuffle RNG in a '<params>.state.npz' sidecar, so that an "
                   "interrupted run equals a straight one")
    p.add_argument("--train-precision", choices=("highest", "high", "default", "bf16"),
                   default="highest",
                   help="training convolutions: 'highest' is f32 with TF32 off (exact "
                   "reference parity, the default); 'high' and 'default' are TF32 "
                   "convolutions on the card (plain f32 on the CPU); 'bf16' is mixed "
                   "precision (bf16 forward and backward, f32 master weights and "
                   "gradients)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the random weights when the config names no "
                   "parameters file, and of the training shuffle")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs on the card (the CUDA kernels, cuDNN in training); "
                   "cpu their plain version")
    add_precision_flags(p)
    p.add_argument("--bucket", type=int, default=0,
                   help="pad image shapes up to multiples of this (identical "
                   "results; 0 = exact shapes)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="bicubic upscale of the input on the device by this "
                   "factor before the net")
    p.add_argument("--spatial-shard", type=int, default=0, metavar="N",
                   help="forward: split the image's rows over N devices (-1 = all) "
                   "with one halo exchange per image; results are identical to "
                   "single-device")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="training: split the sample batch over N devices (-1 = all) "
                   "and sum their gradients. The train and validation split sizes "
                   "must divide by N")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the run into this directory "
                   "(Chrome trace format, for Perfetto); 'profile' also ranks its ops")
    p.add_argument("--packed-io", dest="packed_io", action="store_true", default=None,
                   help="accepted for the JAX CLI's command lines; does nothing (the "
                   "uint32-packed color ends change only the TPU's layout)")
    p.add_argument("--no-packed-io", dest="packed_io", action="store_false",
                   help="accepted for the JAX CLI's command lines; does nothing")
    return p


def add_precision_flags(p: argparse.ArgumentParser, precision: bool = True) -> None:
    """``--precision`` (unless ``precision`` is False) and the JAX command
    line's ``--pallas`` and ``--pallas-precision``, which map onto it
    (``resolve_precision``)."""
    if precision:
        p.add_argument("--precision", choices=("f32", "bf16"), default=None,
                       help="conv-stack precision: f32 (the default), or the bf16 "
                       "stream with the int8 first layer")
    p.add_argument("--pallas", action="store_true",
                   help="the JAX command line's fused Pallas forward: the bf16 stream, "
                   "or f32 with --pallas-precision f32; without it the JAX package "
                   "runs XLA in f32, which is f32 here")
    p.add_argument("--pallas-precision", choices=("bf16", "f32"), default=None,
                   help="with --pallas: bf16 (the default) or f32")


def resolve_precision(p: argparse.ArgumentParser, args) -> str:
    """Map ``--pallas`` / ``--pallas-precision`` onto the port's precision
    and store it in ``args.precision``: ``--pallas`` is its
    ``--pallas-precision`` (bf16 by default); no ``--pallas`` is f32, the
    JAX package's XLA forward. An explicit ``--precision`` that disagrees
    with ``--pallas`` is an argparse error."""
    given = getattr(args, "precision", None)
    if args.pallas:
        mapped = args.pallas_precision or "bf16"
        if given is not None and given != mapped:
            p.error(f"--precision {given} contradicts --pallas"
                    + (f" --pallas-precision {args.pallas_precision}"
                       if args.pallas_precision else "") + f" (precision {mapped})")
    else:
        mapped = given or "f32"
    args.precision = mapped
    return mapped


def _check_device(args):
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")


def _resolve_devices(n: int, device: str) -> int:
    """-1 → every device of ``device``'s kind; checks 1 ≤ n ≤ that count."""
    from .parallel.mesh import available_devices

    avail = len(available_devices(device))
    if n == -1:
        return avail
    if n < 1 or n > avail:
        raise SystemExit(f"need 1..{avail} devices, got {n}")
    return n


def _load_model(args, cfg):
    import torch

    from .utils.params_io import init_params, params_to_torch

    _check_device(args)
    params, _ = init_params(cfg, seed=args.seed)
    return params_to_torch(params, torch.device(args.device))


def _forward_one(args, cfg, params, rgba):
    """One image through the selected forward path; uint8 RGB on the host."""
    if args.spatial_shard:
        from .api import upscale_image_spatial

        return upscale_image_spatial(cfg, params, rgba,
                                     _resolve_devices(args.spatial_shard, args.device),
                                     precision=args.precision)
    from .api import upscale_image

    return upscale_image(cfg, params, rgba, bucket=args.bucket, precision=args.precision)


def _pre_scale(args, params, rgba):
    import numpy as np
    import torch

    from .ops.resize import upscale_rgba

    img = torch.as_tensor(np.require(rgba, requirements=("C", "W")),
                          device=params[0]["w"].device)
    return upscale_rgba(img, args.scale).cpu().numpy()


def _upscale_file(args, cfg, params, src: str, dst: Optional[str], profiler,
                  stage: str) -> None:
    from .ops.image import load_image, write_image

    with profiler.stage("load_image"):
        rgba = load_image(src)
    t0 = time.perf_counter()
    if args.scale != 1.0:
        rgba = profiler.timed("upscale_input (bicubic)", _pre_scale, args, params, rgba)
        print(f"Pre-scaled by {args.scale}x to {rgba.shape[1]}x{rgba.shape[0]}")
    out = profiler.timed(stage, _forward_one, args, cfg, params, rgba)
    dt = time.perf_counter() - t0
    print(f"{src}: {rgba.shape[1]}x{rgba.shape[0]} upscaled in {dt * 1e3:.1f} ms")
    if dst:
        with profiler.stage("write_image"):
            write_image(dst, out)
        print(f"Output written: {dst}")


def run_forward(args, cfg, profiler) -> int:
    # forward mode with random weights only ever produces garbage, so a
    # parameters file that is named but missing is an error here
    if cfg.parameters_file and not os.path.isfile(cfg.parameters_file):
        print(f"Parameters file not found: '{cfg.parameters_file}' "
              "(forward mode needs trained weights)")
        return 1
    params = _load_model(args, cfg)
    if not os.path.isdir(args.in_path):
        _upscale_file(args, cfg, params, args.in_path, args.out_path, profiler,
                      "upscale (luma+forward+swap)")
        return 0
    return _run_forward_dir(args, cfg, params, profiler)


def _run_forward_dir(args, cfg, params, profiler) -> int:
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
        _upscale_file(args, cfg, params, os.path.join(args.in_path, name), dst, profiler,
                      "upscale")
    return 0


def run_training(args, cfg, profiler) -> int:
    import numpy as np

    from .training.samples import find_training_samples, load_sample_set
    from .training.trainer import init_train_state, train_loop
    from .utils.params_io import save_parameters_file

    print(
        f"Training mode, epochs: {args.epochs}\n"
        f"Training samples directory: {args.in_path}\n"
        f"Output: {args.out_path or '-'}"
    )
    with profiler.stage("load_samples"):
        pairs = find_training_samples(args.in_path)
        samples = load_sample_set(pairs, channels=cfg.channels,
                                  zero_mean_target=cfg.zero_mean_target,
                                  squared_mean=cfg.subtract_squared_mean)
    print(f"Loaded {samples.count} samples of {samples.width}x{samples.height}")

    state = init_train_state(cfg, seed=args.seed)

    rng = None
    if args.full_state:
        from .training.checkpoint import load_full_state

        if cfg.parameters_file:
            rng = load_full_state(cfg.parameters_file, state)
            if rng is not None:
                print(f"Resumed full training state (momentum + RNG) from "
                      f"'{cfg.parameters_file}.state.npz'")
        if rng is None:
            rng = np.random.default_rng(args.seed)

    mesh = None
    if args.data_parallel:
        from .parallel.mesh import available_devices, make_mesh

        n = _resolve_devices(args.data_parallel, args.device)
        v = int(samples.count * args.validation_percent / 100.0)
        t = samples.count - v
        if t % n or (v and v % n):
            raise SystemExit(
                f"--data-parallel {n}: train split {t} and validation "
                f"split {v} must both divide by the device count")
        mesh = make_mesh(n_data=n, devices=available_devices(args.device))
        print(f"Data-parallel training over {n} devices "
              f"(batch split; gradients summed on the first)")

    t0 = time.perf_counter()
    with profiler.stage("train_loop"):
        error = train_loop(
            cfg, samples, state, args.epochs,
            validation_percent=args.validation_percent,
            mini_batch_count=args.mini_batch_count,
            validation_cadence=args.validation_cadence,
            epochs_per_dispatch=args.epochs_per_dispatch, mesh=mesh,
            precision=None if args.train_precision == "highest" else args.train_precision,
            seed=args.seed, rng=rng, device=args.device,
        )
    dt = time.perf_counter() - t0
    if args.epochs > 0:
        print(f"Training time: {dt:.3f}s ({dt / args.epochs:.5f} s/epoch, "
              f"{args.epochs / dt:.2f} epochs/s)")

    if args.out_path and not error:
        print(f"Saving parameters to: '{args.out_path}'")
        save_parameters_file(args.out_path, state.params, epochs=state.epochs)
        if args.full_state:
            from .training.checkpoint import save_full_state

            print(f"Saving full training state to: "
                  f"'{save_full_state(args.out_path, state, rng)}'")
    return 1 if error else 0


_MODE_WORDS = {"train", "dry", "profile"}
_VALUED_OPTS = {"-c", "--config", "-i", "--in", "-o", "--out", "-e", "--epochs",
                "--validation-percent", "--mini-batch-count", "--validation-cadence",
                "--epochs-per-dispatch", "--train-precision", "--seed", "--device",
                "--precision", "--pallas-precision", "--bucket", "--scale",
                "--spatial-shard", "--data-parallel", "--trace-dir"}


def _split_modes(argv: List[str]):
    """Extract bare-word mode flags from anywhere in the argument list
    (``cnn_torch train dry -c cfg -i dir profile``); a valued option's
    argument is never taken for one."""
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
    parser = build_parser()
    args = parser.parse_args(rest)
    resolve_precision(parser, args)
    profile = "profile" in modes
    if "dry" in modes:
        args.out_path = None
    elif not args.out_path:
        print("Either provide out path or do the dry run")
        return 1
    if profile:
        print("!!! RUNNING IN PROFILING MODE !!!")

    from .profiling import StageProfiler, print_device_memory, report_op_shares
    from .utils.config import ConfigError, read_config
    from .utils.debug import warn_blocking_transfers

    # profile mode always traces: into --trace-dir if given (kept for
    # Perfetto), else a temporary directory read by the op table below
    trace_dir = args.trace_dir
    if profile and not trace_dir:
        import tempfile

        trace_dir = tempfile.mkdtemp(prefix="cnnsr_trace_")
    profiler = StageProfiler(enabled=profile, profile_dir=trace_dir)

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
        _check_device(args)
        profiler.start_trace()
        # profile mode also warns at every host-blocking device operation,
        # the reference's warn_about_blocking_operation flag (pch.cpp:16)
        with warn_blocking_transfers(enabled=profile, device=args.device):
            if "train" in modes:
                rc = run_training(args, cfg, profiler)
            else:
                rc = run_forward(args, cfg, profiler)
    except (FileNotFoundError, NotADirectoryError) as e:
        print(f"File not found: {e}")
        return 1
    except (ValueError, RuntimeError) as e:
        print(f"Error: {e}")
        return 1
    finally:
        profiler.stop_trace()
        profiler.report()
        if profile:
            report_op_shares(trace_dir)
            print_device_memory(device=args.device)
    if rc == 0:
        print("DONE")
    return rc


if __name__ == "__main__":
    sys.exit(main())
