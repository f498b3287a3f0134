"""Evaluate a trained model: PSNR(Y) over a directory of image pairs.

The port's counterpart of ``tools/evaluate.py``: for each
``*_large/*_small`` pair (the training-sample format) OR each plain image
(degraded on the fly by ``--degrade`` through the port's
``ops.resize.degrade``, bicubic, on ``--device``), run the net on the
degraded image (``api.upscale_image``) and report PSNR(Y)
(``utils.metrics.psnr_y``) against the ground truth over the center the
net computed: bicubic (the degraded input itself) against the network
output, per image and averaged.

    python -m cnn_sr_tpu_torch.tools.evaluate -c cfg.json -i samples_dir [--pallas]
    python -m cnn_sr_tpu_torch.tools.evaluate -c cfg.json -i photos_dir --degrade 2

``--pallas`` runs the bf16 stream (``--pallas-precision f32``: the f32
kernels); without it the f32 kernels run, as the JAX tool's XLA forward
is f32 (``cli.resolve_precision``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..cli import add_precision_flags, resolve_precision
from . import add_device_flag, check_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cnn_sr_tpu_torch.tools.evaluate",
                                description="PSNR(Y) evaluation over an image set.")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--in-dir", "-i", required=True,
                   help="directory of *_large/*_small pairs, or plain images "
                   "when --degrade is given")
    p.add_argument("--degrade", "-d", type=float, default=None,
                   help="degrade plain images by this factor on the fly")
    add_precision_flags(p, precision=False)
    p.add_argument("--seed", type=int, default=None)
    add_device_flag(p)
    args = p.parse_args(argv)
    precision = resolve_precision(p, args)
    check_device(p, args.device)

    import torch

    from .. import api
    from ..ops.image import load_image
    from ..ops.resize import degrade
    from ..training.samples import find_training_samples
    from ..utils import metrics
    from ..utils.config import read_config
    from ..utils.params_io import init_params, params_to_torch

    cfg = read_config(args.config)
    params = params_to_torch(init_params(cfg, seed=args.seed)[0], args.device)

    if args.degrade:
        files = sorted(
            os.path.join(args.in_dir, f)
            for f in os.listdir(args.in_dir)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        pairs = []
        for f in files:
            gt = load_image(f)
            rgb = torch.as_tensor(np.ascontiguousarray(gt[..., :3]), dtype=torch.float32,
                                  device=args.device)
            soft = torch.clamp(torch.round(degrade(rgb, args.degrade)), 0, 255)
            soft = soft.to(torch.uint8).cpu().numpy()
            soft = np.dstack([soft, np.full(soft.shape[:2], 255, np.uint8)])
            pairs.append((os.path.basename(f), gt, soft))
    else:
        found = find_training_samples(args.in_dir)
        if not found:
            print("no image pairs found")
            return 1
        pairs = [
            (os.path.basename(lg), load_image(lg), load_image(sm))
            for lg, sm in found
        ]

    pad = cfg.total_padding() // 2
    bicubic_scores, net_scores = [], []
    print(f"{'image':<28} {'bicubic':>9} {'network':>9} {'delta':>8}")
    for name, gt, degraded in pairs:
        out = api.upscale_image(cfg, params, degraded, precision=precision)
        # compare only the center the net actually computed
        gt3 = gt[..., :3]
        c = (slice(pad, gt3.shape[0] - pad), slice(pad, gt3.shape[1] - pad))
        p_bi = metrics.psnr_y(degraded[..., :3][c], gt3[c])
        p_net = metrics.psnr_y(out[c], gt3[c])
        bicubic_scores.append(p_bi)
        net_scores.append(p_net)
        print(f"{name:<28} {p_bi:>8.2f} {p_net:>8.2f} {p_net - p_bi:>+8.2f}")

    print("-" * 58)
    mb, mn = np.mean(bicubic_scores), np.mean(net_scores)
    print(f"{'MEAN':<28} {mb:>8.2f} {mn:>8.2f} {mn - mb:>+8.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
