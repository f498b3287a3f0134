#!/usr/bin/env python
"""Launcher for the PyTorch/CUDA port's CLI (counterpart of ``cnn.py``):

    python cnn_torch.py [dry] -c cfg.json -i <in> [-o <out>] [--device cuda|cpu]
    python cnn_torch.py train [dry] -c cfg.json -i <samples dir> -e N [-o params.json]
                        [--device cuda|cpu]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cnn_sr_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
