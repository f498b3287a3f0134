"""The comparison that decides ``correct``.

Each answer the window produced and the run samples (a frame, or a
request's frame) is held against the plain reference worked out again
from the same uint8 input and the same weights. Per answer, over every
value of the uint8 RGB output, border included:

* ``mean_abs``     — the mean absolute difference, in uint8 levels;
* ``max_abs``      — the largest absolute difference;
* ``share_over_1`` — the share of values off by two levels or more.

A cell's number is the worst of its answers. ``limits/<cell>.json``
names the numbers compared, each with its limit; an answer of the wrong
shape reads infinite.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("mean_abs", "max_abs", "share_over_1")


def answer_numbers(out, ref: torch.Tensor) -> dict:
    """The numbers of one answer ``out`` (uint8 (H, W, 3), numpy or
    tensor) against the reference's ``ref``."""
    out = torch.as_tensor(out if isinstance(out, torch.Tensor) else np.asarray(out)).to(ref.device)
    if tuple(out.shape) != tuple(ref.shape) or out.dtype != ref.dtype:
        return {k: math.inf for k in NUMBERS}
    d = (out.to(torch.int16) - ref.to(torch.int16)).abs()
    return {"mean_abs": float(d.float().mean()), "max_abs": float(d.max()),
            "share_over_1": float((d > 1).float().mean())}


def worst(per_answer: list) -> dict:
    if not per_answer:
        return {k: math.inf for k in NUMBERS}
    return {k: max(p[k] for p in per_answer) for k in NUMBERS}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` for the numbers that
    ``limits`` compares (its ``numbers``: name -> {"limit": x, ...})."""
    checks = {name: {"value": numbers[name], "limit": spec["limit"]}
              for name, spec in limits["numbers"].items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def reference_answers(samples, ref_module, weights_np, cfg: dict, device,
                      control=None) -> list:
    """The reference's answer for every sample ``(input, output,
    pre-scale)``, one frame at a time, each with the sample's numbers:
    ``[numbers]``. ``control`` computes the reference in a lower
    precision instead (``reference.srcnn.round_to``)."""
    weights = [(torch.as_tensor(w, device=device), torch.as_tensor(b, device=device))
               for w, b in weights_np]
    out = []
    for rgba, answer, factor in samples:
        x = torch.as_tensor(np.ascontiguousarray(rgba), device=device)
        if factor != 1.0:
            x = ref_module.pre_scale(x, factor)
        ref = ref_module.upscale_frame(x, weights, cfg["channels"], cfg["zero_mean_target"],
                                       cfg.get("subtract_squared_mean", False), control=None)
        if control is not None:
            answer = ref_module.upscale_frame(x, weights, cfg["channels"],
                                              cfg["zero_mean_target"],
                                              cfg.get("subtract_squared_mean", False),
                                              control=control)
        out.append(answer_numbers(answer, ref))
    return out
