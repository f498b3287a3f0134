"""``fused_forward``: the SRCNN conv stack on the card, routed by shape.

Counterpart of ``cnn_sr_tpu/ops/pallas_fused/entry.py:fused_forward``.
Two hand-written kernels share the work, each in two precisions, chosen
by ``route``, a pure function of the shapes:

* ``csrc/fused_srcnn.cu``, the whole stack in one launch, for 3-layer
  stacks with c_in <= 4 and n_out <= 4 whose tiles fit one block's shared
  memory (the luma models: flagship 9-5-5, 9-1-5);
* ``csrc/conv_layer.cu`` through ``chain.chain_forward``, one launch per
  layer, for every other well-formed stack (the 7-layer RGB model).

``precision="f32"`` runs them in f32. ``precision="bf16"`` runs the JAX
package's bf16 stream with the int8 first layer (``reference`` states
the numbers), on the JAX rule of where that stream applies
(``bf16_envelope``): elsewhere JAX runs its XLA f32 forward, and so this
takes its f32 route.

A stack with a layer whose input window does not fit in shared memory
raises NotImplementedError on every device, before any launch. A CPU
tensor takes the plain version (``reference.fused_forward``) on either
route; a CUDA tensor always takes the kernel of its route and precision,
or raises. There is no fallback from one to another.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import chain, reference

# launches in this process of the fused kernel in f32 (``LAUNCHES``) and
# in bf16 (``LAUNCHES_BF16``); ``chain.LAUNCHES`` and
# ``chain.LAUNCHES_BF16`` count the chain's. The smoke run reads all four
# to show which kernels a path ran.
LAUNCHES = 0
LAUNCHES_BF16 = 0

TILE_H = TILE_W = 16
SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt into on sm_90
ELEM_BYTES = {"f32": 4, "bf16": 2}  # bytes of a stored activation or weight
_ROADMAP = "ROADMAP.md Queue 2"


def tile_bytes(c: int, dims, elem: int = 4) -> int:
    """Shared bytes of one block's activations: the input window with its
    halo, the conv1 tile and the conv2 tile, ``elem`` bytes each (4 for
    f32, 2 for bf16). ``dims`` is ((f, n) per layer)."""
    (f1, n1), (f2, n2), (f3, _) = dims
    a2 = (TILE_H + f3 - 1, TILE_W + f3 - 1)
    a1 = (a2[0] + f2 - 1, a2[1] + f2 - 1)
    win = (a1[0] + f1 - 1, a1[1] + f1 - 1)
    return elem * (c * win[0] * win[1] + n1 * a1[0] * a1[1] + n2 * a2[0] * a2[1])


def _weight_chunk(used: int, layers, elem: int = 4):
    """Elements of weights that fit in the shared memory beside ``used``
    bytes, up to the largest layer's whole set (a multiple of 16 bytes'
    worth, for 16-byte reads); None when not even one input channel's
    weights of a layer fit. ``layers`` = ((f, k, n), ...)."""
    vec = 16 // elem
    need = max(f * f * n for f, _, n in layers)  # one input channel
    full = max(f * f * k * n for f, k, n in layers)
    chunk = min((SMEM_LIMIT - used) // 16 * vec, -(-full // vec) * vec)
    return chunk if chunk >= need else None


def smem_plan(c: int, layers, elem: int = 4):
    """The fused kernel's ``(weight_chunk_elems, total_bytes)`` for
    ``layers`` = ((f, k, n), ...) at ``elem`` bytes an element: the shared
    memory left beside the tiles, up to the block limit, holds the weights
    a chunk of input channels at a time (the whole layer where it fits).
    None when not even one input channel's weights of a layer fit."""
    tiles = tile_bytes(c, [(f, n) for f, _, n in layers], elem)
    chunk = _weight_chunk(tiles, layers, elem)
    return None if chunk is None else (chunk, tiles + elem * chunk)


class LayerPlan(NamedTuple):
    """One chain launch: the output tile of a block, the elements of its
    weight chunk and its dynamic shared bytes (window plus chunk)."""
    tile_h: int
    tile_w: int
    chunk: int
    smem: int


def window_bytes(f: int, k: int, elem: int = 4) -> int:
    """Shared bytes of a chain block's input window: the output tile plus
    its (f − 1) halo, all k channels, ``elem`` bytes each."""
    return elem * k * (TILE_H + f - 1) * (TILE_W + f - 1)


def layer_plan(f: int, k: int, n: int, elem: int = 4) -> LayerPlan:
    """The chain's plan for one f×f layer from k to n channels at ``elem``
    bytes an element: the rest of the block's shared memory beside the
    window carries the weights, a chunk of input channels at a time.
    Raises NotImplementedError when the window and one input channel's
    weights do not fit."""
    win = window_bytes(f, k, elem)
    chunk = _weight_chunk(win, [(f, k, n)], elem)
    if chunk is None:
        raise NotImplementedError(
            f"a {TILE_H}x{TILE_W} tile of an f={f} layer over {k} channels needs "
            f"{win} shared bytes for its window plus {elem * f * f * n} for weights "
            f"(> {SMEM_LIMIT}); such layers need the tensor-core kernel "
            f"({_ROADMAP} #1)")
    return LayerPlan(TILE_H, TILE_W, chunk, win + elem * chunk)


def route(c: int, layers, elem: int = 4):
    """``("fused", (chunk, smem))`` for a stack the fused kernel takes,
    else ``("chain", [LayerPlan, ...])``; ``layers`` = ((f, k, n), ...),
    ``c`` the input channels and ``elem`` the bytes of an element. Raises
    NotImplementedError for a stack neither kernel takes."""
    if len(layers) == 3 and c <= 4 and layers[-1][2] <= 4:
        plan = smem_plan(c, layers, elem)
        if plan is not None:
            return "fused", plan
    return "chain", [layer_plan(*layer, elem) for layer in layers]


def bf16_envelope(c: int, layers, h: int, w: int) -> bool:
    """Whether the JAX package runs its bf16 stream on this shape
    (``cnn_sr_tpu/ops/pallas_fused/entry.py:151-160``): n_out ≤ 4, at
    least 3 layers, c_in ≤ 4, every middle layer's k a multiple of 8 and
    an (h, w) image larger than shrink + 8 both ways. Outside it JAX
    returns its XLA f32 forward. ``layers`` = ((f, k, n), ...)."""
    shrink = sum(f - 1 for f, _, _ in layers)
    return (layers[-1][2] <= 4 and len(layers) >= 3 and c <= 4
            and all(k % 8 == 0 for _, k, _ in layers[1:])
            and h > shrink + 8 and w > shrink + 8)


def _check(params, x, precision: str = "f32"):
    """Raise ValueError for malformed input and NotImplementedError for a
    well-formed stack that no kernel takes, on every device, so the CPU
    and CUDA paths take the same stacks. Returns ``(precision, kind,
    plan)``: the precision the stack runs in (bf16 only inside
    ``bf16_envelope``) and ``route``'s answer for it."""
    if precision not in reference.PRECISIONS:
        raise ValueError(f"precision must be one of {reference.PRECISIONS}, "
                         f"got {precision!r}")
    if x.dim() != 4 or x.shape[0] == 0:
        raise ValueError(f"x must be (N, H, W, C), got shape {tuple(x.shape)}")
    if not params:
        raise ValueError("the stack has no layers")
    tensors = [x] + [t for layer in params for t in (layer["w"], layer["b"])]
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_forward takes contiguous float32 tensors on "
                             f"one device; got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned tensors")
    k = x.shape[3]
    for i, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        if (w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != k
                or tuple(b.shape) != (w.shape[3],)):
            raise ValueError(f"layer {i + 1}: weights {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not chain from {k} channels")
        k = w.shape[3]
    shrink = sum(layer["w"].shape[0] - 1 for layer in params)
    if x.shape[1] <= shrink or x.shape[2] <= shrink:
        raise ValueError(f"input {x.shape[2]}x{x.shape[1]} is not larger than "
                         f"the stack's receptive field ({shrink}+1 px)")
    if x.shape[0] > 65535:
        raise NotImplementedError("more than 65535 images in one launch")
    layers = [tuple(l["w"].shape[1:]) for l in params]
    if precision == "bf16" and not bf16_envelope(x.shape[3], layers, x.shape[1], x.shape[2]):
        precision = "f32"
    return (precision,) + route(x.shape[3], layers, ELEM_BYTES[precision])


def bf16_weights(params):
    """The bf16 kernels' weights: w1 with the 1/127 fold, every other w
    rounded to bf16, contiguous on the weights' device. Made once per
    weight tensor (and again only after it changes in place): the result
    is kept on the tensor itself, beside its version counter."""
    out = []
    for i, layer in enumerate(params):
        w = layer["w"]
        key = (i == 0, w._version)
        kept = getattr(w, "_cnn_sr_bf16", None)
        if kept is None or kept[0] != key:
            wb = reference.fold_first(w) if i == 0 else w.to(torch.bfloat16)
            kept = (key, wb.contiguous())
            w._cnn_sr_bf16 = kept
        out.append(kept[1])
    return out


def fused_forward(params, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(N, H, W, C) f32 → (N, H−s, W−s, n_out) f32, s = Σ(f−1): ReLU on
    every layer but the last. ``params`` is ``[{"w": (f, f, k, n),
    "b": (n,)}, ...]`` (HWIO), on the same device as ``x``;
    ``precision`` is "f32" or "bf16" (see the module's docstring)."""
    global LAUNCHES, LAUNCHES_BF16
    precision, kind, plan = _check(params, x, precision)
    if x.device.type == "cpu":
        return reference.fused_forward(params, x, precision)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    bf16 = precision == "bf16"
    if kind == "chain":
        return chain.chain_forward(params, x, plan, bf16=bf16)
    chunk, smem = plan
    dims = [(layer["w"].shape[0], layer["w"].shape[3]) for layer in params]
    n, h, w, c = x.shape
    from .build import load_library

    lib = load_library()
    shrink = sum(f - 1 for f, _ in dims)
    y = torch.empty((n, h - shrink, w - shrink, dims[2][1]),
                    dtype=torch.float32, device=x.device)
    weights = bf16_weights(params) if bf16 else [layer["w"] for layer in params]
    ptrs = [x.data_ptr()]
    for wt, layer in zip(weights, params):
        ptrs += [wt.data_ptr(), layer["b"].data_ptr()]
    (f1, n1), (f2, n2), (f3, n3) = dims
    launch = lib.fused_srcnn_forward_bf16 if bf16 else lib.fused_srcnn_forward
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*ptrs, y.data_ptr(), n, h, w, c, f1, n1, f2, n2, f3, n3,
                     TILE_H, TILE_W, chunk, smem, stream)
    if err:
        raise RuntimeError(f"fused_srcnn{'_bf16' if bf16 else ''} launch failed: "
                           + lib.cnn_sr_error_string(err).decode())
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return y
