"""RRDBNet (ESRGAN, Real-ESRGAN x4plus) on the bf16 chain's kernels: the
launch schedule of a SAME model.

basicsr's ``RRDBNet`` (``basicsr/archs/rrdbnet_arch.py``), every
convolution 3x3, stride 1, SAME, with bias, LeakyReLU of slope 0.2:

* a dense block (RDB) on x: ``x_i = lrelu(conv_i(cat(x, x_1 .. x_{i-1})))``
  for i = 1..4, then ``x + 0.2·conv_5(cat(x, x_1 .. x_4))``;
* an RRDB: ``x + 0.2·RDB3(RDB2(RDB1(x)))``;
* the trunk: ``f = conv_first(x)``, then ``f + conv_body(RRDB^num_block(f))``;
* the head: two rounds of nearest x2 and a conv with lrelu, then
  ``conv_last(lrelu(conv_hr(·)))``.

``params`` is the flat layer list in ``state_dict`` order
(``utils.config.rrdbnet_layers``). The schedule is one launch a
convolution (351 for x4plus), each on ``chain.same_forward``:

* a dense block lives in one NHWC buffer ``num_feat + 4·num_grow_ch``
  channels wide (192): its x in the first ``num_feat``, each ``x_i``
  written as a channel slice after it, each conv reading a channel prefix,
  so nothing is concatenated. Four such buffers: the trunk's f stays in
  the first for the trunk's residual; an RRDB's three blocks run in the
  other three in turn, and its last conv_5 writes the RRDB's output over
  its input in place (its residuals read each position before it is
  stored, and that launch reads another buffer), so the next RRDB starts
  where this one did;
* conv_5's epilogue is ``x + 0.2·v`` (the block's x), and the third
  block's adds ``x_rrdb + 0.2·(...)`` after it; conv_body's is ``f + v``,
  written over f. The 64-channel residual stream is kept in f32: each
  dense buffer's x has an f32 twin that conv_5 writes beside its bf16
  output (``out32``) and that the residuals read (f's twin is its bf16
  value, copied), so the stream is rounded to bf16 only where a conv
  reads it, not once a block: in the plain version at 48x64 that cut the
  mean gap to the f32 reference from 0.66 to 0.27 levels;
* the head's nearest x2 upsamples are torch copies between its convs.

The plain version takes the same schedule with ``reference.same_layer`` in
place of each launch, over bf16-rounded values in bf16 and in plain f32 in
f32: on the CPU both precisions run; on a card bf16 runs the kernels and
f32 raises (ROADMAP #C4).

Spans: ``model.rrdb.trunk`` (conv_first through the trunk's residual) and
``model.rrdb.head`` (the upsamples, conv_up1, conv_up2, conv_hr and
conv_last), recorded while a profiler records.
"""

from __future__ import annotations

import torch

from ...profiling import span
from ...utils.config import rrdbnet_layers
from . import chain, entry, reference

RES_SCALE = 0.2  # the dense block's and the RRDB's residual scale


def layout(params) -> tuple:
    """``(channels, num_feat, num_grow_ch, num_block)`` of the flat layer
    list ``params``, every shape checked against ``rrdbnet_layers``;
    ValueError for any other list."""
    n_layers = len(params)
    if n_layers < 21 or (n_layers - 6) % 15:
        raise ValueError(f"an RRDBNet has 6 + 15·num_block layers; got {n_layers}")
    w0 = params[0]["w"]
    if w0.dim() != 4:
        raise ValueError(f"conv_first's weights {tuple(w0.shape)} are not (f, f, k, n)")
    channels, num_feat = int(w0.shape[2]), int(w0.shape[3])
    num_grow_ch = int(params[1]["w"].shape[3]) if params[1]["w"].dim() == 4 else 0
    want = rrdbnet_layers(channels, num_feat, num_grow_ch, (n_layers - 6) // 15)
    for i, (layer, (f, k, n)) in enumerate(zip(params, want)):
        w, b = layer["w"], layer["b"]
        if tuple(w.shape) != (f, f, k, n) or tuple(b.shape) != (n,):
            raise ValueError(f"layer {i + 1}: weights {tuple(w.shape)} / bias {tuple(b.shape)}, "
                             f"an RRDBNet of {num_feat} features and {num_grow_ch} growth "
                             f"channels wants ({f}, {f}, {k}, {n}) / ({n},)")
    if num_feat % 8 or num_grow_ch % 8:
        raise ValueError("num_feat and num_grow_ch must be multiples of 8")
    return channels, num_feat, num_grow_ch, (n_layers - 6) // 15


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 of NHWC ``x`` (N, H, W, C) into a new contiguous (N, 2H,
    2W, C): ``F.interpolate(scale_factor=2, mode="nearest")``."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _schedule(conv, alloc, x: torch.Tensor, dims) -> torch.Tensor:
    """The launch schedule over ``conv(i, src, k, dst, c0, lrelu=False,
    residuals=(), first=False, last=False, out32=None)`` (layer i from the
    first k channels of ``src`` into the channels of ``dst`` from c0 on;
    residuals and ``out32`` f32) and ``alloc(shape, f32)`` (an activation
    buffer of the stream's type, or f32)."""
    channels, nf, gc, nb = dims
    n, h, w, _ = x.shape
    with span("model.rrdb.trunk"):
        bufs = [alloc((n, h, w, nf + 4 * gc), False) for _ in range(4)]
        streams = [alloc((n, h, w, nf), True) for _ in range(4)]  # bufs[d][..., :nf] in f32
        conv(0, x, channels, bufs[0], 0, first=True)
        streams[0].copy_(bufs[0][..., :nf])
        s, i = 0, 1
        for _ in range(nb):
            # the RRDB's three blocks in bufs s, 1, 2; its output into bufs 3
            # (in place from the second RRDB on, where s is 3)
            seq = [s, 1, 2, 3]
            for j in range(3):
                d = bufs[seq[j]]
                for c in range(4):
                    conv(i, d, nf + c * gc, d, nf + c * gc, lrelu=True)
                    i += 1
                res = [(streams[seq[j]], RES_SCALE)]
                if j == 2:  # the RRDB's own residual after the block's
                    res.append((streams[s], RES_SCALE))
                conv(i, d, nf + 4 * gc, bufs[seq[j + 1]], 0, residuals=res,
                     out32=streams[seq[j + 1]])
                i += 1
            s = 3
        conv(i, bufs[3], nf, bufs[0], 0, residuals=[(streams[0], 1.0)])  # f + conv_body(...)
        trunk = bufs[0][..., :nf]
        del bufs, streams
    with span("model.rrdb.head"):
        u = upsample2(trunk)
        del trunk
        a = alloc(u.shape, False)
        conv(i + 1, u, nf, a, 0, lrelu=True)  # conv_up1
        u = upsample2(a)
        a = alloc(u.shape, False)
        conv(i + 2, u, nf, a, 0, lrelu=True)  # conv_up2
        del u
        hr = alloc(a.shape, False)
        conv(i + 3, a, nf, hr, 0, lrelu=True)  # conv_hr
        del a
        y = alloc((n, 4 * h, 4 * w, channels), True)
        conv(i + 4, hr, nf, y, 0, last=True)  # conv_last
    return y


def forward(params, x: torch.Tensor, precision: str = "bf16") -> torch.Tensor:
    """(N, H, W, C) f32 (the image in 0..1) → (N, 4H, 4W, C) f32, before
    any clamp, in ``precision`` ("f32" or "bf16"). On a card the bf16
    schedule runs the kernels; on the CPU its plain version runs in either
    precision."""
    if precision not in reference.PRECISIONS:
        raise ValueError(f"precision must be one of {reference.PRECISIONS}, got {precision!r}")
    dims = layout(params)
    if x.dim() != 4 or x.shape[0] == 0 or x.shape[3] != dims[0]:
        raise ValueError(f"x must be (N, H, W, {dims[0]}), got shape {tuple(x.shape)}")
    for t in [x] + [t for layer in params for t in (layer["w"], layer["b"])]:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the RRDBNet takes contiguous float32 tensors on one device; got "
                             f"{t.dtype} {t.device} contiguous={t.is_contiguous()}")
    if x.shape[0] > 65535:
        raise NotImplementedError("more than 65535 images in one launch")
    if x.device.type == "cpu":
        return _schedule(_plain_conv(params, precision), _plain_alloc(x), x, dims)
    if precision == "f32":
        raise NotImplementedError(
            "an RRDBNet runs on a card in bf16 only: f32 needs the SAME layer in "
            "csrc/conv_layer.cu (ROADMAP #C4)")
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _card_schedule(params, x, dims)


def _plain_conv(params, precision: str):
    def conv(i, src, k, dst, c0, lrelu=False, residuals=(), first=False, last=False, out32=None):
        layer = params[i]
        n = layer["w"].shape[3]
        y, v = reference.same_layer(src[..., :k], layer["w"], layer["b"], lrelu,
                                    [(r[..., :n], s) for r, s in residuals], first, last,
                                    precision)
        dst[..., c0:c0 + n] = y
        if out32 is not None:
            out32[..., :n] = v
    return conv


def _plain_alloc(x: torch.Tensor):
    return lambda shape, f32: torch.zeros(shape, dtype=torch.float32, device=x.device)


def card_plans(params) -> list:
    """Each layer's bf16 plan on the card; NotImplementedError where a plan
    has no SAME kernel instance (``entry.same_instances``: the kernels
    compile those of Real-ESRGAN x4plus's widths)."""
    n_layers = len(params)
    plans = [entry.bf16_layer_plan(*layer["w"].shape[1:], first=i == 0, last=i == n_layers - 1)
             for i, layer in enumerate(params)]
    for i, plan in enumerate(plans):
        if entry.plan_instance(plan) not in entry.same_instances():
            raise NotImplementedError(
                f"layer {i + 1} {tuple(params[i]['w'].shape)} has no SAME kernel instance; the "
                "kernels compile those of Real-ESRGAN x4plus's widths (entry.same_instances)")
    return plans


def _card_schedule(params, x: torch.Tensor, dims) -> torch.Tensor:
    from .build import load_library

    plans = card_plans(params)
    lib = load_library()
    n_layers = len(params)
    operands = [entry.packed_last(layer["w"], layer["b"], plan) if i == n_layers - 1
                else entry.packed_bf16(layer["w"], layer["b"], i == 0, 255 if i == 0 else 127)
                for i, (layer, plan) in enumerate(zip(params, plans))]

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream

        def conv(i, src, k, dst, c0, lrelu=False, residuals=(), first=False, last=False,
                 out32=None):
            wt, bt = operands[i]
            chain.same_forward(lib, src, k, wt, bt, dst, c0, plans[i], lrelu, residuals,
                               out32, stream)

        def alloc(shape, f32):
            return torch.empty(shape, dtype=torch.float32 if f32 else torch.bfloat16,
                               device=x.device)

        return _schedule(conv, alloc, x, dims)
