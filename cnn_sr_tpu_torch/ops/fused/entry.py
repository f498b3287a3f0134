"""``fused_forward``: the SRCNN conv stack on the card, routed by shape.

Counterpart of ``cnn_sr_tpu/ops/pallas_fused/entry.py:fused_forward``.
Two hand-written kernels share the work, each in two precisions, chosen
by ``route``, a pure function of the shapes:

* ``csrc/fused_srcnn.cu`` (f32) and ``csrc/fused_wgmma.cu`` (bf16), the
  whole stack in one launch, for 3-layer stacks with c_in <= 4 and n_out
  <= 4 whose tiles fit one block's shared memory (the luma models:
  flagship 9-5-5, 9-1-5);
* the layer chain through ``chain.chain_forward``, one launch per layer,
  for every other well-formed stack (the 7-layer RGB model):
  ``csrc/conv_layer.cu`` in f32, the three ``wgmma`` kernels in bf16.

``precision="f32"`` runs them in f32 on the CUDA cores, both on
``csrc/ffma_stage.cuh`` with weights packed once by ``pack_f32`` (the
chain's plan per layer: ``layer_plan``). ``precision="bf16"``
runs the JAX package's bf16 stream with the int8 first layer
(``reference`` states the numbers) on the tensor cores (the fused
kernel on ``wgmma``; the chain's first layer on ``csrc/conv_first_wgmma.cu``,
every middle layer on ``csrc/conv_wgmma.cu``, its last layer on
``csrc/conv_last_wgmma.cu``), with its own plans
(``bf16_layer_plan``, ``fused_wgmma_plan``) and its weights packed
tap-major (``pack_bf16``; the fused kernel takes them tiled into its
shared-memory image, ``fused_weights``; the chain's last layer with its dx
taps side by side in N, ``pack_last``), on the JAX rule of where that stream applies
(``bf16_envelope``): elsewhere JAX runs its XLA f32 forward, and so this
takes its f32 route. A stack may take the fused kernel in f32 and the
chain in bf16 (the wide 9-5-5: its bf16 tiles do not fit one block).

Both chains stream a layer's input window through shared memory a chunk
of input channels at a time, so no well-formed stack is refused for its
width; an f32 layer one input channel of whose window and weights
exceeds a block's shared memory even at NB output channels a block (an
f of about 50 or more) raises NotImplementedError on every device,
before any launch. A CPU
tensor takes the plain version (``reference.fused_forward``) on either
route; a CUDA tensor always takes the kernel of its route and precision,
or raises. There is no fallback from one to another.
"""

from __future__ import annotations

import functools
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
SM_SMEM = 233_472  # shared memory of an SM
SM_RESERVE = 1_024  # shared bytes the runtime keeps for each resident block
ELEM_BYTES = {"f32": 4, "bf16": 2}  # bytes of a stored activation or weight


# (output channels, output rows) a thread of the f32 fused kernel computes
# at once in each layer ((kNB1, kPX1), ... in csrc/fused_srcnn.cu): its
# packed weights and biases are zero-padded to a multiple of the first,
# and its tiles' column strides follow from the second
FUSED_SHAPE = ((8, 4), (4, 5), (4, 2))
FUSED_NB = tuple(nb for nb, _ in FUSED_SHAPE)


def col_stride(rows: int, f: int, px: int) -> int:
    """The column stride of an f32 fused tile of ``rows`` rows read by a
    layer of ``f`` taps at ``px`` rows a thread (``ffma_col_stride`` in
    ``csrc/ffma_stage.cuh``): odd, for conflict-free reads across columns,
    and long enough for the last row block's reads."""
    need = -(-(rows - f + 1) // px) * px + f - 1
    return max(rows, need) | 1


def tile_bytes(c: int, dims, shape=FUSED_SHAPE) -> int:
    """Shared bytes of one f32 fused block's activations: the input window
    with its halo, the conv1 tile and the conv2 tile, each [c][x][y] with
    the column stride of the layer that reads it. ``dims`` is ((f, n) per
    layer); ``shape`` the kernel's (NB, PX) per layer."""
    (f1, n1), (f2, n2), (f3, _) = dims
    a2 = TILE_H + f3 - 1
    a1 = a2 + f2 - 1
    win = a1 + f1 - 1
    (_, px1), (_, px2), (_, px3) = shape
    return 4 * (c * win * col_stride(win, f1, px1) + n1 * a1 * col_stride(a1, f2, px2)
                + n2 * a2 * col_stride(a2, f3, px3))


def _weight_chunk(used: int, layers):
    """f32 weights that fit in the shared memory beside ``used`` bytes, up
    to the largest layer's whole set (a multiple of 4, for 16-byte reads);
    None when not even one input channel's weights of a layer fit.
    ``layers`` = ((f, k, n), ...)."""
    need = max(f * f * n for f, _, n in layers)  # one input channel
    full = max(f * f * k * n for f, k, n in layers)
    chunk = min((SMEM_LIMIT - used) // 16 * 4, -(-full // 4) * 4)
    return chunk if chunk >= need else None


def n_pad_f32(n: int, nb: int) -> int:
    """A layer's packed width in the f32 fused kernel: n rounded up to nb."""
    return -(-n // nb) * nb


def smem_plan(c: int, layers, shape=FUSED_SHAPE):
    """The f32 fused kernel's ``(wbuf_floats, total_bytes)`` for ``layers``
    = ((f, k, n), ...) at the kernel's (NB, PX) per layer ``shape``: the
    shared memory left beside the tiles, up to the block limit and to the
    largest layer's whole packed set, carries the weights
    (``weight_stages`` says how). None when not even one input channel's
    packed weights of a layer fit."""
    tiles = tile_bytes(c, [(f, n) for f, _, n in layers], shape)
    padded = [(f, k, n_pad_f32(n, nb)) for (f, k, n), (nb, _) in zip(layers, shape)]
    wbuf = _weight_chunk(tiles, padded)
    return None if wbuf is None else (wbuf, tiles + 4 * wbuf)


def weight_stages(f: int, k: int, npad: int, wbuf: int):
    """How one layer's packed weights (``k`` input channels of ``f²·npad``
    floats) pass through ``wbuf`` shared floats in the f32 fused kernel, as
    ``FfmaChunks`` in ``csrc/ffma_stage.cuh`` computes it: ``(channels a
    chunk, stages)``. The whole layer where it fits; else two stages
    (cp.async brings chunk c + 1 while chunk c is computed) of as many
    channels as fit in half the buffer; else one stage."""
    per_ch = f * f * npad
    if k * per_ch <= wbuf:
        return k, 1
    if 2 * per_ch <= wbuf:
        return wbuf // 2 // per_ch, 2
    return wbuf // per_ch, 1


# The f32 chain's width classes, by a layer's n (kChainNarrow, kChainMid,
# kChainWide in csrc/ffma_plan.cuh): (NB output channels and PX output
# rows a thread, the most threads a block, the blocks an SM its registers
# and shared memory are sized for, the most input channels a stage)
CHAIN_SHAPE = {"narrow": (4, 2, 512, 1, 32), "mid": (8, 4, 256, 2, 16),
               "wide": (16, 4, 512, 1, 16)}
CHAIN_GROUPS = 8  # the most NB-column groups a block (kChainGroups)


def chain_class(n: int) -> str:
    """The f32 chain's width class of a layer of n output channels."""
    return "narrow" if n <= 4 else "mid" if n <= 64 else "wide"


class LayerPlan(NamedTuple):
    """One f32 chain launch (``conv_layer_forward``), as ``ChainPlan`` in
    ``csrc/ffma_plan.cuh`` computes it: the width class's (NB, PX), the
    block's output tile, its threads (one item each: PX rows of one
    column for NB channels) and its ``nblk`` output columns, the input
    channels a stage, the stages and the dynamic shared bytes."""
    nb: int
    px: int
    tile_h: int
    tile_w: int
    items: int
    nblk: int
    kc: int
    stages: int
    smem: int


def layer_plan(f: int, k: int, n: int) -> LayerPlan:
    """The f32 chain's plan for one f×f layer from k to n channels.

    n pads to npad, a multiple of the class's NB: npad / NB groups, of
    which a block takes the largest divisor up to CHAIN_GROUPS (``nblk``
    columns; the rest of N in more blocks) whose stage of one input
    channel fits. The tile is 32 columns wide for one group a block, else
    16, and as many row blocks of PX rows (at most 32 rows) as the class's
    threads allow; a block launches exactly its items. A stage holds kc
    input channels of window ([c][x][y], column stride ``col_stride``, an
    odd channel stride) and packed weights; kc is the most, up to the
    class's cap and k, whose stages (two where kc < k) fit the shared
    memory of one of the class's blocks an SM (else of a block alone on
    its SM), then evened out over the chunks. Raises NotImplementedError
    when not even one input channel fits at one group a block."""
    return _layer_plan(f, k, n, CHAIN_SHAPE[chain_class(n)])


def _layer_plan(f: int, k: int, n: int, shape) -> LayerPlan:
    """``layer_plan`` at the width class ``shape`` (a ``CHAIN_SHAPE``
    value; ``tune`` passes others)."""
    nb, px, threads, blocks, kcmax = shape
    npad = n_pad_f32(n, nb)
    groups = npad // nb
    share = min(SMEM_LIMIT, SM_SMEM // blocks - SM_RESERVE)
    for gb in range(min(CHAIN_GROUPS, groups), 0, -1):
        if groups % gb:
            continue
        nblk = gb * nb
        tile_w = 32 if gb == 1 else 16
        rb = min(threads // (gb * tile_w), -(-32 // px))
        tile_h = rb * px
        items = gb * rb * tile_w
        ih, iw = tile_h + f - 1, tile_w + f - 1
        plane = iw * col_stride(ih, f, px) | 1

        def smem(kc):  # a stage: kc·f²·nblk weights and kc·plane window, 16-byte aligned
            return 4 * (2 if kc < k else 1) * (-(-kc * (f * f * nblk + plane) // 4) * 4)

        def fit(budget):
            kc = min(k, kcmax)
            while kc > 0 and smem(kc) > budget:
                kc -= 1
            return kc

        kc = fit(share) or fit(SMEM_LIMIT)
        if kc:
            kc = -(-k // -(-k // kc))  # even chunks
            return LayerPlan(nb, px, tile_h, tile_w, items, nblk, kc, 2 if kc < k else 1,
                             smem(kc))
    raise NotImplementedError(
        f"an f={f} layer to {n} channels needs {smem(1)} shared bytes for the window and "
        f"weights of one input channel at {nb} output channels a block "
        f"({'one stage' if k == 1 else 'two stages'}; > {SMEM_LIMIT})")


# The bf16 kernels (tensor cores): padded widths, the chain's plan per
# layer (csrc/conv_first_wgmma.cu, csrc/conv_wgmma.cu, csrc/conv_last_wgmma.cu) and
# the fused kernel's (csrc/fused_wgmma.cu). The C side recomputes the same
# plans and refuses a launch whose shared bytes fall short of them.

def n_pad(n: int) -> int:
    """A layer's N on the tensor cores: 8, 16, 32, 64 or a multiple of 128
    (a block takes at most 128 columns)."""
    for w in (8, 16, 32, 64):
        if n <= w:
            return w
    return -(-n // 128) * 128


def k_pad(k: int) -> int:
    """A middle or last layer's K: its input's padded N, at least 16."""
    return max(16, n_pad(k))


def kx_lanes(f: int, c: int) -> int:
    """The first layer's K: its dx-expanded window's f·c lanes, padded to
    a multiple of 16."""
    return -(-f * c // 16) * 16


# The bf16 chain's first layer (csrc/conv_first_wgmma.cu, its plan
# csrc/conv_first_plan.cuh): the raw f32 pixels landed through a ring of
# stages, quantised and dx-expanded by four consumer warpgroups into a window
# of planes of 8 lanes, W resident or through a ring, the output staged and
# stored by tensor copies.
FIRST_MAX_RAW = 4  # kFirstMaxRaw
FIRST_WGS = 4  # kFirstWgs: consumer warpgroups
FIRST_COLS = (64, 32, 16, 8, 4)  # kFirstCols: the tile's columns the plan chooses from


def first_slabs(bn: int) -> int:
    """The m64 slabs a warpgroup owns at ``bn`` block columns where the
    window fits (``first_slabs``): 2 up to 32, 1 at 64 (at most 32 sums a
    thread)."""
    return 2 if bn <= 32 else 1


def first_instances():
    """The first-layer kernel's instances, ``(bn, slabs)``: each block width
    at its ``first_slabs`` and at one slab."""
    return sorted({(bn, s) for bn in (8, 16, 32, 64) for s in (first_slabs(bn), 1)})


class FirstPlan(NamedTuple):
    """One first-layer launch (``conv_first_forward_wgmma``), as
    ``first_plan`` in ``csrc/conv_first_plan.cuh`` computes it: the layer
    (f, k → n, k = c the input's channels), its dx-expanded lanes (kx),
    packed N, the block's columns (bn) and N's chunks of them, the slabs a
    warpgroup, the tile's columns and rows, the window's rows, the windows
    and their bytes, a raw row's pixels (iw) and a raw stage's bytes (each
    row to 4 floats), the raw stages, a W slice's bytes, whether W is
    resident (else ``w_ring`` slices stream), the W bytes, the output
    buffers a warpgroup and their bytes, and the dynamic shared bytes."""
    f: int
    k: int
    n: int
    kx: int
    npad: int
    bn: int
    nchunks: int
    slabs: int
    cols: int
    tile_rows: int
    win_rows: int
    win_bufs: int
    win_bytes: int
    iw: int
    raw_bytes: int
    raw_ring: int
    w_slice: int
    w_res: int
    w_ring: int
    w_bytes: int
    out_bufs: int
    out_bytes: int
    smem: int


def first_layer_plan(f: int, c: int, n: int) -> FirstPlan:
    """The plan of the bf16 chain's first f×f layer over c input channels
    into n outputs (n a multiple of 8). A block computes bn = min(n_pad(n), 64) columns (N
    in chunks of them; fewer, down to 8, where the window of a wide f
    leaves no room) of a tile cols columns wide and
    ``FIRST_WGS``·slabs·64 / cols rows tall: four warpgroups of ``slabs``
    m64 slabs. Its window is the tile's rows plus f − 1 by ``cols``
    positions of kx lanes (bf16), two of them where they fit (the next
    tile's is expanded while this one's products run); its raw pixels those
    rows by cols + f − 1 columns of c channels (f32) a stage. A tile fits
    where its windows, output buffers (two windows and two buffers a
    warpgroup, else one window, else one of each), two raw stages and all of
    W (or two W slices) fit ``SMEM_LIMIT``; W stays resident where all of it
    fits beside two raw stages, which then take the rest (at most
    ``FIRST_MAX_RAW``), else two raw stages and a ring of W slices in the
    rest, its bytes to a multiple of 1024. It takes ``first_slabs(bn)``
    slabs, else one; at the first that fits, of the columns of
    ``FIRST_COLS`` the widest whose rows are at least f − 1 (each input row
    expanded at most twice), else the narrowest that fits. Raises
    NotImplementedError for a layer it does not take."""
    if min(f, c, n) < 1 or n % 8:
        raise NotImplementedError(
            f"the first-layer kernel takes n a multiple of 8; got f={f}, c={c}, n={n}")
    kx = kx_lanes(f, c)
    npad = n_pad(n)
    slack = 1024 + 8 * 2 * (FIRST_MAX_RAW + WG_MAX_RING)

    def fit(bn, slabs, cc, wins, bufs):
        nchunks = npad // bn
        w_slice = kx * bn * 2
        w_all = -(-nchunks * f * w_slice // 1024) * 1024
        w_two = -(-2 * w_slice // 1024) * 1024
        tile_rows = FIRST_WGS * slabs * WG_SLAB // cc
        win_rows = tile_rows + f - 1
        win_bytes = wins * win_rows * cc * kx * 2
        iw = cc + f - 1
        raw_bytes = win_rows * -(-iw * c // 4) * 4 * 4
        out_bytes = bufs * FIRST_WGS * slabs * WG_SLAB * bn * 2
        budget = SMEM_LIMIT - slack - out_bytes - win_bytes
        if budget < 2 * raw_bytes + min(w_all, w_two):
            return None
        w_res = int(w_all + 2 * raw_bytes <= budget)
        if w_res:
            raw_ring = min(FIRST_MAX_RAW, (budget - w_all) // raw_bytes)
            w_ring, w_bytes = 0, w_all
        else:
            raw_ring = 2
            w_ring = min(WG_MAX_RING, (budget - 2 * raw_bytes) // w_slice)
            while w_ring > 0 and -(-w_ring * w_slice // 1024) * 1024 > budget - 2 * raw_bytes:
                w_ring -= 1
            if w_ring < 2:
                return None
            w_bytes = -(-w_ring * w_slice // 1024) * 1024
        return FirstPlan(f, c, n, kx, npad, bn, nchunks, slabs, cc, tile_rows, win_rows, wins,
                         win_bytes, iw, raw_bytes, raw_ring, w_slice, w_res, w_ring, w_bytes,
                         bufs, out_bytes,
                         slack + w_bytes + out_bytes + win_bytes + raw_ring * raw_bytes)

    for bn in (b for b in (64, 32, 16, 8) if b <= npad):
        for slabs in sorted({first_slabs(bn), 1}, reverse=True):
            best = None
            for cc in FIRST_COLS:
                p = fit(bn, slabs, cc, 2, 2) or fit(bn, slabs, cc, 1, 2) or fit(bn, slabs, cc, 1, 1)
                if p:
                    best = p
                    if p.tile_rows >= f - 1:
                        break
            if best:
                return best
    raise NotImplementedError(
        f"a first f={f} layer over {c} channels into {n}: the window, output staging, two raw "
        f"stages and two W slices of its narrowest tile do not fit (> {SMEM_LIMIT})")


# The wgmma stage of the bf16 chain's middle layers (csrc/conv_wgmma.cu, its
# plan csrc/conv_wgmma_plan.cuh): a tile of 16 columns and 8 rows a slab a
# warpgroup, A boxes of 32 or 64 lanes, W slices of a tap's lanes x the
# block's columns, resident or through a ring.
WG_TILE_COLS = 16  # kWgTileCols
WG_SLAB = 64  # positions of an m64 slab (kWgSlab)
WG_MAX_RING = 16
WG_SLACK = 1024 + 8 * 4 * WG_MAX_RING  # alignment and mbarriers


def wg_slabs(bn: int) -> int:
    """The m64 slabs a warpgroup owns at ``bn`` block columns (``wg_slabs``):
    4 up to 32 (at most 64 sums a thread), 2 at 64 and 128, the fastest
    ``tune.py`` timed (PERF.md)."""
    return 4 if bn <= 32 else 2


def wgmma_instances():
    """The kernel's instances, ``(bn, lanes, slabs)``: one for each block
    width and box lanes (32 or 64 below 128 columns, 64 at 128)."""
    return [(bn, lanes, wg_slabs(bn)) for bn in (8, 16, 32, 64, 128)
            for lanes in ((64,) if bn == 128 else (32, 64))]


class WgmmaPlan(NamedTuple):
    """One wgmma launch (``conv_layer_forward_wgmma``), as ``wgmma_plan`` in
    ``csrc/conv_wgmma_plan.cuh`` computes it: the layer (f, k → n; never
    first or last), its packed K and N, the block's columns (bn), the lanes
    of a box row and K's chunks of them, the slabs a warpgroup and the
    tile's rows, the dy taps a box (gy) and the boxes a dx (groups), a box's
    input rows and bytes, the A stages, a W slice's bytes, whether W is
    resident (else ``w_ring`` slices stream), the W and output staging bytes
    and the dynamic shared bytes."""
    f: int
    k: int
    n: int
    kp: int
    npad: int
    bn: int
    lanes: int
    chunks: int
    slabs: int
    tile_rows: int
    gy: int
    groups: int
    box_rows: int
    a_box: int
    a_ring: int
    w_slice: int
    w_res: int
    w_ring: int
    w_bytes: int
    out_bytes: int
    smem: int


def wgmma_layer_plan(f: int, k: int, n: int, a_ring: int = 0) -> WgmmaPlan:
    """The wgmma stage's plan for a middle f×f layer from k to n channels
    (f odd, k and n multiples of 8) at ``a_ring`` A stages, 0 for the plan's
    own choice. A block computes bn = min(n_pad(n), 128) columns of a tile
    16 columns wide and 8·slabs rows tall (``wg_slabs``); a box row holds
    32 lanes of K (64-byte swizzle) where K pads to
    32 or less below 128 columns, else 64. A box is the tile's rows plus
    the halo of gy dy taps: gy is the most taps whose two boxes fit beside
    two W slices and the output staging in ``SMEM_LIMIT``, evened out over
    the boxes a dx needs. The weights stay resident where all of them fit
    beside two boxes (one column chunk of at most 64); the A ring then takes
    the rest, at most ``WG_MAX_RING`` stages. Else two A stages and a ring
    of W slices in the rest. The W bytes round up to 1024, so that the
    output staging after them keeps the swizzle's alignment. Raises
    NotImplementedError for a layer or a choice it does not take."""
    if f < 1 or f % 2 == 0 or k <= 0 or k % 8 or n <= 0 or n % 8:
        raise NotImplementedError(
            f"the wgmma stage takes an odd f and k and n multiples of 8; got f={f}, k={k}, "
            f"n={n}")
    npad = n_pad(n)
    bn = min(npad, 128)
    slabs = wg_slabs(bn)
    kp = k_pad(k)
    lanes = 32 if bn <= 64 and kp <= 32 else 64
    chunks = -(-k // lanes)
    tile_rows = 2 * slabs * WG_SLAB // WG_TILE_COLS
    row = WG_TILE_COLS * lanes * 2
    w_slice = lanes * bn * 2
    out_bytes = 2 * slabs * WG_SLAB * bn * 2
    budget = SMEM_LIMIT - WG_SLACK - out_bytes
    gy = f
    while gy > 0 and 2 * (tile_rows + gy - 1) * row + 2 * w_slice > budget:
        gy -= 1
    if gy == 0:
        raise NotImplementedError(
            f"an f={f} layer to {n} channels: two {tile_rows}-row A boxes and two W slices "
            f"({2 * tile_rows * row + 2 * w_slice} bytes) do not fit beside the "
            f"{out_bytes}-byte output staging (> {SMEM_LIMIT})")
    gy = -(-f // -(-f // gy))
    box_rows = tile_rows + gy - 1
    a_box = box_rows * row
    w_all = -(-chunks * f * f * w_slice // 1024) * 1024
    w_res = int(npad == bn and bn <= 64 and w_all + 2 * a_box <= budget)
    if w_res:
        most = min(WG_MAX_RING, (budget - w_all) // a_box)
        a_ring = a_ring or most
        if not 2 <= a_ring <= most:
            raise NotImplementedError(f"{a_ring} A stages of {a_box} bytes beside resident "
                                      f"weights: from 2 to {most} fit")
        w_ring, w_bytes = 0, w_all
    else:
        a_ring = a_ring or 2
        w_ring = min(WG_MAX_RING, (budget - a_ring * a_box) // w_slice)
        while w_ring > 0 and -(-w_ring * w_slice // 1024) * 1024 > budget - a_ring * a_box:
            w_ring -= 1
        if not 2 <= a_ring <= WG_MAX_RING or w_ring < 2:
            raise NotImplementedError(f"{a_ring} A stages of {a_box} bytes leave no room for "
                                      f"two W slices of {w_slice}")
        w_bytes = -(-w_ring * w_slice // 1024) * 1024
    return WgmmaPlan(f, k, n, kp, npad, bn, lanes, chunks, slabs, tile_rows, gy, -(-f // gy),
                     box_rows, a_box, a_ring, w_slice, w_res, w_ring, w_bytes, out_bytes,
                     WG_SLACK + a_ring * a_box + out_bytes + w_bytes)


# The bf16 chain's last layer (csrc/conv_last_wgmma.cu, its plan
# csrc/conv_last_plan.cuh): its f dx taps side by side in N, a tile of
# LAST_COLS input columns, 2 or 1 m64 slabs a warpgroup, A boxes of 32 or 64
# lanes, W slices of a (dx group, dy)'s lanes x N, resident or through a
# ring, the f32 sums staged in rows of N + LAST_PAD floats.
LAST_PAD = 8  # kLastPad
LAST_COLS = 64  # kLastCols: 32 and 16 ran slower at RGB L7 (PERF.md)


def last_slabs(npad: int) -> int:
    """The m64 slabs a warpgroup owns at ``npad`` columns (``last_slabs``):
    2 up to 32 (at most 32 sums a thread), else 1."""
    return 2 if npad <= 32 else 1


def last_instances():
    """The last-layer kernel's instances, ``(npad, lanes, slabs)``: one for
    each packed width and box lanes."""
    return [(npad, lanes, last_slabs(npad)) for npad in (8, 16, 32, 64, 128)
            for lanes in (32, 64)]


class LastPlan(NamedTuple):
    """One last-layer launch (``conv_last_forward_wgmma``), as ``last_plan``
    in ``csrc/conv_last_plan.cuh`` computes it: the layer (f, k → n), its
    packed K, the lanes of a box row and K's chunks of them, the dx groups
    and the dx taps a group, the packed columns (``n_pad(gdx·n)``), the
    tile's output columns (of ``LAST_COLS``), the slabs a warpgroup and
    the tile's output rows, the dy taps a box (gy) and the boxes (groups), a
    box's input rows and bytes, the A stages, a W slice's bytes, whether W is
    resident (else ``w_ring`` slices stream), the W and staged-sum bytes and
    the dynamic shared bytes."""
    f: int
    k: int
    n: int
    kp: int
    lanes: int
    chunks: int
    dgroups: int
    gdx: int
    npad: int
    out_cols: int
    slabs: int
    tile_rows: int
    gy: int
    groups: int
    box_rows: int
    a_box: int
    a_ring: int
    w_slice: int
    w_res: int
    w_ring: int
    w_bytes: int
    e_bytes: int
    smem: int


def last_layer_plan(f: int, k: int, n: int) -> LastPlan:
    """The plan of the bf16 chain's last f×f layer from k channels to n
    outputs (f up to 63, k a multiple of 8, n up to 128). The f dx taps of
    the n outputs sit side by side in N, column (dx − d0)·n + c, in the
    fewest dx groups of at most 128 columns (one where f·n ≤ 128), their taps
    evened out; a product's 64 rows are 64 input positions, a row of a tile
    ``LAST_COLS`` columns wide whose first LAST_COLS − f + 1 columns are its
    outputs. A box row holds 32 lanes of K (64-byte swizzle) where K pads to
    32 or less, else 64. A box is the tile's rows plus the halo of gy dy
    taps: gy is the most taps whose two boxes fit beside two W slices and the
    staged sums in ``SMEM_LIMIT``, evened out over the boxes. The weights stay
    resident where all of them fit beside two boxes; the A ring then takes the
    rest, at most ``WG_MAX_RING`` stages. Else two A stages and a ring of W
    slices in the rest. Raises NotImplementedError for a layer it does not
    take."""
    if f < 1 or f >= LAST_COLS or k <= 0 or k % 8 or not 1 <= n <= 128:
        raise NotImplementedError(
            f"the last-layer kernel takes f up to {LAST_COLS - 1}, k a multiple of 8 and n up "
            f"to 128; got f={f}, k={k}, n={n}")
    kp = k_pad(k)
    lanes = 32 if kp <= 32 else 64
    chunks = -(-k // lanes)
    dgroups = -(-f // (128 // n))
    gdx = -(-f // dgroups)
    npad = n_pad(gdx * n)
    slabs = last_slabs(npad)
    tile_rows = 2 * slabs * WG_SLAB // LAST_COLS
    row = LAST_COLS * lanes * 2
    w_slice = lanes * npad * 2
    e_bytes = 2 * slabs * WG_SLAB * (npad + LAST_PAD) * 4
    budget = SMEM_LIMIT - WG_SLACK - e_bytes
    gy = f
    while gy > 0 and 2 * (tile_rows + gy - 1) * row + 2 * w_slice > budget:
        gy -= 1
    if gy == 0:
        raise NotImplementedError(
            f"a last f={f} layer: two {tile_rows}-row A boxes and two W slices "
            f"({2 * tile_rows * row + 2 * w_slice} bytes) do not fit beside the "
            f"{e_bytes}-byte staged sums (> {SMEM_LIMIT})")
    gy = -(-f // -(-f // gy))
    box_rows = tile_rows + gy - 1
    a_box = box_rows * row
    w_all = -(-chunks * dgroups * f * w_slice // 1024) * 1024
    w_res = int(w_all + 2 * a_box <= budget)
    if w_res:
        a_ring = min(WG_MAX_RING, (budget - w_all) // a_box)
        w_ring, w_bytes = 0, w_all
    else:
        a_ring = 2
        w_ring = min(WG_MAX_RING, (budget - a_ring * a_box) // w_slice)
        while w_ring > 0 and -(-w_ring * w_slice // 1024) * 1024 > budget - a_ring * a_box:
            w_ring -= 1
        if w_ring < 2:
            raise NotImplementedError(f"two A stages of {a_box} bytes leave no room for two W "
                                      f"slices of {w_slice}")
        w_bytes = -(-w_ring * w_slice // 1024) * 1024
    return LastPlan(f, k, n, kp, lanes, chunks, dgroups, gdx, npad, LAST_COLS - f + 1, slabs,
                    tile_rows, gy, -(-f // gy), box_rows, a_box, a_ring, w_slice, w_res, w_ring,
                    w_bytes, e_bytes, WG_SLACK + a_ring * a_box + w_bytes + e_bytes)


def bf16_layer_plan(f: int, k: int, n: int, first: bool = False, last: bool = False):
    """The bf16 chain's plan for one layer, which names its kernel: every
    middle layer takes the wgmma stage (``wgmma_layer_plan``), the last
    layer ``conv_last_wgmma.cu`` (``last_layer_plan``) and the first
    ``conv_first_wgmma.cu`` (``first_layer_plan``). A pure function of the
    shape."""
    if first:
        return first_layer_plan(f, k, n)
    if last:
        return last_layer_plan(f, k, n)
    return wgmma_layer_plan(f, k, n)


def plan_instance(plan) -> tuple:
    """The kernel instance a bf16 chain plan launches: ``("first", bn,
    slabs)``, ``("wgmma", bn, lanes, slabs)`` or ``("last", npad, lanes,
    slabs)``, as ``first_instances``, ``wgmma_instances`` and
    ``last_instances`` list them."""
    if isinstance(plan, FirstPlan):
        return ("first", plan.bn, plan.slabs)
    if isinstance(plan, WgmmaPlan):
        return ("wgmma", plan.bn, plan.lanes, plan.slabs)
    return ("last", plan.npad, plan.lanes, plan.slabs)


@functools.lru_cache(maxsize=None)
def same_instances() -> tuple:
    """The instances that the three wgmma kernels also compile in their SAME
    form (``conv_*_forward_wgmma_same``), each a ``plan_instance``: those of
    the plans that Real-ESRGAN x4plus's layers reach (an RRDBNet of 64
    features and 32 growth channels over RGB, ``ops/fused/rrdb.py``). The
    kernels refuse a SAME launch on any other plan; compiling every VALID
    instance's SAME twin would cost each checkout's first build the time of
    instances that no SAME model launches."""
    from ...utils.config import rrdbnet_layers

    layers = rrdbnet_layers(3, 64, 32, 1)
    return tuple(sorted({plan_instance(bf16_layer_plan(f, k, n, first=i == 0,
                                                       last=i == len(layers) - 1))
                         for i, (f, k, n) in enumerate(layers)}))


# The bf16 fused kernel (csrc/fused_wgmma.cu, its plan
# csrc/fused_wgmma_plan.cuh): three consumer warpgroups, conv2 tiles of at
# most 32 x 32 positions in 8 x 8 patches, at most 96 conv2 sums a thread,
# at most 8 w2 tap slices in flight.
FW_CONSUMERS = 3  # kFwConsumers
FW_MAX_A2 = 32  # kFwMaxA2
FW_MIN_A2 = 24  # kFwMinA2: below it the halo recompute outweighs what fusion saves
FW_ACC_FLOATS = 96  # kFwAccFloats
FW_MAX_RING = 8  # kFwMaxRing
FW_BAR_BYTES = 8 * (3 + 2 * FW_MAX_RING)  # kFwBarBytes


class FusedWgmmaPlan(NamedTuple):
    """One bf16 fused launch (``fused_srcnn_forward_bf16``), as
    ``fused_wgmma_plan`` in ``csrc/fused_wgmma_plan.cuh`` computes it: the
    stack; conv1's K a dy tap (the window's lanes) and N, conv2's K and N,
    conv3's K and N (its f3 dx taps side by side, ``n_pad(f3·n3)``
    columns); the output tile's side, the conv2 tile's (a2, a multiple of
    8) and the conv1 tile's (a1), the window's rows (a1 wide); conv1's
    raster chunks of 64 positions, conv2's 8 x 8 patches and a warpgroup's
    share of them, conv3's raster chunks (the output rows a2 wide); the
    positions the window and a2 hold (the chunks read past the tiles); and
    the shared bytes: window (later a2, ``r0``) | w1 | a1 (later conv3's
    f32 sums of ``e_bytes``, ``r1``) | w3 | the next tile's input pixels,
    f32 (``raw_bytes``) | ``ring`` w2 tap slices | mbarriers, ``smem`` in
    all."""
    c: int
    f1: int
    n1: int
    f2: int
    n2: int
    f3: int
    n3: int
    kx: int
    n1p: int
    k2: int
    n2p: int
    k3: int
    n3p: int
    tile: int
    a2: int
    a1: int
    ih: int
    chunks1: int
    patches: int
    per_wg: int
    chunks3: int
    win_pos: int
    a2_pos: int
    win_bytes: int
    w1_bytes: int
    a2_bytes: int
    r0: int
    a1_bytes: int
    e_bytes: int
    r1: int
    w3_bytes: int
    raw_bytes: int
    slice: int
    ring: int
    smem: int


def fused_wgmma_plan(c: int, layers):
    """The bf16 fused kernel's plan for ``layers`` = ((f, k, n), ...) over
    ``c`` input channels, or None for a stack it does not take (c outside 1
    .. 4, n1 padded past 128, f3·n3 past 32, or no conv2 tile whose
    patches fit a warpgroup's sums and whose buffers fit ``SMEM_LIMIT``
    beside two w2 slots). The larger conv2 tile a2 of 32 and 24 that fits
    is taken; the output tile is a2 − f3 + 1."""
    (f1, _, n1), (f2, _, n2), (f3, _, n3) = layers
    if not (1 <= c <= 4 and min(f1, f2, f3, n1, n2, n3) >= 1 and f3 * n3 <= 32):
        return None
    kx, n1p, k2, n2p, k3 = kx_lanes(f1, c), n_pad(n1), k_pad(n1), n_pad(n2), k_pad(n2)
    n3p = n_pad(f3 * n3)
    if n1p > 128:
        return None
    taps2 = f2 * f2
    for a2 in range(FW_MAX_A2, FW_MIN_A2 - 1, -8):
        tile = a2 - f3 + 1
        patches = (a2 // 8) ** 2
        per_wg = -(-patches // FW_CONSUMERS)
        if tile < 1 or per_wg > min(6, FW_ACC_FLOATS // (n2p // 2)):
            continue
        a1 = a2 + f2 - 1
        ih = a1 + f1 - 1
        chunks1 = -(-a1 * a1 // 64)
        chunks3 = -(-tile * a2 // 64)
        win_pos = max(ih * a1, chunks1 * 64 + (f1 - 1) * a1)
        a2_pos = max(a2 * a2, chunks3 * 64 + (f3 - 1) * a2)
        win_bytes, w1_bytes = win_pos * kx * 2, f1 * kx * n1p * 2
        a2_bytes = a2_pos * k3 * 2
        r0 = max(win_bytes, a2_bytes)
        a1_bytes, e_bytes = a1 * a1 * k2 * 2, chunks3 * 64 * n3p * 4
        r1 = max(a1_bytes, e_bytes)
        raw_bytes = -(-ih * (a1 + f1 - 1) * c * 4 // 16) * 16
        w3_bytes = f3 * k3 * n3p * 2
        slice_ = k2 * n2p * 2
        fixed = r0 + w1_bytes + r1 + w3_bytes + raw_bytes + FW_BAR_BYTES
        ring = min(FW_MAX_RING, taps2, (SMEM_LIMIT - fixed) // slice_)
        if ring < min(2, taps2):
            continue
        return FusedWgmmaPlan(c, f1, n1, f2, n2, f3, n3, kx, n1p, k2, n2p, k3, n3p, tile, a2, a1,
                              ih, chunks1, patches, per_wg, chunks3, win_pos, a2_pos, win_bytes,
                              w1_bytes, a2_bytes, r0, a1_bytes, e_bytes, r1, w3_bytes, raw_bytes,
                              slice_, ring, fixed + ring * slice_)
    return None


def route(c: int, layers, elem: int = 4):
    """The kernel for ``layers`` = ((f, k, n), ...) over ``c`` input
    channels at ``elem`` bytes an element (4: f32, 2: the bf16 stream).
    f32: ``("fused", (wbuf, smem))`` (``smem_plan``) for a stack the
    fused kernel takes, else ``("chain", [LayerPlan, ...])`` (``layer_plan``). bf16:
    ``("fused", FusedWgmmaPlan)`` (``fused_wgmma_plan``) or ``("chain",
    [FirstPlan, WgmmaPlan, ..., LastPlan])`` (``bf16_layer_plan``). The fused
    kernels take 3-layer stacks with c ≤ 4 and n_out ≤ 4 whose plans fit
    one block.
    Raises NotImplementedError for a stack neither kernel takes."""
    fits = len(layers) == 3 and c <= 4 and layers[-1][2] <= 4
    if elem == 2:
        plan = fused_wgmma_plan(c, layers) if fits else None
        if plan is not None:
            return "fused", plan
        last = len(layers) - 1
        return "chain", [bf16_layer_plan(*layer, first=i == 0, last=i == last)
                         for i, layer in enumerate(layers)]
    plan = smem_plan(c, layers) if fits else None
    if plan is not None:
        return "fused", plan
    return "chain", [layer_plan(*layer) for layer in layers]


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
    well-formed stack that no kernel takes (``layer_plan``), on every
    device, so the CPU and CUDA paths take the same stacks. Returns ``(precision, kind,
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


def pack_bf16(w: torch.Tensor, b: torch.Tensor, first: bool, levels: int = 127):
    """The bf16 kernels' operands of one layer, ``w`` (f, f, k, n) HWIO and
    ``b`` (n,): the weights tap-major ``(taps, K_pad, N_pad)`` bf16 and the
    bias ``(N_pad,)`` f32, zero in every padding lane. The first layer
    (``first``) is dx-expanded with the 1/127 fold (1/``levels``: 255 for a
    SAME model's 0..255 input levels): ``f`` taps (one per dy) whose row
    ``dx·k + ci`` holds ``fold_first(w, levels)[dy, dx, ci]``, K_pad =
    ``kx_lanes(f, k)``; any other layer has ``f²`` taps (dy·f + dx) of
    ``w[dy, dx].to(bf16)``, K_pad = ``k_pad(k)``."""
    f, _, k, n = w.shape
    npad = n_pad(n)
    if first:
        taps, kp, wb = f, kx_lanes(f, k), reference.fold_first(w, levels).reshape(f, f * k, n)
    else:
        taps, kp, wb = f * f, k_pad(k), w.to(torch.bfloat16).reshape(f * f, k, n)
    wp = torch.zeros((taps, kp, npad), dtype=torch.bfloat16, device=w.device)
    wp[:, :wb.shape[1], :n] = wb
    bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
    bp[:n] = b
    return wp, bp


def pack_f32(w: torch.Tensor, b: torch.Tensor, nb: int):
    """The f32 fused kernel's operands of one layer, ``w`` (f, f, k, n)
    HWIO and ``b`` (n,): the weights channel-major ``(k, f·f, npad)`` f32
    (row ``dy·f + dx`` of channel ``ci`` holds ``w[dy, dx, ci]``) and the
    bias ``(npad,)``, npad = ``n_pad_f32(n, nb)``, zero in every padding
    lane. A chunk of input channels is then one contiguous copy."""
    f, _, k, n = w.shape
    npad = n_pad_f32(n, nb)
    wp = torch.zeros((k, f * f, npad), dtype=torch.float32, device=w.device)
    wp[:, :, :n] = w.permute(2, 0, 1, 3).reshape(k, f * f, n)
    bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
    bp[:n] = b
    return wp, bp


def _packed(w: torch.Tensor, b: torch.Tensor, attr: str, key, pack):
    """``pack()``, made once per weight tensor and ``key`` (and again only
    after ``w`` or ``b`` changes in place): kept on ``w`` itself as
    ``attr``, beside the version counters."""
    key = (key, w._version, b.data_ptr(), b._version)
    kept = getattr(w, attr, None)
    if kept is None or kept[0] != key:
        kept = (key, pack())
        setattr(w, attr, kept)
    return kept[1]


def packed_f32(w: torch.Tensor, b: torch.Tensor, nb: int):
    """``pack_f32(w, b, nb)``, made once per weight tensor and ``nb`` (and
    again only after ``w`` or ``b`` changes in place): the fused kernel and
    the chain may pack one weight at two NBs, each kept apart."""
    return _packed(w, b, f"_cnn_sr_f32_nb{nb}", nb, lambda: pack_f32(w, b, nb))


def f32_weights(params, nbs=FUSED_NB):
    """The f32 kernels' ``(weights, bias)`` of each layer (``packed_f32``
    at ``nbs``: the fused kernel's by default, or each chain plan's
    ``nb``)."""
    return [packed_f32(layer["w"], layer["b"], nb) for layer, nb in zip(params, nbs)]


def packed_bf16(w: torch.Tensor, b: torch.Tensor, first: bool, levels: int = 127):
    """``pack_bf16(w, b, first, levels)``, made once per weight tensor (and
    again only after ``w`` or ``b`` changes in place): the result is kept on
    ``w`` itself, beside the version counters."""
    return _packed(w, b, "_cnn_sr_bf16", (first, levels),
                   lambda: pack_bf16(w, b, first, levels))


def fused_image(wp: torch.Tensor) -> torch.Tensor:
    """The bf16 fused kernel's shared-memory image of packed weights
    ``wp`` (taps, K, N): each tap the K-major wgmma operand in no-swizzle
    core matrices, ``[K / 8][N / 8][8 columns][8 rows of K]``, so that a tap
    is one contiguous copy."""
    taps, k, n = wp.shape
    return wp.view(taps, k // 8, 8, n // 8, 8).permute(0, 1, 3, 4, 2).contiguous()


def pack_fused_last(w: torch.Tensor) -> torch.Tensor:
    """The bf16 fused kernel's conv3 weights, ``w`` (f, f, k, n) HWIO: f
    taps (one per dy) of ``k_pad(k)`` x ``n_pad(f·n)``, column ``dx·n + c``
    of tap dy, row ci holding ``w[dy, dx, ci, c]`` in bf16, zero padding;
    as ``fused_image``."""
    f, _, k, n = w.shape
    wp = torch.zeros((f, k_pad(k), n_pad(f * n)), dtype=torch.bfloat16, device=w.device)
    wp[:, :k, :f * n] = w.to(torch.bfloat16).permute(0, 2, 1, 3).reshape(f, k, f * n)
    return fused_image(wp)


def pack_last(w: torch.Tensor, b: torch.Tensor, plan: LastPlan):
    """The last-layer kernel's operands, ``w`` (f, f, k, n) HWIO and ``b``
    (n,) at ``plan`` (``last_layer_plan``): the weights as ``dgroups·f``
    slices (dx group, dy) of ``kp`` x ``npad`` bf16, column (dx − d0)·n + c
    of slice dg·f + dy, row ci holding ``w[dy, dx, ci, c]`` for the dx
    group's taps d0 = dg·gdx ..; the bias ``(n_pad(n),)`` f32; zero in
    every padding lane."""
    f, _, k, n = w.shape
    wl = torch.zeros((plan.dgroups * f, plan.kp, plan.npad), dtype=torch.bfloat16,
                     device=w.device)
    wb = w.to(torch.bfloat16)
    for dg in range(plan.dgroups):
        d0, d1 = dg * plan.gdx, min(f, (dg + 1) * plan.gdx)
        wl[dg * f:(dg + 1) * f, :k, :(d1 - d0) * n] = (
            wb[:, d0:d1].permute(0, 2, 1, 3).reshape(f, k, (d1 - d0) * n))
    bl = torch.zeros(n_pad(n), dtype=torch.float32, device=b.device)
    bl[:n] = b
    return wl, bl


def packed_last(w: torch.Tensor, b: torch.Tensor, plan: LastPlan):
    """``pack_last(w, b, plan)``, made once per weight tensor and packing
    (and again only after ``w`` or ``b`` changes in place)."""
    key = (plan.dgroups, plan.gdx, plan.npad, plan.kp)
    return _packed(w, b, "_cnn_sr_bf16_last", key, lambda: pack_last(w, b, plan))


def chain_bf16_weights(params, plans):
    """The bf16 chain's ``(weights, bias)`` of each layer as its plan's
    stage takes them: ``packed_last`` for a ``LastPlan``, else
    ``packed_bf16`` (the first layer dx-expanded and folded)."""
    return [packed_last(layer["w"], layer["b"], plan) if isinstance(plan, LastPlan)
            else packed_bf16(layer["w"], layer["b"], i == 0)
            for i, (layer, plan) in enumerate(zip(params, plans))]


def fused_weights(params):
    """The bf16 fused kernel's ``(image, bias)`` of each layer, made once per
    weight tensor (and again only after ``w`` or ``b`` changes in place):
    conv1's and conv2's ``fused_image`` of ``packed_bf16``, conv3's
    ``pack_fused_last``; the biases ``packed_bf16``'s."""
    out = []
    for i, layer in enumerate(params):
        wp, bp = packed_bf16(layer["w"], layer["b"], i == 0)
        pack = ((lambda wt=layer["w"]: pack_fused_last(wt)) if i == len(params) - 1
                else (lambda wp=wp: fused_image(wp)))
        out.append((_packed(layer["w"], layer["b"], "_cnn_sr_bf16_image", i, pack), bp))
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
    dims = [(layer["w"].shape[0], layer["w"].shape[3]) for layer in params]
    n, h, w, c = x.shape
    from .build import load_library

    lib = load_library()
    shrink = sum(f - 1 for f, _ in dims)
    y = torch.empty((n, h - shrink, w - shrink, dims[2][1]),
                    dtype=torch.float32, device=x.device)
    operands = fused_weights(params) if bf16 else f32_weights(params)
    ptrs = [x.data_ptr()] + [t.data_ptr() for pair in operands for t in pair]
    (f1, n1), (f2, n2), (f3, n3) = dims
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            err = lib.fused_srcnn_forward_bf16(*ptrs, y.data_ptr(), n, h, w, c, f1, n1, f2, n2,
                                               f3, n3, plan.smem, stream)
        else:
            wbuf, smem = plan
            err = lib.fused_srcnn_forward(*ptrs, y.data_ptr(), n, h, w, c, f1, n1, f2, n2, f3,
                                          n3, wbuf, smem, stream)
    if err:
        raise RuntimeError(f"fused_srcnn{'_bf16' if bf16 else ''} launch failed: "
                           + lib.cnn_sr_error_string(err).decode())
    if bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return y
