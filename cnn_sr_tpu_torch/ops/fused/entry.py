"""``fused_forward``: the SRCNN conv stack on the card, routed by shape.

Counterpart of ``cnn_sr_tpu/ops/pallas_fused/entry.py:fused_forward``.
Two hand-written kernels share the work, each in two precisions, chosen
by ``route``, a pure function of the shapes:

* ``csrc/fused_srcnn.cu`` (f32) and ``csrc/fused_wgmma.cu`` (bf16), the
  whole stack in one launch, for 3-layer stacks with c_in <= 4 and n_out
  <= 4 whose tiles fit one block's shared memory (the luma models:
  flagship 9-5-5, 9-1-5);
* ``csrc/conv_layer.cu`` through ``chain.chain_forward``, one launch per
  layer, for every other well-formed stack (the 7-layer RGB model).

``precision="f32"`` runs them in f32 on the CUDA cores, both on
``csrc/ffma_stage.cuh`` with weights packed once by ``pack_f32`` (the
chain's plan per layer: ``layer_plan``). ``precision="bf16"``
runs the JAX package's bf16 stream with the int8 first layer
(``reference`` states the numbers) on the tensor cores (the fused
kernel on ``wgmma``; the chain on ``csrc/tc_stage.cuh``, its middle
layers at n > 64 on ``csrc/conv_wgmma.cu``), with its own plans
(``bf16_layer_plan``, ``fused_wgmma_plan``) and its weights packed
tap-major (``pack_bf16``; the fused kernel takes them tiled into its
shared-memory image, ``fused_weights``), on the JAX rule of where that stream applies
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
# layer (csrc/tc_stage.cuh, csrc/conv_wgmma.cu) and the fused kernel's
# (csrc/fused_wgmma.cu). The C side recomputes the same plans and refuses a
# launch whose shared bytes fall short of them.

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


def w_stride(nb: int) -> int:
    """bf16 elements of a shared weight row of nb columns: padded by 16
    bytes where nb / 8 is even, so that ldmatrix rows fall on distinct
    banks."""
    return nb if (nb // 8) % 2 else nb + 8


class TcPlan(NamedTuple):
    """One bf16 chain launch (``conv_layer_forward_bf16``): the layer
    (f, k → n, first or last of the stream), the window's lanes a channel
    chunk, the taps a weight stage and the dynamic shared bytes. The
    output tile is TILE_H x TILE_W."""
    f: int
    k: int
    n: int
    first: bool
    last: bool
    kc: int
    tps: int
    smem: int


def tc_layer_plan(f: int, k: int, n: int, first: bool = False, last: bool = False) -> TcPlan:
    """The bf16 chain's ``mma.sync`` plan (``csrc/tc_stage.cuh``) for one
    f×f layer from k to n channels: a first or last layer, or a middle one
    at n ≤ 64 (a middle layer at n > 64 is ``wgmma_layer_plan``'s, and
    raises NotImplementedError here). The
    window (the tile plus its halo, position-major, rows of kc + 8 lanes;
    the first layer dx-expanded, TILE_W positions wide) takes all of K
    where it fits beside two stages of one tap's weights, else the largest
    chunk of 16 lanes that does. The weights stay whole in one stage where
    window and weights fit in half the block limit (two blocks an SM); else
    they stream in stages of as many taps as fit in two (in half the limit
    where one tap does, else in all of it). Raises NotImplementedError when
    not even 16 lanes fit."""
    if not first and not last and n_pad(n) > 64:
        raise NotImplementedError(
            f"a middle layer to {n} channels takes the wgmma stage (wgmma_layer_plan), "
            "not tc_stage.cuh")
    nb = min(n_pad(n), 128)
    ws = w_stride(nb)
    rows = TILE_H + f - 1
    if first:
        kp, cols, taps = kx_lanes(f, k), TILE_W, f
    else:
        kp, cols, taps = k_pad(k), TILE_W + f - 1, f * f
    win = lambda kc: 2 * rows * cols * (kc + 8)  # noqa: E731
    tap = lambda kc: 2 * kc * ws  # noqa: E731
    kc = kp
    while not first and kc > 16 and win(kc) + 2 * tap(kc) > SMEM_LIMIT:
        kc -= 16
    if win(kc) + 2 * tap(kc) > SMEM_LIMIT:
        raise NotImplementedError(
            f"a {TILE_H}x{TILE_W} tile of an f={f} layer over {k} channels needs "
            f"{win(kc)} shared bytes for its window plus {2 * tap(kc)} for weights "
            f"(> {SMEM_LIMIT})")
    half = SMEM_LIMIT // 2
    if kc == kp and win(kc) + taps * tap(kc) <= half:
        tps = taps
    else:
        budget = half if win(kc) + 2 * tap(kc) <= half else SMEM_LIMIT
        tps = min(taps, (budget - win(kc)) // (2 * tap(kc)))
    stages = 2 if -(-taps // tps) > 1 else 1
    out = 0 if last else 2 * TILE_H * TILE_W * ws  # the staged bf16 output tile
    return TcPlan(f, k, n, first, last, kc, tps, max(win(kc) + stages * tps * tap(kc), out))


# The wgmma stage of the bf16 chain's middle layers at n > 64
# (csrc/conv_wgmma.cu, its plan csrc/conv_wgmma_plan.cuh): a 16x16 output
# tile, A boxes of 64 lanes x 16 columns, W slices of 64 rows x 128 columns.
WG_TILE = 16  # output rows and columns of a tile (kWgTileRows, kWgTileCols)
WG_LANES = 64  # lanes of a box row (kWgLanes)
WG_N = 128  # output columns a block (kWgN)
WG_MAX_RING = 16
WG_W_SLICE = WG_LANES * WG_N * 2  # bytes of a W slice
WG_OUT = WG_TILE * WG_TILE * WG_N * 2  # bytes of the output staging
WG_SLACK = 1024 + 8 * 4 * WG_MAX_RING  # alignment and mbarriers


class WgmmaPlan(NamedTuple):
    """One wgmma launch (``conv_layer_forward_wgmma``), as ``wgmma_plan`` in
    ``csrc/conv_wgmma_plan.cuh`` computes it: the layer (f, k → n; never
    first or last), its packed K and N, K's 64-lane chunks, the dy taps a
    box (gy) and the boxes a dx (groups), a box's input rows and bytes, the
    A and W ring stages and the dynamic shared bytes."""
    f: int
    k: int
    n: int
    kp: int
    npad: int
    chunks: int
    gy: int
    groups: int
    box_rows: int
    a_box: int
    a_ring: int
    w_ring: int
    smem: int
    first: bool = False
    last: bool = False


def wgmma_layer_plan(f: int, k: int, n: int) -> WgmmaPlan:
    """The wgmma stage's plan for a middle f×f layer from k to n channels
    (f odd, k and n multiples of 8, n > 64). A box of A is the tile's rows
    plus the halo of gy dy taps: gy is the most taps whose two boxes fit
    beside two W slices and the output staging in ``SMEM_LIMIT``, evened
    out over the boxes a dx needs; two A stages; the rest of the shared
    memory, up to ``WG_MAX_RING`` slices, is the W ring. Raises
    NotImplementedError for a layer it does not take."""
    if f < 1 or f % 2 == 0 or k <= 0 or k % 8 or n <= 64 or n % 8:
        raise NotImplementedError(
            f"the wgmma stage takes an odd f, k and n multiples of 8, and n > 64; "
            f"got f={f}, k={k}, n={n}")
    budget = SMEM_LIMIT - WG_SLACK - WG_OUT
    row = WG_TILE * WG_LANES * 2
    gy = f
    while gy > 0 and 2 * (WG_TILE + gy - 1) * row + 2 * WG_W_SLICE > budget:
        gy -= 1
    if gy == 0:
        raise NotImplementedError(
            f"an f={f} layer to {n} channels: two {WG_TILE}-row A boxes and two W "
            f"slices ({2 * WG_TILE * row + 2 * WG_W_SLICE} bytes) do not fit beside the "
            f"{WG_OUT}-byte output staging (> {SMEM_LIMIT})")
    gy = -(-f // -(-f // gy))
    box_rows = WG_TILE + gy - 1
    a_box = box_rows * row
    w_ring = min(WG_MAX_RING, (budget - 2 * a_box) // WG_W_SLICE)
    return WgmmaPlan(f, k, n, k_pad(k), n_pad(n), -(-k // WG_LANES), gy, -(-f // gy),
                     box_rows, a_box, 2, w_ring, WG_SLACK + 2 * a_box + w_ring * WG_W_SLICE
                     + WG_OUT)


def bf16_layer_plan(f: int, k: int, n: int, first: bool = False, last: bool = False):
    """The bf16 chain's plan for one layer, which names its stage: a middle
    layer at n > 64 takes the wgmma stage (``wgmma_layer_plan``), every
    other layer ``tc_stage.cuh`` (``tc_layer_plan``). A pure function of
    the shape."""
    if not first and not last and n_pad(n) > 64:
        return wgmma_layer_plan(f, k, n)
    return tc_layer_plan(f, k, n, first, last)


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
    [TcPlan or WgmmaPlan, ...])`` (``bf16_layer_plan``). The fused kernels
    take 3-layer stacks with c ≤ 4 and n_out ≤ 4 whose plans fit one block.
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


def pack_bf16(w: torch.Tensor, b: torch.Tensor, first: bool):
    """The bf16 kernels' operands of one layer, ``w`` (f, f, k, n) HWIO and
    ``b`` (n,): the weights tap-major ``(taps, K_pad, N_pad)`` bf16 and the
    bias ``(N_pad,)`` f32, zero in every padding lane. The first layer
    (``first``) is dx-expanded with the 1/127 fold: ``f`` taps (one per
    dy) whose row ``dx·k + ci`` holds ``fold_first(w)[dy, dx, ci]``, K_pad
    = ``kx_lanes(f, k)``; any other layer has ``f²`` taps (dy·f + dx) of
    ``w[dy, dx].to(bf16)``, K_pad = ``k_pad(k)``."""
    f, _, k, n = w.shape
    npad = n_pad(n)
    if first:
        taps, kp, wb = f, kx_lanes(f, k), reference.fold_first(w).reshape(f, f * k, n)
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


def packed_bf16(w: torch.Tensor, b: torch.Tensor, first: bool):
    """``pack_bf16(w, b, first)``, made once per weight tensor (and again
    only after ``w`` or ``b`` changes in place): the result is kept on
    ``w`` itself, beside the version counters."""
    return _packed(w, b, "_cnn_sr_bf16", first, lambda: pack_bf16(w, b, first))


def bf16_weights(params):
    """The bf16 kernels' ``(weights, bias)`` of every layer
    (``packed_bf16``, the first layer dx-expanded and folded)."""
    return [packed_bf16(layer["w"], layer["b"], i == 0) for i, layer in enumerate(params)]


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
