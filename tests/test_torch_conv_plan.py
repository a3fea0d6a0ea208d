"""The work plans of K1, K2 and B2 (ops/conv_plan.py) cover every output
element exactly once, keep K1's and K2's one-process sum order wherever
they do not split K and are off the wgmma route (bfloat16 K1 and B2 at the
deep maps, whose K order and split come from the shape without Cout), fit
their shared memory, and give the card's SMs work at the recurrent gates'
shapes. Pure integer arithmetic on the CPU;
the kernels derive the same indices from the plan's integers
(csrc/conv_ring.cuh, csrc/conv_dw.cu) and the card tests hold them to
their plain versions."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from event_flow_tpu_torch.ops.conv_plan import (B2_PIX, K2_PAIRED_GROUPS,
                                                RING_CCH, RING_HALF_SMEM,
                                                RING_MAX_SLICES,
                                                RING_MAX_SMEM, RING_TILE,
                                                WG_CH, WG_DW_BN, WG_K1_BN,
                                                WG_K1_SLICES, WG_TILE,
                                                b2_plan, k1_plan, k2_plan,
                                                ring_smem, wg_b2_smem,
                                                wg_k1_smem, wgmma_route)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (needs the sys.path insert)

SMS = 132  # the H100's SMs
ESIZES = [4, 2]  # float32, bfloat16

# (B, H, W, Cin, Cout, k): LIFFireNet's dx and head at the training recipe
# and serving, the spiking U-Net's deep cells and heads, RecEVFlowNet's,
# FireNet's and E2VID's gates (chip_smoke.py::GATE_SHAPES), serving's
# 12 x 15, and edges: channel counts off 16-byte rows, Cout <= 8, k 1 and
# 5, maps smaller than a tile and tiles straddling images past B
GATE_SHAPES = [(8, 8, 8, 1024, 1024, 3), (8, 8, 8, 1024, 512, 3),
               (1, 12, 15, 1024, 1024, 3), (1, 12, 15, 1024, 512, 3),
               (8, 128, 128, 64, 64, 3), (8, 128, 128, 64, 32, 3),
               (8, 16, 16, 512, 1024, 3)]
SHAPES = GATE_SHAPES + [
    (8, 128, 128, 32, 32, 3), (8, 128, 128, 2, 32, 1),
    (8, 128, 128, 32, 2, 1), (1, 180, 240, 32, 32, 3),
    (1, 180, 240, 32, 2, 1), (8, 8, 8, 512, 512, 3),
    (8, 16, 16, 256, 256, 3), (8, 16, 16, 1024, 256, 3),
    (8, 16, 16, 256, 2, 1), (1, 24, 30, 1026, 256, 3),
    (1, 46, 60, 514, 128, 3), (2, 20, 21, 5, 7, 3), (2, 12, 15, 2, 32, 3),
    (2, 9, 13, 130, 64, 3), (1, 10, 12, 258, 40, 5), (3, 8, 8, 514, 9, 3),
    (1, 6, 7, 1026, 7, 1), (8, 4, 4, 64, 32, 3), (3, 8, 8, 32, 16, 5),
    (5, 8, 16, 48, 24, 3),
    # the wgmma route's edges (chip_smoke.py::WGMMA_EDGES): images past B,
    # Cout off the groups, tiles overhanging the map
    (3, 8, 8, 512, 200, 3), (5, 9, 11, 576, 72, 3)]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _partitions(ranges, n):
    """The ranges are consecutive and together range(n)."""
    flat = [i for r in ranges for i in r]
    return flat == list(range(n))


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plan_covers_every_output_once(shape, esize):
    """Every (b, y, x, co) of y lies in exactly one item's tile and group;
    a tile is 256 pixels, imgs images of th x tw, with a warp's 32 pixels
    in one image (on the wgmma route 128 pixels, groups of 128 channels);
    the clusters' walks split the items without overlap, and the blocks of
    a cluster (the wgmma route's slices) its passes."""
    b, h, w, cin, cout, k = shape
    plan = k1_plan(b, h, w, cin, cout, k, esize, SMS)
    if plan.wgmma:
        assert plan.imgs * plan.th * plan.tw == WG_TILE
        assert plan.tw in (8, 16, 32) and plan.co == WG_K1_BN
        assert plan.passes == -(-cin // WG_CH)
        assert 1 <= plan.slices <= min(WG_K1_SLICES, plan.passes)
        assert plan.units == plan.items * plan.slices
    else:
        assert plan.imgs * plan.th * plan.tw == RING_TILE
        assert plan.th * plan.tw >= 32 and plan.tw in (8, 16, 32)
        assert plan.co in ((8,) if cout <= 8 else (8, 16, 32))
        assert 1 <= plan.slices <= min(RING_MAX_SLICES, plan.passes)
    seen = np.zeros((b, h, w, cout), np.int8)
    for i in range(plan.items):
        b0, y0, x0, co0 = plan.item(i)
        seen[b0:b0 + plan.imgs, y0:y0 + plan.th, x0:x0 + plan.tw,
             co0:co0 + plan.co] += 1
    assert (seen == 1).all()
    for n in sorted({1, 7, SMS, plan.items}):
        assert _partitions([plan.cluster_items(c, n) for c in range(n)],
                           plan.items)
    assert _partitions([plan.block_passes(q) for q in range(plan.slices)],
                       plan.passes)


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plan_keeps_the_one_process_order(shape, esize):
    """Off the wgmma route, wherever the plan claims bitwise (no split of
    K), one block walks every pass of an item in order, passes of 32 input
    channels each padded to the MMA's k of 8 (conv_tile.cuh::pass_pad), as
    the one-process mainloop did; the taps run in order inside a pass in
    both mainloops. On the wgmma route (bfloat16 at the deep maps) the
    plan claims no such order: its passes are 64 channels, its sums the
    tensor core's, in an order and split that depend on the shape without
    Cout."""
    b, h, w, cin, cout, k = shape
    plan = k1_plan(b, h, w, cin, cout, k, esize, SMS)
    cch = WG_CH if plan.wgmma else RING_CCH
    assert plan.passes == -(-cin // cch)
    c = 0
    for p in range(plan.passes):
        c0, c1, cpad = plan.pass_channels(p)
        assert (c0, c1) == (c, min(cin, c + cch))
        assert cpad == (c1 - c0 + 7) // 8 * 8
        c = c1
    assert c == cin
    assert plan.wgmma == wgmma_route(cin, cout, k, esize)
    if plan.wgmma:
        assert not plan.bitwise and esize == 2
        return
    assert plan.bitwise == (plan.slices == 1)
    if plan.bitwise:
        assert list(plan.block_passes(0)) == list(range(plan.passes))


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plans_fit_shared_memory(shape, esize):
    """Each plan's stages fit in one block's 227 KB (bfloat16 K1 on the
    ring within half an SM's where two blocks a SM fit), with a ring of 1
    to 2 (float32) or 4 stages, or K1's one-image tile (no ring). The
    bytes are the plan's own formulas (ring_smem, tile_smem, b2_smem);
    test_plan_bytes_match_the_kernels_layout holds those to the kernels'
    layouts at a few plans worked out by hand, and on the card a kernel
    refuses a plan whose layout does not fit."""
    b, h, w, cin, cout, k = shape
    k1 = k1_plan(b, h, w, cin, cout, k, esize, SMS)
    assert k1.smem <= RING_MAX_SMEM
    if k1.wgmma:
        # two halo stages and 2 to 12 weight boxes, one block a SM
        assert 2 <= k1.ns <= 12
        assert k1.smem == wg_k1_smem(k1.tw, k1.imgs, k, k1.ns)
    elif k1.ring:
        assert 1 <= k1.ns <= (2 if esize == 4 else 4)
    else:
        assert (k1.tw, k1.th, k1.imgs, k1.slices) == (32, 8, 1, 1)
        assert k1.co == (8 if cout <= 8 else 32)
    b2 = b2_plan(b, h, w, cin, cout, k, esize, SMS)
    if b2.wgmma:
        # one block a SM: three warpgroups
        assert b2.threads == 384 and 2 <= b2.ns <= 6
        assert b2.smem == wg_b2_smem(b2.tw, b2.imgs, k, b2.ns)
        assert b2.smem <= RING_MAX_SMEM
        assert (b2.cb, b2.bn) == (WG_CH, WG_DW_BN)
        return
    assert b2.smem <= RING_MAX_SMEM and 2 <= b2.ns <= 4
    if b2.ns > 2:
        assert b2.smem <= RING_HALF_SMEM
    assert b2.threads % 32 == 0 and b2.threads <= 256


# (plan, its fields, its bytes) worked out by hand from the kernels' own
# layout code: csrc/conv_ring.cuh::layout (1024 bytes of mbarriers; ns
# stages of the halo, imgs x (th + k - 1) x (tw + k - 1) rows of 128
# float32 or 64 bfloat16 bytes rounded up to 1024, plus the pass's weight
# rows k*k*32*co*4 or k*k*32*(co + 8)*2 rounded up to 1024 where they are
# streamed; float32's split hi and lo of both; resident weights of the
# passes, doubled in float32; the cluster's 256*2*(co/8)*16 bytes),
# csrc/conv_tile.cuh::smem_bytes ((8 + k - 1) x (32 + k - 1) halo pixels
# of cpad + 4 floats, or cpad | 8 bfloat16, and k*k*cpad weight rows of
# co + 8, or 8 where co is 8) and csrc/conv_dw.cu::make_geo (128 bytes of
# mbarriers; ns buffers of the halo, imgs x (th + k - 1) x (tw + k - 1)
# pixels of cs elements rounded up to 128 bytes, then 128 g pixels of bn +
# 8, or 8, elements, rounded up to 128; the epilogue's 4*bn*(k*k*cb | 1)
# bytes inside a buffer where they fit)
HAND_K1 = [
    # the f32 gate: 4 images of 8 x 8, groups of 16, 1 stage streamed:
    # 1024 + 69632 (51200 halo + 18432 weights) + 2 * 69632 (split)
    ((8, 8, 8, 1024, 1024, 3, 4), (8, 8, 4, 16, 1, 1, False), 209920),
    # its bf16 on the wgmma route (csrc/conv_wgmma.cu: 1024 bytes of
    # mbarriers, two halo stages of 2 x 10 x 10 pixels of 128 bytes, 25600,
    # and ns weight boxes of 128 rows of 128 bytes, 16384): tiles of two
    # 8 x 8 images, groups of 128, 8 slices, 11 boxes: 1024 + 51200 +
    # 180224
    ((8, 8, 8, 1024, 1024, 3, 2), (8, 8, 2, 128, 8, 11, False), 232448),
    # serving's f32 gate split over 2 blocks: 1024 + 60416 (41984 halo +
    # 18432) + 2 * 60416 + 16384 of the cluster's sum
    ((1, 12, 15, 1024, 1024, 3, 4), (16, 16, 1, 16, 2, 1, False), 198656),
    # the bf16 head 256 -> 2 at k 1: 4 stages of 16384 halo, 8 passes of
    # 512 weight bytes resident (4096)
    ((8, 16, 16, 256, 2, 1, 2), (16, 16, 1, 8, 1, 4, True), 70656),
    # the f32 head's dx 2 -> 32 at k 1 on the one-image tile: 8 x 32
    # pixels of 12 floats and 8 rows of 40, (3072 + 320) * 4
    ((8, 128, 128, 2, 32, 1, 4), (32, 8, 1, 32, 1, 0, False), 13568),
]
HAND_B2 = [
    # the f32 512 -> 512 on 8 x 8: 2 images of 8 x 8, halo 2*10*10*40*4 =
    # 32000, g 128*40*4 = 20480, two buffers of 52480
    ((8, 8, 8, 512, 512, 3, 4), (8, 8, 2, 2), 105088),
    # its bf16 on the wgmma route (csrc/conv_wgmma.cu: 1024 bytes of
    # mbarriers, ns stages of the halo, 2 x 10 x 10 pixels of 128 bytes,
    # and a g box of 128 pixels of 128 bytes, then the epilogue's 64 rows
    # of 576 bfloat16 values and 16 bytes): 3 stages of 41984, 74752
    ((8, 8, 8, 512, 512, 3, 2), (8, 8, 2, 3), 201728),
    # the bf16 head 32 -> 2 at k 1: 4 buffers of 4*32*40*2 + 128*8*2
    ((8, 128, 128, 32, 2, 1, 2), (32, 4, 1, 4), 49280),
]


@pytest.mark.parametrize("case", HAND_K1 + HAND_B2)
def test_plan_bytes_match_the_kernels_layout(case):
    """The plan's shared-memory bytes at these plans are the byte counts
    worked out by hand from the kernels' layout code above, not from the
    plan's formulas."""
    (b, h, w, cin, cout, k, esize), fields, smem = case
    if len(fields) == 7:
        plan = k1_plan(b, h, w, cin, cout, k, esize, SMS)
        assert (plan.tw, plan.th, plan.imgs, plan.co, plan.slices, plan.ns,
                plan.resident) == fields
    else:
        plan = b2_plan(b, h, w, cin, cout, k, esize, SMS)
        assert (plan.tw, plan.th, plan.imgs, plan.ns) == fields
    assert plan.smem == smem


def test_deep_maps_fill_their_tiles():
    """The 8 x 8 maps fill K1's 256-pixel tile with four images (its
    bfloat16 wgmma route's 128-pixel tile with two) and B2's 128-pixel
    tile with two, and serving's 12 x 15 is one K1 tile (two of 16 x 8 on
    the wgmma route)."""
    for esize in ESIZES:
        k1 = k1_plan(8, 8, 8, 1024, 1024, 3, esize, SMS)
        assert (k1.tw, k1.th, k1.imgs, k1.tiles) == (
            (8, 8, 4, 2) if esize == 4 else (8, 8, 2, 4))
        b2 = b2_plan(8, 8, 8, 512, 512, 3, esize, SMS)
        assert (b2.tw, b2.th, b2.imgs, b2.ntiles) == (8, 8, 2, 4)
        serving = k1_plan(1, 12, 15, 1024, 1024, 3, esize, SMS)
        assert (serving.tiles, serving.tw) == ((1, 16) if esize == 4
                                               else (2, 16))


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_b2_plan_covers_every_output_and_pixel(shape, esize):
    """Every dw element lies in exactly one output tile, each output tile
    sums every pixel tile exactly once over its chunks, the pixel tiles
    (128 pixels, imgs images of th x tw) cover every pixel exactly once,
    and the blocks' walks split the items without overlap."""
    b, h, w, cin, cout, k = shape
    plan = b2_plan(b, h, w, cin, cout, k, esize, SMS)
    assert plan.imgs * plan.th * plan.tw == B2_PIX
    seen = np.zeros((cout, cin), np.int32)
    tiles_of = {}
    for i in range(plan.items):
        c0, co0, tiles = plan.item(i)
        assert len(tiles) >= 1
        seen[co0:co0 + plan.bn, c0:c0 + plan.cb] += 1
        tiles_of.setdefault((c0, co0), []).append(tiles)
    assert (seen == plan.chunks).all()
    for ranges in tiles_of.values():
        assert _partitions(ranges, plan.ntiles)
    px = np.zeros((b, h, w), np.int8)
    for t in range(plan.ntiles):
        b0, y0, x0 = plan.tile(t)
        px[b0:b0 + plan.imgs, y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    assert (px == 1).all()
    for n in sorted({1, 5, 2 * SMS, plan.items}):
        assert _partitions([plan.block_items(j, n) for j in range(n)],
                           plan.items)


# the gate whose K1 on the wgmma route leaves SMs idle, (B, H, W, Cin, Cout):
# serving's 1024 -> 512 at 2 tiles x 4 groups x 8 slices. Its slices are
# serving's 1024 -> 1024 gate's (the K order comes from the shape without
# Cout, for the model axis's bits). On the H100 16 slices, which give this
# gate 128 units, ran 1.13x faster here and 1.33x slower at 1024 -> 1024
# (PERF.md)
WG_K1_SHORT = {(1, 12, 15, 1024, 512): 64}


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_gate_shapes_fill_the_card(shape, esize):
    """At the recurrent gates' shapes B2's items are at least the card's
    132 SMs, and K1's work units (items, times the blocks of a cluster
    where K is split) at least 96 % of them, a split's in one round of the
    blocks the card holds at once. The gates' tile and group counts are
    powers of two, so K1 gives 128 units for 132 SMs where it does not
    split: on the H100 the 132-or-more plans there (groups of 8 where 16
    give 128 items, or a split over 3 blocks) measured 1.5-2x slower, and
    a split off serving's single-image maps would leave the one-process
    sum order (PERF.md).

    On the bfloat16 wgmma route (one block a SM) K1's slices come from
    the shape without Cout and are summed by a second launch, not in a
    cluster, so no round of co-resident blocks bounds them; serving's
    1024 -> 512 gate alone has fewer units (WG_K1_SHORT), its slices being
    those of serving's 1024 -> 1024 gate. B2's items there are its output
    tiles of 64 x 64 channels, split into pixel chunks only where the SMs
    outnumber them twice or more: a split of the gates' 128 output tiles
    (Cin 1024 x Cout 512 or 512 x 1024, 97 % of the SMs) puts twice the
    items in two rounds of one block a SM, plus the partials' sum, and ran
    1.6-2.4x slower (the plan's measured rule, PERF.md, ``kernel_timing.py
    plans``), so there the items are 96 % of the SMs or more."""
    b, h, w, cin, cout, k = shape
    b2 = b2_plan(b, h, w, cin, cout, k, esize, SMS)
    k1 = k1_plan(b, h, w, cin, cout, k, esize, SMS)
    units = k1.items * k1.slices
    if k1.wgmma and (b, h, w, cin, cout) in WG_K1_SHORT:
        assert units == WG_K1_SHORT[(b, h, w, cin, cout)], k1
    else:
        assert units >= 0.96 * SMS, k1
    if b2.wgmma:
        out_tiles = b2.cblocks * b2.coblocks
        assert b2.items >= SMS or (
            b2.chunks == 1 and 2 * out_tiles > SMS
            and out_tiles >= 0.96 * SMS), b2
    else:
        assert b2.items >= SMS
    if k1.slices > 1 and not k1.wgmma:
        cap = SMS * (2 if (esize == 2 or k == 1)
                     and k1.smem <= RING_HALF_SMEM else 1)
        assert b == 1 and units <= cap, k1


def test_plans_depend_on_the_shape_alone():
    """The same arguments give the same plan; another SM count may give
    another split, never another tile."""
    a = k1_plan(1, 12, 15, 1024, 512, 3, 4, SMS)
    assert a == k1_plan(1, 12, 15, 1024, 512, 3, 4, SMS)
    c = k1_plan(1, 12, 15, 1024, 512, 3, 4, 16)
    assert (c.tw, c.th, c.imgs) == (a.tw, a.th, a.imgs)
    assert b2_plan(8, 128, 128, 32, 32, 3, 4, 16).chunks < b2_plan(
        8, 128, 128, 32, 32, 3, 4, SMS).chunks


# PERF.md's deep rows of bfloat16 K1 and B2 (B, H, W, Cin, Cout), where the
# mma.sync mainloops ran 1.8-4.9x cuDNN's bf16 time
DEEP_ROWS = [(1, 12, 15, 1024, 1024), (8, 8, 8, 1024, 1024),
             (8, 8, 8, 1024, 512), (8, 16, 16, 1024, 256),
             (8, 8, 8, 512, 512)]


def _path_shapes():
    """(B, H, W, Cin, Cout, k) of every K1 and B2 shape chip_smoke.py holds
    at: the gates, the U-Nets' same convs in training and the heads."""
    rows = [(b, h, w, cin, cout, 3)
            for _, b, h, w, cin, cout in chip_smoke.GATE_SHAPES]
    rows += [(b, h, w, cin, cout, k)
             for b, h, w, cin, cout, k, _ in chip_smoke.B2_UNET]
    rows += [(1, h, w, cin, 2, 1) for h, w, cin in chip_smoke.UNET_K1]
    return list(dict.fromkeys(rows))


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", _path_shapes())
def test_wgmma_route_at_the_path_shapes(shape, esize):
    """bfloat16 K1 and B2 at the deep maps (k 3, 512 input channels or more
    in 64-channel blocks) run on the wgmma route, every deep row of
    PERF.md's tables among them; float32 never does, nor do the shallower
    maps, the decoders' 514 and 258 channels or the heads."""
    b, h, w, cin, cout, k = shape
    deep = esize == 2 and k == 3 and cin >= 512 and cin % 64 == 0
    assert k1_plan(b, h, w, cin, cout, k, esize, SMS).wgmma == deep
    assert b2_plan(b, h, w, cin, cout, k, esize, SMS).wgmma == deep
    if (b, h, w, cin, cout) in DEEP_ROWS:
        assert deep == (esize == 2)


@pytest.mark.parametrize("shape", DEEP_ROWS + [
    (8, 16, 16, 512, 1024), (1, 12, 15, 1024, 512), (3, 8, 8, 512, 200)])
def test_wgmma_k_order_does_not_depend_on_cout(shape):
    """K1's tiles, passes and their slices on the wgmma route come from the
    shape without Cout, and its groups are 128 channels: a model-axis
    shard of Cout / 2 or Cout / 4 (64 or more) runs the whole layer's
    units for its channels, in the same order, so its y is the whole
    layer's channels bitwise (the card tests hold it)."""
    b, h, w, cin, cout = shape
    whole = k1_plan(b, h, w, cin, cout, 3, 2, SMS)
    assert whole.wgmma
    for mp in (2, 4):
        if cout // mp < 64 or cout % (mp * 8):
            continue
        shard = k1_plan(b, h, w, cin, cout // mp, 3, 2, SMS)
        assert shard.wgmma and shard.co == whole.co == WG_K1_BN
        assert ((shard.tw, shard.th, shard.imgs, shard.tiles, shard.passes,
                 shard.slices, shard.ns) ==
                (whole.tw, whole.th, whole.imgs, whole.tiles, whole.passes,
                 whole.slices, whole.ns))
        for q in range(whole.slices):
            assert shard.block_passes(q) == whole.block_passes(q)
        # item i of the shard is item i of the whole layer where the
        # shard's groups end
        for i in range(shard.items):
            assert shard.item(i) == whole.item(i)


def test_shape_log_sees_every_k1_and_b2_launch(monkeypatch):
    """chip_smoke.py's ShapeLog logs each K1 and B2 launch with its shape.
    The operator evflow::conv2d_same holds K1's wrapper function itself
    (ops/native.py::define_op), so a log that replaced the module's
    wrapper saw no K1 launch and the profiled updates' K1 by shape read
    "not measured"; the log now hooks the wrapper's call of the plan. Run
    here on fake CUDA tensors through the function the operator holds,
    with a library whose entries return success and a card of 132 SMs;
    then at a bfloat16 deep map, whose K1 and B2 launch on the wgmma route
    (counted as such) and are logged with their plans."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from event_flow_tpu_torch.ops import conv, native

    class Card:
        def __getattr__(self, name):
            return lambda *args: 0

    held = conv._conv_kernel  # what evflow::conv2d_same runs on the card
    monkeypatch.setattr(native, "library", lambda: Card())
    monkeypatch.setattr(native, "stream_handle", lambda device: 0)
    monkeypatch.setattr(conv, "sm_count", lambda device: SMS)
    counts = dict(native.LAUNCHES)
    try:
        with FakeTensorMode():
            x = torch.zeros((2, 8, 8, 4), device="cuda")
            g = torch.zeros((2, 8, 8, 6), device="cuda")
            w = torch.zeros((6, 4, 3, 3), device="cuda")
            with chip_smoke.ShapeLog() as log:
                held(x, w)
                conv._dw(x, g, 3)
            bf = torch.bfloat16
            xd = torch.zeros((8, 8, 8, 512), device="cuda", dtype=bf)
            gd = torch.zeros((8, 8, 8, 256), device="cuda", dtype=bf)
            wd = torch.zeros((256, 512, 3, 3), device="cuda", dtype=bf)
            native.reset_launch_counts()
            with chip_smoke.ShapeLog() as deep:
                held(xd, wd)
                conv._dw(xd, gd, 3)
            wgmma = {k: n for k, n in native.LAUNCHES.items() if n}
    finally:
        native.LAUNCHES.update(counts)
    assert log.k1 == [(2, 8, 8, 4, 6, 3)]
    assert log.b2 == [(2, 8, 8, 4, 6, 3, 4)]
    assert conv.k1_plan is k1_plan and conv._conv_kernel is held
    assert deep.k1 == [(8, 8, 8, 512, 256, 3)]
    assert deep.b2 == [(8, 8, 8, 512, 256, 3, 2)]
    (cs, esize, plan), = deep.k1_plans
    assert (cs, esize, plan.wgmma) == (512, 2, True)
    assert wgmma == {"conv2d_same_wgmma_bf16": 1, "conv2d_dw_wgmma_bf16": 1}


# K2's calls (B, H, W, Cin, Crec, Cout, k), Crec 0 for ff: every shape
# chip_smoke.py holds K2 at on the card (K2_SHAPES: the spiking U-Net's
# cells at the training recipe and at serving, UNET_K2, LIFFireNet's at
# both; K2_EDGES: k 1 and 5, B not a multiple of a tile's images, Cout not
# a multiple of 4 or of the group, a map smaller than one tile), the
# model axis's Crec != Cout cells (TP_K2_SHAPES, TP_K2_EDGES: LIFFireNet
# and the U-Net's encoders at mp 2 and 4, odd maps, channel counts off
# 16-byte rows), and a 1 x 1 cell of 1026 channels
K2_SHAPES = list(dict.fromkeys(
    [(*shape, 3) for _, shape in chip_smoke.K2_SHAPES]
    + [tuple(e) for e in chip_smoke.K2_EDGES]
    + [(b, h, w, cin, crec, cout, 3)
       for _, (b, h, w, cin, cout, crec) in chip_smoke.TP_K2_SHAPES]
    + [(b, h, w, cin, crec, cout, k)
       for b, h, w, cin, cout, crec, k in chip_smoke.TP_K2_EDGES]
    + [(1, 6, 7, 1026, 0, 7, 1)]))


def _on_ring(b, h, w, cin, crec, cout, esize):
    """The route K2's plan takes: the ring, but for the one-image tile
    where x's or z_rec's pixel rows are not whole 16-byte rows and at one
    process's shallow, large calls (at most 4 passes, 32768 pixels or
    more, Cout a multiple of 32)."""
    shallow = (crec in (0, cout) and cout % 32 == 0
               and -(-cin // 32) + -(-crec // 32) <= 4 and b * h * w >= 32768)
    return (cin * esize) % 16 == 0 and (crec * esize) % 16 == 0 and (
        not shallow)


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_plan_covers_every_output_once(shape, esize):
    """K2's items cover every (b, y, x, co) of v' exactly once, tiles of
    256 pixels with a warp's 32 in one image, and the clusters' walks and a
    cluster's blocks split the items and the passes without overlap; the
    ring (_on_ring), else the one-image tile of one block per 8 x 32 tile
    and 32 output channels (8 where Cout <= 8)."""
    b, h, w, cin, crec, cout, k = shape
    plan = k2_plan(b, h, w, cin, crec, cout, k, esize, SMS)
    assert plan.ring == _on_ring(b, h, w, cin, crec, cout, esize)
    if not plan.ring:
        assert (plan.tw, plan.th, plan.imgs, plan.slices) == (32, 8, 1, 1)
        assert plan.co == (8 if cout <= 8 else 32)
    assert plan.imgs * plan.th * plan.tw == RING_TILE
    assert plan.th * plan.tw >= 32 and plan.tw in (8, 16, 32)
    assert plan.co in ((8,) if cout <= 8 else (8, 16, 32))
    seen = np.zeros((b, h, w, cout), np.int8)
    for i in range(plan.items):
        b0, y0, x0, co0 = plan.item(i)
        seen[b0:b0 + plan.imgs, y0:y0 + plan.th, x0:x0 + plan.tw,
             co0:co0 + plan.co] += 1
    assert (seen == 1).all()
    for n in sorted({1, 7, SMS, plan.items}):
        assert _partitions([plan.cluster_items(c, n) for c in range(n)],
                           plan.items)
    assert 1 <= plan.slices <= min(RING_MAX_SLICES, plan.passes)
    assert _partitions([plan.block_passes(q) for q in range(plan.slices)],
                       plan.passes)


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_plan_keeps_the_one_process_order(shape, esize):
    """K2's passes are x's 32-channel passes, then z_rec's, each padded to
    the MMA's k of 8: the one-process cell's order (x's segment, then the
    recurrent one, conv_tile.cuh::accumulate); where the plan claims
    bitwise (no split) one block walks them all in order. K is split only
    at serving's single images of 512 input channels or more."""
    b, h, w, cin, crec, cout, k = shape
    plan = k2_plan(b, h, w, cin, crec, cout, k, esize, SMS)
    assert plan.crec == crec and plan.x_passes == -(-cin // RING_CCH)
    assert plan.passes == plan.x_passes + -(-crec // RING_CCH)
    for seg, c, passes in (("x", cin, range(plan.x_passes)),
                           ("z_rec", crec, range(plan.x_passes,
                                                 plan.passes))):
        at = 0
        for p in passes:
            c0, c1, cpad = plan.pass_channels(p)
            assert (c0, c1) == (at, min(c, at + RING_CCH)), seg
            assert cpad == (c1 - c0 + 7) // 8 * 8
            at = c1
        assert at == c, seg
    assert plan.bitwise == (plan.slices == 1)
    assert plan.bitwise or (b == 1 and cin >= 512 and plan.ring), plan
    if plan.bitwise:
        assert list(plan.block_passes(0)) == list(range(plan.passes))


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_plans_fit_shared_memory(shape, esize):
    """Each K2 plan fits one block's 227 KB, in bfloat16 half an SM's
    wherever a group that runs two blocks a SM (K2_PAIRED_GROUPS) fits
    there; a ring of 1 to 2 (float32) or 4 stages; the plan's bytes are
    ring_smem's at its fields (the kernel's layout, held by hand below)."""
    b, h, w, cin, crec, cout, k = shape
    plan = k2_plan(b, h, w, cin, crec, cout, k, esize, SMS)
    assert plan.smem <= RING_MAX_SMEM
    if not plan.ring:
        return
    assert 1 <= plan.ns <= (2 if esize == 4 else 4)
    assert plan.smem == ring_smem(k, plan.co, esize, plan.tw, plan.imgs,
                                  plan.passes, plan.slices, plan.resident,
                                  plan.ns)
    if esize == 2 and plan.smem > RING_HALF_SMEM:
        # one block a SM: no group that pairs fits half an SM's
        assert all(ring_smem(k, co, esize, plan.tw, plan.imgs, plan.passes,
                             1, False, 1) > RING_HALF_SMEM
                   for co in K2_PAIRED_GROUPS if co <= max(8, cout))


# K2 plans and their bytes worked out by hand from conv_ring.cuh::layout
# (as HAND_K1 above): (B, H, W, Cin, Crec, Cout, k, esize), (tw, th, imgs,
# co, slices, ns, resident), bytes
HAND_K2 = [
    # the U-Net's 512 rec cell at 8 x 8 x 8 in f32: 4 images of 8 x 8,
    # groups of 8, 1 stage streamed: 1024 + 60416 (51200 halo + 9216
    # weights) + 2 * 60416 (split)
    ((8, 8, 8, 512, 512, 512, 3, 4), (8, 8, 4, 8, 1, 1, False), 182272),
    # its bf16: 3 stages of 25600 halo + 4608 weights (5120 rounded)
    ((8, 8, 8, 512, 512, 512, 3, 2), (8, 8, 4, 8, 1, 3, False), 93184),
    # the 128 rec cell at 8 x 32 x 32 in f32: 16 x 16, groups of 16, 1
    # stage streamed: 1024 + 60416 (41984, 18 x 18 x 128 rounded, + 18432
    # weights) + 2 * 41984 + 2 * 18432 (split)
    ((8, 32, 32, 128, 128, 128, 3, 4), (16, 16, 1, 16, 1, 1, False),
     182272),
    # serving's 64 rec cell in bf16: 8 x 32, groups of 16, 2 stages of
    # 22528 (34 x 10 x 64 rounded) and the 4 passes' weights resident, 4 *
    # 9 * 32 * 24 * 2
    ((1, 90, 120, 64, 64, 64, 3, 2), (8, 32, 1, 16, 1, 2, True), 101376),
    # serving's 512 ff cell in f32, split over 2 blocks: 1024 + 2 * 51200
    # (41984 halo + 9216) + 2 * 51200 + 8192 of the cluster's sum
    ((1, 12, 15, 512, 0, 512, 3, 4), (16, 16, 1, 8, 2, 2, False), 214016),
]


@pytest.mark.parametrize("case", HAND_K2)
def test_k2_plan_bytes_match_the_kernels_layout(case):
    (b, h, w, cin, crec, cout, k, esize), fields, smem = case
    plan = k2_plan(b, h, w, cin, crec, cout, k, esize, SMS)
    assert (plan.tw, plan.th, plan.imgs, plan.co, plan.slices, plan.ns,
            plan.resident) == fields
    assert plan.smem == smem


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("cin,crec", [(130, 0), (258, 0), (514, 0),
                                      (1026, 0), (2, 0), (32, 5), (6, 6)])
def test_k2_keeps_the_tile_off_16_byte_rows(cin, crec, esize):
    """Where x's or z_rec's pixel rows are not whole 16-byte rows (the
    U-Net decoders' 130 to 1026 channels, LIFFireNet's 2-channel input)
    K2 keeps the parent's one-image tile, its kernel and its bits."""
    plan = k2_plan(8, 32, 32, cin, crec, 32 if crec == 0 else crec, 3,
                   esize, SMS)
    assert not plan.ring and plan.ns == 0 and plan.bitwise
    assert plan.smem <= RING_MAX_SMEM


def test_k2_deep_maps_fill_their_tiles():
    """The U-Net's 8 x 8 cells fill K2's 256-pixel tile with four images;
    its 12 x 15 serving cells are one tile, split over a cluster."""
    for esize in ESIZES:
        for crec in (0, 512):
            p = k2_plan(8, 8, 8, 512, crec, 512, 3, esize, SMS)
            assert (p.tw, p.th, p.imgs, p.tiles, p.slices) == (8, 8, 4, 2, 1)
            s = k2_plan(1, 12, 15, 512, crec, 512, 3, esize, SMS)
            assert s.tiles == 1 and s.slices > 1
            assert s.items * s.slices <= SMS * (
                2 if esize == 2 and s.co in K2_PAIRED_GROUPS else 1)


@pytest.mark.parametrize("esize", ESIZES)
def test_k2_routes_at_the_path_shapes(esize):
    """The spiking U-Net's cells of 128 channels and more (training and
    serving) and its serving encoders, and every model-axis share, run on
    the ring; LIFFireNet's cells and the U-Net's first encoder in training
    (shallow, large: measured faster there, PERF.md) and the decoders
    (130-1026 channels) on the one-image tile."""
    tile = {("U-Net enc0", (8, 64, 64, 64, 64, 64))} | {
        (label, shape) for label, shape in chip_smoke.K2_SHAPES
        if label.startswith("LIFFireNet") or shape[3] % 16 == 2}
    for label, (b, h, w, cin, crec, cout) in chip_smoke.K2_SHAPES:
        plan = k2_plan(b, h, w, cin, crec, cout, 3, esize, SMS)
        assert plan.ring == ((label, (b, h, w, cin, crec, cout)) not in tile)
    for _, (b, h, w, cin, cout, crec) in chip_smoke.TP_K2_SHAPES:
        assert k2_plan(b, h, w, cin, crec, cout, 3, esize, SMS).ring


# The U-Net decoders' calls (B, H, W, Cin, Cout), RecEVFlowNet's K1 and the
# spiking U-Net's K2 feedforward cell, at serving and in training, and
# each plan's route at the pixel stride of the upsampling's padded view
# (ops/resize.py: whole 16-byte rows) by element size: (K1 slices, K2
# slices), 0 for the one-image tile. The ring everywhere but float32
# training's 258 and 130 channels (the tile measured faster there,
# conv_plan.py::_tile_fills); K split at serving's 1 x 90 x 120 (K1,
# float32) and 1 x 46 x 60 (bfloat16).
DECODER_ROUTES = {
    (1, 46, 60, 514, 128): {4: (1, 1), 2: (2, 2)},
    (1, 90, 120, 258, 64): {4: (2, 1), 2: (1, 1)},
    (1, 180, 240, 130, 32): {4: (1, 1), 2: (1, 1)},
    (8, 32, 32, 514, 128): {4: (1, 1), 2: (1, 1)},
    (8, 64, 64, 258, 64): {4: (0, 0), 2: (1, 1)},
    (8, 128, 128, 130, 32): {4: (0, 0), 2: (1, 1)},
}


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("case", sorted(DECODER_ROUTES))
def test_decoders_route_by_stride(case, esize):
    """The contiguous decoder map (pixel rows off 16-byte rows) keeps K1's
    and K2's one-image tile; at the padded stride each plan takes its
    route above, covers every output once, fits its shared memory (the
    ring's bytes ring_smem's, the tile's the one-image tile's), walks the
    passes in the one-process order and claims bitwise exactly where it
    does not split K. bfloat16 K2 takes groups of 32 there, one block a
    SM."""
    from event_flow_tpu_torch.ops.conv_plan import tile_smem
    from event_flow_tpu_torch.ops.native import channel_stride

    b, h, w, cin, cout = case
    cs = channel_stride(cin, esize)
    assert cs != cin and cs * esize % 16 == 0
    for slices, plan, flat in zip(
            DECODER_ROUTES[case][esize],
            (k1_plan(b, h, w, cin, cout, 3, esize, SMS, cs),
             k2_plan(b, h, w, cin, 0, cout, 3, esize, SMS, cs)),
            (k1_plan(b, h, w, cin, cout, 3, esize, SMS),
             k2_plan(b, h, w, cin, 0, cout, 3, esize, SMS))):
        assert not flat.ring and flat.bitwise
        assert plan.ring == (slices > 0), plan
        assert plan.slices == max(slices, 1) and plan.bitwise == (
            plan.slices == 1)
        assert plan.passes == -(-cin // RING_CCH)
        if plan.ring:
            assert plan.smem == ring_smem(3, plan.co, esize, plan.tw,
                                          plan.imgs, plan.passes,
                                          plan.slices, plan.resident,
                                          plan.ns) <= RING_MAX_SMEM
        else:
            assert plan.smem == tile_smem(3, plan.co, esize, cin)
        seen = np.zeros((b, h, w, cout), np.int8)
        for i in range(plan.items):
            b0, y0, x0, co0 = plan.item(i)
            seen[b0:b0 + plan.imgs, y0:y0 + plan.th, x0:x0 + plan.tw,
                 co0:co0 + plan.co] += 1
        assert (seen == 1).all()
        assert _partitions([plan.block_passes(q)
                            for q in range(plan.slices)], plan.passes)
    k2 = k2_plan(b, h, w, cin, 0, cout, 3, esize, SMS, cs)
    if esize == 2:
        assert k2.co == 32, k2


def test_stride_moves_only_the_padded_maps():
    """A plan at a stride equal to the channel count is the contiguous
    map's plan, and a pixel stride off 16-byte rows keeps the tile, as
    does a padded map at a pointer off 16 bytes."""
    for shape in ((8, 8, 8, 1024, 1024), (8, 32, 32, 514, 128),
                  (1, 46, 60, 514, 128)):
        b, h, w, cin, cout = shape
        for esize in ESIZES:
            assert k1_plan(b, h, w, cin, cout, 3, esize, SMS, cin) == \
                k1_plan(b, h, w, cin, cout, 3, esize, SMS)
            assert k2_plan(b, h, w, cin, 0, cout, 3, esize, SMS, cin) == \
                k2_plan(b, h, w, cin, 0, cout, 3, esize, SMS)
    assert not k1_plan(8, 32, 32, 514, 128, 3, 4, SMS, 515).ring
    assert not k2_plan(8, 32, 32, 514, 0, 128, 3, 2, SMS, 517).ring
    # a padded view at a pointer off 16 bytes: the tile, whose copies take
    # the stride (the ring's thread copies take contiguous maps only)
    assert not k1_plan(8, 32, 32, 514, 128, 3, 4, SMS, 516, False).ring
    assert not k2_plan(8, 32, 32, 514, 0, 128, 3, 2, SMS, 520, False).ring
    assert k1_plan(8, 8, 8, 512, 512, 3, 4, SMS, 0, False).ring
