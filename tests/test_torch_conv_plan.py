"""The work plans of K1 and B2 (ops/conv_plan.py) cover every output
element exactly once, keep K1's one-process sum order wherever they do
not split K, fit their shared memory, and give the card's SMs work at the
recurrent gates' shapes. Pure integer arithmetic on the CPU; the kernels
derive the same indices from the plan's integers (csrc/conv_ring.cuh,
csrc/conv_dw.cu) and the card tests hold them to their plain versions."""

import numpy as np
import pytest
import torch

from event_flow_tpu_torch.ops.conv_plan import (B2_PIX, RING_CCH,
                                                RING_HALF_SMEM,
                                                RING_MAX_SLICES,
                                                RING_MAX_SMEM, RING_TILE,
                                                b2_plan, k1_plan)

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
    (5, 8, 16, 48, 24, 3)]


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
    in one image; the clusters' walks split the items without overlap,
    and the blocks of a cluster its passes."""
    b, h, w, cin, cout, k = shape
    plan = k1_plan(b, h, w, cin, cout, k, esize, SMS)
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
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_plan_keeps_the_one_process_order(shape, esize):
    """Wherever the plan claims bitwise (no split of K), one block walks
    every pass of an item in order, passes of 32 input channels each padded
    to the MMA's k of 8 (conv_tile.cuh::pass_pad), as the one-process
    mainloop did; the taps run in order inside a pass in both mainloops."""
    b, h, w, cin, cout, k = shape
    plan = k1_plan(b, h, w, cin, cout, k, esize, SMS)
    assert plan.passes == -(-cin // RING_CCH)
    c = 0
    for p in range(plan.passes):
        c0, c1, cpad = plan.pass_channels(p)
        assert (c0, c1) == (c, min(cin, c + RING_CCH))
        assert cpad == (c1 - c0 + 7) // 8 * 8
        c = c1
    assert c == cin
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
    if k1.ring:
        assert 1 <= k1.ns <= (2 if esize == 4 else 4)
    else:
        assert (k1.tw, k1.th, k1.imgs, k1.slices) == (32, 8, 1, 1)
        assert k1.co == (8 if cout <= 8 else 32)
    b2 = b2_plan(b, h, w, cin, cout, k, esize, SMS)
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
    # its bf16: 2 stages of 25600 halo + 14336 weights (13824 rounded)
    ((8, 8, 8, 1024, 1024, 3, 2), (8, 8, 4, 16, 1, 2, False), 80896),
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
    """The 8 x 8 maps fill K1's 256-pixel tile with four images and B2's
    128-pixel tile with two, and serving's 12 x 15 is one K1 tile."""
    for esize in ESIZES:
        k1 = k1_plan(8, 8, 8, 1024, 1024, 3, esize, SMS)
        assert (k1.tw, k1.th, k1.imgs, k1.tiles) == (8, 8, 4, 2)
        b2 = b2_plan(8, 8, 8, 512, 512, 3, esize, SMS)
        assert (b2.tw, b2.th, b2.imgs, b2.ntiles) == (8, 8, 2, 4)
        assert k1_plan(1, 12, 15, 1024, 1024, 3, esize, SMS).tiles == 1


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
    sum order (PERF.md)."""
    b, h, w, cin, cout, k = shape
    assert b2_plan(b, h, w, cin, cout, k, esize, SMS).items >= SMS
    k1 = k1_plan(b, h, w, cin, cout, k, esize, SMS)
    units = k1.items * k1.slices
    assert units >= 0.96 * SMS, k1
    if k1.slices > 1:
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


def test_shape_log_sees_every_k1_and_b2_launch(monkeypatch):
    """chip_smoke.py's ShapeLog logs each K1 and B2 launch with its shape.
    The operator evflow::conv2d_same holds K1's wrapper function itself
    (ops/native.py::define_op), so a log that replaced the module's
    wrapper saw no K1 launch and the profiled updates' K1 by shape read
    "not measured"; the log now hooks the wrapper's call of the plan. Run
    here on fake CUDA tensors through the function the operator holds,
    with a library whose entries return success and a card of 132 SMs."""
    import chip_smoke
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
    finally:
        native.LAUNCHES.update(counts)
    assert log.k1 == [(2, 8, 8, 4, 6, 3)]
    assert log.b2 == [(2, 8, 8, 4, 6, 3, 4)]
    assert conv.k1_plan is k1_plan and conv._conv_kernel is held
