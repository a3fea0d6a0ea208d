"""The work plan of the int8 conv kernels (ops/s8_plan.py) covers every
output pixel and channel once, and every pass of the K dimension once per
item, at every shape chip_smoke.py holds the kernels at (K1_S8, K2_S8,
the spiking U-Net's int8 window, the plan's edge shapes), for cards of
132, 16 and 1 SMs and any number of resident clusters. The kernel
(csrc/conv_s8.cuh) derives the same indices from the plan's tile width
and slice count; its results are held bitwise on the card
(tests/test_torch_cuda.py, chip_smoke.py [int8])."""

import sys
from pathlib import Path

import numpy as np
import pytest

from event_flow_tpu_torch.ops.s8_plan import (S8_CCH, S8_MAX_SLICES,
                                              S8_TILE, s8_plan)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (needs the sys.path insert)

# (B, H, W, Cin, Crec, Cout)
SHAPES = sorted(set(
    [(b, h, w, cin, 0, cout) for b, h, w, cin, cout, _, _ in chip_smoke.K1_S8]
    + [(b, h, w, cin, cout if rec else 0, cout)
       for b, h, w, cin, cout, rec in chip_smoke.K2_S8]
    + [(1, h, w, cin, cout if rec else 0, cout)
       for h, w, cin, cout, rec in chip_smoke.UNET_K2]
    + [(1, h, w, cin, 0, 2) for h, w, cin in chip_smoke.UNET_K1]
    + [(b, h, w, cin, cout if rec else 0, cout)
       for b, h, w, cin, cout, _, rec in chip_smoke.S8_EDGES]
    + [(b, h, w, cin, 0, cout)
       for b, h, w, cin, cout, _, _ in chip_smoke.S8_EDGES]))


@pytest.mark.parametrize("sms", [132, 16, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_output_once(shape, sms):
    b, h, w, cin, crec, cout = shape
    plan = s8_plan(b, h, w, cin, crec, cout, sms)
    assert plan.tw * plan.th == S8_TILE
    assert 1 <= plan.slices <= min(S8_MAX_SLICES, plan.passes)
    assert plan.passes == -(-cin // S8_CCH) + -(-crec // S8_CCH)
    if plan.items >= sms:
        assert plan.slices == 1  # enough items: no split
    for n in sorted({1, min(plan.items, sms), plan.items}):
        hits = np.zeros((b, h, w, cout), np.int32)
        seen = []
        for c in range(n):
            items = plan.cluster_items(c, n)
            assert len(items) >= 1  # no cluster idles
            seen += list(items)
            for i in items:
                b0, y0, x0, co0 = plan.item(i)
                assert y0 < h and x0 < w and co0 < cout
                hits[b0, y0:y0 + plan.th, x0:x0 + plan.tw,
                     co0:co0 + plan.co] += 1
        assert seen == list(range(plan.items))
        assert (hits == 1).all()
    passes = [p for q in range(plan.slices) for p in plan.block_passes(q)]
    assert passes == list(range(plan.passes))
    assert all(len(plan.block_passes(q)) >= 1 for q in range(plan.slices))


def test_tile_width_follows_the_map():
    """The widest tile that leaves the fewest tiles: 16 x 16 at the ECD
    maps (180 tiles, 184 of 8 x 32) and at 12 x 15 (one tile, where 8 x
    32 takes two); a split over 4 blocks at the U-Net's deepest cell,
    none at the ECD cells."""
    ecd = s8_plan(1, 180, 240, 32, 32, 32, 132)
    assert (ecd.tw, ecd.tiles, ecd.slices) == (16, 180, 1)
    deep = s8_plan(1, 12, 15, 512, 512, 512, 132)
    assert (deep.tw, deep.tiles, deep.groups, deep.slices) == (16, 1, 16, 4)
    assert s8_plan(1, 46, 60, 258, 0, 64, 132).tw == 32
