"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes, the backward on the card against the CPU, and the
repeatability of the training update. Needs a CUDA card and nvcc; skips
elsewhere.

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances as in tests/test_torch_kernels_plain.py: f32 atol 1e-5,
spikes equal except where |v' - thresh| < 1e-4, counts bitwise equal;
K3's sums within rtol 1e-5 of the float64 sum (its fixed-point sum is
exact but for some 1e-14 and is rounded once).
Sums over all pixels (the weight gradient, the per-channel leak and
threshold gradients) are held relative to their largest magnitude,
1e-5: f32 sums of up to a few thousand products taken in another order.
K1 and K2 multiply on the tensor cores in 3xTF32; the dense randn inputs
below have nonzero low TF32 bits, so a kernel taking one TF32 pass fails
them (tests/test_torch_precision.py gives the error of both on the CPU).
"""

import copy

import pytest
import torch

from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.ops.conv import (conv2d_dw_kernel, conv2d_dw_plain,
                                           conv2d_same, conv2d_same_plain,
                                           conv2d_strided)
from event_flow_tpu_torch.ops.conv_plan import (b2_plan, k1_plan, k2_plan,
                                                wgmma_route)
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                fused_conv_lif_plain,
                                                fused_conv_lif_rec,
                                                fused_conv_lif_rec_plain,
                                                fused_lif_bwd_kernel,
                                                fused_lif_bwd_plain)
from event_flow_tpu_torch.ops.s8_plan import sm_count
from event_flow_tpu_torch.ops.scatter import (scatter_add, scatter_add_kernel,
                                              scatter_add_plain)

SUM_RTOL = 1e-5
SCATTER_RTOL = 1e-5

pytestmark = pytest.mark.cuda

ATOL = 1e-5
NEAR = 1e-4


@pytest.fixture
def dev():
    """The card, with PyTorch's TF32 flags left at their defaults, as a
    user runs the port: every plain version sets its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("shape,k,cout,inputs", [
    # ragged: Cin 5 / 7 (4-byte staging), Cout 3 / 9 / 40, H and W off the
    # 8 x 32 tile, k 5
    ((2, 18, 30, 5), 1, 3, "randn"), ((1, 18, 30, 32), 3, 40, "randn"),
    ((2, 9, 13, 7), 5, 9, "randn"), ((1, 180, 240, 32), 1, 2, "randn"),
    # the serving 3x3 and the training shapes: dx 32 -> 32 k 3, the head
    # 32 -> 2 k 1 and its dx 2 -> 32 k 1; spikes x snn-init weights and
    # dense randn, whose low TF32 bits are nonzero (one TF32 pass fails)
    ((1, 180, 240, 32), 3, 32, "spikes"), ((1, 180, 240, 32), 3, 32, "randn"),
    ((8, 128, 128, 32), 3, 32, "spikes"), ((8, 128, 128, 32), 3, 32, "randn"),
    ((8, 128, 128, 32), 1, 2, "randn"), ((8, 128, 128, 2), 1, 32, "randn")])
def test_conv_kernel_matches_plain(dev, shape, k, cout, inputs):
    g = _gen()
    if inputs == "spikes":
        x = (torch.rand(shape, generator=g) < 0.1).float().to(dev)
        bound = (1 / shape[-1]) ** 0.5
        w = ((torch.rand((cout, shape[-1], k, k), generator=g) * 2 - 1)
             * bound).to(dev)
    else:
        x = torch.randn(shape, generator=g).to(dev)
        w = (0.2 * torch.randn((cout, shape[-1], k, k), generator=g)).to(dev)
    before = native.LAUNCHES["conv2d_same"]
    y = conv2d_same(x, w)
    assert native.LAUNCHES["conv2d_same"] == before + 1
    torch.testing.assert_close(y, conv2d_same_plain(x, w), atol=ATOL,
                               rtol=1e-5)


def _cell_inputs(case, k, rec, dev):
    """(x, w, w_rec, v, z, leak, thresh) of one cell: "small" ragged (Cin
    5, Cout 12), "counts" (the head: Cin 2 event counts, Cout 32) and
    "wide" (Cin 32 spikes at 64 x 64); v spread around the threshold, z at
    about 10 %."""
    g = _gen()
    b, h, w, cin, c = {"small": (2, 18, 30, 5, 12), "counts": (2, 18, 30, 2, 32),
                       "wide": (2, 64, 64, 32, 32)}[case]
    if case == "counts":
        x = torch.poisson(torch.full((b, h, w, cin), 0.3), generator=g)
    else:
        x = (torch.rand((b, h, w, cin), generator=g) < 0.3).float()
    if case == "small":
        wt = 0.3 * torch.randn((c, cin, k, k), generator=g)
        wr = 0.3 * torch.randn((c, c, k, k), generator=g)
    else:  # snn init, U(+-sqrt(1 / fan-in channels))
        wt = (torch.rand((c, cin, k, k), generator=g) * 2 - 1) * cin ** -0.5
        wr = (torch.rand((c, c, k, k), generator=g) * 2 - 1) * c ** -0.5
    thresh = 0.8 + 0.1 * torch.randn(c, generator=g)
    leak = torch.sigmoid(torch.randn(c, generator=g))
    v = thresh + 0.3 * torch.randn((b, h, w, c), generator=g)
    z = (torch.rand((b, h, w, c), generator=g) < 0.1).float()
    return [t.to(dev) for t in (x, wt, wr if rec else None, v, z, leak,
                                thresh) if t is not None]


@pytest.mark.parametrize("case", ["small", "counts", "wide"])
@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_fused_lif_kernel_matches_plain(dev, rec, hard, k, case):
    with torch.no_grad():
        if rec:
            x, wt, wr, v, z, leak, thresh = _cell_inputs(case, k, rec, dev)
            vk, zk = fused_conv_lif_rec(x, wt, wr, v, z, z, leak, thresh, k,
                                        hard)
            vp, zp = fused_conv_lif_rec_plain(x, wt, wr, v, z, z, leak,
                                              thresh, k, hard)
        else:
            x, wt, v, z, leak, thresh = _cell_inputs(case, k, rec, dev)
            vk, zk = fused_conv_lif(x, wt, v, z, leak, thresh, k, hard)
            vp, zp = fused_conv_lif_plain(x, wt, v, z, leak, thresh, k, hard)
    torch.testing.assert_close(vk, vp, atol=ATOL, rtol=0)
    flips = zk != zp
    near = (vp - thresh).abs() < NEAR
    assert not (flips & ~near).any()
    assert float(flips.float().mean()) <= 1e-3
    assert 0.0 < float(zp.mean()) < 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout,crec,k", [(16, 32, 3), (12, 5, 3), (4, 8, 1),
                                         (8, 40, 5)])
def test_fused_lif_rec_kernel_with_crec(dev, cout, crec, k, dtype):
    """K2 rec with a recurrent input of Crec channels and Cout outputs, a
    cell's share under a mesh's model axis (LIFFireNet's 16 of 32 at mp
    2), against its plain version: v' within ATOL (bfloat16: one ulp of
    it), spikes equal but near the threshold, twice bitwise."""
    g = _gen()
    b, h, w, cin = 2, 18, 30, 6
    x = (torch.rand((b, h, w, cin), generator=g) < 0.3).float()
    zr = (torch.rand((b, h, w, crec), generator=g) < 0.2).float()
    wt = (torch.rand((cout, cin, k, k), generator=g) * 2 - 1) * cin ** -0.5
    wr = (torch.rand((cout, crec, k, k), generator=g) * 2 - 1) * crec ** -0.5
    thresh = 0.5 + 0.1 * torch.randn(cout, generator=g)
    leak = torch.sigmoid(torch.randn(cout, generator=g))
    v = thresh + 0.3 * torch.randn((b, h, w, cout), generator=g)
    z = (torch.rand((b, h, w, cout), generator=g) < 0.1).float()
    x, zr, wt, wr, v, z = (t.to(dev, dtype) for t in (x, zr, wt, wr, v, z))
    leak, thresh = leak.to(dev), thresh.to(dev)
    with torch.no_grad():
        run = lambda: fused_conv_lif_rec(x, wt, wr, v, z, zr, leak, thresh,
                                         k, True)
        vk, zk = run()
        vp, zp = fused_conv_lif_rec_plain(x, wt, wr, v, z, zr, leak, thresh,
                                          k, True)
        assert all(map(torch.equal, (vk, zk), run()))
    name = native.variant("fused_conv_lif_rec", dtype)
    if dtype == torch.bfloat16:
        assert not native.beyond_bf16_ulp(vk, vp, ATOL).any()
    else:
        torch.testing.assert_close(vk, vp, atol=ATOL, rtol=0)
    flips = zk != zp
    near = (vp.float() - thresh).abs() < NEAR + 1e-2 * (dtype != torch.float32)
    assert not (flips & ~near).any(), name
    assert 0.0 < float(zp.float().mean()) < 1.0


# K2 rec with Crec != Cout on its persistent mainloop (csrc/conv_ring.cuh):
# (B, H, W, Cin, Cout, Crec, k) of LIFFireNet's cells at mp 2 and 4, the
# spiking U-Net's four recurrent encoder cells at mp 2 and 4, and the
# mainloop's edges: odd H and W at B 2, a map smaller than one tile, more
# items than resident blocks, pixel rows that are not whole 16-byte rows
# (no TMA) at k 1, channel counts that are not multiples of 32
_MODEL_AXIS_CELLS = [
    (8, 128, 128, 32, 16, 32, 3), (8, 128, 128, 32, 8, 32, 3),
    (8, 64, 64, 64, 32, 64, 3), (8, 32, 32, 128, 64, 128, 3),
    (8, 16, 16, 256, 128, 256, 3), (8, 8, 8, 512, 256, 512, 3),
    (8, 64, 64, 64, 16, 64, 3), (8, 32, 32, 128, 32, 128, 3),
    (8, 16, 16, 256, 64, 256, 3), (8, 8, 8, 512, 128, 512, 3),
    (2, 37, 45, 32, 16, 32, 3), (1, 5, 6, 32, 16, 32, 3),
    (8, 160, 192, 32, 16, 32, 3), (2, 13, 11, 6, 12, 5, 1),
    (2, 9, 7, 6, 4, 8, 1), (2, 19, 23, 40, 24, 48, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("shape", _MODEL_AXIS_CELLS)
def test_fused_lif_rec_kernel_model_axis(dev, shape, hard, dtype):
    """K2 rec with a rank's Cout of a cell's Crec channels (x and the
    recurrent input over all of them) against its plain version (v' within
    ATOL, bfloat16 one ulp of it; spikes equal but near the threshold),
    twice bitwise, and bitwise one process's whole cell sliced to the
    rank's channels, for the first and last rank; where Crec is not a
    multiple of Cout, a cell of its own against its plain version."""
    b, h, w, cin, cout, crec, k = shape
    whole = crec % cout == 0
    c = crec if whole else cout
    g = _gen()
    x = (torch.rand((b, h, w, cin), generator=g) < 0.1).float()
    zr = (torch.rand((b, h, w, crec), generator=g) < 0.1).float()
    wt = (torch.rand((c, cin, k, k), generator=g) * 2 - 1) * cin ** -0.5
    wr = (torch.rand((c, crec, k, k), generator=g) * 2 - 1) * crec ** -0.5
    thresh = 0.8 + 0.1 * torch.randn(c, generator=g)
    leak = torch.sigmoid(-4 + 0.1 * torch.randn(c, generator=g))
    v = thresh + 0.3 * torch.randn((b, h, w, c), generator=g)
    z = zr if whole else (torch.rand((b, h, w, c), generator=g) < 0.1).float()
    x, zr, wt, wr, v, z = (t.to(dev, dtype) for t in (x, zr, wt, wr, v, z))
    leak, thresh = leak.to(dev), thresh.to(dev)
    with torch.no_grad():
        cell = (fused_conv_lif_rec(x, wt, wr, v, z, zr, leak, thresh, k, hard)
                if whole else None)
        for rank in ((0, crec // cout - 1) if whole else (0,)):
            part = slice(rank * cout, (rank + 1) * cout)
            args = [t.contiguous() for t in (wt[part], wr[part], v[..., part],
                                             z[..., part])]
            lt = (leak[part].contiguous(), thresh[part].contiguous())
            run = lambda: fused_conv_lif_rec(x, *args, zr, *lt, k, hard)
            vk, zk = run()
            vp, zp = fused_conv_lif_rec_plain(x, *args, zr, *lt, k, hard)
            assert all(map(torch.equal, (vk, zk), run()))
            if whole:
                assert torch.equal(vk, cell[0][..., part])
                assert torch.equal(zk, cell[1][..., part])
            if dtype == torch.bfloat16:
                assert not native.beyond_bf16_ulp(vk, vp, ATOL).any()
            else:
                torch.testing.assert_close(vk, vp, atol=ATOL, rtol=0)
            flips = zk != zp
            near = ((vp.float() - lt[1]).abs()
                    < NEAR + 1e-2 * (dtype != torch.float32))
            assert not (flips & ~near).any()


def test_conv_and_cell_kernels_bitwise_repeatable(dev):
    """K1 and K2 (feedforward and recurrent) run twice on the same inputs
    give the same bits: no split-K, no atomics."""
    g = _gen()
    x = torch.randn((2, 40, 70, 32), generator=g).to(dev)
    w = (0.2 * torch.randn((32, 32, 3, 3), generator=g)).to(dev)
    assert torch.equal(conv2d_same(x, w), conv2d_same(x, w))
    with torch.no_grad():
        for rec in (False, True):
            x, wt, *rest = _cell_inputs("wide", 3, rec, dev)
            if rec:
                wr, v, z, leak, thresh = rest
                run = lambda: fused_conv_lif_rec(x, wt, wr, v, z, z, leak,
                                                 thresh, 3, True)
            else:
                v, z, leak, thresh = rest
                run = lambda: fused_conv_lif(x, wt, v, z, leak, thresh, 3,
                                             True)
            (v1, z1), (v2, z2) = run(), run()
            assert torch.equal(v1, v2) and torch.equal(z1, z2)


# SpikingRecEVFlowNet at the ECD recipe (1 x 180 x 240, base 32): every K2
# call of a window as (H, W, Cin, Cout, recurrent) and every K1 head as
# (H, W, Cin); Cin 1026, 514, 258 and 130 leave a last pass of 2 channels
# and take the 4-byte staging, widths 15 and 30 are under one pixel tile
UNET_K2 = [(90, 120, 64, 64, True), (45, 60, 128, 128, True),
           (23, 30, 256, 256, True), (12, 15, 512, 512, True),
           (12, 15, 512, 512, False), (24, 30, 1024, 256, False),
           (46, 60, 514, 128, False), (90, 120, 258, 64, False),
           (180, 240, 130, 32, False)]
UNET_K1 = [(24, 30, 256), (46, 60, 128), (90, 120, 64), (180, 240, 32)]


def _unet_x(shape, inputs, g):
    """Spikes at 10 %, or dense randn at 0.15: against snn-init weights a
    current of about 0.5 or 0.25, as in the model. The randn low TF32 bits
    are nonzero, so one TF32 pass fails ATOL, while the f32 rounding of a
    sum of up to 9234 products, on either side, stays under it."""
    if inputs == "spikes":
        return (torch.rand(shape, generator=g) < 0.1).float()
    return 0.15 * torch.randn(shape, generator=g)


@pytest.mark.parametrize("inputs", ["spikes", "randn"])
@pytest.mark.parametrize("h,w,cin,c,rec", UNET_K2)
def test_fused_lif_kernel_at_unet_shapes(dev, h, w, cin, c, rec, inputs):
    g = _gen()
    x = _unet_x((1, h, w, cin), inputs, g).to(dev)
    wt = ((torch.rand((c, cin, 3, 3), generator=g) * 2 - 1)
          * cin ** -0.5).to(dev)
    wr = ((torch.rand((c, c, 3, 3), generator=g) * 2 - 1) * c ** -0.5).to(dev)
    thresh = (0.8 + 0.1 * torch.randn(c, generator=g)).to(dev)
    leak = torch.sigmoid(-4 + 0.1 * torch.randn(c, generator=g)).to(dev)
    v = thresh + 0.3 * torch.randn((1, h, w, c), generator=g).to(dev)
    z = (torch.rand((1, h, w, c), generator=g) < 0.1).float().to(dev)
    with torch.no_grad():
        if rec:
            run = lambda: fused_conv_lif_rec(x, wt, wr, v, z, z, leak,
                                             thresh, 3, True)
            vp, zp = fused_conv_lif_rec_plain(x, wt, wr, v, z, z, leak,
                                              thresh, 3, True)
        else:
            run = lambda: fused_conv_lif(x, wt, v, z, leak, thresh, 3, True)
            vp, zp = fused_conv_lif_plain(x, wt, v, z, leak, thresh, 3, True)
        vk, zk = run()
        v2, z2 = run()
    torch.testing.assert_close(vk, vp, atol=ATOL, rtol=0)
    flips = zk != zp
    assert not (flips & ~((vp - thresh).abs() < NEAR)).any()
    assert float(flips.float().mean()) <= 1e-3
    assert torch.equal(vk, v2) and torch.equal(zk, z2)


@pytest.mark.parametrize("inputs", ["spikes", "randn"])
@pytest.mark.parametrize("h,w,cin", UNET_K1)
def test_conv_kernel_at_unet_heads(dev, h, w, cin, inputs):
    g = _gen()
    x = _unet_x((1, h, w, cin), inputs, g).to(dev)
    wt = ((torch.rand((2, cin, 1, 1), generator=g) * 2 - 1) * 0.01).to(dev)
    y = conv2d_same(x, wt)
    torch.testing.assert_close(y, conv2d_same_plain(x, wt), atol=ATOL,
                               rtol=1e-5)
    assert torch.equal(y, conv2d_same(x, wt))


def test_unet_window_card_vs_cpu(dev):
    """One window of SpikingRecEVFlowNet at the ECD recipe from the same
    seeded init on the card and on the CPU. A near-threshold spike flip
    moves the cells after it by a weight, so past the first cell the
    comparison is by share: at most 0.1 % of each cell's spikes flip, and
    the full-resolution flow stays within 1e-4 on average."""
    from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET
    from event_flow_tpu_torch.eval.harness import cell_states
    from event_flow_tpu_torch.models.registry import build_model

    cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
    g = _gen()
    cnt = torch.poisson(torch.full((1, 180, 240, 2), 0.2), generator=g)
    outs = {}
    for d in (torch.device("cpu"), dev):
        model = build_model(cfg, d, seed=0)
        native.reset_launch_counts()
        with torch.no_grad():
            out, state = model(cnt.to(d), cnt.to(d),
                               model.zero_state(1, 180, 240, d))
        want = ({"fused_conv_lif": 8, "fused_conv_lif_rec": 4,
                 "conv2d_same": 4} if d.type == "cuda" else {})
        assert {k: n for k, n in native.LAUNCHES.items() if n} == want
        outs[d.type] = ([f.cpu() for f in out["flow"]],
                        [tuple(t.cpu() for t in s) for s in
                         cell_states(state)])
    (fk, sk), (fc, sc) = outs["cuda"], outs["cpu"]
    for (_, zk), (_, zc) in zip(sk, sc):
        assert float((zk != zc).float().mean()) <= 1e-3
    assert all(torch.isfinite(f).all() for f in fk)
    assert float((fk[-1] - fc[-1]).abs().mean()) <= 1e-4


def test_scatter_kernel_matches_plain(dev):
    g = _gen()
    size = 500
    idx = torch.randint(-3, size + 3, (2, 4000), generator=g)
    idx[:, :500] = 11  # duplicates
    counts = (torch.rand((2, 4000, 2), generator=g) < 0.5).float()
    vals = torch.cat([counts, torch.rand((2, 4000, 2), generator=g)], -1)
    got = scatter_add(idx.to(dev), vals.to(dev), size)
    ref = scatter_add_plain(idx, vals, size).to(dev)
    assert torch.equal(got[..., :2], ref[..., :2])
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=1e-5)


def test_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(1, 4, 4, 2, device=dev)
    with pytest.raises(TypeError):
        conv2d_same(x.double(), torch.zeros(2, 2, 3, 3, device=dev,
                                            dtype=torch.float64))
    with pytest.raises(ValueError):
        conv2d_same(x, torch.zeros(2, 2, 3, 3))  # weights on the CPU
    with pytest.raises(ValueError):
        conv2d_same(x, torch.zeros(2, 2, 4, 4, device=dev))  # even k


def assert_close_to_max(got, ref, rtol=SUM_RTOL):
    err = float((got - ref).abs().max())
    assert err <= rtol * float(ref.abs().max()), err


@pytest.mark.parametrize("shape,k,cout,inputs", [
    # ragged: Cin 5 / 7 (4-byte staging), Cout 3 / 9 / 40, H and W off the
    # pixel tile, k 1 / 3 / 5, dense randn x (three products)
    ((2, 18, 30, 5), 1, 3, "randn"), ((1, 18, 30, 32), 3, 40, "randn"),
    ((2, 9, 13, 7), 5, 9, "randn"), ((2, 20, 36, 2), 3, 32, "randn"),
    ((1, 16, 33, 32), 1, 2, "randn"),
    # the design's edges: Cin 130 and 1026 (several 32-channel blocks, a
    # last one of 2, 8-byte staging), Cout 64 and 256 (several output
    # column blocks), 12 x 15 and 8 x 8 images under one pixel tile, the
    # k 5 and k 1 paths at Cout 2 and 64; spike x (two products per tile)
    # and the U-Net decoders' spikes with 2 dense flow channels
    ((2, 12, 15, 130), 3, 64, "spikes"), ((1, 8, 8, 1026), 3, 256, "spikes"),
    ((2, 12, 15, 1026), 1, 2, "flow"), ((2, 16, 16, 2), 5, 2, "counts"),
    ((3, 8, 8, 64), 5, 64, "randn"), ((1, 17, 40, 258), 3, 64, "flow")])
def test_conv_dw_kernel_matches_plain(dev, shape, k, cout, inputs):
    g = _gen()
    if inputs == "randn":
        x = torch.randn(shape, generator=g)
    elif inputs == "counts":
        x = torch.poisson(torch.full(shape, 0.3), generator=g)
    else:
        x = (torch.rand(shape, generator=g) < 0.1).float()
        if inputs == "flow":
            x[..., -2:] = torch.randn(shape[:3] + (2,), generator=g)
    x = x.to(dev)
    gy = torch.randn(shape[:3] + (cout,), generator=g).to(dev)
    before = native.LAUNCHES["conv2d_dw"]
    dw = conv2d_dw_kernel(x, gy, k)
    assert native.LAUNCHES["conv2d_dw"] == before + 1
    assert dw.shape == (cout, shape[-1], k, k)
    assert_close_to_max(dw, conv2d_dw_plain(x, gy, k))
    assert torch.equal(dw, conv2d_dw_kernel(x, gy, k))  # repeatable


def _b4_args(dev, shape, dtype=torch.float32, activation="arctanspike",
             hard=True, offset=0):
    """B4's arguments on the card: maps of ``dtype``, each a contiguous
    view ``offset`` elements into its storage, and float32 leak and
    thresh, all from one seeded generator."""
    g = _gen()
    c = shape[-1]
    width = {"mgspike": 0.5, "trianglespike": 1.0}.get(activation, 10.0)
    thresh = 0.8 + 0.1 * torch.randn(c, generator=g)
    leak = torch.sigmoid(torch.randn(c, generator=g))

    def card(t):
        buf = torch.empty(t.numel() + offset, dtype=dtype, device=dev)
        buf[offset:] = t.reshape(-1).to(dev, dtype)
        return buf[offset:].view(shape)

    v = card(thresh + 0.3 * torch.randn(shape, generator=g))
    z = card((torch.rand(shape, generator=g) < 0.1).float())
    v_out = card(thresh + 0.3 * torch.randn(shape, generator=g))
    g_v = card(torch.randn(shape, generator=g))
    g_z = card(torch.randn(shape, generator=g))
    return (v, z, v_out, leak.to(dev), thresh.to(dev), g_v, g_z, hard,
            activation, width)


def _hold_b4(args):
    """B4 against its plain version: one launch of the variant of the
    maps' type; g_cur and g_vin within ATOL (bfloat16: one ulp), the
    float32 sums within SUM_RTOL of their largest magnitude; twice
    bitwise equal."""
    name = native.variant("fused_lif_bwd", args[0].dtype)
    before = native.LAUNCHES[name]
    got = fused_lif_bwd_kernel(*args)
    assert native.LAUNCHES[name] == before + 1
    ref = fused_lif_bwd_plain(*args)
    for a, r in zip(got[:2], ref[:2]):
        if a.dtype == torch.bfloat16:
            _bf16_close(a, r, 1e-7)
        else:
            torch.testing.assert_close(a, r, atol=ATOL, rtol=1e-5)
    for a, r in zip(got[2:], ref[2:]):
        assert a.dtype == torch.float32 and a.shape == (args[0].shape[-1],)
        assert_close_to_max(a, r)
    again = fused_lif_bwd_kernel(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["arctanspike", "superspike",
                                        "trianglespike", "mgspike"])
@pytest.mark.parametrize("hard", [True, False])
def test_fused_lif_bwd_kernel_matches_plain(dev, activation, hard, dtype):
    _hold_b4(_b4_args(dev, (2, 9, 13, 12), dtype, activation, hard))


# B4's chunks (csrc/fused_lif_bwd.cu): whole pixels of a row segment (the
# row, or 128 bytes of it where the row holds 512 bytes or more), 8 KB a
# map at most, fewer pixels where that leaves under 256 chunks. At C = 32
# a chunk is 64 float32 or 128 bfloat16 pixels from 256 chunks on, so 256
# chunks less or more one pixel end in a chunk one pixel short or one
# pixel long; at C = 2048 (64 or 32 segments) 256 or 512 pixels less or
# more one end the same way in 64-pixel chunks
def _b4_edge_shape(case, c, dtype):
    if case == "npix 1":
        return (1, 1, 1, c)
    if case == "small":
        return (2, 3, 5, c)
    chunk = 8192 // (c * torch.empty((), dtype=dtype).element_size())
    return (1, 1, 256 * chunk + (1 if case == "chunk + 1" else -1), c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,c", [
    (case, c) for case in ("npix 1", "small")
    for c in (1, 3, 12, 24, 2048)] + [
    (case, c) for case in ("chunk - 1", "chunk + 1") for c in (32, 2048)])
def test_fused_lif_bwd_kernel_edges(dev, case, c, dtype):
    """B4 at its edges in both types: one pixel; C 1 and 3 (rows under 16
    bytes: the scalar path), 12 (three float32 vectors; 24 bytes of
    bfloat16, not a multiple of 16: the scalar path in bfloat16), 24 (six
    float32 vectors, three bfloat16 ones) and 2048 (MAX_C, in row
    segments); and chunk boundaries less or more one pixel (a last chunk
    one pixel short, or of one pixel; at C = 32 257 chunks in 256
    slices of one or two)."""
    _hold_b4(_b4_args(dev, _b4_edge_shape(case, c, dtype), dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 13, 32), (8, 8, 8, 512),
                                   (1, 4, 4, 3)])
def test_fused_lif_bwd_kernel_scalar_path(dev, shape, dtype):
    """Maps that are contiguous views one element (4 or 2 bytes) into
    their storage are not 16-byte aligned: B4 takes its scalar path, one
    element a load, and holds to the plain version as the vector path
    does."""
    args = _b4_args(dev, shape, dtype, offset=1)
    assert all(t.data_ptr() % 16 for t in args[:3] + args[5:7])
    _hold_b4(args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_lif_bwd_kernel_is_one_device_operation(dev, dtype):
    """A B4 call is one device operation, its one cooperative kernel: no
    second pass over the partial sums, no fill (torch.profiler; a session
    can miss events, so it counts at most one per call)."""
    from torch.profiler import ProfilerActivity, profile

    args = _b4_args(dev, (8, 8, 8, 512), dtype)
    fused_lif_bwd_kernel(*args)
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fused_lif_bwd_kernel(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert names, "the profiler saw no device events"
    assert len(names) <= 10
    assert all("lif_bwd_kernel" in n for n in names), set(names)


def test_conv2d_same_has_grad_fn_on_cuda(dev):
    x = torch.randn(1, 6, 7, 3, device=dev, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, device=dev, requires_grad=True)
    y = conv2d_same(x, w)
    assert y.grad_fn is not None
    y.square().sum().backward()
    assert x.grad is not None and w.grad is not None


def _grads_on(device, fn, inputs):
    ts = [t.to(device).requires_grad_(t.is_floating_point() and rg)
          for t, rg in inputs]
    out = fn(*ts)
    loss = sum((o * torch.linspace(-1, 1, o.numel(), device=device)
                .reshape(o.shape)).sum() for o in out)
    wrt = [t for t in ts if t.requires_grad]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return ([o.detach().cpu() for o in out],
            [torch.zeros_like(t).cpu() if g is None else g.cpu()
             for g, t in zip(grads, wrt)])


def test_conv_backward_card_vs_cpu(dev):
    g = _gen()
    x = torch.randn((2, 18, 30, 5), generator=g)
    w = 0.3 * torch.randn((7, 5, 3, 3), generator=g)
    fn = lambda a, b: (conv2d_same(a, b),)
    (yc,), gc = _grads_on(torch.device("cpu"), fn, [(x, True), (w, True)])
    (yk,), gk = _grads_on(dev, fn, [(x, True), (w, True)])
    torch.testing.assert_close(yk, yc, atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(gk[0], gc[0], atol=ATOL, rtol=1e-5)
    assert_close_to_max(gk[1], gc[1])


@pytest.mark.parametrize("rec", [False, True])
def test_cell_backward_card_vs_cpu(dev, rec):
    g = _gen()
    b, h, w, cin, c, k = 2, 12, 20, 5, 8, 3
    x = (torch.rand((b, h, w, cin), generator=g) < 0.3).float()
    wt = 0.3 * torch.randn((c, cin, k, k), generator=g)
    wr = 0.3 * torch.randn((c, c, k, k), generator=g)
    thresh = 0.8 + 0.1 * torch.randn(c, generator=g)
    leak = torch.sigmoid(torch.randn(c, generator=g))
    v = thresh + 0.3 * torch.randn((b, h, w, c), generator=g)
    z = (torch.rand((b, h, w, c), generator=g) < 0.1).float()
    if rec:
        fn = lambda x_, w_, wr_, v_, z_, l_, t_: fused_conv_lif_rec(
            x_, w_, wr_, v_, z_, z_, l_, t_, k, True)
        inputs = [(x, True), (wt, True), (wr, True), (v, True), (z, True),
                  (leak, True), (thresh, True)]
    else:
        fn = lambda x_, w_, v_, z_, l_, t_: fused_conv_lif(
            x_, w_, v_, z_, l_, t_, k, True)
        inputs = [(x, True), (wt, True), (v, True), (z, True),
                  (leak, True), (thresh, True)]
    out_c, gc = _grads_on(torch.device("cpu"), fn, inputs)
    out_k, gk = _grads_on(dev, fn, inputs)
    torch.testing.assert_close(out_k[0], out_c[0], atol=ATOL, rtol=0)
    assert len(gk) == len(gc)
    for a, r in zip(gk, gc):
        assert_close_to_max(a, r, rtol=1e-4)


def test_scatter_kernel_bitwise_repeatable(dev):
    g = _gen()
    b, m, c, size = 8, 10000, 16, 130 * 130
    idx = torch.randint(0, size, (b, m), generator=g)
    idx[:, :2000] = idx[:, :1] + torch.arange(2000) % 7  # hot cells
    vals = torch.randn((b, m, c), generator=g)
    idx, vals = idx.to(dev), vals.to(dev)
    first = scatter_add_kernel(idx, vals, size)
    assert torch.equal(first, scatter_add_kernel(idx, vals, size))
    # against the float64 sum: the f32 plain version adds with float
    # atomics in no fixed order, and on the hot cells (about 290 randn
    # values each) its own rounding can exceed the tolerance
    ref = scatter_add_plain(idx, vals.double(), size).float()
    torch.testing.assert_close(first, ref, atol=ATOL, rtol=1e-5)


def test_train_update_bitwise_repeatable(dev):
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=2, resolution=[32, 32])
    cfg["data"].update(window=200, window_loss=600)
    cfg["model"]["base_num_channels"] = 8
    stream = SyntheticWindowStream(cfg)
    batches = [stream.next_batch() for _ in range(3)]
    runs = []
    for _ in range(2):
        trainer = Trainer(cfg, dev)
        step = trainer.step
        ev = torch.stack([torch.as_tensor(x["events"]) for x in batches],
                         1).to(dev)
        va = torch.stack([torch.as_tensor(x["valid"]) for x in batches],
                         1).to(dev)
        aug = torch.ones((2, 3), device=dev)
        loss, _ = step.loss(trainer.state.model_state, ev, va, aug)
        loss.backward()
        runs.append((loss.detach(), [p.grad.clone() for p in
                                     trainer.model.parameters()]))
    assert torch.isfinite(runs[0][0])
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


# K3 at every shape the main paths give it, as (B, M, size, C, count
# channels): the serving window's encoding and metric warps, the training
# loss's warps, the per-event flow gather's backward and the encoding of
# all B*T windows (chip_smoke.py::K3_SHAPES)
K3_SHAPES = [(1, 15000, 180 * 240, 1, 1), (1, 15000, 180 * 240, 4, 2),
             (8, 10000, 130 * 130, 16, 4), (80, 1000, 128 * 128, 2, 0),
             (80, 1000, 128 * 128, 4, 2)]


def _k3_inputs(b, m, size, ch, n_counts, dev):
    """int32 indices (as the paths pass them) with 1000 events of each row
    on five cells; n_counts channels of 0/1 counts, the rest randn."""
    g = _gen()
    idx = torch.randint(0, size, (b, m), generator=g, dtype=torch.int32)
    idx[:, :1000] = (torch.arange(1000) % 5).to(torch.int32)
    counts = (torch.rand((b, m, n_counts), generator=g) < 0.5).float()
    vals = torch.cat([counts, torch.randn((b, m, ch - n_counts),
                                          generator=g)], -1)
    return idx.to(dev), vals.to(dev)


@pytest.mark.parametrize("b,m,size,ch,n_counts", K3_SHAPES)
def test_scatter_kernel_at_path_shapes(dev, b, m, size, ch, n_counts):
    """Bitwise repeatable, counts exact, the rest within SCATTER_RTOL of
    the float64 sum."""
    idx, vals = _k3_inputs(b, m, size, ch, n_counts, dev)
    before = native.LAUNCHES["scatter_add"]
    got = scatter_add_kernel(idx, vals, size)
    assert native.LAUNCHES["scatter_add"] == before + 1
    assert torch.equal(got, scatter_add_kernel(idx, vals, size))
    ref = scatter_add_plain(idx, vals.double(), size)
    assert torch.equal(got[..., :n_counts], ref[..., :n_counts].float())
    torch.testing.assert_close(got.double(), ref, atol=ATOL,
                               rtol=SCATTER_RTOL)


def test_scatter_kernel_nan_and_out_of_range(dev):
    """A NaN value comes out NaN in its cell and leaves the other rows
    finite; indices outside [0, size) are dropped."""
    b, m, size, ch, n_counts = K3_SHAPES[2]
    idx, vals = _k3_inputs(b, m, size, ch, n_counts, dev)
    nan_vals = vals.clone()
    nan_vals[3, 17, 5] = float("nan")
    got = scatter_add_kernel(idx, nan_vals, size)
    assert torch.isnan(got[3, int(idx[3, 17]), 5])
    assert torch.isfinite(got[torch.arange(b, device=dev) != 3]).all()
    bad = idx.clone()
    bad[:, ::3] = torch.where(bad[:, ::3] % 2 == 0, -1 - bad[:, ::3],
                              size + bad[:, ::3])
    got = scatter_add_kernel(bad, vals, size)
    ref = scatter_add_plain(bad, vals.double(), size)  # drops them too
    torch.testing.assert_close(got.double(), ref, atol=ATOL,
                               rtol=SCATTER_RTOL)


def test_scatter_kernel_is_one_device_operation(dev):
    """Every device operation of a K3 call is its one kernel: no zero
    fill, no index conversion, no second pass (torch.profiler; a session
    can miss events, so it counts at most one per call)."""
    from torch.profiler import ProfilerActivity, profile

    b, m, size, ch, n_counts = K3_SHAPES[2]
    idx, vals = _k3_inputs(b, m, size, ch, n_counts, dev)
    scatter_add_kernel(idx, vals, size)
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                scatter_add_kernel(idx, vals, size)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert names, "the profiler saw no device events"
    assert len(names) <= 10
    assert all("scatter_tile_kernel" in n for n in names), set(names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 13, 384), (2, 9, 13, 512),
                                   (2, 9, 13, 1024), (8, 8, 8, 512)])
@pytest.mark.parametrize("hard", [True, False])
def test_fused_lif_bwd_kernel_past_256_channels(dev, shape, hard, dtype):
    """B4 at the U-Net's 512-channel cells (the residual blocks' and the
    deepest encoder's 8 x 8 x 8 x 512 at B 8, 128 x 128) and around
    them, in both types: rows of 512 bytes or more are cut into 128-byte
    segments, each a unit of work of its own."""
    _hold_b4(_b4_args(dev, shape, dtype, hard=hard))


def test_strided_conv_grads_are_f32_under_default_tf32(dev):
    """conv2d_strided's dx and dw at U-Net encoder 1's shape (64 -> 128,
    stride 2, 8 x 64 x 64) with cuDNN's TF32 allowed, as it is by default:
    within 1e-4 of max of the float64 gradients (one TF32 pass misses by
    about 3e-4 to 8e-4 here)."""
    g = _gen()
    x = torch.randn((8, 64, 64, 64), generator=g).to(dev)
    w = (0.05 * torch.randn((128, 64, 3, 3), generator=g)).to(dev)
    gy = torch.randn((8, 32, 32, 128), generator=g).to(dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        grads = []
        for dtype in (torch.float32, torch.float64):
            xs = x.to(dtype).requires_grad_()
            ws = w.to(dtype).requires_grad_()
            y = conv2d_strided(xs, ws, 2)
            grads.append(torch.autograd.grad(y, (xs, ws), gy.to(dtype)))
    for got, ref in zip(*grads):
        err = float((got.double() - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err


# the decoders' bilinear x2 inputs of the U-Net update at B 8, 128 x 128
UPSAMPLE_SHAPES = [(8, 8, 8, 1024), (8, 16, 16, 514), (8, 32, 32, 258),
                   (8, 64, 64, 130)]


@pytest.mark.parametrize("shape", UPSAMPLE_SHAPES)
def test_bilinear_backward_repeats_and_matches_cpu(dev, shape):
    """The fixed-order backward of upsample2x_bilinear (no atomics): twice
    bitwise equal on the card and within 1e-6 of max|gx| of the same
    stencil on the CPU (f32 products and sums, the card may contract them
    into fused multiply-adds)."""
    from event_flow_tpu_torch.ops.resize import (upsample2x_bilinear,
                                                 upsample2x_bilinear_grad)

    g = _gen()
    b, h, w, c = shape
    x = torch.randn(shape, generator=g).to(dev).requires_grad_()
    gy = torch.randn((b, 2 * h, 2 * w, c), generator=g)
    y = upsample2x_bilinear(x)
    first = torch.autograd.grad(y, x, gy.to(dev))[0]
    again = torch.autograd.grad(upsample2x_bilinear(x), x, gy.to(dev))[0]
    assert torch.equal(first, again)
    ref = upsample2x_bilinear_grad(gy)
    err = float((first.cpu() - ref).abs().max())
    assert err <= 1e-6 * float(ref.abs().max()), err


# the U-Net encoders' strided convs at B 8, 128 x 128: (x shape, Cout)
ENCODER_SHAPES = [((8, 128, 128, 2), 64), ((8, 64, 64, 64), 128),
                  ((8, 32, 32, 128), 256), ((8, 16, 16, 256), 512)]


@pytest.mark.parametrize("shape,cout", ENCODER_SHAPES)
def test_strided_conv_backward_repeats_under_any_flags(dev, shape, cout):
    """conv2d_strided's dx and dw twice bitwise equal with cuDNN's TF32
    and autotuning switched on around the call: the conv sets its own
    flags (TF32 off, deterministic algorithms, no autotuning)."""
    g = _gen()
    x = torch.randn(shape, generator=g).to(dev)
    w = (0.05 * torch.randn((cout, shape[3], 3, 3), generator=g)).to(dev)
    gy = torch.randn((shape[0], shape[1] // 2, shape[2] // 2, cout),
                     generator=g).to(dev)
    runs = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True,
                                    benchmark=True, deterministic=False):
        for _ in range(2):
            xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = conv2d_strided(xs, ws, 2)
            runs.append((y.detach(),) + torch.autograd.grad(y, (xs, ws), gy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _small_update(dev, recipe, base):
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    cfg = copy.deepcopy(recipe)
    cfg["loader"].update(batch_size=2, resolution=[64, 64])
    cfg["data"].update(window=500, window_loss=1000)
    cfg["model"]["base_num_channels"] = base
    trainer = Trainer(cfg, dev)
    stream = SyntheticWindowStream(cfg)
    loss = None
    while loss is None:
        loss = trainer.feed(stream.next_batch())
    return loss


@pytest.mark.parametrize("name", ["SpikingRecEVFlowNet", "RecEVFlowNet"])
def test_unet_update_under_deterministic_algorithms(dev, name):
    """One update of each U-Net with torch.use_deterministic_algorithms on:
    an op with a nondeterministic CUDA backward would raise instead of
    drifting (the bilinear and strided conv backward, the concat and crop
    of the skips, the nearest resize of the flows, the gathers and
    scatters of the loss)."""
    from event_flow_tpu_torch.config import TRAIN_ANNREC, TRAIN_SNNREC
    from event_flow_tpu_torch.ops.resize import resize_nearest

    recipe = TRAIN_SNNREC if name == "SpikingRecEVFlowNet" else TRAIN_ANNREC
    torch.use_deterministic_algorithms(True)
    try:
        with torch.enable_grad():
            loss = _small_update(dev, recipe, 8)
            x = torch.randn((1, 12, 15, 2), device=dev, requires_grad=True)
            gx = torch.autograd.grad(resize_nearest(x, (180, 240)).sum(), x)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(torch.tensor(loss))
    assert float(gx[0].min()) == float(gx[0].max()) == 15 * 16


# the x2 transposed decoders of EVFlowNet (use_upsample_conv False) at
# B 8, 128 x 128: (x shape, Cout)
TRANSPOSED_SHAPES = [((8, 8, 8, 1024), 256), ((8, 16, 16, 514), 128),
                     ((8, 32, 32, 258), 64), ((8, 64, 64, 130), 32)]


@pytest.mark.parametrize("shape,cout", TRANSPOSED_SHAPES)
def test_transposed_conv_backward_repeats_under_any_flags(dev, shape,
                                                          cout):
    """conv_transpose2x forward, dx and dw twice bitwise equal with cuDNN's
    TF32 and autotuning switched on around the call, and again under
    torch.use_deterministic_algorithms; within 1e-4 of max of the float64
    result (one TF32 pass misses by about 1e-3)."""
    from event_flow_tpu_torch.ops.conv import conv_transpose2x

    g = _gen()
    x = torch.randn(shape, generator=g).to(dev)
    w = (0.05 * torch.randn((shape[3], cout, 3, 3), generator=g)).to(dev)
    gy = torch.randn((shape[0], 2 * shape[1], 2 * shape[2], cout),
                     generator=g).to(dev)

    def run(dtype=torch.float32):
        xs = x.to(dtype).requires_grad_()
        ws = w.to(dtype).requires_grad_()
        y = conv_transpose2x(xs, ws)
        return (y.detach(),) + torch.autograd.grad(y, (xs, ws), gy.to(dtype))

    runs = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True,
                                    benchmark=True, deterministic=False):
        runs += [run(), run()]
    torch.use_deterministic_algorithms(True)
    try:
        runs.append(run())
    finally:
        torch.use_deterministic_algorithms(False)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    for got, ref in zip(runs[0], run(torch.float64)):
        err = float((got.double() - ref).abs().max())
        assert err <= 1e-4 * float(ref.abs().max()), err


def test_firenet_update_bitwise_repeatable(dev):
    """One FireNet update at base 32 (B 2, 64 x 64, T 2) twice from the
    seeded init: the loss and every gradient bitwise equal."""
    from event_flow_tpu_torch.config import TRAIN_ANN

    runs = []
    for _ in range(2):
        with torch.enable_grad():
            trainer, loss = _small_trainer(dev, TRAIN_ANN, 32)
        runs.append((loss, [p.grad.clone() for p in
                            trainer.model.parameters()]))
    assert torch.isfinite(torch.tensor(runs[0][0]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def _small_trainer(dev, recipe, base, **model):
    """A Trainer of ``recipe``'s model at ``base`` channels (and the model
    options ``model``) at B 2, 64 x 64, T 2, after its first update;
    returns (trainer, loss)."""
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    cfg = copy.deepcopy(recipe)
    cfg["loader"].update(batch_size=2, resolution=[64, 64])
    cfg["data"].update(window=500, window_loss=1000)
    cfg["model"].update(base_num_channels=base, **model)
    trainer = Trainer(cfg, dev)
    stream = SyntheticWindowStream(cfg)
    loss = None
    while loss is None:
        loss = trainer.feed(stream.next_batch())
    return trainer, loss


@pytest.mark.parametrize("name,model", [
    ("E2VID", {}),
    ("EVFlowNet", {"use_upsample_conv": False, "norm": "BN",
                   "norm_input": True})])
def test_ann_update_under_deterministic_algorithms(dev, name, model):
    """One update of E2VID (the ConvLSTM gates, the sum skips) and of
    EVFlowNet with the transposed decoders, BN and norm_input, with
    torch.use_deterministic_algorithms on: an op with a nondeterministic
    CUDA backward would raise instead of drifting."""
    from event_flow_tpu_torch.config import TRAIN_ANNREC

    torch.use_deterministic_algorithms(True)
    try:
        with torch.enable_grad():
            trainer, loss = _small_trainer(dev, TRAIN_ANNREC, 8, name=name,
                                           **model)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(torch.tensor(loss))
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in trainer.model.parameters())


def test_e2vid_window_card_vs_cpu(dev):
    """One window of E2VID at base 32 at the ECD recipe's 180 x 240 from
    the same seeded init on the card and on the CPU: K1 12 launches (the
    head, 3 ConvLSTM gates, 4 residual-block convs, 3 decoders, the
    prediction), the (hidden, cell) states and the flow within 1e-5 of
    their max."""
    from event_flow_tpu_torch.config import ECD_RECEVFLOWNET
    from event_flow_tpu_torch.models.registry import build_model

    cfg = copy.deepcopy(ECD_RECEVFLOWNET)
    cfg["model"]["name"] = "E2VID"
    cnt = torch.poisson(torch.full((1, 180, 240, 2), 0.2), generator=_gen())
    outs = {}
    for d in (torch.device("cpu"), dev):
        model = build_model(cfg, d, seed=0)
        native.reset_launch_counts()
        with torch.no_grad():
            out, state = model(cnt.to(d), cnt.to(d),
                               model.zero_state(1, 180, 240, d))
        want = {"conv2d_same": 12} if d.type == "cuda" else {}
        assert {k: n for k, n in native.LAUNCHES.items() if n} == want
        outs[d.type] = [t.cpu() for t in [out["flow"][0]]
                        + [t for pair in state for t in pair]]
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        assert torch.isfinite(got).all()
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err
    assert float(outs["cuda"][0].abs().max()) > 0


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_avg_pool_backward_card_vs_cpu(dev, stride, sliced):
    """The trace's pooling of a one-channel NHWC map at 8 x 128 x 128 (k
    3, padding 1), under a contiguous cotangent and one sliced from a
    wider map: value and dx within 1e-6 of the CPU's, twice bitwise
    equal. On the permuted view of the map (NCHW, with strides that also
    read as channels_last) torch's CUDA avg_pool2d backward missed the
    CPU's dx by more than its largest entry, so avg_pool pools a copy in
    NCHW strides."""
    from event_flow_tpu_torch.ops.resize import avg_pool

    g = _gen()
    x = torch.rand((8, 128, 128, 1), generator=g)
    gy = torch.randn((8, -(-128 // stride), -(-128 // stride),
                      4 if sliced else 1), generator=g)[..., :1]
    outs = {}
    for d in ("cpu", "cuda", "cuda"):
        xd = x.to(d).requires_grad_(True)
        with torch.enable_grad():
            y = avg_pool(xd, 3, stride, 1)
            gx, = torch.autograd.grad(y, xd, gy.to(d))
        outs.setdefault(d, []).append((y.detach().cpu(), gx.cpu()))
    (y, gx), = outs["cpu"]
    (y1, gx1), (y2, gx2) = outs["cuda"]
    assert torch.equal(y1, y2) and torch.equal(gx1, gx2)
    assert float((y1 - y).abs().max()) <= 1e-6
    assert float((gx1 - gx).abs().max()) <= 1e-6


def test_xlif_update_bitwise_repeatable(dev):
    """One XLIFFireNet update at base 32 (B 2, 64 x 64, T 2) twice from
    the seeded init: the loss and every gradient bitwise equal; the
    frozen t0 and t1 take none."""
    from event_flow_tpu_torch.config import TRAIN_XLIF

    runs = []
    for _ in range(2):
        with torch.enable_grad():
            trainer, loss = _small_trainer(dev, TRAIN_XLIF, 32)
        runs.append((loss, {n: p.grad.clone() for n, p in
                            trainer.model.named_parameters()
                            if p.grad is not None}))
    assert torch.isfinite(torch.tensor(runs[0][0]))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][1]) == sum(1 for n, _ in trainer.model.named_parameters()
                                  if not n.endswith((".t0", ".t1")))
    for name, grad in runs[0][1].items():
        assert torch.equal(grad, runs[1][1][name]), name


@pytest.mark.parametrize("name", ["XLIFFireNet", "XLIFRecEVFlowNet",
                                  "PLIFRecEVFlowNet", "LeakyRecEVFlowNet"])
def test_neuron_update_under_deterministic_algorithms(dev, name):
    """One update of the PLIF, XLIF and Leaky models with
    torch.use_deterministic_algorithms on: the trace's avg_pool and its
    backward, the channel mean, the per-pixel threshold's gradient and
    the reductions into the per-channel parameters would raise instead of
    drifting if any took a nondeterministic CUDA path."""
    from event_flow_tpu_torch.config import TRAIN_ANNREC, with_model

    torch.use_deterministic_algorithms(True)
    try:
        with torch.enable_grad():
            trainer, loss = _small_trainer(dev, with_model(TRAIN_ANNREC,
                                                           name), 8)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.isfinite(torch.tensor(loss))
    assert all(torch.isfinite(p.grad).all()
               for p in trainer.model.parameters() if p.grad is not None)


def test_xlif_window_card_vs_cpu(dev):
    """One window of XLIFFireNet at base 32 at the ECD recipe's 180 x 240
    from the same seeded init on the card and on the CPU: K1 8 launches;
    the head cell's v and trace state within 1e-5 and its spikes equal but
    where |v - thresh| < 1e-4 (the per-pixel t0 + t1 pt'). A near-threshold
    flip moves the cells after it by a weight, so past the head the
    comparison is by share, as the spiking U-Net's: at most 0.1 % of each
    cell's spikes flip, and the flow stays within 1e-4 on average."""
    from event_flow_tpu_torch.config import ECD_XLIFFIRENET
    from event_flow_tpu_torch.models.registry import build_model

    cnt = torch.poisson(torch.full((1, 180, 240, 2), 0.2), generator=_gen())
    outs = {}
    for d in (torch.device("cpu"), dev):
        model = build_model(ECD_XLIFFIRENET, d, seed=0)
        native.reset_launch_counts()
        with torch.no_grad():
            out, state = model(cnt.to(d), cnt.to(d),
                               model.zero_state(1, 180, 240, d))
        want = {"conv2d_same": 8} if d.type == "cuda" else {}
        assert {k: n for k, n in native.LAUNCHES.items() if n} == want
        outs[d.type] = (out["flow"][0].cpu(),
                        [[t.cpu() for t in s] for s in state], model)
    flow, states, model = outs["cpu"]
    gflow, gstates, _ = outs["cuda"]
    (v, z, pt), (gv, gz, gpt) = states[0], gstates[0]
    head = model.head
    thresh = (torch.maximum(head.t0, torch.tensor(0.01)).reshape(-1)
              + torch.maximum(head.t1, torch.tensor(0.0)).reshape(-1) * pt)
    assert float((gv - v).abs().max()) <= ATOL
    assert float((gpt - pt).abs().max()) <= ATOL
    assert not ((gz != z) & ((v - thresh).abs() >= NEAR)).any()
    for (_, z, _), (_, gz, _) in zip(states, gstates):
        assert float((gz != z).float().mean()) <= 1e-3
    assert all(bool(z.any()) for _, z, _ in states)
    assert torch.isfinite(gflow).all()
    assert float((gflow - flow).abs().mean()) <= 1e-4


@pytest.mark.parametrize("saved_on,restored_on", [("cuda", "cpu"),
                                                  ("cpu", "cuda")])
def test_checkpoint_moves_between_card_and_cpu(dev, tmp_path, saved_on,
                                               restored_on):
    """A full checkpoint of one update saved on one device resumes on the
    other: the weights, the Adam state and the carried state bit for bit,
    and the serving FWL/RSAT of the restored weights within 1e-3 of the
    saving side's (near-threshold spike flips, as chip_smoke.py's
    SLICE_RTOL)."""
    from event_flow_tpu_torch.config import ECD_LIFFIRENET, TRAIN_SNN
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.train.loop import Trainer
    from event_flow_tpu_torch.utils.tracking import Tracker

    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=2, resolution=[32, 32])
    cfg["data"].update(window=200, window_loss=600)
    cfg["model"]["base_num_channels"] = 8
    devices = {"cuda": dev, "cpu": torch.device("cpu")}
    tracker = Tracker(runs_root=str(tmp_path))
    first = Trainer(cfg, devices[saved_on], tracker=tracker)
    stream = SyntheticWindowStream(cfg)
    while first.updates < 1:
        first.feed(stream.next_batch())
    first.save_full_checkpoint(stream, 0)
    second = Trainer(cfg, devices[restored_on])
    assert second.resume(tracker.dir, stream) == 0
    assert not second._pending_reset

    def tensors(tr):
        opt = tr.state.optimizer.state_dict()["state"]
        return ([p for _, p in sorted(tr.model.state_dict().items())]
                + [opt[i][k] for i in sorted(opt) for k in sorted(opt[i])]
                + [t for cell in tr.state.model_state for t in cell])

    for a, b in zip(tensors(first), tensors(second)):
        assert torch.equal(a.cpu(), b.cpu())
    ecfg = copy.deepcopy(ECD_LIFFIRENET)
    ecfg["loader"]["resolution"] = [32, 48]
    ecfg["data"]["window"] = ecfg["data"]["window_eval"] = 500
    ecfg["model"]["base_num_channels"] = 8
    ref = evaluate(ecfg, devices[saved_on], model=first.model.eval())
    got = evaluate(ecfg, devices[restored_on], model=second.model.eval())
    for metric, vals in ref["results"].items():
        for fname, val in vals.items():
            assert got["results"][metric][fname] == pytest.approx(
                val, rel=1e-3), (metric, fname)


def test_time_update_bitwise_under_deterministic_algorithms(dev):
    """A time-mode LIFFireNet update at B 2, 64 x 64, width 8, of the
    t_live < t_max_windows windows the Trainer gathered, run twice from
    the same init under torch.use_deterministic_algorithms: the loss,
    every gradient and the carried state bitwise equal."""
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                                  synthetic_sequences)
    from event_flow_tpu_torch.train.loop import Trainer

    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=2, resolution=[64, 64])
    cfg["data"].update(mode="time", window=0.05, window_loss=3000,
                       max_events=2048, t_max_windows=6)
    cfg["model"]["base_num_channels"] = 8
    seen = []
    torch.use_deterministic_algorithms(True)
    try:
        with torch.enable_grad():
            first = Trainer(cfg, dev)
            step = first.step
            first.step = lambda *args: seen.append(args[1:]) or step(*args)
            stream = ArrayEventStream(cfg, synthetic_sequences(cfg))
            loss = None
            while loss is None:
                loss = first.feed(stream.next_batch())
            events, valid, aug, reset = seen[0]
            assert first.t_live == events.shape[1] < 6
            again = Trainer(cfg, dev)
            loss_2, state_2 = again.step(again.state, events, valid, aug,
                                         reset)
    finally:
        torch.use_deterministic_algorithms(False)
    assert loss_2.item() == loss
    for (n1, p1), (n2, p2) in zip(first.model.named_parameters(),
                                  again.model.named_parameters()):
        assert torch.equal(p1.grad, p2.grad), n1
    for (v1, z1), (v2, z2) in zip(first.state.model_state,
                                  state_2.model_state):
        assert torch.equal(v1, v2) and torch.equal(z1, z2)


@pytest.mark.parametrize("mode,window", [("gtflow_dt1", 1),
                                         ("gtflow_dt4", 0.25)])
def test_aee_serving_card_vs_cpu(dev, mode, window):
    """MVSEC-protocol AEE serving of LIFFireNet at 64 x 64, width 8, with
    the 65 536-event bucket (mostly padding): per-file AEE and outlier
    share within 1e-3 of the CPU's, and the ground truth as the
    prediction scoring AEE < 1e-4 px on the card."""
    from event_flow_tpu_torch.config import MVSEC_LIFFIRENET
    from event_flow_tpu_torch.data.stream import synthetic_sequences
    from event_flow_tpu_torch.eval_flow import evaluate
    from event_flow_tpu_torch.loss.metrics import aee

    cfg = copy.deepcopy(MVSEC_LIFFIRENET)
    cfg["loader"]["resolution"] = [64, 64]
    cfg["model"]["base_num_channels"] = 8
    cfg["data"].update(mode=mode, window=window)
    seqs = synthetic_sequences(cfg)
    gpu = evaluate(cfg, dev, sequences=seqs)["results"]
    cpu = evaluate(cfg, "cpu", sequences=seqs)["results"]
    assert set(gpu) == set(cpu) == {"AEE", "AEE_percent"}
    for metric, per_file in cpu.items():
        for fname, ref in per_file.items():
            assert gpu[metric][fname] == pytest.approx(ref, rel=1e-3,
                                                       abs=1e-6)
    gt = torch.randn((1, 64, 64, 2), device=dev)
    mask = (torch.rand((1, 64, 64, 1), device=dev) < 0.3).float()
    dt_in = torch.tensor([0.05], device=dev)
    dt_gt = torch.tensor([0.2], device=dev)
    a, pct = aee(gt / (128 * dt_gt / dt_in), gt, mask, dt_in, dt_gt)
    assert float(a) < 1e-4 and float(pct) == 0.0


def _engine_windows(res, n, n_events, seed):
    """[n, 1, N, 4] uniform windows (sorted ts, integer pixels, +-1)."""
    g = torch.Generator().manual_seed(seed)
    h, w = res
    ts = torch.rand((n, 1, n_events), generator=g).sort(-1).values
    ys = torch.randint(0, h, (n, 1, n_events), generator=g).float()
    xs = torch.randint(0, w, (n, 1, n_events), generator=g).float()
    ps = torch.randint(0, 2, (n, 1, n_events), generator=g).float() * 2 - 1
    return torch.stack([ts, ys, xs, ps], -1)


def _serve_cpu_artifact_on_card(dev, tmp_path, cfg, n, n_events):
    """Export the engine of ``cfg`` (seed-0 init) on the CPU, serve it on
    the card beside the live engine on the card: (live flows, served
    flows, launches of the live run, launches of the served run)."""
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.eval.serialized import (SerializedEngine,
                                                      export_engine)
    from event_flow_tpu_torch.models.registry import build_model

    res = tuple(cfg["loader"]["resolution"])
    cpu = InferenceEngine(cfg, build_model(cfg, "cpu"), "cpu")
    path = export_engine(cpu, str(tmp_path / "art"), n_events=n_events)
    live = InferenceEngine(cfg, build_model(cfg, dev), dev)
    ser = SerializedEngine(path, device=dev)
    windows = _engine_windows(res, n, n_events, 0).to(dev)
    out = []
    for engine in (live, ser):
        native.reset_launch_counts()
        out.append([engine.step(w) for w in windows])
        out.append(dict(native.LAUNCHES))
    return out


def test_cpu_artifact_launches_the_kernels_on_the_card(dev, tmp_path):
    """LIFFireNet exported on the CPU and served on the card: per window
    K2 5 + 2, K1 1, K3 1, as the live engine; flows within 1e-6."""
    from event_flow_tpu_torch.config import ECD_LIFFIRENET

    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = [32, 48]
    cfg["model"]["base_num_channels"] = 32
    live, live_counts, served, counts = _serve_cpu_artifact_on_card(
        dev, tmp_path, cfg, 4, 3000)
    want = {**dict.fromkeys(native.LAUNCHES, 0), "conv2d_same": 4,
            "fused_conv_lif": 20, "fused_conv_lif_rec": 8, "scatter_add": 4}
    assert live_counts == want and counts == want
    assert max(float(f.abs().max()) for f in live) > 0
    for a, b in zip(served, live):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


def test_unet_artifact_matches_live_under_tf32(dev, tmp_path):
    """SpikingRecEVFlowNet (base 8) exported on the CPU and served on the
    card with cuDNN's TF32 on: the strided convs carry their own flags, so
    the artifact matches the live engine within 1e-6."""
    from event_flow_tpu_torch.config import ECD_SPIKING_RECEVFLOWNET

    cfg = copy.deepcopy(ECD_SPIKING_RECEVFLOWNET)
    cfg["loader"]["resolution"] = [36, 48]
    cfg["model"]["base_num_channels"] = 8
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        live, _, served, counts = _serve_cpu_artifact_on_card(
            dev, tmp_path, cfg, 3, 3000)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert counts["fused_conv_lif"] == 24 and counts["conv2d_same"] == 12
    for a, b in zip(served, live):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cls,kw,stride", [
    ("ConvLIF", {"norm": "group"}, 1),
    ("ConvLIFRecurrent", {"norm": "group"}, 1),
    ("ConvLIF", {"norm": "weight"}, 1),
    ("ConvLIFRecurrent", {"norm": "weight"}, 1),
    ("ConvLIFRecurrent", {"detach": False}, 1),
    ("ConvXLIFRecurrent", {}, 2)])
def test_option_cells_card_vs_cpu(dev, cls, kw, stride):
    """The cells of the norm, detach=False and strided-recurrent options
    over two steps on the card and on the CPU: v within 1e-5, spikes
    equal, and the gradient of a weighted sum into the input and every
    parameter within 1e-4 of its largest magnitude; on the card K1 and
    B2, never K2 or B4."""
    from event_flow_tpu_torch.models import snn_cells

    g = _gen()
    x = 2.0 * (torch.rand((2, 12, 20, 5), generator=g) < 0.3).float()
    runs = {}
    for device in ("cpu", dev):
        cell = getattr(snn_cells, cls)(5, 8, 3, stride, generator=_gen(),
                                       **kw).to(device)
        xd = x.detach().to(device).requires_grad_(True)
        state = cell.zero_state(2, 12, 20, device)
        native.reset_launch_counts()
        total, steps = 0.0, []
        for _ in range(2):
            out, state = cell(xd, state)
            steps.append((state[0].detach().cpu(), state[1].detach().cpu()))
            total = total + (out * torch.linspace(
                -1, 1, out.numel(), device=device).reshape(out.shape)).sum()
        total = total + state[0].sum()
        total.backward()
        grads = [xd.grad.cpu()] + [p.grad.cpu() for p in cell.parameters()
                                   if p.requires_grad]
        runs[str(device)] = (steps, grads, dict(native.LAUNCHES))
    (cs, cg, _), (ks, kg, counts) = runs["cpu"], runs[str(dev)]
    for (cv, cz), (kv, kz) in zip(cs, ks):
        torch.testing.assert_close(kv, cv, atol=ATOL, rtol=0)
        assert torch.equal(kz, cz)
    assert 0.0 < float(ks[-1][1].mean()) < 1.0
    for a, r in zip(kg, cg):
        assert_close_to_max(a, r, rtol=1e-4)
    assert counts["fused_conv_lif"] == counts["fused_conv_lif_rec"] == 0
    assert counts["fused_lif_bwd"] == 0
    assert counts["conv2d_same"] > 0 and counts["conv2d_dw"] > 0


def test_evaluator_vis_card_vs_cpu(dev):
    """The Evaluator's vis dict (K = 3, vis.store, activity,
    overwrite_intermediate) on the card against the CPU over 12 windows:
    counts bitwise, flows within 1e-4 of max, the IWEs equal but for
    events within rounding of a pixel line, activity within 1e-4; K3 once
    per window for the encoding and once for the display IWE, 4 + 2 per
    group."""
    from event_flow_tpu_torch.config import ECD_LIFFIRENET
    from event_flow_tpu_torch.data.stream import (ArrayEventStream,
                                                  synthetic_sequences)
    from event_flow_tpu_torch.eval.harness import Evaluator
    from event_flow_tpu_torch.models.registry import build_model
    from event_flow_tpu_torch.ops.hot_filter import init_hot_state

    cfg = copy.deepcopy(ECD_LIFFIRENET)
    cfg["loader"]["resolution"] = [32, 48]
    cfg["data"].update(window=500, window_eval=1500)
    cfg["vis"].update(store=True, activity=True)
    cfg["loss"] = {"overwrite_intermediate": True}
    seqs = synthetic_sequences(cfg, n_sequences=1, n_windows=1.0)
    out = {}
    for device in ("cpu", dev):
        ev = Evaluator(cfg, build_model(cfg, device), torch.device(device))
        stream = ArrayEventStream(cfg, seqs)
        state = (ev.model.zero_state(1, 32, 48, device),
                 init_hot_state(1, (32, 48), device))
        native.reset_launch_counts()
        wins = []
        with torch.no_grad():
            for _ in range(12):
                *state, vis = ev.process_batch(stream, *state,
                                               stream.next_batch())
                wins.append({k: ({n: float(t) for n, t in v.items()}
                                 if k == "activity" else v.cpu())
                             for k, v in vis.items()})
        out[str(device)] = (wins, dict(native.LAUNCHES), ev.results())
    (cw, _, cres), (kw_, counts, kres) = out["cpu"], out[str(dev)]
    assert counts["scatter_add"] == 12 + 12 + 4 * 4 + 2 * 4
    for c, k in zip(cw, kw_):
        assert set(c) == set(k)
        for key in ("event_cnt", "event_mask", "events_window"):
            if key in c:
                assert torch.equal(k[key], c[key]), key
        for key in ("flow", "flow_window"):
            if key in c:
                assert_close_to_max(k[key], c[key], rtol=1e-4)
        for key in ("iwe", "iwe_window"):
            if key in c:
                moved = 0.5 * float((k[key] - c[key]).abs().sum())
                assert moved <= 1e-3 * float(c[key].sum()), key
        for name, val in c["activity"].items():
            assert abs(k["activity"][name] - val) <= 1e-4, name
    for metric in ("FWL", "RSAT"):
        for f, val in cres[metric].items():
            assert kres[metric][f] == pytest.approx(val, rel=1e-3)


def test_train_vis_update_on_the_card(dev, tmp_path):
    """One --vis update at batch 1 on the card: the display dict of the
    last window, finite and on the card, its tree written, K2, B4 and B2
    launched."""
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.train_flow import train

    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=1, resolution=[32, 32])
    cfg["data"].update(window=300, window_loss=900)
    native.reset_launch_counts()
    rid, trainer, hist = train(cfg, dev, max_updates=1,
                               runs_root=str(tmp_path), vis=True)
    counts = dict(native.LAUNCHES)
    assert counts["fused_conv_lif"] > 0 and counts["fused_lif_bwd"] > 0
    assert counts["conv2d_dw"] > 0
    vis = trainer.step.vis
    assert vis["flow"].shape == (1, 32, 32, 2) and vis["flow"].is_cuda
    assert torch.isfinite(vis["flow"]).all()
    files = list((tmp_path / rid / "vis" / "train" / "flow").iterdir())
    assert len(files) == 1 and len(hist) == 1


def _dist_config():
    from event_flow_tpu_torch.config import TRAIN_SNN

    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=4, resolution=[32, 32])
    cfg["data"].update(window=300, window_loss=600)
    cfg["model"]["base_num_channels"] = 8
    return cfg


def _dist_feeds(cfg, n):
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream

    stream = SyntheticWindowStream(cfg)
    return [stream.next_batch() for _ in range(n)]


WORKER = str(__import__("pathlib").Path(__file__).with_name(
    "torch_parallel_worker.py")) + ":cases"


def test_world1_nccl_update_bitwise_equal_to_no_mesh(dev):
    """Trainer(mesh=make_mesh()) in a world of one NCCL process: its
    collectives run (the gradient all-reduce, over one rank) and its
    updates are bitwise the no-mesh Trainer's."""
    from event_flow_tpu_torch.parallel.launch import run_world

    cfg = _dist_config()
    case = {"fn": "without_and_with_mesh", "cfg": cfg,
            "feeds": _dist_feeds(cfg, 4)}
    [out] = run_world(WORKER, 1, {"cases": [("w1", case)]}, device="cuda",
                      backend="nccl", timeout=300)
    plain, meshed = out["w1"]["plain"], out["w1"]["mesh"]
    assert len(plain["losses"]) == 2
    assert meshed["losses"] == plain["losses"]
    for name, p in plain["params"].items():
        assert torch.equal(meshed["params"][name], p), name


def test_world2_gloo_on_one_card_matches_one_process(dev):
    """Two processes on one card under gloo (NCCL refuses two ranks on
    one device): the replicas bitwise equal, and within 1e-5 of one
    process's updates on the card."""
    from event_flow_tpu_torch.parallel.launch import run_world
    from event_flow_tpu_torch.train.loop import Trainer

    cfg = _dist_config()
    feeds = _dist_feeds(cfg, 4)
    one = Trainer(cfg, dev)
    sd = {k: v.cpu() for k, v in one.model.state_dict().items()}
    losses = [v for v in (one.feed(b) for b in feeds) if v is not None]
    case = {"fn": "train", "meshes": [(2, 1)],
            "models": {"lif": (cfg, sd, feeds)}}
    runs = [r["w2"][(2, 1, "lif")] for r in run_world(
        WORKER, 2, {"cases": [("w2", case)]}, device="cuda:0",
        backend="gloo", timeout=300)]
    assert runs[0]["losses"] == runs[1]["losses"]
    for name, p in runs[0]["params"].items():
        assert torch.equal(runs[1]["params"][name], p), name
    assert runs[0]["losses"] == pytest.approx(losses, rel=1e-5)
    for name, p in one.model.named_parameters():
        ref = p.detach().cpu()
        gap = float((runs[0]["params"][name] - ref).norm() / ref.norm())
        assert gap <= 1e-5, name


# the bfloat16 variants of K1, B2, K2 and B4 (the mixed-precision policy):
# each against its bfloat16 plain version, both summing in float32 and
# rounding once, so within one bfloat16 ulp plus the float32 sums' order
# (ATOL; the pixel sums SUM_RTOL of their largest magnitude), spikes
# equal away from the threshold; the training shapes and the U-Net's
# deepest, with 1026 and 514 channels (4-byte copies) and a ragged case
BF16_CONV = [((8, 128, 128, 32), 32, 3, "spikes"),
             ((8, 128, 128, 2), 32, 1, "randn"),
             ((8, 128, 128, 32), 2, 1, "spikes"),
             ((1, 24, 30, 1026), 256, 3, "randn"),
             ((8, 16, 16, 1024), 256, 3, "spikes"),
             ((2, 18, 30, 5), 3, 3, "randn")]
BF16_CELLS = [(8, 128, 128, 32, 32, False), (8, 128, 128, 32, 32, True),
              (8, 128, 128, 2, 32, False), (8, 8, 8, 512, 512, True),
              (1, 46, 60, 514, 128, False)]


def _bf16_close(got, ref, atol):
    assert got.dtype == ref.dtype == torch.bfloat16
    assert not native.beyond_bf16_ulp(got, ref, atol).any()


def _route(kernel, x, cout, k):
    """The launch count K1 (``conv2d_same``) or B2 (``conv2d_dw``) on a
    contiguous x adds to: the wgmma route's at the bfloat16 deep maps
    (ops/conv_plan.py::wgmma_route), else x's type's variant."""
    if wgmma_route(x.shape[3], cout, k, x.element_size()):
        return kernel + "_wgmma_bf16"
    return native.variant(kernel, x.dtype)


@pytest.mark.parametrize("shape,cout,k,inputs", BF16_CONV)
def test_bf16_conv_kernels_match_plain(dev, shape, cout, k, inputs):
    """K1 and B2 on bfloat16 x, w and g: their bfloat16 variants launch
    (their own counts, the float32 ones' unchanged), within one ulp of
    the plain versions, twice bitwise equal."""
    g = _gen()
    if inputs == "spikes":
        x = (torch.rand(shape, generator=g) < 0.1).float()
    else:
        x = 0.3 * torch.randn(shape, generator=g)
    w = (torch.rand((cout, shape[-1], k, k), generator=g) * 2 - 1) * (
        1 / (shape[-1] * k * k)) ** 0.5
    gy = 1e-2 * torch.randn(shape[:3] + (cout,), generator=g)
    x, w, gy = (t.to(dev, torch.bfloat16) for t in (x, w, gy))
    before = dict(native.LAUNCHES)
    y = conv2d_same(x, w)
    dw = conv2d_dw_kernel(x, gy, k)
    # the deep maps' K1 and B2 count under the wgmma route's names
    k1, b2 = (_route(kernel, x, cout, k) for kernel in ("conv2d_same",
                                                       "conv2d_dw"))
    assert native.LAUNCHES[k1] == before[k1] + 1
    assert native.LAUNCHES[b2] == before[b2] + 1
    assert native.LAUNCHES["conv2d_same"] == before["conv2d_same"]
    assert native.LAUNCHES["conv2d_dw"] == before["conv2d_dw"]
    _bf16_close(y, conv2d_same_plain(x, w), ATOL)
    ref = conv2d_dw_plain(x, gy, k)
    _bf16_close(dw, ref, SUM_RTOL * float(ref.float().abs().max()))
    assert torch.equal(y, conv2d_same(x, w))
    assert torch.equal(dw, conv2d_dw_kernel(x, gy, k))


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("b,h,w,cin,c,rec", BF16_CELLS)
def test_bf16_cell_kernels_match_plain(dev, b, h, w, cin, c, rec, hard):
    """K2 on bfloat16 x, w, v, z (and z_rec, w_rec) with float32 leak and
    thresh, then B4 on its saved maps and bfloat16 cotangents: their
    bfloat16 variants launch, v', g_cur and g_vin within one ulp of the
    plain versions, spikes equal away from the threshold of the float32
    v', the leak and threshold sums float32 within SUM_RTOL, twice
    bitwise equal."""
    g = _gen()
    bf = torch.bfloat16
    if cin == 2:
        x = torch.poisson(torch.full((b, h, w, cin), 0.3), generator=g)
    else:
        x = (torch.rand((b, h, w, cin), generator=g) < 0.1).float()
    wt = (torch.rand((c, cin, 3, 3), generator=g) * 2 - 1) * (1 / cin) ** 0.5
    wr = (torch.rand((c, c, 3, 3), generator=g) * 2 - 1) * (1 / c) ** 0.5
    thresh = (0.8 + 0.1 * torch.randn(c, generator=g)).to(dev)
    leak = torch.sigmoid(-4 + 0.1 * torch.randn(c, generator=g)).to(dev)
    v = thresh.cpu() + 0.3 * torch.randn((b, h, w, c), generator=g)
    z = (torch.rand((b, h, w, c), generator=g) < 0.1).float()
    x, wt, wr, v, z = (t.to(dev, bf) for t in (x, wt, wr, v, z))

    def cell(fn, fn_rec, *ts):
        if rec:
            return fn_rec(*ts[:3], ts[3], ts[4], ts[4], leak, thresh, 3, hard)
        return fn(ts[0], ts[1], ts[3], ts[4], leak, thresh, 3, hard)

    name = "fused_conv_lif_rec_bf16" if rec else "fused_conv_lif_bf16"
    before = native.LAUNCHES[name]
    vo, zo = cell(fused_conv_lif, fused_conv_lif_rec, x, wt, wr, v, z)
    assert native.LAUNCHES[name] == before + 1
    vp, zp = cell(fused_conv_lif_plain, fused_conv_lif_rec_plain, x, wt, wr,
                  v, z)
    v32, _ = cell(fused_conv_lif_plain, fused_conv_lif_rec_plain,
                  *(t.float() for t in (x, wt, wr, v, z)))
    _bf16_close(vo, vp, ATOL)
    assert zo.dtype == torch.bfloat16
    flips = zo != zp
    near = (v32 - thresh).abs() < NEAR
    assert not (flips & ~near).any() and 0.0 < float(zp.float().mean()) < 1.0
    assert all(map(torch.equal, (vo, zo), cell(
        fused_conv_lif, fused_conv_lif_rec, x, wt, wr, v, z)))

    args = (v, z, vo, leak, thresh, (1e-2 * torch.randn(
        v.shape, generator=g)).to(dev, bf), (1e-2 * torch.randn(
            v.shape, generator=g)).to(dev, bf), hard, "arctanspike", 10.0)
    before = native.LAUNCHES["fused_lif_bwd_bf16"]
    got = fused_lif_bwd_kernel(*args)
    assert native.LAUNCHES["fused_lif_bwd_bf16"] == before + 1
    ref = fused_lif_bwd_plain(*args)
    for a, r in zip(got[:2], ref[:2]):
        _bf16_close(a, r, 1e-7)
    for a, r in zip(got[2:], ref[2:]):
        assert a.dtype == torch.float32
        assert float((a - r).abs().max()) <= SUM_RTOL * float(r.abs().max())
    assert all(torch.equal(a, r) for a, r in zip(
        got, fused_lif_bwd_kernel(*args)))


def test_bf16_update_bitwise_repeatable_with_f32_state(dev):
    """One bfloat16 LIFFireNet update, run twice from one state: bitwise
    equal loss and gradients, only the bfloat16 variants (and K3)
    launched, the parameters, Adam's state and the carried state
    float32."""
    from event_flow_tpu_torch.config import TRAIN_SNN
    from event_flow_tpu_torch.data.stream import SyntheticWindowStream
    from event_flow_tpu_torch.train.loop import Trainer

    cfg = copy.deepcopy(TRAIN_SNN)
    cfg["loader"].update(batch_size=2, resolution=[64, 64])
    cfg["data"].update(window=300, window_loss=900)
    runs = []
    for _ in range(2):
        trainer = Trainer(cfg, dev, precision="bfloat16")
        stream = SyntheticWindowStream(cfg)
        native.reset_launch_counts()
        loss = None
        while loss is None:
            loss = trainer.feed(stream.next_batch())
        runs.append((loss, [p.grad.clone() for p in
                            trainer.model.parameters()]))
        launched = {k for k, n in native.LAUNCHES.items() if n}
        assert launched == {"scatter_add", "conv2d_same_bf16",
                            "fused_conv_lif_bf16", "fused_conv_lif_rec_bf16",
                            "conv2d_dw_bf16", "fused_lif_bwd_bf16"}
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    opt = trainer.state.optimizer.state_dict()["state"]
    tensors = (list(trainer.model.parameters())
               + [t for s in opt.values() for t in s.values()
                  if isinstance(t, torch.Tensor)]
               + [t for s in trainer.state.model_state for t in s])
    assert all(t.dtype == torch.float32 for t in tensors
               if t.is_floating_point())


@pytest.mark.parametrize("kind", ["strided", "transposed"])
def test_bf16_cudnn_convs_under_deterministic_algorithms(dev, kind):
    """conv2d_strided and conv_transpose2x on bfloat16 (cuDNN's bfloat16
    conv, outside any kernel of the port as in JAX): forward, dx and dw
    bfloat16, twice bitwise equal under torch.use_deterministic_algorithms,
    within 1e-2 of max of the CPU's (float32 sums rounded once; a bfloat16
    ulp is 2^-8 of a value)."""
    from event_flow_tpu_torch.ops.conv import conv_transpose2x

    g = _gen()
    if kind == "strided":
        shape, cout = ENCODER_SHAPES[1]
        wshape = (cout, shape[3], 3, 3)
        oshape = (shape[0], shape[1] // 2, shape[2] // 2, cout)
        conv = lambda x, w: conv2d_strided(x, w, 2)
    else:
        shape, cout = TRANSPOSED_SHAPES[1]
        wshape = (shape[3], cout, 3, 3)
        oshape = (shape[0], 2 * shape[1], 2 * shape[2], cout)
        conv = conv_transpose2x
    x = torch.randn(shape, generator=g).to(torch.bfloat16)
    w = (0.05 * torch.randn(wshape, generator=g)).to(torch.bfloat16)
    gy = torch.randn(oshape, generator=g).to(torch.bfloat16)

    def run(d):
        xs = x.to(d).requires_grad_()
        ws = w.to(d).requires_grad_()
        with torch.enable_grad():
            y = conv(xs, ws)
            return (y.detach(),) + torch.autograd.grad(y, (xs, ws),
                                                       gy.to(d))

    torch.use_deterministic_algorithms(True)
    try:
        runs = [run(dev), run(dev)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for got, ref in zip(runs[0], run("cpu")):
        assert got.dtype == ref.dtype == torch.bfloat16
        err = float((got.cpu().float() - ref.float()).abs().max())
        assert err <= 1e-2 * float(ref.float().abs().max()), err


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_avg_pool_and_upsample_card_vs_cpu(dev, stride):
    """The PLIF/XLIF trace's avg_pool on a bfloat16 one-channel NHWC map
    (the permuted case whose float32 CUDA backward was wrong, PR 9) and
    the decoders' bilinear x2 upsampling, forward and backward in
    bfloat16: within 1e-2 of max of the CPU's, twice bitwise equal."""
    from event_flow_tpu_torch.ops.resize import avg_pool, upsample2x_bilinear

    g = _gen()
    cases = [(lambda t: avg_pool(t, 3, stride, 1),
              torch.rand((8, 128, 128, 1), generator=g)),
             (upsample2x_bilinear, torch.randn((8, 16, 16, 514),
                                               generator=g))]
    for fn, x in cases:
        x = x.to(torch.bfloat16)
        outs = {}
        for d in ("cpu", dev, dev):
            xd = x.to(d).requires_grad_()
            with torch.enable_grad():
                y = fn(xd)
                gy = torch.ones_like(y).cumsum(1) / y.shape[1]
                gx, = torch.autograd.grad(y, xd, gy)
            outs.setdefault(str(d), []).append((y.detach().cpu(), gx.cpu()))
        (y, gx), = outs["cpu"]
        (y1, gx1), (y2, gx2) = outs[str(dev)]
        assert y1.dtype == gx1.dtype == torch.bfloat16
        assert torch.equal(y1, y2) and torch.equal(gx1, gx2)
        for a, r in ((y1, y), (gx1, gx)):
            err = float((a.float() - r.float()).abs().max())
            assert err <= 1e-2 * float(r.float().abs().max()), err


# The bf16 mainloops' fragment loads (ldmatrix on the halo tile and the
# weight or g tile, mma.sync m16n8k16) at every staging path they meet:
# input channels 1 to 1026 (16-, 8-, 4-byte copies and 2-byte stores;
# passes of 8 mod 16 channels end in a half k16 step; B2 pads a tap's rows
# to 8 channels), output channels 2 to 256 (n8 tiles of 8 and 32
# columns), k 1, 3 and 5, on dense randn inputs, on a ragged map (partial
# 8 x 32 tiles, B2 tiles of 32 x 4) and on an 8-wide map with an odd
# number of rows (B2's 8 x 7 tile ends in a half k16 step). Bounds as
# above, one bf16 ulp plus ATOL, or plus SUM_RTOL of the largest |dw|;
# each test prints its largest error beyond the ulp in units of that
# term, and its docstring gives the largest over its cases on an NVIDIA
# H100 80GB HBM3 at 700 W.
BF16_CIN = [1, 2, 3, 5, 8, 16, 24, 32, 130, 514, 1026]
BF16_COUT = [2, 7, 8, 32, 256]
BF16_MAPS = [(2, 10, 37), (1, 7, 5)]


def _bf16_err(got, ref, atol):
    """_bf16_close, and the largest |got - ref| beyond one ulp in units of
    atol (0 when every value is within one ulp)."""
    _bf16_close(got, ref, atol)
    excess = (got.float() - ref.float()).abs() - native.bf16_ulp(got, ref)
    return float(excess.clamp(min=0).max()) / atol


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("cin", BF16_CIN)
def test_bf16_conv_fragment_paths(dev, cin, k):
    """K1 and B2 in bfloat16 at every output channel count and map above:
    within the bounds of their bf16 plain versions, twice bitwise equal.
    Largest error beyond one ulp measured: K1 0.131 ATOL (Cin 1026, k 5),
    B2 0.0122 SUM_RTOL (Cin 1026, k 5)."""
    g = _gen()
    worst = [0.0, 0.0]
    for cout in BF16_COUT:
        for b, h, w in BF16_MAPS:
            x = torch.randn((b, h, w, cin), generator=g)
            wt = (torch.rand((cout, cin, k, k), generator=g) * 2 - 1) * (
                1 / (cin * k * k)) ** 0.5
            gy = 1e-2 * torch.randn((b, h, w, cout), generator=g)
            x, wt, gy = (t.to(dev, torch.bfloat16) for t in (x, wt, gy))
            y = conv2d_same(x, wt)
            worst[0] = max(worst[0], _bf16_err(
                y, conv2d_same_plain(x, wt), ATOL))
            assert torch.equal(y, conv2d_same(x, wt))
            dw = conv2d_dw_kernel(x, gy, k)
            ref = conv2d_dw_plain(x, gy, k)
            atol = SUM_RTOL * float(ref.float().abs().max())
            worst[1] = max(worst[1], _bf16_err(dw, ref, atol))
            assert torch.equal(dw, conv2d_dw_kernel(x, gy, k))
    print(f"[bf16 fragments] Cin {cin} k {k}: beyond one ulp K1 "
          f"{worst[0]:.3g} ATOL, B2 {worst[1]:.3g} SUM_RTOL")


@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("cin", BF16_CIN)
def test_bf16_cell_fragment_paths(dev, cin, k, rec):
    """K2 in bfloat16, feedforward or recurrent, hard and soft reset, at
    every output channel count and map above: v' within one ulp plus ATOL
    of the bf16 plain version, spikes equal away from the threshold of the
    float32 v', twice bitwise equal. Largest error beyond one ulp
    measured: 0.0954 ATOL (Cin 514 and 1026, k 5)."""
    g = _gen()
    worst = 0.0
    for cout in BF16_COUT:
        for b, h, w in BF16_MAPS:
            x = torch.randn((b, h, w, cin), generator=g)
            wt = (torch.rand((cout, cin, k, k), generator=g) * 2 - 1) * (
                1 / (cin * k * k)) ** 0.5
            wr = (torch.rand((cout, cout, k, k), generator=g) * 2 - 1) * (
                1 / (cout * k * k)) ** 0.5
            thresh = (0.8 + 0.1 * torch.randn(cout, generator=g)).to(dev)
            leak = torch.sigmoid(torch.randn(cout, generator=g)).to(dev)
            v = thresh.cpu() + 0.3 * torch.randn((b, h, w, cout), generator=g)
            z = (torch.rand((b, h, w, cout), generator=g) < 0.2).float()
            x, wt, wr, v, z = (t.to(dev, torch.bfloat16)
                               for t in (x, wt, wr, v, z))
            for hard in (True, False):
                def cell(fn, fn_rec, x, wt, wr, v, z):
                    if rec:
                        return fn_rec(x, wt, wr, v, z, z, leak, thresh, k,
                                      hard)
                    return fn(x, wt, v, z, leak, thresh, k, hard)

                vo, zo = cell(fused_conv_lif, fused_conv_lif_rec, x, wt, wr,
                              v, z)
                vp, zp = cell(fused_conv_lif_plain, fused_conv_lif_rec_plain,
                              x, wt, wr, v, z)
                v32, _ = cell(fused_conv_lif_plain, fused_conv_lif_rec_plain,
                              *(t.float() for t in (x, wt, wr, v, z)))
                worst = max(worst, _bf16_err(vo, vp, ATOL))
                flips = zo != zp
                near = (v32 - thresh).abs() < NEAR
                assert not (flips & ~near).any()
                assert all(map(torch.equal, (vo, zo), cell(
                    fused_conv_lif, fused_conv_lif_rec, x, wt, wr, v, z)))
    print(f"[bf16 fragments] K2 Cin {cin} k {k} rec {rec}: beyond one ulp "
          f"{worst:.3g} ATOL")


@pytest.mark.parametrize("shape,chunked", [((8, 128, 128, 32, 32), True),
                                           ((8, 8, 8, 512, 512), False)])
@pytest.mark.parametrize("inputs", ["spikes", "randn"])
def test_bf16_conv_dw_split_and_unsplit(dev, shape, chunked, inputs):
    """B2 in bfloat16 at k 3 where the pixels are split into chunks
    (FireNet's 32 -> 32 on 128 x 128: one output tile) and where they are
    not (the U-Net's 512 -> 512 on 8 x 8: 256 output tiles): within one
    ulp plus SUM_RTOL of the largest |dw| of the bf16 plain version, twice
    bitwise equal. Largest error beyond one ulp measured: 0.0157 SUM_RTOL
    (32 -> 32, randn), 0.00672 (512 -> 512, randn), 0 on spikes."""
    b, h, w, cin, cout = shape
    chunks = b2_plan(b, h, w, cin, cout, 3, 2,
                     sm_count(torch.device(dev))).chunks
    assert (chunks > 1) == chunked
    g = _gen()
    if inputs == "spikes":
        x = (torch.rand((b, h, w, cin), generator=g) < 0.1).float()
    else:
        x = torch.randn((b, h, w, cin), generator=g)
    gy = 1e-3 * torch.randn((b, h, w, cout), generator=g)
    x, gy = (t.to(dev, torch.bfloat16) for t in (x, gy))
    dw = conv2d_dw_kernel(x, gy, 3)
    ref = conv2d_dw_plain(x, gy, 3)
    atol = SUM_RTOL * float(ref.float().abs().max())
    print(f"[bf16 fragments] B2 {shape} {inputs}, {chunks} chunks: beyond "
          f"one ulp {_bf16_err(dw, ref, atol):.3g} SUM_RTOL")
    assert torch.equal(dw, conv2d_dw_kernel(x, gy, 3))


# int8 serving: K1-s8 and K2-s8 (csrc/conv.cu, csrc/fused_lif.cu) against
# their plain versions. Integer sums are exact and both round each later
# operation alike, so K1-s8 and K2-s8 are bitwise their plain versions.
S8_CIN = (1, 2, 5, 8, 16, 24, 32, 33, 48, 64, 130, 258)


def _s8_args(g, dev, b, h, w, cin, cout, k, rec=False):
    from event_flow_tpu_torch.ops.quant import int8_operands

    x = torch.randn((b, h, w, cin), generator=g)
    wt = 0.3 * torch.randn((cout, cin, k, k), generator=g)
    acts, weights = (x,), (wt,)
    if rec:
        acts += ((torch.rand((b, h, w, cout), generator=g) < 0.2).float(),)
        weights += (0.3 * torch.randn((cout, cout, k, k), generator=g),)
    with torch.no_grad():
        qa, qw, scale = int8_operands("s8 test", acts, weights)
    ints = (qa[0], qw[0], qw[1], qa[1]) if rec else (qa[0], qw[0])
    return tuple(t.to(dev) for t in ints), scale.to(dev)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("cin", S8_CIN)
def test_s8_conv_kernel_matches_plain_bitwise(dev, cin, k):
    """K1-s8 at every copy width (Cin 1 to 258: 1-, 2-, 4-, 8- and
    16-byte staging), one and several passes, Cout 2, 9 and 40, ragged
    maps: bitwise its plain version, twice."""
    from event_flow_tpu_torch.ops.conv import (conv2d_same_s8_kernel,
                                               conv2d_same_s8_plain)

    g = _gen()
    for b, h, w, cout in ((1, 9, 35, 2), (2, 18, 30, 9), (1, 17, 33, 40)):
        (xq, wq), scale = _s8_args(g, dev, b, h, w, cin, cout, k)
        y = conv2d_same_s8_kernel(xq, wq, scale)
        assert y.dtype == torch.float32
        assert torch.equal(y, conv2d_same_s8_plain(xq, wq, scale))
        assert torch.equal(y, conv2d_same_s8_kernel(xq, wq, scale))


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("cin,cout", [(2, 32), (32, 32), (5, 7), (33, 9),
                                      (130, 64), (512, 512)])
def test_s8_cell_kernels_match_plain_bitwise(dev, cin, cout, rec, hard):
    """K2-s8 ff and rec against their plain versions: v' and z' bitwise,
    twice."""
    from event_flow_tpu_torch.ops.fused_lif import (
        _ff_s8_kernel, _rec_s8_kernel, fused_conv_lif_rec_s8_plain,
        fused_conv_lif_s8_plain)

    g = _gen()
    b, h, w = (1, 12, 15) if cin == 512 else (2, 20, 37)
    ints, scale = _s8_args(g, dev, b, h, w, cin, cout, 3, rec)
    v = (0.3 * torch.randn((b, h, w, cout), generator=g)).to(dev)
    z = (torch.rand((b, h, w, cout), generator=g) < 0.2).float().to(dev)
    leak = torch.sigmoid(torch.randn(cout, generator=g)).to(dev)
    thresh = (0.2 + 0.1 * torch.rand(cout, generator=g)).to(dev)
    if rec:
        xq, wq, wrq, zq = ints

        def run(fn):
            return fn(xq, wq, wrq, scale, v, z, zq, leak, thresh, 3, hard,
                      "arctanspike", 10.0)
        got, ref = run(_rec_s8_kernel), run(fused_conv_lif_rec_s8_plain)
        again = run(_rec_s8_kernel)
    else:
        xq, wq = ints

        def run(fn):
            return fn(xq, wq, scale, v, z, leak, thresh, 3, hard,
                      "arctanspike", 10.0)
        got, ref = run(_ff_s8_kernel), run(fused_conv_lif_s8_plain)
        again = run(_ff_s8_kernel)
    for a, r, a2 in zip(got, ref, again):
        assert torch.equal(a, r) and torch.equal(a, a2)
    assert 0 < float(ref[1].mean()) < 1


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("cin", (1, 5, 32, 33, 258))
def test_s8_bf16_conv_kernel_matches_plain_bitwise(dev, cin, k):
    """K1-s8's bfloat16 variant (the float32 y rounded once) at odd
    widths, one and several passes, Cout 2, 9 and 40, ragged maps: y
    bfloat16, bitwise its plain form, twice, and one launch counted under
    its own name."""
    from event_flow_tpu_torch.ops.conv import (conv2d_same_s8_bf16_plain,
                                               conv2d_same_s8_kernel)

    g = _gen()
    for b, h, w, cout in ((1, 9, 35, 2), (2, 18, 30, 9), (1, 17, 33, 40)):
        (xq, wq), scale = _s8_args(g, dev, b, h, w, cin, cout, k)
        native.reset_launch_counts()
        y = conv2d_same_s8_kernel(xq, wq, scale, torch.bfloat16)
        assert native.LAUNCHES["conv2d_same_s8_bf16"] == 1
        assert native.LAUNCHES["conv2d_same_s8"] == 0
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, conv2d_same_s8_bf16_plain(xq, wq, scale))
        assert torch.equal(y, conv2d_same_s8_kernel(xq, wq, scale,
                                                    torch.bfloat16))


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("cin,cout", [(2, 32), (5, 7), (33, 9), (130, 64),
                                      (512, 512)])
def test_s8_bf16_cell_kernels_match_plain_bitwise(dev, cin, cout, rec, hard):
    """K2-s8's bfloat16 variants, ff and rec, on bfloat16 v and z (every
    operation of the update rounded to bfloat16, JAX's XLA cell under
    int8 and the bfloat16 policy) against their plain forms: v' and z'
    bfloat16 and bitwise, twice."""
    from event_flow_tpu_torch.ops.fused_lif import (
        _ff_s8_kernel, _rec_s8_kernel, fused_conv_lif_rec_s8_plain,
        fused_conv_lif_s8_plain)

    bf = torch.bfloat16
    g = _gen()
    b, h, w = (1, 12, 15) if cin == 512 else (2, 20, 37)
    ints, scale = _s8_args(g, dev, b, h, w, cin, cout, 3, rec)
    v = (0.3 * torch.randn((b, h, w, cout), generator=g)).to(dev, bf)
    z = (torch.rand((b, h, w, cout), generator=g) < 0.2).to(dev, bf)
    leak = torch.sigmoid(torch.randn(cout, generator=g)).to(dev)
    thresh = (0.2 + 0.1 * torch.rand(cout, generator=g)).to(dev)
    if rec:
        xq, wq, wrq, zq = ints

        def run(fn, **kw):
            return fn(xq, wq, wrq, scale, v, z, zq, leak, thresh, 3, hard,
                      "arctanspike", 10.0, **kw)
        got, ref = run(_rec_s8_kernel, dtype=bf), run(
            fused_conv_lif_rec_s8_plain)
        again = run(_rec_s8_kernel, dtype=bf)
    else:
        xq, wq = ints

        def run(fn, **kw):
            return fn(xq, wq, scale, v, z, leak, thresh, 3, hard,
                      "arctanspike", 10.0, **kw)
        got, ref = run(_ff_s8_kernel, dtype=bf), run(fused_conv_lif_s8_plain)
        again = run(_ff_s8_kernel, dtype=bf)
    for a, r, a2 in zip(got, ref, again):
        assert a.dtype == bf
        assert torch.equal(a, r) and torch.equal(a, a2)
    assert 0 < float(ref[1].float().mean()) < 1


def test_s8_bf16_cuda_tensors_launch_the_variant_or_raise(dev):
    """Under quantized("int8") a bfloat16 CUDA tensor at the public conv
    and cells launches the bfloat16 s8 variants (each counted once, no
    other kernel), and a float32 state at the bfloat16 cell's kernel is
    refused."""
    from event_flow_tpu_torch.ops.fused_lif import _ff_s8_kernel
    from event_flow_tpu_torch.ops.quant import int8_operands, quantized

    bf = torch.bfloat16
    g = _gen()
    x = (torch.rand((1, 16, 20, 8), generator=g) < 0.3).to(dev, bf)
    w = (0.3 * torch.randn((16, 8, 3, 3), generator=g)).to(dev)
    wr = (0.3 * torch.randn((16, 16, 3, 3), generator=g)).to(dev)
    v = torch.zeros((1, 16, 20, 16), device=dev, dtype=bf)
    leak = torch.full((16,), 0.5, device=dev)
    thresh = torch.full((16,), 0.3, device=dev)
    native.reset_launch_counts()
    with quantized("int8"), torch.no_grad():
        y = conv2d_same(x, w)
        vo, zo = fused_conv_lif(x, w, v, v, leak, thresh, 3)
        vr, zr = fused_conv_lif_rec(x, w, wr, v, v, v, leak, thresh, 3)
        (xq,), (wq,), scale = int8_operands("test", (x,), (w,))
    assert y.dtype == vo.dtype == vr.dtype == bf
    assert {k: n for k, n in native.LAUNCHES.items() if n} == {
        "conv2d_same_s8_bf16": 1, "fused_conv_lif_s8_bf16": 1,
        "fused_conv_lif_rec_s8_bf16": 1}
    with pytest.raises(TypeError):
        _ff_s8_kernel(xq, wq, scale, v.float(), v.float(), leak, thresh, 3,
                      True, "arctanspike", 10.0, dtype=bf)


def test_int8_bf16_window_twice_bitwise(dev):
    """One int8-bf16 LIFFireNet engine window at the ECD recipe from the
    same state twice: bitwise, the bfloat16 s8 kernels' launches only,
    the state bfloat16."""
    from event_flow_tpu_torch.config import ECD_LIFFIRENET
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.models.registry import build_model

    cfg = copy.deepcopy(ECD_LIFFIRENET)
    h, w = cfg["loader"]["resolution"]
    g = _gen()
    ev = torch.stack([torch.sort(torch.rand(15000, generator=g)).values,
                      torch.randint(0, h, (15000,), generator=g).float(),
                      torch.randint(0, w, (15000,), generator=g).float(),
                      torch.randint(0, 2, (15000,), generator=g).float() * 2
                      - 1], -1)
    engine = InferenceEngine(cfg, build_model(cfg, dev), dev,
                             quantize="int8", precision="bfloat16")
    flows = []
    for _ in range(2):
        engine.reset()
        native.reset_launch_counts()
        flows.append(engine.step(ev.to(dev)))
        assert {k: n for k, n in native.LAUNCHES.items() if n} == {
            "fused_conv_lif_s8_bf16": 5, "fused_conv_lif_rec_s8_bf16": 2,
            "conv2d_same_s8_bf16": 1, "scatter_add": 1}
        assert all(t.dtype == torch.bfloat16 for s in engine._state
                   for t in s)
    assert torch.equal(flows[0], flows[1]) and flows[0].dtype == torch.float32
    assert torch.isfinite(flows[0]).all() and flows[0].abs().max() > 0


def test_int8_window_twice_bitwise(dev):
    """One int8 LIFFireNet engine window at the ECD recipe, from the same
    state twice: bitwise, with the s8 kernels' launches and no float
    K1/K2."""
    from event_flow_tpu_torch.config import ECD_LIFFIRENET
    from event_flow_tpu_torch.eval.predict import InferenceEngine
    from event_flow_tpu_torch.models.registry import build_model

    cfg = copy.deepcopy(ECD_LIFFIRENET)
    h, w = cfg["loader"]["resolution"]
    g = _gen()
    ev = torch.stack([torch.sort(torch.rand(15000, generator=g)).values,
                      torch.randint(0, h, (15000,), generator=g).float(),
                      torch.randint(0, w, (15000,), generator=g).float(),
                      torch.randint(0, 2, (15000,), generator=g).float() * 2
                      - 1], -1)
    engine = InferenceEngine(cfg, build_model(cfg, dev), dev,
                             quantize="int8")
    flows = []
    for _ in range(2):
        engine.reset()
        native.reset_launch_counts()
        flows.append(engine.step(ev.to(dev)))
        assert native.LAUNCHES["fused_conv_lif_s8"] == 5
        assert native.LAUNCHES["fused_conv_lif_rec_s8"] == 2
        assert native.LAUNCHES["conv2d_same_s8"] == 1
        assert native.LAUNCHES["conv2d_same"] == 0
        assert native.LAUNCHES["fused_conv_lif"] == 0
    assert torch.equal(flows[0], flows[1])
    assert torch.isfinite(flows[0]).all() and flows[0].abs().max() > 0


# The persistent int8 mainloop (csrc/conv_s8.cuh; its plan ops/s8_plan.py)
# at every shape chip_smoke.py holds it at: K1_S8, K2_S8 and the plan's
# edges (a map smaller than one tile, B 2 with odd H and W, more tiles
# than resident blocks, Cout 2, 7 and 9; split over a cluster where the
# items are fewer than the SMs). K1-s8 and K2-s8 (both resets) in both
# output and state types, bitwise their plain forms, twice.
def _s8_shapes():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    k1 = [(b, h, w, cin, cout, k, False)
          for b, h, w, cin, cout, k, _ in chip_smoke.K1_S8]
    k2 = [(b, h, w, cin, cout, 3, rec)
          for b, h, w, cin, cout, rec in chip_smoke.K2_S8]
    edges = list(chip_smoke.S8_EDGES)
    return ([("K1", s) for s in k1 + edges]
            + [("K2", s) for s in k2 + edges])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,shape", _s8_shapes())
def test_s8_mainloop_bitwise_at_path_and_edge_shapes(dev, kernel, shape,
                                                     dtype):
    from event_flow_tpu_torch.ops.conv import (conv2d_same_s8_bf16_plain,
                                               conv2d_same_s8_kernel,
                                               conv2d_same_s8_plain)
    from event_flow_tpu_torch.ops.fused_lif import (
        _ff_s8_kernel, _rec_s8_kernel, fused_conv_lif_rec_s8_plain,
        fused_conv_lif_s8_plain)

    b, h, w, cin, cout, k, rec = shape
    g = _gen()
    if kernel == "K1":
        (xq, wq), scale = _s8_args(g, dev, b, h, w, cin, cout, k)
        plain = (conv2d_same_s8_plain if dtype == torch.float32
                 else conv2d_same_s8_bf16_plain)
        ref = plain(xq, wq, scale)
        for _ in range(2):
            y = conv2d_same_s8_kernel(xq, wq, scale, dtype)
            assert y.dtype == dtype and torch.equal(y, ref)
        return
    ints, scale = _s8_args(g, dev, b, h, w, cin, cout, k, rec)
    v = (0.3 * torch.randn((b, h, w, cout), generator=g)).to(dev, dtype)
    z = (torch.rand((b, h, w, cout), generator=g) < 0.2).to(dev, dtype)
    leak = torch.sigmoid(torch.randn(cout, generator=g)).to(dev)
    thresh = (0.2 + 0.1 * torch.rand(cout, generator=g)).to(dev)
    for hard in (True, False):
        if rec:
            xq, wq, wrq, zq = ints
            args = (xq, wq, wrq, scale, v, z, zq, leak, thresh, k, hard,
                    "arctanspike", 10.0)
            kern, plain = _rec_s8_kernel, fused_conv_lif_rec_s8_plain
        else:
            xq, wq = ints
            args = (xq, wq, scale, v, z, leak, thresh, k, hard,
                    "arctanspike", 10.0)
            kern, plain = _ff_s8_kernel, fused_conv_lif_s8_plain
        ref = plain(*args)
        for _ in range(2):
            got = kern(*args, dtype=dtype)
            for a, r in zip(got, ref):
                assert a.dtype == dtype and torch.equal(a, r)


# K1 and B2 on their plans (ops/conv_plan.py; K1 on the persistent float
# mainloop of csrc/conv_ring.cuh, or on the one-image tile of
# csrc/conv_tile.cuh) in both types, each against its plain version and
# run twice bitwise equal: the deep shapes of the gates and the U-Nets
# (four 8 x 8 images a K1 tile, two a B2 tile; K split over a cluster at
# serving's two 1 x 12 x 15 gates only), input channel counts whose pixel
# rows are not whole 16-byte rows (2, 130, 258, 514, 1026: K1's one-image
# tile, B2's thread copies instead of TMA), heads of 8 or fewer output
# channels (a 1 x 1 head of 32 input channels on K1's one-image tile), k
# 1, 3 and 5, B 1 and 8, maps smaller than a tile, and maps whose tiles
# straddle two images (3 or 5 images, the last tile partly past B).
CONV_PLAN_CASES = [
    (8, 8, 8, 1024, 1024, 3, "randn"), (8, 8, 8, 1024, 512, 3, "randn"),
    (1, 12, 15, 1024, 1024, 3, "randn"), (1, 12, 15, 1024, 512, 3, "randn"),
    (8, 16, 16, 512, 1024, 3, "randn"), (8, 8, 8, 512, 512, 3, "spikes"),
    (8, 16, 16, 1024, 256, 3, "spikes"), (8, 16, 16, 256, 2, 1, "spikes"),
    (2, 12, 15, 2, 32, 3, "counts"), (2, 9, 13, 130, 64, 3, "flow"),
    (1, 10, 12, 258, 40, 5, "flow"), (3, 8, 8, 514, 9, 3, "flow"),
    (1, 6, 7, 1026, 7, 1, "flow"), (8, 4, 4, 64, 32, 3, "randn"),
    (3, 8, 8, 32, 16, 5, "randn"), (5, 8, 16, 48, 24, 3, "randn"),
    (2, 20, 36, 32, 2, 1, "spikes")]


def _conv_plan_inputs(dev, case, dtype):
    b, h, w, cin, cout, k, kind = case
    g = _gen()
    shape = (b, h, w, cin)
    if kind == "randn":
        x = 0.5 * torch.randn(shape, generator=g)
    elif kind == "counts":
        x = torch.poisson(torch.full(shape, 0.3), generator=g)
    else:
        x = (torch.rand(shape, generator=g) < 0.1).float()
        if kind == "flow":
            x[..., -2:] = torch.randn(shape[:3] + (2,), generator=g)
    wt = (torch.rand((cout, cin, k, k), generator=g) * 2 - 1) * (
        1 / (k * k * cin)) ** 0.5
    gy = 1e-3 * torch.randn((b, h, w, cout), generator=g)
    return (t.to(dev, dtype) for t in (x, wt, gy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_PLAN_CASES)
def test_conv_kernel_on_its_plan(dev, case, dtype):
    """K1 against its plain version (float32: ATOL; bfloat16: one ulp plus
    ATOL), one launch a call, twice bitwise equal."""
    b, h, w, cin, cout, k, _ = case
    x, wt, _ = _conv_plan_inputs(dev, case, dtype)
    plan = k1_plan(b, h, w, cin, cout, k, x.element_size(),
                   sm_count(torch.device(dev)))
    if (b, h, w) == (1, 12, 15):  # the split path stays under test
        assert plan.slices > 1, plan
    name = _route("conv2d_same", x, cout, k)
    assert plan.wgmma == name.endswith("wgmma_bf16")
    before = native.LAUNCHES[name]
    y = conv2d_same(x, wt)
    assert native.LAUNCHES[name] == before + 1
    ref = conv2d_same_plain(x, wt)
    if dtype == torch.bfloat16:
        _bf16_close(y, ref, ATOL)
    else:
        torch.testing.assert_close(y, ref, atol=ATOL, rtol=1e-5)
    assert torch.equal(y, conv2d_same(x, wt)), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CONV_PLAN_CASES)
def test_conv_dw_kernel_on_its_plan(dev, case, dtype):
    """B2 against its plain version within SUM_RTOL of the largest |dw|
    (bfloat16: plus one ulp), one launch a call, twice bitwise equal."""
    b, h, w, cin, cout, k, _ = case
    x, _, gy = _conv_plan_inputs(dev, case, dtype)
    plan = b2_plan(b, h, w, cin, cout, k, x.element_size(),
                   sm_count(torch.device(dev)))
    name = _route("conv2d_dw", x, cout, k)
    assert plan.wgmma == name.endswith("wgmma_bf16")
    before = native.LAUNCHES[name]
    dw = conv2d_dw_kernel(x, gy, k)
    assert native.LAUNCHES[name] == before + 1
    assert dw.shape == (cout, cin, k, k) and dw.dtype == dtype
    ref = conv2d_dw_plain(x, gy, k)
    if dtype == torch.bfloat16:
        _bf16_close(dw, ref, SUM_RTOL * float(ref.float().abs().max()))
    else:
        assert_close_to_max(dw, ref)
    assert torch.equal(dw, conv2d_dw_kernel(x, gy, k)), plan


# bfloat16 K1 and B2 on the wgmma route (csrc/conv_wgmma.cuh), (B, H, W,
# Cin, Cout): every deep shape of chip_smoke.py's GATE_SHAPES and B2_UNET
# (UNET_K1's heads are 1 x 1, off the route), then images past B in tiles
# of two 8 x 8 images with Cout off K1's groups of 128 and B2's 64, and
# tiles overhanging a 9 x 11 map at 5 images and 576 channels
WGMMA_CASES = [(8, 8, 8, 1024, 1024), (8, 8, 8, 1024, 512),
               (1, 12, 15, 1024, 1024), (1, 12, 15, 1024, 512),
               (8, 16, 16, 512, 1024), (8, 8, 8, 512, 512),
               (8, 16, 16, 1024, 256), (3, 8, 8, 512, 200),
               (5, 9, 11, 576, 72)]


@pytest.mark.parametrize("kind", ["spikes", "randn"])
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_wgmma_kernels_match_plain(dev, case, kind):
    """K1 and B2 on the wgmma route: one launch each under their own
    counts, within one bf16 ulp plus ATOL (B2: plus SUM_RTOL of the
    largest |dw|) of their plain versions, twice bitwise equal."""
    b, h, w, cin, cout = case
    x, wt, gy = _conv_plan_inputs(dev, (b, h, w, cin, cout, 3, kind),
                                  torch.bfloat16)
    sms = sm_count(torch.device(dev))
    assert k1_plan(b, h, w, cin, cout, 3, 2, sms).wgmma
    assert b2_plan(b, h, w, cin, cout, 3, 2, sms).wgmma
    before = dict(native.LAUNCHES)
    y = conv2d_same(x, wt)
    dw = conv2d_dw_kernel(x, gy, 3)
    moved = {k: n - before[k] for k, n in native.LAUNCHES.items()
             if n != before[k]}
    assert moved == {"conv2d_same_wgmma_bf16": 1, "conv2d_dw_wgmma_bf16": 1}
    _bf16_close(y, conv2d_same_plain(x, wt), ATOL)
    ref = conv2d_dw_plain(x, gy, 3)
    _bf16_close(dw, ref, SUM_RTOL * float(ref.float().abs().max()))
    assert torch.equal(y, conv2d_same(x, wt))
    assert torch.equal(dw, conv2d_dw_kernel(x, gy, 3))


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("case", [(8, 8, 8, 1024, 1024),
                                  (1, 12, 15, 1024, 512)])
def test_wgmma_k1_model_axis_shard_bitwise(dev, case, mp):
    """K1 on the wgmma route of a model-axis shard (Cout / mp of the
    layer's output channels) is the whole layer's channels bitwise: its
    tiles, passes and slices come from the shape without Cout."""
    b, h, w, cin, cout = case
    x, wt, _ = _conv_plan_inputs(dev, (b, h, w, cin, cout, 3, "randn"),
                                 torch.bfloat16)
    y = conv2d_same(x, wt)
    n = cout // mp
    for r in range(mp):
        part = conv2d_same(x, wt[r * n:(r + 1) * n].contiguous())
        assert torch.equal(part, y[..., r * n:(r + 1) * n]), r


def _off_16_bytes(t):
    """A contiguous copy of t whose pointer is 2 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


@pytest.mark.parametrize("what", ["x", "g"])
def test_wgmma_route_leaves_misaligned_maps(dev, what):
    """At a bfloat16 deep map (8 x 8 x 8, 512 -> 512) an x (K1 and B2) or
    a g (B2) whose pointer is off 16 bytes, which the wgmma route's TMA
    maps cannot take, leaves the route: K1 and B2 launch their mma.sync
    kernels and match their plain versions."""
    b, h, w, cin, cout = 8, 8, 8, 512, 512
    x, wt, gy = _conv_plan_inputs(dev, (b, h, w, cin, cout, 3, "randn"),
                                  torch.bfloat16)
    sms = sm_count(torch.device(dev))
    assert b2_plan(b, h, w, cin, cout, 3, 2, sms).wgmma
    assert not b2_plan(b, h, w, cin, cout, 3, 2, sms, cin, False).wgmma
    assert not k1_plan(b, h, w, cin, cout, 3, 2, sms, cin, False).wgmma
    xs = _off_16_bytes(x) if what == "x" else x
    gs = _off_16_bytes(gy) if what == "g" else gy
    before = dict(native.LAUNCHES)
    dw = conv2d_dw_kernel(xs, gs, 3)
    y = conv2d_same(xs, wt)
    moved = {k: n - before[k] for k, n in native.LAUNCHES.items()
             if n != before[k]}
    assert moved == ({"conv2d_same_bf16": 1, "conv2d_dw_bf16": 1}
                     if what == "x" else
                     {"conv2d_same_wgmma_bf16": 1, "conv2d_dw_bf16": 1})
    ref = conv2d_dw_plain(x, gy, 3)
    _bf16_close(dw, ref, SUM_RTOL * float(ref.float().abs().max()))
    _bf16_close(y, conv2d_same_plain(x, wt), ATOL)


def _with_nans(t, where):
    """float32 ``t`` with the card's NaN (bits 0x7fffffff, whose rounding
    to TF32 by adding half a unit would carry into the sign bit) at the
    first index of ``where`` and -NaN (0xffffffff) at the second."""
    t = t.clone()
    bits = t.view(torch.int32)
    bits[where[0]] = 0x7fffffff
    bits[where[1]] = -1
    return t


def _window_nans(x, w, k):
    """Where a same conv of x (NHWC) with w (OIHW) must be NaN: a NaN in
    an output's k x k window of x, or in its channel's weights (a NaN
    weight meets a padding zero as well, and NaN * 0 is NaN)."""
    hit = torch.isnan(x).any(-1).double()[:, None]
    win = torch.nn.functional.conv2d(hit, torch.ones(1, 1, k, k,
                                                     dtype=torch.float64),
                                     padding=k // 2)[:, 0] > 0.5
    return win[..., None] | torch.isnan(w).flatten(1).any(1)


def _finite_close(got, ref, mask, atol):
    assert torch.equal(torch.isnan(got), mask)
    torch.testing.assert_close(got[~mask].float(), ref[~mask].float(),
                               atol=atol, rtol=1e-2 if got.dtype ==
                               torch.bfloat16 else 1e-5)


# (B, H, W, Cin, Cout): K1 on the ring and on the one-image tile (130
# channels), B2 by TMA and by the threads' copies; in bfloat16 both on the
# wgmma route at 512 channels, on 12 x 15 maps, whose last tiles overhang
# them
NAN_CASES = [(2, 8, 8, 64, 32), (2, 12, 15, 130, 16),
             (2, 12, 15, 512, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["x", "w"])
@pytest.mark.parametrize("case", NAN_CASES)
def test_conv_kernel_keeps_nans(dev, case, operand, dtype):
    """A NaN or -NaN in K1's x or w (the card's bits) comes out NaN in
    exactly the outputs whose sum over the zero-padded x reads it, as
    IEEE products give it (some backends of the plain version skip the
    padding's products, so the mask is worked out here), and the other
    outputs stay close to the plain version."""
    b, h, w, cin, cout = case
    g = _gen()
    x = 0.5 * torch.randn((b, h, w, cin), generator=g)
    wt = (torch.rand((cout, cin, 3, 3), generator=g) * 2 - 1) * (
        1 / (9 * cin)) ** 0.5
    if operand == "x":
        x = _with_nans(x, [(0, 3, 4, 5), (1, h - 1, 2, cin - 1)])
    else:
        wt = _with_nans(wt, [(3, 5, 1, 1), (cout - 1, cin - 1, 0, 2)])
    plan = k1_plan(b, h, w, cin, cout, 3, 4 if dtype == torch.float32
                   else 2, sm_count(torch.device(dev)))
    assert plan.ring == (cin != 130)
    assert plan.wgmma == (cin == 512 and dtype == torch.bfloat16)
    x, wt = x.to(dev, dtype), wt.to(dev, dtype)
    y = conv2d_same(x, wt)
    mask = _window_nans(x.cpu().double(), wt.cpu().double(), 3).to(dev)
    _finite_close(y, conv2d_same_plain(x, wt), mask, ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["x", "g"])
@pytest.mark.parametrize("case", NAN_CASES)
def test_conv_dw_kernel_keeps_nans(dev, case, operand, dtype):
    """A NaN or -NaN in B2's x or g comes out NaN in exactly the dw
    entries that sum it (a NaN in g: its output channel's every entry; in
    x: its input channel's taps that reach it from inside the map), and
    the others stay close to the plain version."""
    b, h, w, cin, cout = case
    g = _gen()
    x = 0.5 * torch.randn((b, h, w, cin), generator=g)
    gy = 1e-3 * torch.randn((b, h, w, cout), generator=g)
    if operand == "x":
        x = _with_nans(x, [(0, 3, 4, 5), (1, h - 1, 2, cin - 1)])
    else:
        gy = _with_nans(gy, [(0, 2, 2, 3), (1, h - 1, w - 1, cout - 1)])
    assert b2_plan(b, h, w, cin, cout, 3, 4 if dtype == torch.float32
                   else 2, sm_count(torch.device(dev))).wgmma == (
        cin == 512 and dtype == torch.bfloat16)
    x, gy = x.to(dev, dtype), gy.to(dev, dtype)
    dw = conv2d_dw_kernel(x, gy, 3)
    reach = conv2d_dw_plain(torch.isnan(x).double().cpu(),
                            torch.ones((b, h, w, 1), dtype=torch.float64),
                            3)[0] > 0.5                  # [Cin, 3, 3]
    mask = (reach[None] | torch.isnan(gy).flatten(0, 2).any(0).cpu()[
        :, None, None, None]).to(dev)
    ref = conv2d_dw_plain(x, gy, 3)
    _finite_close(dw, ref, mask, SUM_RTOL * float(
        ref[~mask].float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["x", "w", "z_rec"])
def test_fused_lif_rec_model_axis_keeps_nans(dev, operand, dtype):
    """K2 rec with Crec != Cout (the ring): a NaN or -NaN in x, the
    weights or z_rec gives v' NaN in exactly the outputs whose current
    reads it, and the others stay close to the plain version."""
    b, h, w, cin, cout, crec = 2, 9, 13, 32, 16, 32
    g = _gen()
    x = (torch.rand((b, h, w, cin), generator=g) < 0.3).float()
    zr = (torch.rand((b, h, w, crec), generator=g) < 0.2).float()
    wt = (torch.rand((cout, cin, 3, 3), generator=g) * 2 - 1) * cin ** -0.5
    wr = (torch.rand((cout, crec, 3, 3), generator=g) * 2 - 1) * crec ** -0.5
    if operand == "x":
        x = _with_nans(x, [(0, 3, 4, 5), (1, h - 1, 2, cin - 1)])
    elif operand == "w":
        wt = _with_nans(wt, [(3, 5, 1, 1), (cout - 1, cin - 1, 0, 2)])
    else:
        zr = _with_nans(zr, [(0, 4, 6, 7), (1, 0, w - 1, crec - 1)])
    thresh = 0.5 + 0.1 * torch.randn(cout, generator=g)
    leak = torch.sigmoid(torch.randn(cout, generator=g))
    v = thresh + 0.3 * torch.randn((b, h, w, cout), generator=g)
    z = (torch.rand((b, h, w, cout), generator=g) < 0.1).float()
    mask = _window_nans(torch.cat([x, zr], -1).double(),
                        torch.cat([wt, wr], 1).double(), 3).to(dev)
    x, zr, wt, wr, v, z = (t.to(dev, dtype) for t in (x, zr, wt, wr, v, z))
    leak, thresh = leak.to(dev), thresh.to(dev)
    with torch.no_grad():
        vk, _ = fused_conv_lif_rec(x, wt, wr, v, z, zr, leak, thresh, 3,
                                   True)
        vp, _ = fused_conv_lif_rec_plain(x, wt, wr, v, z, zr, leak, thresh,
                                         3, True)
    _finite_close(vk, vp, mask, ATOL)


# K2 (ff, and rec with Crec == Cout) on its plan (ops/conv_plan.py::
# k2_plan: the persistent float mainloop of csrc/conv_ring.cuh wherever x's
# and z_rec's pixel rows are whole 16-byte rows, else the one-image tile
# of csrc/conv_tile.cuh), (B, H, W, Cin, Crec, Cout, k; Crec 0: the
# feedforward cell): the spiking U-Net's cells at the training recipe
# (B 8 at 128 x 128) and at serving (every UNET_K2 shape; K split at its
# 1 x 12 x 15 and 1 x 24 x 30 cells of 512 input channels or more),
# LIFFireNet's cells at both, and edges: k 1 and 5, B not a multiple of
# a tile's images (3 and 5 images of 8 x 8), Cout not a multiple of 4 (the
# element-wise epilogue) or of the channel group, maps smaller than a tile
K2_PLAN_CASES = [
    (8, 64, 64, 64, 64, 64, 3), (8, 32, 32, 128, 128, 128, 3),
    (8, 16, 16, 256, 256, 256, 3), (8, 8, 8, 512, 512, 512, 3),
    (8, 8, 8, 512, 0, 512, 3), (8, 16, 16, 1024, 0, 256, 3),
    (8, 32, 32, 514, 0, 128, 3), (8, 64, 64, 258, 0, 64, 3),
    (8, 128, 128, 130, 0, 32, 3),
    (1, 90, 120, 64, 64, 64, 3), (1, 45, 60, 128, 128, 128, 3),
    (1, 23, 30, 256, 256, 256, 3), (1, 12, 15, 512, 512, 512, 3),
    (1, 12, 15, 512, 0, 512, 3), (1, 24, 30, 1024, 0, 256, 3),
    (1, 46, 60, 514, 0, 128, 3), (1, 90, 120, 258, 0, 64, 3),
    (1, 180, 240, 130, 0, 32, 3),
    (8, 128, 128, 32, 0, 32, 3), (8, 128, 128, 32, 32, 32, 3),
    (8, 128, 128, 2, 0, 32, 3), (1, 180, 240, 32, 0, 32, 3),
    (1, 180, 240, 32, 32, 32, 3), (1, 180, 240, 2, 0, 32, 3),
    (2, 12, 15, 32, 32, 32, 1), (3, 8, 8, 64, 0, 48, 5),
    (3, 8, 8, 512, 512, 512, 3), (5, 8, 8, 64, 64, 64, 3),
    (2, 9, 13, 32, 0, 6, 3), (2, 9, 13, 64, 0, 20, 3),
    (2, 9, 13, 32, 24, 24, 3), (1, 5, 6, 32, 32, 32, 3)]


def _k2_case(dev, case, dtype, unaligned=False):
    """x, w, w_rec (None for ff), v, z, leak, thresh of a K2 case: spikes
    at 10 % (event counts at 2 channels), snn-init weights, v spread
    around the threshold; with ``unaligned`` v and z start two elements
    past a 16-byte boundary."""
    b, h, w, cin, crec, cout, k = case
    g = _gen()
    x = (torch.rand((b, h, w, cin), generator=g) < 0.1).float()
    if cin == 2:
        x = torch.poisson(torch.full((b, h, w, cin), 0.3), generator=g)
    wt = (torch.rand((cout, cin, k, k), generator=g) * 2 - 1) * cin ** -0.5
    wr = ((torch.rand((cout, crec, k, k), generator=g) * 2 - 1)
          * crec ** -0.5) if crec else None
    thresh = 0.8 + 0.1 * torch.randn(cout, generator=g)
    leak = torch.sigmoid(-4 + 0.1 * torch.randn(cout, generator=g))
    v = thresh + 0.3 * torch.randn((b, h, w, cout), generator=g)
    z = (torch.rand((b, h, w, cout), generator=g) < 0.1).float()
    x, wt, v, z = (t.to(dev, dtype) for t in (x, wt, v, z))
    if unaligned:
        v, z = (torch.cat([torch.zeros(2, device=dev, dtype=dtype),
                           t.flatten()])[2:].view(t.shape) for t in (v, z))
        assert v.data_ptr() % 16 and z.data_ptr() % 16
    return (x, wt, None if wr is None else wr.to(dev, dtype), v, z,
            leak.to(dev), thresh.to(dev))


def _k2_run(fn, fn_rec, x, wt, wr, v, z, leak, thresh, k, hard):
    if wr is None:
        return fn(x, wt, v, z, leak, thresh, k, hard)
    return fn_rec(x, wt, wr, v, z, z, leak, thresh, k, hard)


def _k2_hold(vk, zk, vp, zp, thresh, dtype):
    """v' within ATOL of the plain form (bfloat16: one ulp plus ATOL),
    spikes equal away from the threshold."""
    if dtype == torch.bfloat16:
        _bf16_close(vk, vp, ATOL)
    else:
        torch.testing.assert_close(vk, vp, atol=ATOL, rtol=0)
    flips = zk != zp
    near = ((vp.float() - thresh).abs()
            < NEAR + 1e-2 * (dtype != torch.float32))
    assert not (flips & ~near).any()
    assert float(flips.float().mean()) <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("case", K2_PLAN_CASES)
def test_fused_lif_kernel_on_its_plan(dev, case, hard, dtype):
    """K2 on its plan (the ring wherever x's and z_rec's pixel rows are
    16-byte rows but at one process's shallow, large calls; K split only
    at serving's 512-channel single images) against its plain form, one
    launch a call, twice bitwise equal."""
    b, h, w, cin, crec, cout, k = case
    x, wt, wr, v, z, leak, thresh = _k2_case(dev, case, dtype)
    esize = x.element_size()
    plan = k2_plan(b, h, w, cin, crec, cout, k, esize,
                   sm_count(torch.device(dev)))
    shallow = (crec in (0, cout) and cout % 32 == 0 and b * h * w >= 32768
               and -(-cin // 32) + -(-crec // 32) <= 4)
    assert plan.ring == ((cin * esize) % 16 == 0
                         and (crec * esize) % 16 == 0 and not shallow), plan
    assert plan.bitwise == (not (b == 1 and cin >= 512 and plan.ring)), plan
    name = native.variant("fused_conv_lif_rec" if crec else "fused_conv_lif",
                          dtype)
    before = native.LAUNCHES[name]
    with torch.no_grad():
        vk, zk = _k2_run(fused_conv_lif, fused_conv_lif_rec, x, wt, wr, v, z,
                         leak, thresh, k, hard)
        assert native.LAUNCHES[name] == before + 1
        vp, zp = _k2_run(fused_conv_lif_plain, fused_conv_lif_rec_plain, x,
                         wt, wr, v, z, leak, thresh, k, hard)
        _k2_hold(vk, zk, vp, zp, thresh, dtype)
        assert all(map(torch.equal, (vk, zk), _k2_run(
            fused_conv_lif, fused_conv_lif_rec, x, wt, wr, v, z, leak,
            thresh, k, hard))), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 9, 13, 32, 0, 32, 3),
                                  (3, 8, 8, 64, 64, 64, 3)])
def test_fused_lif_kernel_unaligned_state(dev, case, dtype):
    """K2 on the ring with v and z off a 16-byte boundary (the element-wise
    epilogue) against its plain form, bitwise the aligned call."""
    x, wt, wr, v, z, leak, thresh = _k2_case(dev, case, dtype, True)
    _, _, _, va, za, _, _ = _k2_case(dev, case, dtype)
    with torch.no_grad():
        vk, zk = _k2_run(fused_conv_lif, fused_conv_lif_rec, x, wt, wr, v, z,
                         leak, thresh, case[-1], True)
        vp, zp = _k2_run(fused_conv_lif_plain, fused_conv_lif_rec_plain, x,
                         wt, wr, v, z, leak, thresh, case[-1], True)
        va_k, za_k = _k2_run(fused_conv_lif, fused_conv_lif_rec, x, wt, wr,
                             va, za, leak, thresh, case[-1], True)
    _k2_hold(vk, zk, vp, zp, thresh, dtype)
    assert torch.equal(vk, va_k) and torch.equal(zk, za_k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("operand", ["x", "w", "z_rec"])
def test_fused_lif_kernel_on_the_ring_keeps_nans(dev, operand, dtype):
    """K2 rec with Crec == Cout on the ring (four 8 x 8 images a tile): a
    NaN or -NaN in x, the weights or z_rec gives v' NaN in exactly the
    outputs whose current reads it, and the others stay close to the plain
    form."""
    b, h, w, cin, c = 3, 8, 8, 64, 32
    g = _gen()
    x = (torch.rand((b, h, w, cin), generator=g) < 0.3).float()
    zr = (torch.rand((b, h, w, c), generator=g) < 0.2).float()
    wt = (torch.rand((c, cin, 3, 3), generator=g) * 2 - 1) * cin ** -0.5
    wr = (torch.rand((c, c, 3, 3), generator=g) * 2 - 1) * c ** -0.5
    if operand == "x":
        x = _with_nans(x, [(0, 3, 4, 5), (2, h - 1, 2, cin - 1)])
    elif operand == "w":
        wt = _with_nans(wt, [(3, 5, 1, 1), (c - 1, cin - 1, 0, 2)])
    else:
        zr = _with_nans(zr, [(0, 4, 6, 7), (1, 0, w - 1, c - 1)])
    thresh = 0.5 + 0.1 * torch.randn(c, generator=g)
    leak = torch.sigmoid(torch.randn(c, generator=g))
    v = thresh + 0.3 * torch.randn((b, h, w, c), generator=g)
    mask = _window_nans(torch.cat([x, zr], -1).double(),
                        torch.cat([wt, wr], 1).double(), 3).to(dev)
    x, zr, wt, wr, v = (t.to(dev, dtype) for t in (x, zr, wt, wr, v))
    leak, thresh = leak.to(dev), thresh.to(dev)
    assert k2_plan(b, h, w, cin, c, c, 3, x.element_size(),
                   sm_count(torch.device(dev))).ring
    with torch.no_grad():
        vk, _ = fused_conv_lif_rec(x, wt, wr, v, zr, zr, leak, thresh, 3,
                                   True)
        vp, _ = fused_conv_lif_rec_plain(x, wt, wr, v, zr, zr, leak, thresh,
                                         3, True)
    _finite_close(vk, vp, mask, ATOL)


# The U-Net decoders' inputs as ops/resize.py::upsample2x_bilinear writes
# them: the [..., :C] view of a buffer of whole 16-byte pixel rows (514,
# 258 and 130 channels at 516, 260, 132 in float32 and 520, 264, 136 in
# bfloat16), which K1, K2 and B2 read in place and TMA stages. The decoder
# shapes (B, H, W, Cin, Cout): RecEVFlowNet's and the spiking U-Net's at
# serving (kernel_timing.py::SERVING_DECODERS) and in training
# (chip_smoke.py's B2_UNET and K2_SHAPES).
DECODERS = [(1, 46, 60, 514, 128), (1, 90, 120, 258, 64),
            (1, 180, 240, 130, 32), (8, 32, 32, 514, 128),
            (8, 64, 64, 258, 64), (8, 128, 128, 130, 32)]


def _padded(x, fill=float("nan")):
    """x as the [..., :C] view of a buffer of whole 16-byte pixel rows,
    the pad holding ``fill``."""
    c = x.shape[-1]
    buf = torch.full((*x.shape[:-1], native.channel_stride(
        c, x.element_size())), fill, dtype=x.dtype, device=x.device)
    view = buf[..., :c]
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 5, 16, 17, 31, 130, 258, 514, 1026])
def test_padded_upsample_bitwise_on_the_card(dev, c, dtype):
    """The upsampling on the card (the pad added to the input where C >= 16,
    else the result copied into the padded buffer) bitwise torch's
    interpolation of the contiguous map, at its padded stride; its
    gradient the fixed-order stencil's."""
    from event_flow_tpu_torch.ops.resize import (upsample2x_bilinear,
                                                 upsample2x_bilinear_grad)

    g = _gen()
    for shape in ((2, 5, 7), (1, 23, 30), (8, 16, 16)):
        x = torch.randn((*shape, c), generator=g).to(dev, dtype)
        y = upsample2x_bilinear(x)
        cs = native.channel_stride(c, x.element_size())
        h, w = 2 * shape[1], 2 * shape[2]
        assert y.stride() == (h * w * cs, w * cs, cs, 1)
        ref = torch.nn.functional.interpolate(
            x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
        assert torch.equal(y, ref), (shape, c)
    xg = x.detach().requires_grad_()
    gy = torch.randn(y.shape, generator=g).to(dev, dtype)
    (gx,) = torch.autograd.grad(upsample2x_bilinear(xg), xg, gy)
    assert torch.equal(gx, upsample2x_bilinear_grad(gy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODERS)
def test_decoder_kernels_on_padded_views(dev, case, dtype):
    """K1 and K2 (the feedforward cell) on a NaN-padded view at the
    decoders' shapes, on their plans (ops/conv_plan.py), against their
    plain forms on the contiguous map (float32 ATOL, bfloat16 one ulp plus
    ATOL; spikes equal away from the threshold), one launch a call;
    bitwise the contiguous map's call (the one-image tile) wherever the
    plan does not split K; in training B2 on the view bitwise B2 on the
    contiguous map."""
    b, h, w, cin, cout = case
    sms = sm_count(torch.device(dev))
    x, wt, gy = _conv_plan_inputs(dev, (b, h, w, cin, cout, 3, "flow"),
                                  dtype)
    xp = _padded(x)
    cs = xp.stride(2)
    plan = k1_plan(b, h, w, cin, cout, 3, x.element_size(), sms, cs)
    assert plan.ring == (dtype == torch.bfloat16 or b == 1
                         or cin == 514), plan
    name = native.variant("conv2d_same", dtype)
    before = native.LAUNCHES[name]
    y = conv2d_same(xp, wt)
    assert native.LAUNCHES[name] == before + 1
    ref = conv2d_same_plain(x, wt)
    if dtype == torch.bfloat16:
        _bf16_close(y, ref, ATOL)
    else:
        torch.testing.assert_close(y, ref, atol=ATOL, rtol=1e-5)
    if plan.bitwise:
        assert torch.equal(y, conv2d_same(x, wt)), plan
    if b > 1:
        assert torch.equal(conv2d_dw_kernel(xp, gy, 3),
                           conv2d_dw_kernel(x, gy, 3))
    xk, wk, _, v, z, leak, thresh = _k2_case(
        dev, (b, h, w, cin, 0, cout, 3), dtype)
    xkp = _padded(xk)
    plan = k2_plan(b, h, w, cin, 0, cout, 3, x.element_size(), sms, cs)
    assert plan.ring == (dtype == torch.bfloat16 or b == 1
                         or cin == 514), plan
    name = native.variant("fused_conv_lif", dtype)
    before = native.LAUNCHES[name]
    with torch.no_grad():
        vk, zk = fused_conv_lif(xkp, wk, v, z, leak, thresh, 3, True)
        assert native.LAUNCHES[name] == before + 1
        vp, zp = fused_conv_lif_plain(xk, wk, v, z, leak, thresh, 3, True)
        _k2_hold(vk, zk, vp, zp, thresh, dtype)
        if plan.bitwise:
            vt, zt = fused_conv_lif(xk, wk, v, z, leak, thresh, 3, True)
            assert torch.equal(vk, vt) and torch.equal(zk, zt), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_padded_view_keeps_nans_inside_c(dev, kernel, dtype):
    """On the ring over a padded view (NaN in every pad channel) a NaN or
    -NaN inside C comes out NaN in exactly the outputs whose sum reads it,
    and the others stay close to the plain form: the pad is never read."""
    b, h, w, cin, cout = 2, 12, 15, 130, 16
    g = _gen()
    x = (torch.rand((b, h, w, cin), generator=g) < 0.3).float()
    x = _with_nans(x, [(0, 3, 4, 5), (1, h - 1, 2, cin - 1)])
    wt = (torch.rand((cout, cin, 3, 3), generator=g) * 2 - 1) * cin ** -0.5
    mask = _window_nans(x.double(), wt.double(), 3).to(dev)
    x, wt = x.to(dev, dtype), wt.to(dev, dtype)
    xp = _padded(x)
    sms = sm_count(torch.device(dev))
    if kernel == "K1":
        assert k1_plan(b, h, w, cin, cout, 3, x.element_size(), sms,
                       xp.stride(2)).ring
        _finite_close(conv2d_same(xp, wt), conv2d_same_plain(x, wt), mask,
                      ATOL)
        return
    assert k2_plan(b, h, w, cin, 0, cout, 3, x.element_size(), sms,
                   xp.stride(2)).ring
    thresh = (0.5 + 0.1 * torch.randn(cout, generator=g)).to(dev)
    leak = torch.sigmoid(torch.randn(cout, generator=g)).to(dev)
    v = (0.3 * torch.randn((b, h, w, cout), generator=g)).to(dev, dtype)
    z = torch.zeros_like(v)
    with torch.no_grad():
        vk, _ = fused_conv_lif(xp, wt, v, z, leak, thresh, 3, True)
        vp, _ = fused_conv_lif_plain(x, wt, v, z, leak, thresh, 3, True)
    _finite_close(vk, vp, mask, ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_padded_view_takes_the_tile(dev, dtype, monkeypatch):
    """A padded view whose pointer is off 16 bytes (TMA cannot stage it)
    goes to the one-image tile, whose copies take its stride, and matches
    the plain form; the aligned view's call is bitwise the same (no K
    split at this shape). Forced onto the ring, whose thread copies take
    contiguous maps only, K1 refuses it with a CUDA error."""
    from event_flow_tpu_torch.ops import conv as t_conv

    b, h, w, cin, cout = 2, 12, 40, 130, 16
    x, wt, _ = _conv_plan_inputs(dev, (b, h, w, cin, cout, 3, "flow"), dtype)
    buf = torch.full((b, h, w, native.channel_stride(cin, x.element_size())),
                     float("nan"), dtype=dtype, device=dev)
    view = buf[..., 1:cin + 1]
    view.copy_(x)
    assert view.data_ptr() % 16 and view.stride(2) == buf.shape[-1]
    sms = sm_count(torch.device(dev))
    assert not k1_plan(b, h, w, cin, cout, 3, x.element_size(), sms,
                       view.stride(2), False).ring
    y = conv2d_same(view, wt)
    ref = conv2d_same_plain(x, wt)
    if dtype == torch.bfloat16:
        _bf16_close(y, ref, ATOL)
    else:
        torch.testing.assert_close(y, ref, atol=ATOL, rtol=1e-5)
    assert torch.equal(y, conv2d_same(_padded(x), wt))
    ring = k1_plan(b, h, w, cin, cout, 3, x.element_size(), sms,
                   view.stride(2))
    assert ring.ring
    with monkeypatch.context() as m:
        m.setattr(t_conv, "k1_plan", lambda *args: ring)
        with pytest.raises(RuntimeError, match="CUDA error"):
            conv2d_same(view, wt)
    xk, wk, _, v, z, leak, thresh = _k2_case(
        dev, (b, h, w, cin, 0, cout, 3), dtype)
    view.copy_(xk)
    with torch.no_grad():
        vk, zk = fused_conv_lif(view, wk, v, z, leak, thresh, 3, True)
        vp, zp = fused_conv_lif_plain(xk, wk, v, z, leak, thresh, 3, True)
        _k2_hold(vk, zk, vp, zp, thresh, dtype)
        va, za = fused_conv_lif(_padded(xk), wk, v, z, leak, thresh, 3,
                                True)
    assert torch.equal(vk, va) and torch.equal(zk, za)
