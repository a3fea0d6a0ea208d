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
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                fused_conv_lif_plain,
                                                fused_conv_lif_rec,
                                                fused_conv_lif_rec_plain,
                                                fused_lif_bwd_kernel,
                                                fused_lif_bwd_plain)
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
    from event_flow_tpu_torch.eval_flow import build_model

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


@pytest.mark.parametrize("activation", ["arctanspike", "superspike",
                                        "trianglespike", "mgspike"])
@pytest.mark.parametrize("hard", [True, False])
def test_fused_lif_bwd_kernel_matches_plain(dev, activation, hard):
    g = _gen()
    b, h, w, c = 2, 9, 13, 12
    width = {"mgspike": 0.5, "trianglespike": 1.0}.get(activation, 10.0)
    thresh = (0.8 + 0.1 * torch.randn(c, generator=g)).to(dev)
    leak = torch.sigmoid(torch.randn(c, generator=g)).to(dev)
    v = thresh + 0.3 * torch.randn((b, h, w, c), generator=g).to(dev)
    z = (torch.rand((b, h, w, c), generator=g) < 0.1).float().to(dev)
    v_out = thresh + 0.3 * torch.randn((b, h, w, c), generator=g).to(dev)
    g_v = torch.randn((b, h, w, c), generator=g).to(dev)
    g_z = torch.randn((b, h, w, c), generator=g).to(dev)
    args = (v, z, v_out, leak, thresh, g_v, g_z, hard, activation, width)
    before = native.LAUNCHES["fused_lif_bwd"]
    got = fused_lif_bwd_kernel(*args)
    assert native.LAUNCHES["fused_lif_bwd"] == before + 1
    ref = fused_lif_bwd_plain(*args)
    for a, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, r, atol=ATOL, rtol=1e-5)
    for a, r in zip(got[2:], ref[2:]):
        assert_close_to_max(a, r)
    again = fused_lif_bwd_kernel(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


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


@pytest.mark.parametrize("c", [384, 512, 1024])
@pytest.mark.parametrize("hard", [True, False])
def test_fused_lif_bwd_kernel_past_256_channels(dev, c, hard):
    """B4 at the U-Net's 512-channel cells and around them: one channel
    walk per thread and pixel above 256 channels."""
    g = _gen()
    shape = (2, 9, 13, c)
    thresh = (0.8 + 0.1 * torch.randn(c, generator=g)).to(dev)
    leak = torch.sigmoid(torch.randn(c, generator=g)).to(dev)
    v = thresh + 0.3 * torch.randn(shape, generator=g).to(dev)
    z = (torch.rand(shape, generator=g) < 0.1).float().to(dev)
    v_out = thresh + 0.3 * torch.randn(shape, generator=g).to(dev)
    g_v = torch.randn(shape, generator=g).to(dev)
    g_z = torch.randn(shape, generator=g).to(dev)
    args = (v, z, v_out, leak, thresh, g_v, g_z, hard, "arctanspike", 10.0)
    got = fused_lif_bwd_kernel(*args)
    ref = fused_lif_bwd_plain(*args)
    for a, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, r, atol=ATOL, rtol=1e-5)
    for a, r in zip(got[2:], ref[2:]):
        assert a.shape == (c,)
        assert_close_to_max(a, r)
    again = fused_lif_bwd_kernel(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


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
