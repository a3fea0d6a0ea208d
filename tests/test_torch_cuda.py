"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes, the backward on the card against the CPU, and the
repeatability of the training update. Needs a CUDA card and nvcc; skips
elsewhere.

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances as in tests/test_torch_kernels_plain.py: f32 atol 1e-5,
spikes equal except where |v' - thresh| < 1e-4, counts bitwise equal.
Sums over all pixels (the weight gradient, the per-channel leak and
threshold gradients) are held relative to their largest magnitude,
1e-5: f32 sums of up to a few thousand products taken in another order.
"""

import copy

import pytest
import torch

from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.ops.conv import (conv2d_dw_kernel, conv2d_dw_plain,
                                           conv2d_same, conv2d_same_plain)
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                fused_conv_lif_plain,
                                                fused_conv_lif_rec,
                                                fused_conv_lif_rec_plain,
                                                fused_lif_bwd_kernel,
                                                fused_lif_bwd_plain)
from event_flow_tpu_torch.ops.scatter import (scatter_add, scatter_add_kernel,
                                              scatter_add_plain)

SUM_RTOL = 1e-5

pytestmark = pytest.mark.cuda

ATOL = 1e-5
NEAR = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("shape,k,cout", [
    ((2, 18, 30, 5), 1, 3), ((1, 18, 30, 32), 3, 40), ((2, 9, 13, 7), 5, 9),
    ((1, 180, 240, 32), 1, 2)])
def test_conv_kernel_matches_plain(dev, shape, k, cout):
    g = _gen()
    x = torch.randn(shape, generator=g).to(dev)
    w = (0.2 * torch.randn((cout, shape[-1], k, k), generator=g)).to(dev)
    before = native.LAUNCHES["conv2d_same"]
    y = conv2d_same(x, w)
    assert native.LAUNCHES["conv2d_same"] == before + 1
    torch.testing.assert_close(y, conv2d_same_plain(x, w), atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_fused_lif_kernel_matches_plain(dev, rec, hard, k):
    g = _gen()
    b, h, w, cin, c = 2, 18, 30, 5, 12
    x = (torch.rand((b, h, w, cin), generator=g) < 0.3).float().to(dev)
    wt = (0.3 * torch.randn((c, cin, k, k), generator=g)).to(dev)
    thresh = (0.8 + 0.1 * torch.randn(c, generator=g)).to(dev)
    leak = torch.sigmoid(torch.randn(c, generator=g)).to(dev)
    v = thresh + 0.3 * torch.randn((b, h, w, c), generator=g).to(dev)
    z = (torch.rand((b, h, w, c), generator=g) < 0.1).float().to(dev)
    with torch.no_grad():
        if rec:
            wr = (0.3 * torch.randn((c, c, k, k), generator=g)).to(dev)
            vk, zk = fused_conv_lif_rec(x, wt, wr, v, z, z, leak, thresh, k,
                                        hard)
            vp, zp = fused_conv_lif_rec_plain(x, wt, wr, v, z, z, leak,
                                              thresh, k, hard)
        else:
            vk, zk = fused_conv_lif(x, wt, v, z, leak, thresh, k, hard)
            vp, zp = fused_conv_lif_plain(x, wt, v, z, leak, thresh, k, hard)
    torch.testing.assert_close(vk, vp, atol=ATOL, rtol=0)
    flips = zk != zp
    near = (vp - thresh).abs() < NEAR
    assert not (flips & ~near).any()
    assert float(flips.float().mean()) <= 1e-3
    assert 0.0 < float(zp.mean()) < 1.0


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


@pytest.mark.parametrize("shape,k,cout", [
    ((2, 18, 30, 5), 1, 3), ((1, 18, 30, 32), 3, 40), ((2, 9, 13, 7), 5, 9),
    ((2, 20, 36, 2), 3, 32), ((1, 16, 33, 32), 1, 2)])
def test_conv_dw_kernel_matches_plain(dev, shape, k, cout):
    g = _gen()
    x = torch.randn(shape, generator=g).to(dev)
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
    torch.testing.assert_close(first, scatter_add_plain(idx, vals, size),
                               atol=ATOL, rtol=1e-5)


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
