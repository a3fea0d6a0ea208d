"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes. Needs a CUDA card and nvcc; skips elsewhere.

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances as in tests/test_torch_kernels_plain.py: f32 atol 1e-5,
spikes equal except where |v' - thresh| < 1e-4, counts bitwise equal.
"""

import pytest
import torch

from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.ops.conv import conv2d_same, conv2d_same_plain
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                fused_conv_lif_plain,
                                                fused_conv_lif_rec,
                                                fused_conv_lif_rec_plain)
from event_flow_tpu_torch.ops.scatter import scatter_add, scatter_add_plain

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
