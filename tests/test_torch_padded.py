"""The U-Net decoders' channel-padded input maps: the bilinear x2
upsampling (ops/resize.py) returns the ``[..., :C]`` view of a buffer
whose pixels are whole 16-byte rows, and K1, K2 and B2 take such a view
in place (ops/native.py::require_dense_channels).

On the CPU the wrappers run their plain versions, so these tests hold
what the card relies on: the view's strides in both types, its values
bitwise the contiguous result's and within 1e-6 of JAX's resize, its
gradient the fixed-order stencil's; the conv and the fused LIF cells on a
view whose pad holds NaN bitwise the same as on a contiguous copy,
forward and backward, and within the Pallas tests' tolerances of JAX's
``conv_pallas.py::_conv_fwd`` and ``fused_lif_pallas.py::_fused_fwd``
(interpret mode, as tests/test_conv_pallas.py runs them: f32 atol 1e-5,
spikes equal but within 1e-4 of the threshold); the wrappers' layout
check on fake CUDA tensors. Shapes are small in space and full width in
channels (the U-Nets' 514, 258 and 130), one thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from event_flow_tpu.ops import conv_pallas
from event_flow_tpu.ops import resize as jresize
from event_flow_tpu.ops.conv_pallas import conv2d_pallas
from event_flow_tpu.ops.fused_lif_pallas import (fused_conv_lif as
                                                 jax_fused_conv_lif)
from event_flow_tpu_torch.ops import conv as t_conv
from event_flow_tpu_torch.ops import fused_lif as t_lif
from event_flow_tpu_torch.ops import native
from event_flow_tpu_torch.ops.conv import conv2d_same
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif,
                                                fused_conv_lif_rec)
from event_flow_tpu_torch.ops.resize import (upsample2x_bilinear,
                                             upsample2x_bilinear_grad)

BF16 = torch.bfloat16
ATOL = 1e-5
NEAR = 1e-4
# the decoders' input channels (prediction, previous output, skip) at the
# U-Nets' base of 32, and channel counts on and off 16-byte rows
CHANNELS = [514, 258, 130, 5, 2, 32]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret_mode():
    conv_pallas.set_interpret(True)
    yield
    conv_pallas.set_interpret(False)


def _stride(c, dtype):
    esize = torch.tensor([], dtype=dtype).element_size()
    return -(-c * esize // 16) * 16 // esize


def _padded(x, fill=float("nan")):
    """x as the [..., :C] view of a buffer of whole 16-byte pixel rows
    whose pad holds ``fill``."""
    c = x.shape[-1]
    buf = torch.full((*x.shape[:-1], _stride(c, x.dtype)), fill,
                     dtype=x.dtype)
    view = buf[..., :c]
    view.copy_(x)
    return view


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("c", CHANNELS)
def test_upsample_returns_the_padded_view(c, dtype):
    """The pixel stride is C rounded up to whole 16-byte rows (516, 260,
    132 in float32; 520, 264, 136 in bfloat16), rows and images packed
    over it; the values are bitwise torch's bilinear interpolation; a C of
    whole rows stays contiguous."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.normal(size=(2, 5, 7, c)).astype(
        np.float32)).to(dtype)
    y = upsample2x_bilinear(x)
    cs = _stride(c, dtype)
    assert cs == native.channel_stride(c, x.element_size())
    assert cs * x.element_size() % 16 == 0 and cs - c < 16
    assert tuple(y.shape) == (2, 10, 14, c)
    assert y.stride() == (10 * 14 * cs, 14 * cs, cs, 1)
    assert y.is_contiguous() == (cs == c)
    assert native.require_dense_channels("test", y) == cs
    ref = F.interpolate(x.permute(0, 3, 1, 2), size=(10, 14),
                        mode="bilinear", align_corners=False)
    assert torch.equal(y, ref.permute(0, 2, 3, 1))


@pytest.mark.parametrize("c", [514, 258, 130, 5])
def test_padded_upsample_matches_jax_and_keeps_its_gradient(c):
    """Within 1e-6 of JAX's upsample2x_bilinear (the tolerance of
    tests/test_torch_unet.py); the gradient through the view is the
    fixed-order stencil's, bitwise, and within 1e-6 of max|gx| of JAX's
    VJP."""
    rng = np.random.default_rng(c + 1)
    x = rng.normal(size=(2, 6, 5, c)).astype(np.float32)
    g = rng.normal(size=(2, 12, 10, c)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    y = upsample2x_bilinear(tx)
    assert not y.is_contiguous()
    ref = np.asarray(jresize.upsample2x_bilinear(jnp.asarray(x)))
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=1e-6, rtol=0)
    (gx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    assert gx.is_contiguous()
    assert torch.equal(gx, upsample2x_bilinear_grad(torch.from_numpy(g)))
    import jax

    _, vjp = jax.vjp(jresize.upsample2x_bilinear, jnp.asarray(x))
    jgx = np.asarray(vjp(jnp.asarray(g))[0])
    assert np.abs(gx.numpy() - jgx).max() <= 1e-6 * np.abs(jgx).max()


def _grads(fn, tensors):
    """fn's outputs and the gradients of their weighted sum in each of
    ``tensors`` (leaf copies; zeros where one is unused)."""
    leaves = [t.detach().clone().requires_grad_() if t.is_contiguous()
              else t.detach().requires_grad_() for t in tensors]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(7)
    loss = sum((o.float() * torch.randn(o.shape, generator=gen)).sum()
               for o in outs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return outs, grads


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("cin", [514, 258, 130, 5])
def test_conv_takes_a_padded_view(cin, dtype):
    """conv2d_same on a view whose pad holds NaN: y, dx and dw bitwise
    those of a contiguous copy (the pad is never read); dx contiguous."""
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.normal(size=(2, 6, 7, cin)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(6, cin, 3, 3)) * 0.1).astype(
        np.float32))
    xp = _padded(x)
    assert not xp.is_contiguous() and torch.isnan(xp._base).any()
    (y, ), (dx, dw) = _grads(conv2d_same, (x, w))
    (yp, ), (dxp, dwp) = _grads(conv2d_same, (xp, w))
    assert not torch.isnan(yp).any()
    assert torch.equal(y, yp) and torch.equal(dw, dwp)
    assert torch.equal(dx, dxp)


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("cin", [514, 258, 130])
def test_conv_on_a_padded_view_matches_pallas(cin):
    """K1's plain form on the NaN-padded view against JAX's Pallas conv
    (``_conv_fwd``) on the same values: atol 1e-5."""
    rng = np.random.default_rng(cin + 2)
    x = rng.normal(size=(1, 5, 9, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, 4)) / np.sqrt(9 * cin)).astype(
        np.float32)
    ref = np.asarray(conv2d_pallas(jnp.asarray(x), jnp.asarray(w)))
    got = conv2d_same(_padded(torch.from_numpy(x)), _oihw(w))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def _cell(rng, b, h, w, cin, cout, k=3):
    x = (rng.random((b, h, w, cin)) < 0.3).astype(np.float32) * 2.0
    x[..., -2:] = rng.normal(size=(b, h, w, 2))  # the flow's channels
    wk = (rng.normal(size=(k, k, cin, cout)) * 0.3 / np.sqrt(cin / 8)
          ).astype(np.float32)
    thresh = (0.8 + 0.1 * rng.normal(size=cout)).astype(np.float32)
    v = (thresh + 0.3 * rng.normal(size=(b, h, w, cout))).astype(np.float32)
    z = (rng.random((b, h, w, cout)) < 0.1).astype(np.float32)
    leak = (1.0 / (1.0 + np.exp(-rng.normal(size=cout)))).astype(np.float32)
    return x, wk, v, z, leak, thresh


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("cin", [514, 258, 130])
def test_fused_cells_take_a_padded_view(cin, rec, dtype):
    """The feedforward and recurrent LIF cells on a NaN-padded x: v', z'
    and the gradients in x, the weights, v, leak and threshold bitwise
    those of a contiguous copy."""
    rng = np.random.default_rng(cin + rec)
    x, wk, v, z, leak, thresh = _cell(rng, 2, 6, 5, cin, 8)
    wr = (rng.normal(size=(3, 3, 8, 8)) * 0.3).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    tv, tz = (torch.from_numpy(a).to(dtype) for a in (v, z))
    tl, tt = torch.from_numpy(leak), torch.from_numpy(thresh)
    w, w_rec = _oihw(wk), _oihw(wr)

    def cell(x, w, v, w_rec, leak, thresh):
        if rec:
            return fused_conv_lif_rec(x, w, w_rec, v, tz, tz, leak, thresh,
                                      3, True)
        return fused_conv_lif(x, w, v, tz, leak, thresh, 3, True)

    args = (tx, w, tv, w_rec, tl, tt)
    outs, grads = _grads(cell, args)
    outs_p, grads_p = _grads(cell, (_padded(tx), *args[1:]))
    for a, b in zip(outs + grads, outs_p + grads_p):
        assert not torch.isnan(b).any()
        assert torch.equal(a, b)
    assert 0 < float(outs[1].detach().float().mean()) < 1  # it spikes


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("hard_reset", [True, False])
@pytest.mark.parametrize("cin", [514, 130])
def test_fused_cell_on_a_padded_view_matches_pallas(cin, hard_reset):
    """K2's plain form (the decoders' feedforward cell) on the NaN-padded
    view against JAX's Pallas cell (``_fused_fwd``): v' atol 1e-5, spikes
    equal but within 1e-4 of the threshold, at most 0.1 % of them."""
    rng = np.random.default_rng(cin + hard_reset)
    x, wk, v, z, leak, thresh = _cell(rng, 1, 6, 9, cin, 8)
    vr, zr = jax_fused_conv_lif(*(jnp.asarray(a) for a in (
        x, wk, v, z, leak, thresh)), 3, hard_reset, "arctanspike", 10.0)
    vr, zr = np.asarray(vr), np.asarray(zr)
    vo, zo = fused_conv_lif(_padded(torch.from_numpy(x)), _oihw(wk),
                            *(torch.from_numpy(a) for a in (
                                v, z, leak, thresh)), 3, hard_reset)
    np.testing.assert_allclose(vo.detach().numpy(), vr, atol=ATOL, rtol=0)
    flips = zo.detach().numpy() != zr
    near = np.abs(vr - thresh) < NEAR
    assert not (flips & ~near).any() and flips.mean() <= 1e-3
    assert 0 < zr.mean() < 1


class _NoCard:
    """The kernel library on a machine without a card: each C entry asked
    for raises."""

    def __init__(self):
        self.asked = []

    def __getattr__(self, name):
        self.asked.append(name)
        raise RuntimeError(f"{name}: no CUDA card")


def _wrapper_calls(x):
    """Each wrapper that takes a channel-padded x (K1, B2, K2 ff and
    rec) at x, on fake CUDA tensors of x's type."""
    b, h, w, c = x.shape
    dt = x.dtype

    def cuda(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device="cuda")

    wt, wr = cuda((6, c, 3, 3)), cuda((6, 6, 3, 3))
    g, v = cuda((b, h, w, 6)), cuda((b, h, w, 6))
    leak = cuda((6,), torch.float32)
    return [
        lambda: t_conv._conv_kernel(x, wt),
        lambda: t_conv.conv2d_dw_kernel(x, g, 3),
        lambda: t_lif._ff_kernel(x, wt, v, v, leak, leak, 3, True,
                                 "arctanspike", 10.0),
        lambda: t_lif._rec_kernel(x, wt, wr, v, v, v, leak, leak, 3, True,
                                  "arctanspike", 10.0)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_wrappers_take_a_padded_view_and_refuse_other_layouts(
        monkeypatch, dtype):
    """On fake CUDA tensors: K1's, B2's and K2's wrappers pass a padded
    view (and a contiguous map) on to the kernel library; a transposed
    map, a map sliced along its rows or columns and a channel-last-but-
    not-dense view raise before any library call."""
    stub = _NoCard()
    monkeypatch.setattr(native, "library", lambda: stub)
    c = 130
    cs = _stride(c, dtype)
    with FakeTensorMode():
        def cuda(strides):
            return torch.empty_strided((2, 8, 8, c), strides, dtype=dtype,
                                       device="cuda")

        ok = [cuda((64 * cs, 8 * cs, cs, 1)), cuda((64 * c, 8 * c, c, 1))]
        bad = [cuda((64 * c, c, 8 * c, 1)),            # transposed
               cuda((128 * cs, 16 * cs, cs, 1)),       # every other row
               cuda((128 * c, 16 * c, 2 * c, 2))]      # every other channel
        for x in ok:
            assert native.require_dense_channels("t", x) in (c, cs)
            for call in _wrapper_calls(x):
                n = len(stub.asked)
                with pytest.raises(RuntimeError, match="no CUDA card"):
                    call()
                assert len(stub.asked) == n + 1
        for x in bad:
            for call in _wrapper_calls(x):
                n = len(stub.asked)
                with pytest.raises(ValueError, match="dense"):
                    call()
                assert len(stub.asked) == n


@pytest.mark.parametrize("shape,strides,cs", [
    ((2, 3, 4, 5), (96, 32, 8, 1), 8),      # padded pixels
    ((2, 3, 4, 5), (60, 20, 5, 1), 5),      # contiguous
    ((1, 1, 4, 5), (7, 7, 8, 1), 8),        # size-1 dims: any stride
    ((2, 3, 1, 5), (48, 16, 3, 1), 16),     # one column: the row stride
    ((1, 1, 1, 5), (1, 1, 1, 1), 5),        # one pixel
])
def test_require_dense_channels_reads_the_pixel_stride(shape, strides, cs):
    x = torch.zeros(200).as_strided(shape, strides)
    assert native.require_dense_channels("t", x) == cs


@pytest.mark.parametrize("shape,strides", [
    ((2, 3, 4, 5), (96, 32, 8, 2)),         # channels not dense
    ((2, 3, 4, 5), (96, 64, 8, 1)),         # rows apart
    ((2, 3, 4, 5), (100, 32, 8, 1)),        # images apart
    ((2, 3, 4, 5), (60, 20, 4, 1)),         # pixels overlap
    ((2, 4, 3, 5), (60, 5, 20, 1)),         # H and W transposed
])
def test_require_dense_channels_refuses_other_layouts(shape, strides):
    x = torch.zeros(400).as_strided(shape, strides)
    with pytest.raises(ValueError, match="dense"):
        native.require_dense_channels("t", x)
