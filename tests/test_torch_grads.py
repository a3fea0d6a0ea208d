"""The port's backward pieces against the JAX package's on the CPU: the conv
weight gradient (B2) and the conv VJP, the LIF backward (B4) and the
whole cell VJPs, the gather whose backward is the scatter-add, the
batched encodings, the compact IWE and the training loss with its
flow-map gradient. The Pallas kernels run in interpret mode, as
tests/test_conv_pallas.py and test_fused_lif.py run them.

Tolerances, each from f32 arithmetic done in another order by XLA and
PyTorch:
  - elementwise maps and dx (values of order 1): atol 1e-5;
  - sums over every pixel (dw, the per-channel leak and threshold
    gradients): 1e-5 of the largest magnitude, the rounding of sums of
    up to some thousand products;
  - the loss: rtol 1e-5; its flow-map gradient: 1e-4 of the largest
    magnitude, as the gradient passes through the division by the count
    image (iwe + 1e-9), which amplifies the rounding of small counts;
  - counts, masks and indices: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.data.synthetic import constant_flow_window
from event_flow_tpu.loss import warping as jax_warping
from event_flow_tpu.ops import conv_pallas, scatter_pallas
from event_flow_tpu.ops import encodings as jax_enc
from event_flow_tpu.ops import iwe as jax_iwe
from event_flow_tpu.ops.conv_pallas import _conv_dw, conv2d_pallas
from event_flow_tpu.ops.fused_lif_pallas import (_fused_bwd_elem,
                                                 fused_conv_lif,
                                                 fused_conv_lif_rec)
from event_flow_tpu_torch.loss import warping as t_warping
from event_flow_tpu_torch.ops import encodings as t_enc
from event_flow_tpu_torch.ops import fused_lif as t_lif
from event_flow_tpu_torch.ops import iwe as t_iwe
from event_flow_tpu_torch.ops.conv import conv2d_dw_plain, conv2d_same
from event_flow_tpu_torch.ops.scatter import gather_events

ATOL = 1e-5
SUM_RTOL = 1e-5
LOSS_GRAD_RTOL = 1e-4
SURROGATES = [("arctanspike", 10.0), ("superspike", 10.0),
              ("trianglespike", 1.0), ("mgspike", 0.5)]


@pytest.fixture(autouse=True)
def interpret_mode():
    conv_pallas.set_interpret(True)
    scatter_pallas.set_interpret(True)
    yield
    conv_pallas.set_interpret(False)
    scatter_pallas.set_interpret(False)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _oihw(w_hwio):
    return _t(np.transpose(np.asarray(w_hwio), (3, 2, 0, 1)))


def _hwio(w_oihw):
    return np.transpose(w_oihw.detach().numpy(), (2, 3, 1, 0))


def assert_close_to_max(got, ref, rtol=SUM_RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, np.abs(ref).max())


# -- B2 and the conv VJP ----------------------------------------------------

@pytest.mark.parametrize("shape,k,cout", [
    ((2, 9, 13, 3), 1, 5), ((1, 12, 18, 4), 3, 6), ((2, 11, 7, 5), 5, 3)])
def test_conv_dw_plain_matches_pallas(shape, k, cout):
    rng = np.random.default_rng(k)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape[:3] + (cout,)).astype(np.float32)
    ref = np.asarray(_conv_dw(jnp.asarray(x), jnp.asarray(g), k))
    ours = conv2d_dw_plain(_t(x), _t(g), k)  # OIHW
    assert_close_to_max(_hwio(ours).reshape(k * k * shape[-1], cout), ref)


@pytest.mark.parametrize("shape,k,cout", [
    ((2, 9, 13, 3), 1, 5), ((1, 10, 14, 4), 3, 6), ((2, 7, 11, 2), 5, 3)])
def test_conv_function_grads_match_pallas_vjp(shape, k, cout):
    rng = np.random.default_rng(10 + k)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(k, k, shape[-1], cout)) * 0.3).astype(np.float32)
    g = rng.normal(size=shape[:3] + (cout,)).astype(np.float32)
    y_ref, vjp = jax.vjp(conv2d_pallas, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    tw = _oihw(w).requires_grad_()
    y = conv2d_same(tx, tw)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), atol=ATOL,
                               rtol=0)
    assert_close_to_max(_hwio(dw), dw_ref)


def test_conv_function_computes_only_the_grads_asked_for():
    x = torch.randn(1, 5, 6, 2)
    w = torch.randn(3, 2, 3, 3, requires_grad=True)
    conv2d_same(x, w).sum().backward()
    assert w.grad is not None and x.grad is None


# -- B4 and the cell VJPs ---------------------------------------------------

def _bwd_inputs(rng, b=2, h=8, w=12, c=6):
    thresh = (0.8 + 0.1 * rng.normal(size=c)).astype(np.float32)
    leak = (1.0 / (1.0 + np.exp(-rng.normal(size=c)))).astype(np.float32)
    v = (thresh + 0.3 * rng.normal(size=(b, h, w, c))).astype(np.float32)
    z = (rng.random((b, h, w, c)) < 0.2).astype(np.float32)
    v_out = (thresh + 0.3 * rng.normal(size=(b, h, w, c))).astype(np.float32)
    g_v = rng.normal(size=(b, h, w, c)).astype(np.float32)
    g_z = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return v, z, v_out, leak, thresh, g_v, g_z


@pytest.mark.parametrize("c", [6, 256, 512])
@pytest.mark.parametrize("activation,width", SURROGATES)
@pytest.mark.parametrize("hard_reset", [True, False])
def test_fused_lif_bwd_plain_matches_pallas(activation, width, hard_reset, c):
    """B4's plain version, which the card holds B4 against, against JAX's
    _fused_bwd_elem: at 6 channels on a 2 x 8 x 12 map, and at the U-Net's
    256 and 512 (where B4 cuts rows into segments) on a 2 x 4 x 4 one."""
    rng = np.random.default_rng(len(activation) + hard_reset)
    hw = (8, 12) if c == 6 else (4, 4)
    v, z, v_out, leak, thresh, g_v, g_z = _bwd_inputs(rng, 2, *hw, c)
    if activation == "arctanspike":
        leak[0] = 1.0  # sigmoid of a large leak: the (1 - l) clamp
    args = (v, z, v_out, leak, thresh, g_v, g_z)
    ref = _fused_bwd_elem(*map(jnp.asarray, args), hard_reset, activation,
                          width)
    ours = t_lif.fused_lif_bwd_plain(*map(_t, args), hard_reset, activation,
                                     width)
    for a, r in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)
    for a, r in zip(ours[2:], ref[2:]):
        assert np.all(np.isfinite(a.numpy()))
        assert_close_to_max(a.numpy(), r)


def _cell_case(rng, rec, b=2, h=9, w=13, cin=3, c=6, k=3):
    x = (rng.random((b, h, w, cin)) < 0.3).astype(np.float32) * 2.0
    wk = (rng.normal(size=(k, k, cin, c)) * 0.3).astype(np.float32)
    wr = (rng.normal(size=(k, k, c, c)) * 0.3).astype(np.float32)
    thresh = (0.8 + 0.1 * rng.normal(size=c)).astype(np.float32)
    leak = (1.0 / (1.0 + np.exp(-rng.normal(size=c)))).astype(np.float32)
    v = (thresh + 0.3 * rng.normal(size=(b, h, w, c))).astype(np.float32)
    z = (rng.random((b, h, w, c)) < 0.2).astype(np.float32)
    z_rec = (rng.random((b, h, w, c)) < 0.2).astype(np.float32)
    g_v = rng.normal(size=(b, h, w, c)).astype(np.float32)
    g_z = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return x, wk, wr, v, z, z_rec, leak, thresh, g_v, g_z, k


@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("hard_reset", [True, False])
def test_cell_vjp_matches_jax(rec, hard_reset):
    rng = np.random.default_rng(20 + 2 * rec + hard_reset)
    x, wk, wr, v, z, z_rec, leak, thresh, g_v, g_z, k = _cell_case(rng, rec)
    cfg = (k, hard_reset, "arctanspike", 10.0)
    if rec:
        jargs = [jnp.asarray(a) for a in (x, wk, wr, v, z, z_rec, leak,
                                          thresh)]
        _, vjp = jax.vjp(lambda *a: fused_conv_lif_rec(*a, *cfg), *jargs)
        names = ("x", "w", "w_rec", "v", "z", "z_rec", "leak", "thresh")
        targs = [_t(x), _oihw(wk), _oihw(wr), _t(v), _t(z), _t(z_rec),
                 _t(leak), _t(thresh)]
        fn = t_lif.fused_conv_lif_rec
    else:
        jargs = [jnp.asarray(a) for a in (x, wk, v, z, leak, thresh)]
        _, vjp = jax.vjp(lambda *a: fused_conv_lif(*a, *cfg), *jargs)
        names = ("x", "w", "v", "z", "leak", "thresh")
        targs = [_t(x), _oihw(wk), _t(v), _t(z), _t(leak), _t(thresh)]
        fn = t_lif.fused_conv_lif
    ref = dict(zip(names, vjp((jnp.asarray(g_v), jnp.asarray(g_z)))))
    for a in targs:
        a.requires_grad_()
    out = fn(*targs, *cfg)
    grads = torch.autograd.grad(out, targs, (_t(g_v), _t(g_z)),
                                allow_unused=True)
    got = dict(zip(names, grads))
    assert got["z"] is None and not np.asarray(ref["z"]).any()  # dz = 0
    for name in ("x", "v", "z_rec"):
        if name in got:
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(ref[name]), atol=ATOL,
                                       rtol=0, err_msg=name)
    for name in ("w", "w_rec"):
        if name in got:
            assert_close_to_max(_hwio(got[name]), ref[name])
    for name in ("leak", "thresh"):
        assert_close_to_max(got[name].numpy(), ref[name])


@pytest.mark.parametrize("activation,width", SURROGATES)
@pytest.mark.parametrize("rec", [False, True])
def test_cell_backward_equals_autograd_of_plain_forward(activation, width,
                                                        rec):
    """The cell's backward (B4's plain version + the conv pieces) against
    autograd through the plain forward, which detaches z in the reset."""
    rng = np.random.default_rng(30 + rec)
    x, wk, wr, v, z, _, leak, thresh, g_v, g_z, k = _cell_case(rng, rec)
    args = [_t(x), _oihw(wk), _oihw(wr), _t(v), _t(z), _t(leak), _t(thresh)]
    cfg = (k, False, activation, width)  # soft reset: z reaches v' twice

    def grads(fns):
        ins = [a.clone().requires_grad_() for a in args]
        x_, w_, wr_, v_, z_, l_, t_ = ins
        if rec:
            out = fns[1](x_, w_, wr_, v_, z_, z_, l_, t_, *cfg)
        else:
            out = fns[0](x_, w_, v_, z_, l_, t_, *cfg)
        return torch.autograd.grad(out, ins, (_t(g_v), _t(g_z)),
                                   allow_unused=True)

    ours = grads((t_lif.fused_conv_lif, t_lif.fused_conv_lif_rec))
    plain = grads((t_lif.fused_conv_lif_plain,
                   t_lif.fused_conv_lif_rec_plain))
    for name, a, r in zip(("x", "w", "w_rec", "v", "z", "leak", "thresh"),
                          ours, plain):
        assert (a is None) == (r is None), name
        if a is not None:
            assert_close_to_max(a.numpy(), r.numpy())
    # z feeds only the detached reset of the feedforward cell
    assert (ours[4] is None) == (not rec)


# -- gather, encodings, IWE, loss -------------------------------------------

def test_gather_events_and_its_scatter_backward_match_jax():
    rng = np.random.default_rng(5)
    planes = rng.normal(size=(2, 40, 2)).astype(np.float32)
    idx = rng.integers(0, 40, (2, 300)).astype(np.int32)
    idx[:, :60] = 3  # duplicates
    g = rng.normal(size=(2, 300, 2)).astype(np.float32)

    def jgather(p):
        return jnp.take_along_axis(p, jnp.asarray(idx)[..., None], axis=1)

    ref, vjp = jax.vjp(jgather, jnp.asarray(planes))
    (dref,) = vjp(jnp.asarray(g))
    tp = _t(planes).requires_grad_()
    out = gather_events(tp, torch.from_numpy(idx))
    (dp,) = torch.autograd.grad(out, tp, _t(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(dp.numpy(), np.asarray(dref), atol=ATOL,
                               rtol=0)


def _windows(seed, b=2, t=3, n=200, res=(24, 32), n_valid=None):
    rng = np.random.default_rng(seed)
    ev = np.stack([np.stack([constant_flow_window(
        rng, n, res, rng.uniform(-4, 4, 2), sharp_points=12)
        for _ in range(t)]) for _ in range(b)])
    ev[..., 3] = np.where(ev[..., 3] > 0, 1.0, -1.0)
    valid = np.ones((b, t, n), np.float32)
    if n_valid is not None:
        valid[:, :, n_valid:] = 0.0
        ev[:, :, n_valid:, 1:3] = -1.0
    return ev.astype(np.float32), valid


@pytest.mark.parametrize("num_bins,round_ts", [(2, False), (5, True)])
def test_encode_windows_matches_jax(num_bins, round_ts):
    res = (24, 32)
    ev, valid = _windows(num_bins, n_valid=150, res=res)
    ref = jax_enc.encode_windows(jnp.asarray(ev), res, num_bins,
                                 valid=jnp.asarray(valid), round_ts=round_ts)
    ours = t_enc.encode_windows(_t(ev), res, num_bins, valid=_t(valid),
                                round_ts=round_ts)
    assert set(ours) == set(ref)
    for key in ("event_cnt", "event_mask", "pol_mask"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    for key in ("event_list", "event_voxel"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=0)


def test_compact_iwe_matches_jax():
    res = (24, 32)
    rng = np.random.default_rng(8)
    b, m = 2, 500
    ts = rng.uniform(0, 3, (b, m)).astype(np.float32)
    ys = rng.integers(-1, res[0] + 1, (b, m)).astype(np.float32)
    xs = rng.integers(-1, res[1] + 1, (b, m)).astype(np.float32)
    fy, fx = (rng.normal(0, 0.03, (2, b, m))).astype(np.float32)
    payload = rng.normal(size=(b, m, 4)).astype(np.float32)
    for tref in (0.0, 3.0):
        jidx, jw4 = jax_iwe.get_interpolation_compact_cf(
            *map(jnp.asarray, (ts, ys, xs, fy, fx)), tref, res, 32.0)
        tidx, tw4 = t_iwe.get_interpolation_compact(
            *map(_t, (ts, ys, xs, fy, fx)), tref, res, 32.0)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw4.numpy(),
                                   np.moveaxis(np.asarray(jw4), 1, -1),
                                   atol=ATOL, rtol=0)
        stack = (tw4[..., :, None] * _t(payload)[..., None, :]).reshape(
            b, m, 16)
        jstack = jnp.asarray(np.moveaxis(stack.numpy(), -1, 1))
        ref = jax_iwe.interpolate_compact_cf(jidx, jstack, res, 4)
        ours = t_iwe.interpolate_compact(tidx, stack, res, 4)
        np.testing.assert_allclose(ours.numpy(),
                                   np.moveaxis(np.asarray(ref), 1, -1),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("overwrite", [False, True])
@pytest.mark.parametrize("smoothing_mask", [False, True])
def test_event_warping_loss_and_flow_grad_match_jax(overwrite,
                                                    smoothing_mask):
    res = (24, 32)
    ev, valid = _windows(11, n_valid=170, res=res)
    jenc = jax_enc.encode_windows(jnp.asarray(ev), res, 2,
                                  valid=jnp.asarray(valid))
    tenc = t_enc.encode_windows(_t(ev), res, 2, valid=_t(valid))
    rng = np.random.default_rng(12)
    flow = rng.normal(0.0, 0.02, (2, 3, *res, 2)).astype(np.float32)
    kw = dict(flow_regul_weight=0.001, smoothing_mask=smoothing_mask,
              overwrite_intermediate=overwrite)
    jcfg = jax_warping.LossConfig(res, 32.0, **kw)
    tcfg = t_warping.LossConfig(res, 32.0, **kw)

    def jloss(f):
        return jax_warping.event_warping_loss(
            [f], jenc["event_list"], jenc["pol_mask"], jenc["event_mask"],
            jcfg)

    ref, gref = jax.value_and_grad(jloss)(jnp.asarray(flow))
    tf = _t(flow).requires_grad_()
    loss = t_warping.event_warping_loss(
        [tf], tenc["event_list"], tenc["pol_mask"], tenc["event_mask"], tcfg)
    (g,) = torch.autograd.grad(loss, tf)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert float(np.abs(np.asarray(gref)).max()) > 0
    assert_close_to_max(g.numpy(), gref, rtol=LOSS_GRAD_RTOL)
