"""The port's ops (event_flow_tpu_torch/ops, loss, data/augment) against
their JAX counterparts on the same numpy inputs.

Tolerances: f32 values atol 1e-5 (summation order differs); counts,
masks, indices and spikes bitwise equal (integer-valued sums and
comparisons do not depend on the order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.data import augment as jax_augment
from event_flow_tpu.loss import metrics as jax_metrics
from event_flow_tpu.ops import encodings as jax_enc
from event_flow_tpu.ops import hot_filter as jax_hot
from event_flow_tpu.ops import iwe as jax_iwe
from event_flow_tpu.ops import spike as jax_spike
from event_flow_tpu_torch.data import augment as t_augment
from event_flow_tpu_torch.loss import metrics as t_metrics
from event_flow_tpu_torch.ops import encodings as t_enc
from event_flow_tpu_torch.ops import hot_filter as t_hot
from event_flow_tpu_torch.ops import iwe as t_iwe
from event_flow_tpu_torch.ops import spike as t_spike

ATOL = 1e-5
RES = (12, 20)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _window(rng, b=2, n=300, res=RES, n_valid=(300, 211)):
    """Raw event windows [B, N, 4] (ts, y, x, p) with a prefix validity
    mask, some events off the sensor, padding at (-1, -1)."""
    h, w = res
    ts = np.sort(rng.uniform(0.0, 0.05, (b, n)), axis=1) + 3.0
    ys = rng.integers(-1, h + 1, (b, n)).astype(np.float32)
    xs = rng.integers(-1, w + 1, (b, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], (b, n))
    ev = np.stack([ts, ys, xs, ps], -1).astype(np.float32)
    valid = np.zeros((b, n), np.float32)
    for i, k in enumerate(n_valid):
        valid[i, :k] = 1.0
        ev[i, k:, 1:3] = -1.0
    return ev, valid


@pytest.mark.parametrize("name", sorted(t_spike.SPIKE_FNS))
def test_spike_values_and_grads(name):
    rng = np.random.default_rng(0)
    thresh = rng.uniform(0.5, 1.0, 5).astype(np.float32)
    x = (thresh + rng.normal(0.0, 0.3, (4, 5))).astype(np.float32)
    x[0] = thresh  # exactly at threshold: no spike, full surrogate
    jfn = jax_spike.get_spike_fn(name)
    jz = jfn(jnp.asarray(x), jnp.asarray(thresh))
    gx, gt = jax.grad(
        lambda a, t: (jfn(a, t) * jnp.arange(1.0, 6.0)).sum(), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(thresh))

    tx = _t(x).requires_grad_(True)
    tt = _t(thresh).requires_grad_(True)
    tz = t_spike.get_spike_fn(name)(tx, tt)
    (tz * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(_np(tz), np.asarray(jz))
    assert not _np(tz)[0].any()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(gx), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(_np(tt.grad), np.asarray(gt), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("num_bins,round_ts", [(2, False), (5, True)])
def test_encode_window(num_bins, round_ts):
    ev, valid = _window(np.random.default_rng(num_bins))
    ref = jax_enc.encode_window(jnp.asarray(ev), RES, num_bins,
                                valid=jnp.asarray(valid), round_ts=round_ts)
    ours = t_enc.encode_window(_t(ev), RES, num_bins, valid=_t(valid),
                               round_ts=round_ts)
    assert set(ours) == set(ref)
    for key in ("event_cnt", "event_mask", "pol_mask"):
        np.testing.assert_array_equal(_np(ours[key]), np.asarray(ref[key]))
    for key in ("event_list", "event_voxel"):
        np.testing.assert_allclose(_np(ours[key]), np.asarray(ref[key]),
                                   atol=ATOL, rtol=0)
    assert _np(ours["event_cnt"]).sum() > 0


def test_hot_filter_over_windows_with_reset():
    """8 windows of activity with persistently hot pixels; slot 1 is reset
    at window 6. Keep-masks and state must match exactly."""
    rng = np.random.default_rng(1)
    b, (h, w) = 2, RES
    hot = rng.integers(0, h * w, 30)
    jstate = jax_hot.init_hot_state(b, RES)
    tstate = t_hot.init_hot_state(b, RES, torch.device("cpu"))
    masked_any = False
    for step in range(8):
        cnt = (rng.random((b, h, w, 2)) < 0.15).astype(np.float32)
        cnt.reshape(b, h * w, 2)[:, hot] = 1.0
        voxel = rng.normal(size=(b, h, w, 2)).astype(np.float32)
        reset = np.array([0.0, 1.0 if step == 6 else 0.0], np.float32)
        enc = {"event_cnt": cnt, "event_voxel": voxel,
               "event_mask": (cnt.sum(-1, keepdims=True) > 0).astype(np.float32)}
        jout, jstate = jax_hot.apply_hot_filter(
            {k: jnp.asarray(v) for k, v in enc.items()}, jstate,
            reset=jnp.asarray(reset), max_px=20, min_obvs=3, max_rate=0.8)
        tout, tstate = t_hot.apply_hot_filter(
            {k: _t(v) for k, v in enc.items()}, tstate, reset=_t(reset),
            max_px=20, min_obvs=3, max_rate=0.8)
        for key in enc:
            np.testing.assert_array_equal(_np(tout[key]), np.asarray(jout[key]))
        np.testing.assert_array_equal(_np(tstate.hot_events),
                                      np.asarray(jstate.hot_events))
        np.testing.assert_array_equal(_np(tstate.hot_idx),
                                      np.asarray(jstate.hot_idx))
        masked_any |= bool((_np(tout["event_mask"]) < enc["event_mask"]).any())
    assert masked_any  # the filter did mask pixels


def _flow_case(seed, b=2, n=300):
    rng = np.random.default_rng(seed)
    ev, valid = _window(rng, b=b, n=n)
    ev[..., 0] = np.where(valid > 0, rng.uniform(0, 1, (b, n)), 0.0)
    flow_map = rng.normal(0.0, 0.02, (b, *RES, 2)).astype(np.float32)
    pol = jax_enc.polarity_mask(jnp.asarray(ev[..., 3]), jnp.asarray(valid))
    return ev, flow_map, np.asarray(pol)


@pytest.mark.parametrize("round_idx", [True, False])
def test_get_interpolation(round_idx):
    ev, flow_map, _ = _flow_case(2)
    flow = np.random.default_rng(3).normal(
        0.0, 0.05, ev.shape[:2] + (2,)).astype(np.float32)
    jidx, jw = jax_iwe.get_interpolation(jnp.asarray(ev), jnp.asarray(flow),
                                         1.0, RES, 128, round_idx=round_idx)
    tidx, tw = t_iwe.get_interpolation(_t(ev), _t(flow), 1.0, RES, 128,
                                       round_idx=round_idx)
    np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=ATOL, rtol=0)


def test_gather_event_flow_and_pol_iwe():
    ev, flow_map, pol = _flow_case(4)
    jflow = jax_iwe.gather_event_flow(jnp.asarray(flow_map), jnp.asarray(ev),
                                      RES)
    tflow = t_iwe.gather_event_flow(_t(flow_map), _t(ev), RES)
    np.testing.assert_array_equal(_np(tflow), np.asarray(jflow))
    for round_idx in (True, False):
        jiwe = jax_iwe.compute_pol_iwe(
            jnp.asarray(flow_map), jnp.asarray(ev), RES,
            jnp.asarray(pol[..., 0:1]), jnp.asarray(pol[..., 1:2]),
            flow_scaling=128, round_idx=round_idx)
        tiwe = t_iwe.compute_pol_iwe(_t(flow_map), _t(ev), RES,
                                     _t(pol[..., 0:1]), _t(pol[..., 1:2]),
                                     flow_scaling=128, round_idx=round_idx)
        np.testing.assert_allclose(_np(tiwe), np.asarray(jiwe), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("passes", [1, 2])
def test_fwl_and_rsat(passes):
    ev, flow_map, pol = _flow_case(5 + passes)
    flow = np.asarray(jax_iwe.gather_event_flow(
        jnp.asarray(flow_map), jnp.asarray(ev), RES))
    ev = ev.copy()
    ev[..., 0] *= passes
    args = (ev, flow)
    jf = jax_metrics.fwl(*map(jnp.asarray, args), passes, RES, 128)
    tf = t_metrics.fwl(*map(_t, args), passes, RES, 128)
    jr = jax_metrics.rsat(*map(jnp.asarray, args), jnp.asarray(pol), passes,
                          RES, 128)
    tr = t_metrics.rsat(*map(_t, args), _t(pol), passes, RES, 128)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), rtol=1e-5)
    np.testing.assert_allclose(_np(tr), np.asarray(jr), rtol=1e-5)
    assert np.all(np.isfinite(_np(tf))) and np.all(np.isfinite(_np(tr)))


def test_augment_flags_copy_matches_jax():
    mechs = ["Polarity", "Horizontal", "Vertical", "Rotation"]
    probs = [0.5, 0.3, 0.7, 0.9]
    for seed in range(3):
        a = t_augment.draw_augment_flags(np.random.default_rng(seed), 4,
                                         mechs, probs)
        b = jax_augment.draw_augment_flags(np.random.default_rng(seed), 4,
                                           mechs, probs)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    ev, _ = _window(np.random.default_rng(9))
    flags = np.array([[1, 0, 1], [0, 1, 0]], np.float32)
    np.testing.assert_array_equal(
        _np(t_augment.augment_events(_t(ev), _t(flags), RES)),
        np.asarray(jax_augment.augment_events(jnp.asarray(ev),
                                              jnp.asarray(flags), RES)))
