"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU (as
tests/test_conv_pallas.py, test_fused_lif.py and test_scatter_pallas.py
run them).

Tolerances: f32 values atol 1e-5 (the summation order differs between
XLA and PyTorch); spikes equal except where |v' - thresh| < 1e-4, where a
different summation order may move v' across the threshold, and such
flips at most 0.1 %; counts bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_flow_tpu.ops import conv_pallas, scatter_pallas
from event_flow_tpu.ops.conv_pallas import conv2d_pallas
from event_flow_tpu.ops.fused_lif_pallas import (fused_conv_lif,
                                                 fused_conv_lif_rec)
from event_flow_tpu.ops.scatter import _scatter_add_xla
from event_flow_tpu.ops.scatter_pallas import scatter_add_pallas
from event_flow_tpu_torch.ops.conv import conv2d_same_plain
from event_flow_tpu_torch.ops.fused_lif import (fused_conv_lif_plain,
                                                fused_conv_lif_rec_plain)
from event_flow_tpu_torch.ops.scatter import scatter_add_plain

ATOL = 1e-5
NEAR = 1e-4
MAX_FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True)
def interpret_mode():
    conv_pallas.set_interpret(True)
    scatter_pallas.set_interpret(True)
    yield
    conv_pallas.set_interpret(False)
    scatter_pallas.set_interpret(False)


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1))))


def assert_spikes_match(z, z_ref, v_ref, thresh):
    """z equal to z_ref except near the threshold, and such flips rare."""
    flips = z != z_ref
    near = np.abs(v_ref - thresh.reshape(1, 1, 1, -1)) < NEAR
    assert not (flips & ~near).any(), "spike differs away from threshold"
    assert flips.mean() <= MAX_FLIP_SHARE


@pytest.mark.parametrize("shape,k,cout", [
    ((2, 9, 13, 3), 1, 5),
    ((1, 18, 30, 4), 3, 6),
    ((2, 11, 7, 5), 5, 3),
    ((1, 16, 16, 8), 3, 16),
])
def test_conv2d_same_plain_matches_pallas(shape, k, cout):
    rng = np.random.default_rng(k + cout)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(k, k, shape[-1], cout)) * 0.2).astype(np.float32)
    ref = np.asarray(conv2d_pallas(jnp.asarray(x), jnp.asarray(w)))
    ours = conv2d_same_plain(torch.from_numpy(x), _oihw(w)).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def _cell_inputs(rng, b, h, w, cin, cout, k):
    x = (rng.random((b, h, w, cin)) < 0.3).astype(np.float32) * 2.0
    wk = (rng.normal(size=(k, k, cin, cout)) * 0.3).astype(np.float32)
    thresh = (0.8 + 0.1 * rng.normal(size=cout)).astype(np.float32)
    # v spread around the threshold so spikes, resets and near-threshold
    # values all occur
    v = (thresh + 0.3 * rng.normal(size=(b, h, w, cout))).astype(np.float32)
    z = (rng.random((b, h, w, cout)) < 0.1).astype(np.float32)
    leak = (1.0 / (1.0 + np.exp(-rng.normal(size=cout)))).astype(np.float32)
    return x, wk, v, z, leak, thresh


@pytest.mark.parametrize("rec", [False, True])
@pytest.mark.parametrize("hard_reset", [True, False])
def test_fused_conv_lif_plain_matches_pallas(rec, hard_reset):
    rng = np.random.default_rng(3 + 2 * rec + hard_reset)
    b, h, w, cin, cout, k = 2, 12, 18, 4, 8, 3
    x, wk, v, z, leak, thresh = _cell_inputs(rng, b, h, w, cin, cout, k)
    j = [jnp.asarray(a) for a in (x, wk, v, z, leak, thresh)]
    t = [torch.from_numpy(a) for a in (x, v, z, leak, thresh)]
    if rec:
        wr = (rng.normal(size=(k, k, cout, cout)) * 0.3).astype(np.float32)
        vr, zr = fused_conv_lif_rec(j[0], j[1], jnp.asarray(wr), j[2], j[3],
                                    j[3], j[4], j[5], k, hard_reset,
                                    "arctanspike", 10.0)
        vo, zo = fused_conv_lif_rec_plain(t[0], _oihw(wk), _oihw(wr), t[1],
                                          t[2], t[2], t[3], t[4], k,
                                          hard_reset)
    else:
        vr, zr = fused_conv_lif(*j, k, hard_reset, "arctanspike", 10.0)
        vo, zo = fused_conv_lif_plain(t[0], _oihw(wk), t[1], t[2], t[3],
                                      t[4], k, hard_reset)
    vr, zr = np.asarray(vr), np.asarray(zr)
    np.testing.assert_allclose(vo.numpy(), vr, atol=ATOL, rtol=0)
    assert 0.0 < zr.mean() < 1.0  # the inputs do spike
    assert_spikes_match(zo.numpy(), zr, vr, thresh)


@pytest.mark.parametrize("c", [1, 4])
def test_scatter_add_plain_matches_pallas_and_xla(c):
    rng = np.random.default_rng(c)
    b, m, size = 2, 300, 40
    idx = rng.integers(0, size, (b, m)).astype(np.int32)
    idx[:, :50] = 7  # duplicates
    counts = rng.integers(0, 3, (b, m, c)).astype(np.float32)
    vals = rng.normal(size=(b, m, c)).astype(np.float32)
    for v, exact in ((counts, True), (vals, False)):
        ours = scatter_add_plain(torch.from_numpy(idx), torch.from_numpy(v),
                                 size).numpy()
        for ref in (scatter_add_pallas(jnp.asarray(idx), jnp.asarray(v), size),
                    _scatter_add_xla(jnp.asarray(idx), jnp.asarray(v), size)):
            ref = np.asarray(ref)
            if exact:
                np.testing.assert_array_equal(ours, ref)
            else:
                np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_scatter_add_plain_drops_out_of_range():
    idx = torch.tensor([[0, 3, -1, 4, 3]], dtype=torch.int32)
    vals = torch.ones(1, 5, 2)
    out = scatter_add_plain(idx, vals, 4)
    np.testing.assert_array_equal(out[0, :, 0].numpy(), [1, 0, 0, 2])
