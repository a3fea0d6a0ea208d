"""Why K1 and K2 multiply in 3xTF32 and not in one TF32 pass.

The kernels' tensor cores take TF32 operands (10 mantissa bits). This
file emulates on the CPU what they compute: TF32 round-to-nearest
(``cvt.rna.tf32.f32``) by bit masking, one pass as conv(tf32(x),
tf32(w)), and the 3xTF32 split as conv(x_lo, w_hi) + conv(x_hi, w_lo) +
conv(x_hi, w_hi) with hi = tf32(a), lo = tf32(a - hi), each conv being
``conv2d_same_plain`` in float32. Both are held against a float64 conv,
at the operand distributions of the training recipe: spike and
event-count inputs times the snn-init weights U(+-sqrt(1/Cin)) for the
cells' current, dense cotangents for K1's dx. The tolerances are those
the card holds the kernels to: f32 atol 1e-5 on v' and y, and spikes
that differ only where |v' - thresh| < 1e-4, at most 0.1 % of them.
"""

import numpy as np
import pytest
import torch

from event_flow_tpu_torch.ops.conv import conv2d_same_plain

ATOL = 1e-5
NEAR = 1e-4


def tf32(a):
    """float32 -> the nearest TF32 value, ties away from zero (cvt.rna):
    add half a unit of the 13 dropped bits, then clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(a):
    hi = tf32(a)
    return hi, tf32(a - hi)


def conv_one_pass(x, w):
    return conv2d_same_plain(tf32(x), tf32(w))


def conv_3xtf32(x, w):
    (xh, xl), (wh, wl) = split(x), split(w)
    small = conv2d_same_plain(xl, wh) + conv2d_same_plain(xh, wl)
    return small + conv2d_same_plain(xh, wh)


def conv_f64(x, w):
    return conv2d_same_plain(x.double(), w.double())


def _operands(kind, seed=0):
    """(x, w) at the training recipe's distributions, small shapes."""
    rng = np.random.default_rng(seed)
    b, h, wd, k = 2, 16, 16, 3
    if kind == "spikes":      # a cell's input: spikes, Cin 32 -> 32
        cin, cout = 32, 32
        x = (rng.random((b, h, wd, cin)) < 0.1).astype(np.float32)
    elif kind == "counts":    # the head: event counts, Cin 2 -> 32
        cin, cout = 2, 32
        x = rng.poisson(0.3, (b, h, wd, cin)).astype(np.float32)
    else:                     # K1's dx: a dense cotangent, 32 -> 32
        cin, cout = 32, 32
        x = rng.standard_normal((b, h, wd, cin)).astype(np.float32)
    bound = cin ** -0.5
    w = rng.uniform(-bound, bound, (cout, cin, k, k)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _lif(cur, v, z, leak, thresh, hard):
    if hard:
        v_out = v * leak * (1.0 - z) + (1.0 - leak) * cur
    else:
        v_out = v * leak + (1.0 - leak) * cur - z * thresh
    return v_out, (v_out - thresh > 0).to(cur.dtype)


def _cell(kind, hard, conv):
    """(v', z') from ``conv`` and from the float64 reference, and thresh:
    the recipe's neuron (leak = sigmoid(-4 + ...), thresh about 0.8) with v
    spread around the threshold."""
    x, w = _operands(kind)
    rng = np.random.default_rng(1)
    c = w.shape[0]
    thresh = torch.from_numpy(
        (0.8 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    leak = torch.sigmoid(torch.from_numpy(
        (-4 + 0.1 * rng.standard_normal(c)).astype(np.float32)))
    shape = x.shape[:3] + (c,)
    v = thresh + torch.from_numpy(
        (0.3 * rng.standard_normal(shape)).astype(np.float32))
    z = torch.from_numpy((rng.random(shape) < 0.1).astype(np.float32))
    got = _lif(conv(x, w), v, z, leak, thresh, hard)
    ref = _lif(conv_f64(x, w), v.double(), z.double(), leak.double(),
               thresh.double(), hard)
    return got, ref, thresh


@pytest.mark.parametrize("value,expected", [
    (1.0, 1.0), (1.0 + 2.0 ** -12, 1.0), (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10), (-(1.0 + 2.0 ** -11),
                                                -(1.0 + 2.0 ** -10)),
    (0.0, 0.0)])
def test_tf32_rounds_to_nearest_ties_away(value, expected):
    got = tf32(torch.tensor([value], dtype=torch.float32))
    assert float(got[0]) == expected


def test_split_keeps_22_bits():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("kind", ["spikes", "counts"])
@pytest.mark.parametrize("hard", [True, False])
def test_3xtf32_cell_within_f32_tolerance(kind, hard):
    (v, z), (v_ref, z_ref), thresh = _cell(kind, hard, conv_3xtf32)
    assert float((v.double() - v_ref).abs().max()) <= ATOL
    flips = z.double() != z_ref
    near = (v_ref - thresh.double()).abs() < NEAR
    assert not (flips & ~near).any()
    assert float(flips.double().mean()) <= 1e-3


@pytest.mark.parametrize("hard", [True, False])
def test_one_tf32_pass_breaks_the_cell_tolerance(hard):
    """At spike inputs the x operand is exact in TF32; the weights' 13
    dropped bits alone put about 1e-4 on the current."""
    (v, _), (v_ref, _), _ = _cell("spikes", hard, conv_one_pass)
    assert float((v.double() - v_ref).abs().max()) > ATOL


@pytest.mark.parametrize("conv,within", [(conv_3xtf32, True),
                                         (conv_one_pass, False)])
def test_dx_of_dense_cotangents(conv, within):
    x, w = _operands("dense")
    err = float((conv(x, w).double() - conv_f64(x, w)).abs().max())
    assert (err <= ATOL) == within, err
