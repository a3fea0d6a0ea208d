"""Why K1, K2 and B2 multiply in 3xTF32 and not in one TF32 pass.

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
B2's weight gradient dw is emulated the same way with
``conv2d_dw_plain`` and held to SUM_RTOL, 1e-4 of max|dw| (the card's
tolerance for sums over all pixels, chip_smoke.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from event_flow_tpu_torch.ops.conv import conv2d_dw_plain, conv2d_same_plain

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (needs the sys.path insert)

ATOL = 1e-5
NEAR = 1e-4
SUM_RTOL = 1e-4


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


def dw_one_pass(x, g, k):
    return conv2d_dw_plain(tf32(x), tf32(g), k)


def dw_3xtf32(x, g, k):
    (xh, xl), (gh, gl) = split(x), split(g)
    small = conv2d_dw_plain(xl, gh, k) + conv2d_dw_plain(xh, gl, k)
    return small + conv2d_dw_plain(xh, gh, k)


def _dw_operands(kind, seed=0):
    """(x, g) of B2 at the training distributions, small shapes: a cell's
    spikes (Cin 32), the head's event counts (Cin 2), and dense randn (the
    U-Net decoders' flow channels); g a dense cotangent of scale 1e-3."""
    rng = np.random.default_rng(seed)
    b, h, w = 2, 16, 16
    if kind == "spikes":
        x = rng.random((b, h, w, 32)) < 0.1
    elif kind == "counts":
        x = rng.poisson(0.3, (b, h, w, 2))
    else:
        x = rng.standard_normal((b, h, w, 32))
    g = 1e-3 * rng.standard_normal((b, h, w, 32))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(g.astype(np.float32)))


def _dw_rel_err(kind, dw_fn):
    x, g = _dw_operands(kind)
    ref = conv2d_dw_plain(x.double(), g.double(), 3)
    err = (dw_fn(x, g, 3).double() - ref).abs().max()
    return float(err / ref.abs().max())


@pytest.mark.parametrize("kind", ["spikes", "counts", "dense"])
def test_dw_3xtf32_within_sum_tolerance(kind):
    """3xTF32 stays under 1e-6 of max|dw| here, as close to float64 as
    a plain f32 sum."""
    assert _dw_rel_err(kind, dw_3xtf32) <= SUM_RTOL


@pytest.mark.parametrize("kind", ["spikes", "counts", "dense"])
def test_dw_one_tf32_pass_breaks_the_sum_tolerance(kind):
    """One pass misses by about 2e-4 to 3.3e-4 of max|dw| at all three
    distributions, even where x is exact in TF32: g's 13 dropped bits
    alone do it."""
    assert _dw_rel_err(kind, dw_one_pass) > SUM_RTOL


@pytest.mark.parametrize("kind", ["spikes", "counts"])
def test_dw_exact_x_has_no_lo_part(kind):
    """Spikes and event counts are TF32 values: x's lo part is zero, so
    the kernel may skip its product and take two MMAs per product."""
    x, _ = _dw_operands(kind)
    assert torch.equal(split(x)[1], torch.zeros_like(x))
    _, xd = _dw_operands("dense")
    assert split(xd)[1].abs().max() > 0


@pytest.mark.parametrize("k,cin,cout", [(3, 5, 7), (1, 4, 2), (5, 3, 3)])
def test_dw_library_yardstick_is_the_same_function(k, cin, cout):
    """chip_smoke.py times B2 against cuDNN's weight gradient (the
    weight-only aten.convolution_backward of conv2d_dw_library); on the
    CPU it computes what conv2d_dw_plain computes, OIHW."""
    rng = np.random.default_rng(k)
    x, g = (torch.from_numpy(rng.standard_normal((2, 9, 11, c))
                             .astype(np.float32)) for c in (cin, cout))
    got = chip_smoke.conv2d_dw_library(x, g, k)
    assert got.shape == (cout, cin, k, k)
    torch.testing.assert_close(got, conv2d_dw_plain(x, g, k), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("b,m,size,c", [(1, 50, 12, 1), (3, 40, 9, 4)])
def test_scatter_library_yardstick_is_the_same_function(b, m, size, c):
    """chip_smoke.py times K3 against one index_add_ with its index
    flattening and fresh output (scatter_add_library); on the CPU it
    computes what scatter_add_plain computes."""
    from event_flow_tpu_torch.ops.scatter import scatter_add_plain

    rng = np.random.default_rng(size)
    idx = torch.from_numpy(rng.integers(0, size, (b, m)))
    vals = torch.from_numpy(rng.standard_normal((b, m, c)).astype(np.float32))
    got = chip_smoke.scatter_add_library(idx, vals, size)
    assert got.shape == (b, size, c)
    torch.testing.assert_close(got, scatter_add_plain(idx, vals, size),
                               atol=1e-6, rtol=1e-6)
